"""relattn_roofline.train: the localized relation attention's share of its
roofline in training: the least times of B1p and B2 on each traced
batch's rel_index_loc (harness/work.py, the bounds of the port's
benchlib) over the device time of their kernels, found by CUDA symbol
name (local_fwd, local_bwd_*), in percent. Layer: the kernels
(ops/local_relation_attention.py, ops/csrc/local_relation_attention_
{fwd,bwd}.cu). Moves train_tokens_per_s."""

from perfbench.harness.trace import device_seconds


def read(record):
    t = device_seconds(record, "local_fwd", "local_bwd_")
    bound = record["work"].get("relattn_bound_s")
    if not t or not bound:
        return None
    return bound / t * 100.0
