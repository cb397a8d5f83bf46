"""relattn_roofline.serve: the same for serving: B1's least time on each
traced batch over the device time of its kernel (local_fwd), in percent.
Layer: the kernels. Moves decode_graphs_per_s."""

from perfbench.harness.trace import device_seconds


def read(record):
    t = device_seconds(record, "local_fwd")
    bound = record["work"].get("relattn_bound_s")
    if not t or not bound:
        return None
    return bound / t * 100.0
