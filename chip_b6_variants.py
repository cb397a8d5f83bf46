#!/usr/bin/env python3
"""Times B6d and B6s of one checkout on one NVIDIA GPU.

    python3 chip_b6_variants.py [--checkout DIR] [--profile] [--variants]

From the repo root, on a machine with a card. DIR (default: this
checkout) is any checkout of the repo, such as an earlier commit unpacked
with `git archive`; its own chip_smoke.py and gtos_tpu_torch are imported,
so its kernels run with its own wrappers. The script trains the c5 model
as chip_smoke's c5 phase does and captures the main path's B6 inputs
(layer 0 of CAPTURE_BATCHES train batches), then runs chip_smoke's
check_b6 on them and on BLOCK_CASES in f32 and bf16: each kernel against
its plain version, the same bits twice, timed (CUDA events, L2 flushed,
mean of 30 after 3 warm-ups) beside its bound. With --profile (a
checkout whose chip_smoke profiles a given batch), torch.profiler over
one more c5 train step on each captured batch first: device busy time,
idle share, each block-sparse kernel's share. With --variants (this
checkout's kernels only), the backward source is built once more with
GTOS_B6_VARIANTS, which adds four (pairs a lane group holds, blocks an
SM) variants of B6d's and B6s's bf16 pass for rows up to 64 wide; each is
forced in turn and timed on the bf16 inputs, each result held against
the plain versions; the last line gives the mean over the main-path
batches per variant.
"""

import argparse
import json
import sys
from pathlib import Path


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--checkout", default=str(Path(__file__).resolve().parent))
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--variants", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.checkout).resolve()))

    import torch

    import chip_smoke as cs
    from gtos_tpu_torch.ops import block_sparse_attention_bwd as bm

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this script needs a "
                "card")
    print(cs.card_line(), flush=True)
    print(f"[b6] checkout {Path(cs.__file__).resolve().parent}", flush=True)
    trained = cs.phase_c5_train()
    trainer, batches = trained[:2]
    inputs = cs.capture_block_train_inputs(trainer,
                                           batches[:cs.CAPTURE_BATCHES])
    if args.profile:
        for i, batch in enumerate(batches[:cs.CAPTURE_BATCHES]):
            cs.phase_profile_train(trainer, trained[3], batch=batch,
                                   label=f"c5 block_sparse train step {i + 1}")
    del trainer
    torch.cuda.empty_cache()
    cases = []
    for i, (fwd_args, src, bwd) in enumerate(inputs):
        cases.append((f"train{i}", fwd_args, src, bwd))
        cs.check_b6(f"train{i}", fwd_args, src, bwd=bwd)
    for name, spec in cs.BLOCK_CASES.items():
        batch = cs.block_batch(*spec)
        for dtype in (torch.float32, torch.bfloat16):
            fwd_args, src, g = cs.block_inputs(batch, 8, 64, dtype)
            cs.check_b6(name, fwd_args, src, g)
            if args.variants and dtype == torch.bfloat16:
                cases.append((name, fwd_args, src,
                              cs.b6_args(fwd_args, src, g)))
    if args.variants:
        time_variants(cs, bm, cases)


def time_variants(cs, bm, cases):
    """B6d and B6s under each forced bf16 variant on the bf16 cases, each
    result against the plain versions; prints the per-variant means over
    the main-path batches as JSON."""
    import torch

    from gtos_tpu_torch.ops import build

    entries = bm.kernel_entries(build.load(bm.BWD_SOURCE,
                                           ("GTOS_B6_VARIANTS",)))
    variant, real = entries[3], bm._bwd_kernels
    bm._bwd_kernels = lambda: entries
    n = variant(-1)
    means = {}
    try:
        for label, fwd_args, src, (core, plan) in cases:
            ts, tr = fwd_args[5], fwd_args[6]
            ref_d = bm.block_sparse_attention_bwd_dst_reference(*core, ts, tr)
            ref_s = bm.block_sparse_attention_bwd_src_reference(*core, *src)
            for v in range(n):
                variant(v)
                dst = lambda: bm.block_sparse_attention_bwd_dst(  # noqa
                    *core, ts, tr, plan)
                d = dst()
                srcp = lambda: bm.block_sparse_attention_bwd_src(  # noqa
                    *core, *src, plan, d[2])
                dtype_name = cs._dtype_name(core[0])
                cs._compare("B6d", f"{label} variant {v}", dtype_name,
                            list(zip(("dq", "ge"), d, ref_d)))
                cs._compare("B6s", f"{label} variant {v}", dtype_name,
                            list(zip(("dk", "dv"), srcp(), ref_s)))
                ms = (cs.time_ms(dst), cs.time_ms(srcp))
                print(f"[variant] {label} variant {v}: B6d {ms[0]:.6f} ms, "
                      f"B6s {ms[1]:.6f} ms", flush=True)
                if label.startswith("train"):
                    means.setdefault(v, []).append(ms)
            torch.cuda.empty_cache()
    finally:
        variant(-1)
        bm._bwd_kernels = real
    print(json.dumps({"main_path_mean_ms": {
        v: {"B6d": sum(m[0] for m in ms) / len(ms),
            "B6s": sum(m[1] for m in ms) / len(ms)}
        for v, ms in means.items()}}))


if __name__ == "__main__":
    main()
