"""Run one cell of the benchmark once, on the card(s) of this machine.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Set-up (corpus, loader, model, warm-up of every shape the cell uses),
then a window of `--seconds`, then the check of what the window produced
against the plain reference. The last line of standard output is one
JSON object: correct, attempted, failed, metrics (the cell's end-to-end
metrics; with --trace 1 its per-layer metrics), device, with --trace 1
breakdown, and last `checks`, each compared number beside its limit (also
the last lines of standard error). Exits non-zero, printing no result,
without the cards the cell asks for, or where jax, jaxlib, flax or
gtos_tpu was loaded.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
from pathlib import Path

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _finite(x):
    """x with every non-finite float written as a string (JSON has no
    NaN)."""
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return str(x)
    return x


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    from perfbench.harness import cell as cells

    chips = cells.workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: {args.workload} needs {chips} CUDA card(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.reset_peak_memory_stats()
    with cells.caches():
        try:
            out = cells.run_cell(args.workload, args.seed, args.seconds,
                                 bool(args.trace), device)
        finally:
            cells.stop_children()
    loaded = cells.forbidden_modules()
    if loaded:
        print(f"perfbench: the run loaded {loaded}", file=sys.stderr)
        return 3
    line = cells.result(args.workload, out, bool(args.trace), device, chips,
                        cells.benchmark())
    detail = out["numbers"].get("detail")
    print("perfbench: " + json.dumps(dict(
        setup_s=out["setup_s"], window_s=out["window_s"],
        counters=out["counters"], detail=detail,
        trace_cost=(out["record"] or {}).get("cost")), default=str),
        file=sys.stderr)
    for k, v in line["checks"].items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(_finite(line), default=float), flush=True)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    sys.exit(main())
