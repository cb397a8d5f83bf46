"""The readings that a cell's limits are set from, on the card, several
seeds in one process:

    python3 perfbench/calibrate.py --workload <cell> --seeds S [S ...]
        [--mode program | control | <plant>] [--seconds 5]

  program   the check's numbers of sound runs
  control   the float8 reference in the program's place
  <plant>   a fault of harness/plants.py planted in the program

One JSON line a seed (the numbers and their detail), and last one line
with each number's largest and smallest reading over the seeds. The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--mode", default="program")
    p.add_argument("--seconds", type=float, default=5.0)
    args = p.parse_args(argv)
    import torch

    from perfbench.harness import cell as cells
    from perfbench.harness.plants import PLANTS

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    plant = PLANTS.get(args.mode)
    if args.mode not in ("program", "control") and plant is None:
        p.error(f"--mode {args.mode}: program, control or one of "
                f"{sorted(PLANTS)}")
    readings = {}
    with cells.caches():
        for seed in args.seeds:
            t0 = time.perf_counter()
            try:
                out = cells.run_cell(args.workload, seed, args.seconds, False,
                                     device, plant=plant,
                                     control=args.mode == "control")
            finally:
                cells.stop_children()
            nums = out["numbers"]
            for k, v in nums.items():
                if k != "detail":
                    readings.setdefault(k, []).append(v)
            print(json.dumps(dict(seed=seed, mode=args.mode,
                                  seconds=time.perf_counter() - t0,
                                  attempted=out["attempted"], **nums),
                             default=str), flush=True)
    print(json.dumps(dict(workload=args.workload, mode=args.mode,
                          seeds=args.seeds,
                          largest={k: max(v) for k, v in readings.items()},
                          smallest={k: min(v) for k, v in readings.items()})),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
