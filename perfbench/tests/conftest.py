"""The benchmark's own tests: on the CPU at tiny sizes, and (marker
`cuda`) on a card. Run from the repository root:

    python -m pytest perfbench/tests -q
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skipped without one")


# the tests' sizes: the cells' code paths at tiny widths and corpora, in
# f32 on the CPU
TINY = dict(
    model=dict(d_model=32, d_ff=64, heads=2, enc_layers=1, dec_layers=1,
               compute_dtype="float32"),
    params=dict(train_graphs=120, batchify_workers=0, requests=24,
                max_time_step=8, sample=4, trace_seconds=1))
