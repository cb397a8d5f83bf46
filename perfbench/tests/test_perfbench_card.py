"""On a card: each cell's run through perfbench/run.py, a short window,
prints a correct result line with the card's name. Skipped without a
card (decided when the test runs)."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(card, name):
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", name, "--seed",
         str(2 ** 31 + 11), "--seconds", "3", "--trace", "0"],
        capture_output=True, text=True, timeout=900, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["count"] == 1
    assert "H100" in line["device"]["kind"]
