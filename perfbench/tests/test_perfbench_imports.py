"""In a fresh process: a run (a tiny cell on the CPU, the code path of
perfbench/run.py past its look for a card) loads neither jax, jaxlib,
flax nor gtos_tpu, compared by whole top-level module names (the port's
gtos_tpu_torch is not gtos_tpu); the reference loads nothing of the
program either; and run.py without a card exits non-zero and prints no
result."""

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = ("jax", "jaxlib", "flax", "gtos_tpu")

RUN = """
import json, sys, torch
sys.path.insert(0, {root!r}); sys.path.insert(0, {tests!r})
from conftest import TINY
from perfbench.harness import cell as cells
if __name__ == "__main__":
    torch.set_num_threads(2)
    for name in ("c4_train", "c4_serve"):
        cells.run_cell(name, 3, 0.5, True, torch.device("cpu"), TINY)
    cells.stop_children()
    print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE = """
import json, sys
sys.path.insert(0, {root!r})
import perfbench.reference.model, perfbench.reference.batch_check
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def loaded(src):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-c", src.format(root=str(ROOT),
                                          tests=str(ROOT / "perfbench" /
                                                    "tests"))],
        capture_output=True, text=True, timeout=600, env=env,
        cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_and_no_jax_package():
    tops = loaded(RUN)
    assert "gtos_tpu_torch" in tops       # the program did run
    assert not tops & set(FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    tops = loaded(REFERENCE)
    assert not tops & {"gtos_tpu_torch", *FORBIDDEN}


def test_the_forbidden_names_are_compared_whole(monkeypatch):
    from perfbench.harness import cell as cells

    assert cells.FORBIDDEN == FORBIDDEN
    monkeypatch.setitem(sys.modules, "gtos_tpu_torch", sys.modules.get(
        "gtos_tpu_torch", sys.modules[__name__]))
    assert "gtos_tpu_torch" not in cells.forbidden_modules()


def test_run_without_a_card_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "c4_serve",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, env=env,
        cwd=str(ROOT))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
