"""A later change adds a cell as files alone: a copy of the benchmark in
a temporary checkout gets a new workload file and its BENCHMARK.json
entry, and the cell runs, with no file of the harness edited."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

DRIVE = """
import json, sys, torch
sys.path.insert(0, {root!r}); sys.path.insert(0, {tests!r})
from conftest import TINY
from perfbench.harness import cell as cells
if __name__ == "__main__":
    torch.set_num_threads(2)
    out = cells.run_cell("c4_serve_beam4", 5, 0.5, False, torch.device("cpu"),
                         TINY)
    cells.stop_children()
    line = cells.result("c4_serve_beam4", out, False, torch.device("cpu"), 1,
                        cells.benchmark())
    print(json.dumps(line))
"""


def test_a_cell_added_as_files_runs(tmp_path):
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(ROOT / "gtos_tpu_torch", tmp_path / "gtos_tpu_torch")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = json.loads((ROOT / "perfbench" / "workloads" /
                       "c4_serve.json").read_text())
    cell["params"]["beam"] = 4
    (tmp_path / "perfbench" / "workloads" / "c4_serve_beam4.json"
     ).write_text(json.dumps(cell))
    bench["workloads"].append(dict(
        name="c4_serve_beam4", config="c4_nmt_ende", traffic="serve_beam4",
        chips=1, why="the serving mix at beam 4"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "c4_serve" in m.get("workloads", []):
            m["workloads"].append("c4_serve_beam4")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-c", DRIVE.format(
            root=str(tmp_path), tests=str(tmp_path / "perfbench" / "tests"))],
        capture_output=True, text=True, timeout=600, cwd=str(tmp_path),
        env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["attempted"] > 0
    assert set(line["metrics"]) == {"decode_graphs_per_s", "setup_s"}
