"""Every cell end to end on the CPU at tiny sizes: set-up, window, check;
the line a run prints has the contract's keys, its device metrics null
(a CPU run gives no card number), and the check passes."""

import json

import pytest
import torch

from conftest import TINY
from perfbench.harness import cell as cells

CELLS = [w["name"] for w in cells.benchmark()["workloads"]]


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run(name, trace, **kw):
    out = cells.run_cell(name, 2 ** 31 + 7, 1.0, trace, torch.device("cpu"),
                         TINY, **kw)
    cells.stop_children()
    return out, cells.result(name, out, trace, torch.device("cpu"), 1,
                             cells.benchmark())


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_on_the_cpu(name, trace):
    out, line = run(name, trace)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    want = {m["name"] for m in cells.metrics_of(
        cells.benchmark(), name, "per_layer" if trace else "end_to_end")}
    assert set(line["metrics"]) <= want
    if not trace:
        assert set(line["metrics"]) == want
    assert all(m["value"] is None for m in line["metrics"].values())
    assert line["device"]["platform"] == "cpu"
    if trace:
        assert line["device"]["busy_s"] is None
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    json.dumps(line)
    for k, v in line["checks"].items():
        assert v["value"] <= v["limit"], k


# the faults each kind of cell can have
PLANTED = {"train": ["unchanged_state", "half_batch", "stale_inputs"],
           "serve": ["altered_token"]}


@pytest.mark.parametrize("name, plant", [
    (w["name"], p) for w in cells.benchmark()["workloads"]
    for p in PLANTED[cells.workload(w["name"])["driver"]]])
def test_a_planted_fault_fails_the_check(name, plant):
    from perfbench.harness.plants import PLANTS

    _, line = run(name, False, plant=PLANTS[plant])
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_the_check(name):
    """The float8 reference in the program's place (the nearest precision
    below the configurations' bfloat16) fails the cell's limits. Serving
    at a size whose searches run long enough for float8 rounding to add
    up: the limits are set for 100-step hypotheses at the published
    widths."""
    sizes = TINY
    if cells.workload(name)["driver"] == "serve":
        sizes = dict(model=dict(TINY["model"], d_model=256, heads=8,
                                d_ff=512, enc_layers=2, dec_layers=2),
                     params=dict(TINY["params"], max_time_step=100))
    out = cells.run_cell(name, 2 ** 31 + 9, 0.5, False, torch.device("cpu"),
                         sizes, control=True)
    cells.stop_children()
    line = cells.result(name, out, False, torch.device("cpu"), 1,
                        cells.benchmark())
    assert not line["correct"], line["checks"]
