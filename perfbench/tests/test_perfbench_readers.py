"""Each per-layer reader on a recorded trace (fixtures/), and the
breakdown: the numbers worked out by hand from the fixture."""

import json
from pathlib import Path

import pytest

from perfbench.harness import cell as cells
from perfbench.harness.trace import breakdown, busy_s

FIX = Path(__file__).parent / "fixtures"


def record(kind):
    with open(FIX / f"record_{kind}.json") as f:
        return json.load(f)


@pytest.mark.parametrize("metric, kind, want", [
    # (0.010 + 0.006 + 0.004 + 0.006) s over 2 steps
    ("feed_ms.train", "train", 13.0),
    ("host_launches.train", "train", 30.0),
    # 4e12 over 2 s and 1e15/s
    ("mfu.train", "train", 0.2),
    # 0.1 s of bound over (0.1 + 0.15 + 0.1) s of local_* kernels
    ("relattn_roofline.train", "train", 100 * 0.1 / 0.35),
    # busy: [0.1, 0.3] + [0.5, 0.6] + [1.0, 1.5] = 0.8 of 2 s
    ("idle_share.train", "train", 60.0),
    ("batchify_ms.serve", "serve", 15.0),
    ("mfu.serve", "serve", 0.05),
    ("relattn_roofline.serve", "serve", 20.0),
    # busy [0.05, 1.8] + [2.05, 3.8] = 3.5 of 4 s
    ("idle_share.serve", "serve", 12.5),
    ("decode_latency_p95_ms", "serve", 180.0),
])
def test_reader_on_fixture(metric, kind, want):
    assert cells.reader(metric)(record(kind)) == pytest.approx(want)


@pytest.mark.parametrize("metric", [
    "feed_ms.train", "host_launches.train", "mfu.train",
    "relattn_roofline.train", "idle_share.train", "batchify_ms.serve",
    "mfu.serve", "relattn_roofline.serve", "idle_share.serve",
    "decode_latency_p95_ms"])
def test_reader_finds_nothing_returns_none(metric):
    empty = dict(window_s=1.0, spans={}, device=[], host_launches=0,
                 work={})
    assert cells.reader(metric)(empty) is None


def test_breakdown_names_gaps_by_the_main_threads_span():
    rec = record("serve")
    assert busy_s(rec) == pytest.approx(3.5)
    out = breakdown(rec)
    assert out["device_ops"][0][0].startswith("ampere_bf16")
    assert out["device_ops"][0][1] == pytest.approx(3.4)
    gaps = dict(out["idle_gaps"])
    # [0, 0.05] at 0.025 and [3.8, 4.0] at 3.9 in decode_batch; [1.8,
    # 2.05] at 1.925 between two spans
    assert gaps["serve/decode_batch"] == pytest.approx(0.25)
    assert gaps["outside any span"] == pytest.approx(0.25)


def test_every_per_layer_metric_has_a_reader():
    bench = cells.benchmark()
    for m in bench["per_layer"]:
        assert callable(cells.reader(m["name"]))
