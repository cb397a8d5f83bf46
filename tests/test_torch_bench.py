"""The port's measurement layer and its bench on the CPU: the dense
reference against the JAX package's, attention_inputs to the JAX contract,
the timers and their refusal of impossible readings, the kernels' bounds
against hand counts, annotate's spans, and every bench cell at toy widths
(null timings: a CPU run measures no card)."""

import json
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtos_tpu.ops.attention import (
    dense_relation_scores_reference as jax_dense_scores)
from gtos_tpu_torch import bench
from gtos_tpu_torch.ops.attention import (
    bank_relation_scores, dense_relation_scores_reference)
from gtos_tpu_torch.utils import benchlib
from gtos_tpu_torch.utils.profiling import annotate

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOY = dict(d_model=32, d_ff=64, heads=2, enc_layers=2, dec_layers=1)
TOY_ARGS = [f"--{k}={v}" for k, v in TOY.items()]
HBM = 3.35e12


# ---------------------------------------------------------------- reference


@pytest.mark.parametrize("B,H,N,D,P", [(2, 2, 5, 8, 7), (3, 4, 9, 16, 40)])
def test_dense_reference_matches_jax_and_the_bank_scores(B, H, N, D, P):
    """The dense per-pair gather equals the JAX package's on the same f32
    arrays, and the port's 4-term bank decomposition, at 1e-5."""
    rng = np.random.default_rng(B * 100 + N)
    q, k = (rng.standard_normal((B, H, N, D), np.float32) for _ in range(2))
    a, b = (rng.standard_normal((P, H, D), np.float32) for _ in range(2))
    idx = rng.integers(0, P, (B, N, N)).astype(np.int32)
    got = dense_relation_scores_reference(*map(torch.from_numpy,
                                               (q, k, a, b, idx)))
    ref = np.asarray(jax_dense_scores(*map(jnp.asarray, (q, k, a, b, idx))))
    assert got.shape == (B, H, N, N) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)
    bank = bank_relation_scores(*map(torch.from_numpy, (q, k, a, b, idx)))
    torch.testing.assert_close(got, bank, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_inputs_follow_the_jax_contract(dtype):
    """The JAX function's seven arrays: shapes, types, index range, an
    all-true mask; the same values again under one seed."""
    B, H, N, Dh, P = 2, 3, 5, 8, 11
    out = benchlib.attention_inputs(torch.Generator().manual_seed(3), B, H,
                                    N, Dh, P, dtype, "cpu")
    q, k, v, a, b, idx, mask = out
    for x in (q, k, v):
        assert x.shape == (B, H, N, Dh) and x.dtype == dtype
    for x in (a, b):
        assert x.shape == (P, H, Dh) and x.dtype == dtype
    assert idx.shape == (B, N, N) and idx.dtype == torch.int32
    assert int(idx.min()) >= 0 and int(idx.max()) < P
    assert mask.shape == (B, N) and mask.dtype == torch.bool and mask.all()
    again = benchlib.attention_inputs(torch.Generator().manual_seed(3), B,
                                      H, N, Dh, P, dtype, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(out, again))
    assert not torch.equal(q, k)


# ---------------------------------------------------------------- timers


def test_timers_give_a_positive_median_and_ordered_quantiles():
    got = benchlib.time_samples(lambda x: x @ x, torch.ones(64, 64),
                                iters=9, warmup=1, device="cpu")
    assert got["n"] == 9 and len(got["samples"]) == 9
    assert 0 < got["min"] <= got["q1"] <= got["median"] <= got["q3"] \
        <= got["max"]
    assert benchlib.time_fn(lambda: None, iters=5, device="cpu") > 0


@pytest.mark.parametrize("reading", ["zero", "negative", "nan", "inf",
                                     "below_bound"])
def test_impossible_readings_raise(reading, monkeypatch):
    """A stubbed clock that reads no time, time backwards or NaN, and a
    real reading below 0.95 x its bound, each raise."""
    bound_s = None
    if reading == "below_bound":
        bound_s = 10.0      # no call of a no-op takes 9.5 s
    else:
        start, stop = {"zero": (0.0, 0.0), "negative": (1.0, 0.0),
                       "nan": (0.0, float("nan")),
                       "inf": (0.0, float("inf"))}[reading]
        ticks = iter([start, stop] * 50)
        monkeypatch.setattr(benchlib.time, "perf_counter",
                            lambda: float(next(ticks)))
    with pytest.raises(benchlib.ImpossibleReading):
        benchlib.time_samples(lambda: None, iters=3, warmup=0, device="cpu",
                              bound_s=bound_s)


def test_check_reading_accepts_a_reading_at_its_bound():
    benchlib.check_reading(1e-3, bound_s=1e-3)
    benchlib.check_reading(0.96e-3, bound_s=1e-3)
    with pytest.raises(benchlib.ImpossibleReading):
        benchlib.check_reading(0.94e-3, bound_s=1e-3)


def test_deterministic_algorithms_hold_inside_and_restore_after():
    """chip_smoke's comparisons of runs take it: deterministic inside
    the block (warning on ops without such a version), the earlier
    settings after it, also when the block raises."""
    def settings():
        return (torch.backends.cudnn.deterministic,
                torch.backends.cudnn.benchmark,
                torch.are_deterministic_algorithms_enabled(),
                torch.is_deterministic_algorithms_warn_only_enabled())

    before = settings()
    with pytest.raises(KeyError):
        with benchlib.deterministic_algorithms():
            assert settings() == (True, False, True, True)
            raise KeyError
    assert settings() == before


# ---------------------------------------------------------------- bounds

# a 2-graph toy batch, N=3, H=2, Dh=4, bf16 (2 bytes an element), P=4:
# graph 0 references bank rows/slots {0, 1, 2}, graph 1 {0, 3}
IDX = np.array([[[0, 1, 1], [2, 0, 1], [0, 0, 0]],
                [[0, 0, 0], [0, 3, 0], [0, 0, 0]]], np.int32)
B, N, H, DH, P = 2, 3, 2, 4, 4
QKV = B * H * N * DH * 2             # one of q, k, v, out in bf16: 96 bytes
PAIRS = B * N * N                    # 18 pairs


def _toy_tiles():
    """The toy's tile layout (one 128x128 tile, one slot per graph): graph
    0 keeps (0, 1) on row 0, (1, 0) and (2, 2) on row 1; graph 1 (0, 0)
    on row 2: E = 4 kept pairs, R = 3 bank rows."""
    ts = torch.zeros(B, 1, 1, dtype=torch.int32)
    tr = torch.full((B, 1, 1, 128, 128), -1, dtype=torch.int32)
    for b, i, j, r in ((0, 0, 1, 0), (0, 1, 0, 1), (0, 2, 2, 1),
                       (1, 0, 0, 2)):
        tr[b, 0, 0, i, j] = r
    q = torch.zeros(B, H, N, DH, dtype=torch.bfloat16)
    a = torch.zeros(P, H, DH, dtype=torch.bfloat16)
    return (q, q, q, a, a, ts, tr), (ts, tr)


PLANES = (B + B * 128 * 128) * 4     # tile_src and tile_rel, int32
# hand counts (bytes, operations) of each kernel on the toy
HAND = {
    # q, k, v, out; idx; mask; 5 referenced rows x (a, b) x H x Dh
    "B1": (4 * QKV + PAIRS * 4 + B * N + 5 * 2 * H * DH * 2,
           B * H * N * N * 4 * DH),
    # and the f32 probabilities
    "B1p": (4 * QKV + PAIRS * 4 + B * N + 5 * 2 * H * DH * 2
            + B * H * N * N * 4, B * H * N * N * 4 * DH),
    # q, k, v; f32 g; f32 probs; idx and the pair order; slot starts
    # (P_loc + 1 a graph); referenced bank rows; gq, gk, gv; dense g_a, g_b
    "B2": (3 * QKV + B * H * N * DH * 4 + B * H * N * N * 4 + 2 * PAIRS * 4
           + B * (P + 1) * 4 + 5 * 2 * H * DH * 2 + 3 * QKV
           + 2 * B * P * H * DH * 2, B * H * N * N * 12 * DH),
    # q, k, v, out; idx, mask; 10 (graph, i, r) of t2 + 10 (graph, j, r)
    # of t3, per head
    "B3": (4 * QKV + PAIRS * 4 + B * N + 20 * H * 2,
           B * H * N * N * 4 * DH),
    # 4 distinct bank rows: a, b and t4 (f32) per head
    "B3'": (4 * QKV + PAIRS * 4 + B * N + 4 * H * (2 * DH * 2 + 4),
            B * H * N * N * 8 * DH),
    # q, k, v, g; idx, mask; row and column orders; the table entries;
    # f32 gq, gk, gv; dense g_t2, g_t3 [B, N, H, P]
    "B4": (4 * QKV + PAIRS * 4 + B * N + 2 * PAIRS * 4 + 20 * H * 2
           + 3 * B * H * N * DH * 4 + 2 * B * N * H * P * 2,
           B * H * N * N * 10 * DH),
    # the sector floor: t2 and t3 (96 bytes each) touch sectors 0-2 each
    "B4 sectors": (4 * QKV + PAIRS * 4 + B * N + 2 * PAIRS * 4 + 6 * 32
                   + 3 * B * H * N * DH * 4 + 2 * B * N * H * P * 2,
                   B * H * N * N * 10 * DH),
    # q, k, v, out; the planes; 3 rows x H x (a, b, f32 t4); E=4 pairs x H
    # x Dh x (q.k, q.b, k.a, p.v)
    "B5": (4 * QKV + PLANES + 3 * H * (2 * DH * 2 + 4), 2 * 4 * 4 * H * DH),
    "B5s": (4 * QKV + 2 * B * H * N * 4 + PLANES + 3 * H * (2 * DH * 2 + 4),
            2 * 4 * 4 * H * DH),
    # q, k, v, gp, dq; m, l, delta; the planes and row bases; banks;
    # ge and pair_s (H x E x 12); dst2src
    "B6d": (5 * QKV + 3 * B * H * N * 4 + PLANES + B * 128 * 4
            + 3 * H * (2 * DH * 2 + 4) + H * 4 * 12 + 4 * 4,
            2 * 5 * 4 * H * DH),
    # q, gp, dk, dv; a's 3 rows; pair_s (H x E x 8); src planes, bases
    "B6s": (4 * QKV + 3 * H * DH * 2 + H * 4 * 8 + PLANES + B * 128 * 4,
            2 * 3 * 4 * H * DH),
    # ge; the sorted pair arrays; q, k; a, b rows read; dense g_a, g_b
    "B6b": (H * 4 * 4 + 3 * 4 * 4 + 2 * QKV + 3 * H * 2 * DH * 2
            + 2 * P * H * DH * 2, 2 * 2 * 4 * H * DH),
}


def _bound_of(kind):
    if kind in ("B1", "B1p"):
        return benchlib.local_attention_bound(IDX, H, DH, "bfloat16",
                                              with_probs=kind == "B1p")
    if kind == "B2":
        return benchlib.local_attention_bwd_bound(IDX, H, DH, P, "bfloat16")
    if kind in ("B3", "B3'", "B4", "B4 sectors"):
        which = {"B3": "tables", "B3'": "inline"}.get(kind, "bwd")
        return benchlib.global_attention_bound(
            IDX, H, DH, P, "bfloat16", which, sectors=kind == "B4 sectors")
    args, src = _toy_tiles()
    return benchlib.block_bound(kind, args, src)


@pytest.mark.parametrize("kind", sorted(HAND))
def test_bounds_equal_a_hand_count(kind):
    nbytes, ops = HAND[kind]
    got_ms, by = _bound_of(kind)
    t_bytes, t_ops = nbytes / HBM * 1e3, ops / 989e12 * 1e3
    assert by == ("bytes" if t_bytes >= t_ops else "operations")
    assert got_ms == pytest.approx(max(t_bytes, t_ops), rel=1e-12)


def test_check_kernel_refuses_a_wrong_output():
    """The bench's gate passes the plain version's own output and refuses
    one with a gradient zeroed (far below KERNEL_TOL's atol, caught by its
    rtol of the largest value) and one with NaN."""
    gen = torch.Generator().manual_seed(0)
    ref = tuple((torch.randn(*s, generator=gen) * 1e-4).to(torch.bfloat16)
                for s in ((2, 3), (4,)))
    assert bench.check_kernel("B6b", "toy", ref, ref)[0] == 0.0
    zero, nan = torch.zeros_like(ref[1]), torch.full_like(ref[1], np.nan)
    with pytest.raises(bench.BenchFailure, match="largest value"):
        bench.check_kernel("B6b", "toy", (ref[0], zero), ref)
    with pytest.raises(bench.BenchFailure, match="non-finite"):
        bench.check_kernel("B6b", "toy", (ref[0], nan), ref)


def test_check_kernel_holds_b6b_bank_rows_one_by_one():
    """B6b's bank rows are held one by one (benchlib.bank_row_reading):
    an output one unit in the last place off the plain one in many
    elements passes; a small row (1e-3 of the largest) zeroed, or written
    where the plain row is 0, is refused, though the whole output's
    rtol of its largest value passes both."""
    gen = torch.Generator().manual_seed(0)
    P, H, Dh = 16, 2, 8
    scale = torch.ones(P, 1, 1)
    scale[5] = 1e-3
    ref = tuple((torch.randn(P, H, Dh, generator=gen) * scale).to(
        torch.bfloat16) for _ in range(2))
    ref[0][9] = 0.0
    up = ref[0].view(torch.int16) + ((torch.rand(P, H, Dh, generator=gen)
                                      < 0.3) & (ref[0] != 0)).to(torch.int16)
    flipped = (up.view(torch.bfloat16), ref[1])
    assert bench.check_kernel("B6b", "toy", flipped, ref)[2] == 0.0
    small = ref[0].clone()
    small[5] = 0.0
    written = ref[0].clone()
    written[9] = 1e-3
    for got in (small, written):
        assert benchlib.disagreement(("g_a",), (got,), ref[:1],
                                     "bfloat16") is None
        with pytest.raises(bench.BenchFailure, match="bank row"):
            bench.check_kernel("B6b", "toy", (got, ref[1]), ref)


# ---------------------------------------------------------------- spans


def test_annotate_span_appears_in_the_profiler_events():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with annotate("bench/test_span"):
            torch.ones(8).sum()
    spans = [e for e in prof.events() if e.name == "bench/test_span"]
    assert len(spans) == 1
    assert any(c.name == "aten::sum" for c in spans[0].cpu_children)


# ---------------------------------------------------------------- the bench

NO_JAX_BENCH = textwrap.dedent("""
    import json, sys
    import torch
    torch.set_num_threads(2)
    from gtos_tpu_torch import bench
    from gtos_tpu_torch.utils import benchlib
    b = bench.Bench(torch.device("cpu"), dict(d_model=32, heads=2), 0, 1)
    out = b.north_star_local()
    print(json.dumps({"edges": out["info"]["edges_per_pass"],
                      "imported": sorted(
                          m for m in sys.modules
                          if m.split(".")[0] in ("jax", "flax", "gtos_tpu")
                          or m.startswith("jaxlib"))}))
""")


def test_bench_and_benchlib_import_no_jax():
    """In a fresh interpreter the bench (its north-star cell on the CPU)
    leaves jax, flax and gtos_tpu out of sys.modules."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT, os.environ.get("PYTHONPATH", "")]))
    res = subprocess.run([sys.executable, "-c", NO_JAX_BENCH], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    report = json.loads(res.stdout.strip().splitlines()[-1])
    assert report["edges"] == 32 * 32 * 32
    assert report["imported"] == []


def _all_metrics(node):
    if isinstance(node, dict):
        if "unit" in node and "median" in node:
            yield node
            return
        for v in node.values():
            yield from _all_metrics(v)
    elif isinstance(node, list):
        for v in node:
            yield from _all_metrics(v)


def test_bench_cli_on_the_cpu_prints_null_timings(tmp_path):
    """`python -m gtos_tpu_torch.bench --device cpu` at toy widths: its
    last line is one JSON object, every timing in it null, its JSON file
    written under --out."""
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=os.pathsep.join(
        [ROOT, os.environ.get("PYTHONPATH", "")]))
    out = tmp_path / "bench"
    res = subprocess.run(
        [sys.executable, "-m", "gtos_tpu_torch.bench", "--device", "cpu",
         *TOY_ARGS, "--cells", "north_star_local", "--repeats", "2",
         "--out", str(out)], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    result = json.loads(res.stdout.strip().splitlines()[-1])
    assert result["device"] == {"platform": "cpu", "kind": "cpu",
                                "count": 0}
    assert result["card"] is None and result["repeats"] == 2
    cell = result["cells"]["north_star_local"]
    metrics = list(_all_metrics(cell))
    assert len(metrics) == 8
    assert all(m["n"] == 0 and m["median"] is None and m["min"] is None
               for m in metrics)
    assert cell["metrics"]["serve_vs_baseline"]["value"] is None
    assert cell["info"]["unpadded_edges_per_pass"] < 32 ** 3
    assert json.loads((out / "bench.json").read_text()) == result


def test_bench_raises_without_a_card(monkeypatch, tmp_path):
    """Without a visible card the bench raises, as the other entry points
    do: it never measures the CPU in the card's place."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.main(["--cells", "north_star_local", "--out",
                    str(tmp_path)])


@pytest.fixture
def small(monkeypatch):
    """The bench's inputs cut to toy sizes (corpora, batches, buckets,
    decode steps) and a Bench at toy widths on the CPU."""
    for name, value in (("C2_GRAPHS", 160), ("C4_GRAPHS", 60),
                        ("C5_GRAPHS", 6), ("SERVE_REQUESTS", 40),
                        ("SERVE_BUCKETS", 2), ("MAX_STEPS", 3),
                        ("TRAIN_BATCHES", {"c2": 2, "c4": 2, "c5": 1}),
                        ("HOST_WORKERS", 2)):
        monkeypatch.setattr(bench, name, value)
    bench.corpus.cache_clear()
    yield bench.Bench(torch.device("cpu"), TOY, 0, 2)
    bench.corpus.cache_clear()


@pytest.mark.parametrize("cell", ["c2_train_pallas_local", "c2_train_pallas",
                                  "c4_train", "c5_train"])
def test_train_cell_on_the_cpu(cell, small):
    """A train cell runs its fixed batches from memory and through the
    loader, records every layer's span in the traced run and the kernel
    inputs of layer 0, with null timings."""
    out = getattr(small, cell)()
    assert all(m["n"] == 0 for m in out["metrics"].values())
    spans = out["traced"]["spans"]
    for name in ("bench/train_step", "bench/forward", "bench/encode",
                 "bench/optimizer", "bench/host/batchify",
                 "bench/host/pack_copy"):
        assert spans[name]["calls"] >= 1, name
    kernels = {"c2_train_pallas": "B3'", "c5_train": "B6b"}.get(cell, "B2")
    assert spans[f"bench/kernel/{kernels}"]["calls"] >= 1
    assert kernels in small.captured[cell]["calls"]
    assert out["traced"]["idle_share"] is None
    assert spans["bench/train_step"]["host_self_ms"] is None


@pytest.mark.parametrize("cell", ["c2_serve", "c4_serve", "c5_serve"])
def test_serve_cell_on_the_cpu(cell, small):
    """A serve cell decodes its buckets, the same tokens every repeat, with
    the encode and decode-step spans and layer 0's kernel inputs."""
    out = getattr(small, cell)()
    assert all(m["n"] == 0 for m in out["metrics"].values())
    steps = out["info"]["decode_steps"]
    assert len(steps) == len(out["info"]["batches"]) and min(steps) >= 1
    spans = out["traced"]["spans"]
    assert spans["bench/serve_batch"]["calls"] == 1
    assert spans["bench/decode_step"]["calls"] == steps[0]
    kernel = "B5" if cell == "c5_serve" else "B1"
    assert spans[f"bench/kernel/{kernel}"]["calls"] >= 1
    assert kernel in small.captured[cell]["calls"]


def test_kernels_cell_on_the_cpu(small):
    """The kernels cell captures the cells it needs and holds each kernel
    (here its plain version) against its plain version, with its bound."""
    rows = small.kernels()["rows"]
    assert [(r["kernel"], r["source"]) for r in rows] == list(
        bench.Bench.KERNEL_SOURCES)
    for r in rows:
        assert r["max_abs_err"] == 0.0 and r["bound_ms"] > 0
        assert r["ms"]["n"] == 0 and r["device_ms"]["median"] is None


def test_host_cell_on_the_cpu(small):
    out = small.host()
    assert set(out["metrics"]) == {
        f"{f}_{what}" for f in ("c2", "c4") for what in (
            "preprocess_native_ms_per_graph",
            "preprocess_python_ms_per_graph",
            "batchify_ms_per_batch_workers0",
            "batchify_ms_per_batch_workers2")}
    assert all(m["median"] is None for m in out["metrics"].values())
    assert out["info"]["c2"]["batches_per_epoch"] >= 2


# ---------------------------------------------------------------- captures


def test_replaced_stands_in_where_the_model_finds_the_wrapper():
    """A stand-in is what the ops module and graph_transformer hold inside
    the block; it carries the launch count and hands it back; the real
    wrapper is back after."""
    from gtos_tpu_torch.models import graph_transformer as gt
    from gtos_tpu_torch.ops import local_relation_attention as lra
    from gtos_tpu_torch.utils import kernel_calls

    real = lra.local_relation_attention
    before = real.launches

    def stand_in(*args):
        stand_in.launches += 1

    with kernel_calls.replaced("B1", stand_in):
        assert lra.local_relation_attention is stand_in
        assert gt.local_relation_attention is stand_in
        assert kernel_calls.wrapper("B1") is stand_in
        assert kernel_calls.wrapper("B2") is lra.local_relation_attention_bwd
        gt.local_relation_attention()
    assert lra.local_relation_attention is real
    assert gt.local_relation_attention is real
    assert real.launches == before + 1


@pytest.mark.parametrize("family,impl", [("c2", "pallas_local"),
                                         ("c2", "pallas"),
                                         ("c5", "block_sparse")])
def test_chip_smoke_captures_feed_its_gates(family, impl, small,
                                            monkeypatch):
    """chip_smoke's capture_* take layer 0's arguments from
    kernel_calls.capture and hand them on in the order its gates call the
    wrappers with (here their plain versions, on the CPU): each call
    gives outputs of the model's shapes, finite."""
    import types

    from gtos_tpu_torch.ops import block_sparse_attention as bsa
    from gtos_tpu_torch.ops import block_sparse_attention_bwd as bsab
    from gtos_tpu_torch.ops import local_relation_attention as lra
    from gtos_tpu_torch.ops import relation_attention as ra

    monkeypatch.syspath_prepend(ROOT)
    import chip_smoke as cs

    cfg, _ = bench.configs(family, impl, TOY, 0)
    model = small.model(cfg)
    batches = small.train_batches(family, impl)[1][:1]
    trainer = types.SimpleNamespace(model=model)
    B, N = batches[0].concept_mask.shape
    H, Dh = cfg.heads, cfg.d_model // cfg.heads

    def finite(*outs):      # (B6d's pair_s is the kernel's alone)
        for x in outs:
            assert x is None or torch.isfinite(x.float()).all()
        return outs

    if impl == "pallas_local":
        (args,) = cs.capture_b1_inputs(model, batches)
        (out,) = finite(lra.local_relation_attention(*args))
        assert out.shape == (B, H, N, Dh)
        ((fwd, bwd),) = cs.capture_train_inputs(trainer, batches)
        finite(*lra.local_relation_attention_with_probs(*fwd))
        grads = finite(*lra.local_relation_attention_bwd(*bwd[:10],
                                                         runs=bwd[10]))
        assert [g.shape for g in grads[:3]] == [fwd[0].shape] * 3
        assert torch.equal(fwd[6], bwd[0].new_tensor(
            batches[0].concept_mask, dtype=torch.bool))
    elif impl == "pallas":
        for train in (False, True):
            ((kern, args, b4),) = cs.capture_global_inputs(model, batches,
                                                           train)
            assert kern == cs.B3I       # the card's rule: always B3'
            (out,) = finite(ra.fused_relation_attention_inline(*args))
            assert out.shape == (B, H, N, Dh)
            assert (b4 is None) == (not train)
        grads = finite(*ra.fused_relation_attention_bwd(*b4))
        assert grads[0].shape == (B, H, N, Dh)
    else:
        served = cs.capture(model, batches[0], False, model.device)
        finite(bsa.block_sparse_attention(*served["calls"]["B5"][0]))
        ((args, src, (core, plan)),) = cs.capture_block_train_inputs(
            trainer, batches)
        out, m, l = finite(*bsa.block_sparse_attention_with_stats(*args))
        assert out.shape == (B, H, N, Dh)
        dq, ge, pair_s = finite(*bsab.block_sparse_attention_bwd_dst(
            *core, args[5], args[6], plan))
        finite(*bsab.block_sparse_attention_bwd_src(*core, *src, plan,
                                                    pair_s))
        finite(*bsab.block_sparse_bank_grads(core[0], core[1], core[3],
                                             core[4], ge, plan))
        assert dq.shape == (B, H, N, Dh)
