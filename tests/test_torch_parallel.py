"""The port's mesh (DP, TP, CP) on spawned gloo ranks on the CPU against
the JAX package's single-device step, as tests/test_parallel.py holds the
JAX package's own mesh: the mesh layout and each rank's part of a batch;
the DP step (dp=2, ranks holding different numbers of target tokens) and
TP (dp=2, mp=2): loss rtol 1e-5, grad_norm 1e-4, every gradient rtol
5e-4 / atol 1e-6; the full model under "block_sparse" on a graph=2 mesh
against the single-device loss within 2e-4; beam tokens under a CP mesh
equal to the single-device tokens; the scaling report's keys. f32,
dropout off, the JAX init's parameters converted. Beam tokens under a TP
mesh (mp=2) in bf16 compute equal one process's in bf16 compute."""

import dataclasses
import json
import pickle

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import optax

from gtos_tpu.data import BucketSpec as JaxBucketSpec
from gtos_tpu.data import batchify as jax_batchify
from gtos_tpu.data.dataloader import preprocess as jax_preprocess
from gtos_tpu.data.extract import build_vocabs as jax_build_vocabs
from gtos_tpu.data.synthetic import synthetic_amr_corpus as jax_corpus
from gtos_tpu.infer.decode import beam_decode_arrays as jax_beam_decode
from gtos_tpu.models import Generator as JaxGenerator
from gtos_tpu.utils.config import ModelConfig as JaxModelConfig
from gtos_tpu_torch.convert import state_dict_from_flax
from gtos_tpu_torch.models import Generator
from gtos_tpu_torch.models.components import Dense
from gtos_tpu_torch.models.generator import batch_to_device
from gtos_tpu_torch.parallel.mesh import rank_coords
from gtos_tpu_torch.utils.config import ModelConfig
import torch_mesh_ranks as ranks

torch.set_num_threads(2)
TINY = dict(d_model=32, d_ff=64, heads=2, enc_layers=1, dec_layers=1,
            char_dim=8, char_filters=16, rel_emb_dim=8, rel_hidden=16,
            max_oov=16, max_target_len=32, dropout=0.0)
GRAD_TOL = dict(rtol=5e-4, atol=1e-6)
# test_mesh_steps_accumulate_path_and_layout's optimizer, in both packages
MESH_TRAIN = dict(warmup_steps=3, accum_steps=2, adam_eps=1e-3)
# the row arrays of the "xla" route, and the batch-global bank
_BATCH_LEADING = ("concept", "concept_char", "concept_mask", "rel_index",
                  "token_in", "token_out", "token_mask", "cp_seq",
                  "copy_mask")
_BANK = ("rel_bank", "rel_length")


def _setup(tmp_path, impl, jax_impl, n=8, seed=5, bucket=8, spec=None,
           jax_spec=None, **batch_kw):
    """The JAX model and params, the whole batch (JAX and port arrays
    equal), and the files the ranks read: config JSON, the converted
    state_dict, the batch (.npz)."""
    graphs, targets = jax_corpus(n, seed=seed, **batch_kw.pop("corpus", {}))
    jv = jax_build_vocabs(graphs, targets)
    kw = dict(batch_size_bucket=bucket, for_train=True, **batch_kw)
    ja = jax_batchify(jax_preprocess(graphs, targets), *jv,
                      **(dict(spec=jax_spec) if jax_spec else {}),
                      **kw).arrays()
    tv, cv, rv, chv, _ = jv
    cfg = dict(TINY, token_vocab=len(tv), concept_vocab=len(cv),
               relation_vocab=len(rv), char_vocab=len(chv),
               copy_impl="scatter", label_smoothing=0.1)
    cfg.update(spec or {})
    jm = JaxGenerator(JaxModelConfig(**cfg, attention_impl=jax_impl))
    init = JaxGenerator(JaxModelConfig(**cfg, attention_impl="xla")).init
    params = jax.jit(lambda key: init({"params": key}, ja,
                                      deterministic=True))(
        jax.random.PRNGKey(0))
    state = state_dict_from_flax(jax.device_get(params))
    pcfg = ModelConfig(**cfg, attention_impl=impl)
    torch.save(state, tmp_path / "state.pt")
    np.savez(tmp_path / "batch.npz", **ja)
    return jm, params, ja, pcfg, state, dict(
        cfg_json=pcfg.to_json(), state_path=str(tmp_path / "state.pt"),
        arrays_path=str(tmp_path / "batch.npz"))


def _jax_step(jm, params, ja):
    (loss, met), grads = jax.jit(jax.value_and_grad(
        lambda p: jm.apply(p, ja, deterministic=True), has_aux=True))(params)
    return (float(loss), float(met["n_tok"]), float(optax.global_norm(grads)),
            state_dict_from_flax(jax.device_get(grads)))


@pytest.mark.parametrize("dp,mp,graph", [(2, 2, 1), (1, 2, 2), (2, 1, 2)])
def test_mesh_layout(dp, mp, graph, tmp_path):
    """make_mesh lays the ranks out (data, model, graph) row-major, as the
    JAX package's np.array(devices).reshape(dp, mp, graph), with one group
    per line of each axis."""
    world = dp * mp * graph
    grid = np.arange(world).reshape(dp, mp, graph)
    for out in ranks.spawn("mesh_layout", world, tmp_path, dp=dp, mp=mp,
                           graph=graph):
        r = out["rank"]
        d, m, g = rank_coords(r, dp, mp, graph)
        assert out["coords"] == dict(data=d, model=m, graph=g)
        assert grid[d, m, g] == r
        assert out["groups"]["data"] == list(grid[:, m, g])
        assert out["groups"]["model"] == list(grid[d, :, g])
        assert out["groups"]["graph"] == list(grid[d, m, :])


@pytest.mark.parametrize("schedule", ["ring", "a2a"])
def test_shard_arrays_takes_rows_and_blocks(schedule, tmp_path):
    """shard_arrays on a dp=2 x graph=2 mesh: the batch rows by data rank,
    the edge cells' dst block (src block under "a2a") and the per-cell
    tiles' dst block by graph rank, the relation bank whole."""
    graphs, targets = jax_corpus(4, seed=4, min_nodes=30, max_nodes=120)
    ja = jax_batchify(jax_preprocess(graphs, targets),
                      *jax_build_vocabs(graphs, targets),
                      spec=JaxBucketSpec(nodes=(256,)), batch_size_bucket=4,
                      build_edges=True, build_block_tiles=True,
                      sparse_khop=2, cp_shards=2).arrays()
    np.savez(tmp_path / "b.npz", **ja)
    outs = ranks.spawn("shard_layout", 4, tmp_path,
                       path=str(tmp_path / "b.npz"), dp=2, graph=2,
                       cp_schedule=schedule)
    for r, got in enumerate(outs):
        d, _, g = rank_coords(r, 2, 1, 2)
        rows = slice(2 * d, 2 * d + 2)
        np.testing.assert_array_equal(got["concept"], ja["concept"][rows])
        np.testing.assert_array_equal(got["rel_bank"], ja["rel_bank"])
        np.testing.assert_array_equal(got["ctile_rel"],
                                      ja["ctile_rel"][rows, g:g + 1])
        cell = (ja["edge_src"][rows, :, g:g + 1] if schedule == "a2a"
                else ja["edge_src"][rows, g:g + 1])
        np.testing.assert_array_equal(got["edge_src"], cell)


@pytest.mark.parametrize("impl,jax_impl", [
    ("xla", "xla"), ("pallas_local", "pallas_local_interpret")])
def test_dp_step_matches_jax_single_device(impl, jax_impl, tmp_path):
    """dp=2: each rank's rows, the loss divided by the global token count
    and the gradients summed over the data group give the JAX package's
    single-device loss, gradient norm and every gradient, with ranks
    holding different numbers of target tokens (where the mean of the
    per-rank means is another value). Under "pallas_local" each rank
    rebuilds the localize sort order of its own rows."""
    flags = dict(build_local_banks=True) if impl == "pallas_local" else {}
    jm, params, ja, _, _, files = _setup(tmp_path, impl, jax_impl, **flags)
    loss, n_tok, norm, ref = _jax_step(jm, params, ja)
    outs = ranks.spawn("train_step", 2, tmp_path, dp=2, mp=1, graph=1,
                       **files)
    assert outs[0]["rows_tok"] != outs[1]["rows_tok"]
    xla = JaxGenerator(dataclasses.replace(jm.cfg, attention_impl="xla"))
    half_loss = jax.jit(lambda a: xla.apply(params, a, deterministic=True))
    halves = [float(half_loss({
        k: v[h * 4:(h + 1) * 4] if k in _BATCH_LEADING else v
        for k, v in ja.items() if k in _BATCH_LEADING + _BANK})[0])
        for h in range(2)]
    assert abs(np.mean(halves) - loss) > 1e-3 * abs(loss)
    for out in outs:
        np.testing.assert_allclose(out["loss"], loss, rtol=1e-5)
        assert out["n_tok"] == n_tok
        np.testing.assert_allclose(out["grad_norm"], norm, rtol=1e-4)
        assert set(out["grads"]) == set(ref)
        for name, g in out["grads"].items():
            np.testing.assert_allclose(g, ref[name].numpy(), **GRAD_TOL,
                                       err_msg=name)


def test_tp_step_matches_jax_single_device(tmp_path):
    """dp=2 x mp=2: the Megatron splits (q/k/v and fc1 by columns, the
    attention out_proj and fc2 by rows, the relation heads from both
    halves of rel_proj) give the JAX package's single-device loss,
    gradient norm and every gradient (the shards gathered); the split
    parameters hold half the columns or rows, the relation encoder's
    out_proj stays whole."""
    jm, params, ja, _, _, files = _setup(tmp_path, "xla", "xla", seed=3)
    loss, n_tok, norm, ref = _jax_step(jm, params, ja)
    outs = ranks.spawn("train_step", 4, tmp_path, dp=2, mp=2, graph=1,
                       **files)
    shapes = outs[0]["shapes"]
    assert shapes["graph_transformer.layer0.self_attn.q_proj.weight"] == \
        (16, 32)
    assert shapes["graph_transformer.layer0.self_attn.out_proj.weight"] \
        == (32, 16)
    assert shapes["decoder.layer0.ffn.fc2.weight"] == (32, 32)
    assert shapes["relation_encoder.out_proj.weight"] == (32, 32)
    for out in outs:
        np.testing.assert_allclose(out["loss"], loss, rtol=1e-5)
        assert out["n_tok"] == n_tok
        np.testing.assert_allclose(out["grad_norm"], norm, rtol=1e-4)
        for name, g in out["grads"].items():
            np.testing.assert_allclose(g, ref[name].numpy(), **GRAD_TOL,
                                       err_msg=name)


def test_tp_trainer_steps_and_checkpoint(tmp_path):
    """The Trainer under dp=2 x mp=2: two optimizer steps give the
    single-device Trainer's losses (1e-5), and its state_dict holds the
    whole parameters and Adam moments (the shards gathered)."""
    from gtos_tpu_torch.train.trainer import Trainer
    from gtos_tpu_torch.utils.config import TrainConfig

    _, _, ja, pcfg, state, files = _setup(tmp_path, "xla", "xla", seed=3)
    pm = Generator(pcfg, device="cpu")
    pm.load_state_dict(state)
    trainer = Trainer(pm, pcfg, TrainConfig(warmup_steps=3), ja,
                      device="cpu")
    losses = [trainer.train_step(batch_to_device(ja, "cpu"))["loss"].item()
              for _ in range(2)]
    for out in ranks.spawn("trainer_steps", 4, tmp_path, dp=2, mp=2,
                           graph=1, steps=2, **files):
        np.testing.assert_allclose(out["losses"], losses, rtol=1e-5)
        for (name, p), mu in zip(pm.named_parameters(), out["mu"]):
            assert out["params"][name].shape == tuple(p.shape), name
            assert mu.shape == tuple(p.shape), name


@pytest.fixture(scope="module")
def mesh_steps_run(tmp_path_factory):
    """One spawn of two gloo ranks (torch_mesh_ranks.mesh_steps) that
    test_mesh_steps_accumulate_path_and_layout and
    test_tp_search_bf16_matches_one_process read, with the JAX package's
    two accumulation steps on the whole batch and the files the ranks
    read."""
    from gtos_tpu.train import TrainState as JaxTrainState
    from gtos_tpu.train import make_optimizer
    from gtos_tpu.train.trainer import make_train_step as jax_make_train_step
    from gtos_tpu.utils.config import TrainConfig as JaxTrainConfig
    from gtos_tpu_torch.data import batchify
    from gtos_tpu_torch.data.dataloader import preprocess
    from gtos_tpu_torch.data.extract import build_vocabs
    from gtos_tpu_torch.data.synthetic import synthetic_amr_corpus

    tmp_path = tmp_path_factory.mktemp("mesh_steps")
    jm, params, ja, pcfg, _, files = _setup(tmp_path, "xla", "xla", seed=3)
    tx = make_optimizer(JaxTrainConfig(**MESH_TRAIN), TINY["d_model"])
    jstate = JaxTrainState(params=params, opt_state=tx.init(params),
                           step=np.zeros((), np.int32),
                           rng=jax.random.PRNGKey(1))
    jstep = jax_make_train_step(jm, tx)
    for _ in range(2):
        jstate, _ = jstep(jstate, ja)
    g, t = synthetic_amr_corpus(8, seed=3)
    tv, cv, rv, chv, lm = build_vocabs(g, t)
    bs = batchify(preprocess(g, t), tv, cv, rv, chv, lm, for_train=True,
                  batch_size_bucket=8, build_block_tiles=True,
                  sparse_khop=2).arrays()
    np.savez(tmp_path / "bs.npz", **bs)
    bs_cfg = ModelConfig(**TINY, token_vocab=len(tv), concept_vocab=len(cv),
                         relation_vocab=len(rv), char_vocab=len(chv),
                         attention_impl="block_sparse", sparse_khop=2)
    search_cfg = dataclasses.replace(pcfg, compute_dtype="bfloat16")
    outs = ranks.spawn("mesh_steps", 2, tmp_path, **files,
                       train_kw=MESH_TRAIN,
                       bs_cfg_json=bs_cfg.to_json(),
                       bs_arrays_path=str(tmp_path / "bs.npz"),
                       search_cfg_json=search_cfg.to_json())
    return dict(outs=outs, jstate=jstate, files=files,
                search_cfg=search_cfg)


def test_mesh_steps_accumulate_path_and_layout(mesh_steps_run):
    """The spawn of mesh_steps_run (two gloo ranks,
    torch_mesh_ranks.mesh_steps):

      * the Trainer at dp=2 with accum_steps=2 (each rank half the rows),
        two steps on the whole batch, so that both accumulation phases
        run, against the JAX package's make_train_step on the whole
        batch: Adam's moments and every parameter at GRAD_TOL, its count
        and the mini-step exactly. Adam's eps is 1e-3 in both: at its
        first update Adam moves each element by lr * g / (|g| + eps),
        which at the default 1e-9 is the learning rate times the sign of
        g, so that a gradient of rounding noise (the key biases', zero in
        exact arithmetic) or one near eps moves its parameter by up to
        the learning rate either way in the two packages;
      * step_path: "uncaptured: the CPU" at dp=2, where compiled=True
        raises the CPU's error; a context-parallel mesh (graph=2) names
        trainer.EAGER_MESH and refuses compiled=True with it;
      * search_graphs(compiled=True) refuses only the context-parallel
        mesh's search: under mp=2 the error is the CPU's;
      * block_sparse at dp=2: a step's "layout_ok" is true on the batch's
        own tile layouts, and a src-major layout holding none of the
        dst-major layout's pairs raises LAYOUT_MISMATCH (at once on the
        CPU; on the card when check_metrics reads the metrics,
        tests/test_torch_cuda.py)."""
    from gtos_tpu_torch.convert import _find
    from gtos_tpu_torch.infer.decode import EAGER_MESH as SEARCH_CP
    from gtos_tpu_torch.ops.block_sparse_attention_bwd import LAYOUT_MISMATCH
    from gtos_tpu_torch.train.trainer import EAGER_MESH

    outs, jstate = mesh_steps_run["outs"], mesh_steps_run["jstate"]
    ref = state_dict_from_flax(jax.device_get(jstate.params))
    adam = _find(jax.device_get(jstate.opt_state), ("count", "mu", "nu"))
    multi = _find(jax.device_get(jstate.opt_state),
                  ("mini_step", "acc_grads"))
    mu, nu = (state_dict_from_flax(m) for m in (adam.mu, adam.nu))
    for out in outs:
        got = out["accum"]
        assert got["count"] == int(adam.count) == 1
        assert got["mini_step"] == int(multi.mini_step) == 0
        assert sorted(got["names"]) == sorted(ref)
        for i, name in enumerate(got["names"]):
            for mine, theirs in ((got["mu"][i], mu[name]),
                                 (got["nu"][i], nu[name])):
                np.testing.assert_allclose(mine, theirs.numpy(), **GRAD_TOL,
                                           err_msg=name)
            np.testing.assert_allclose(got["params"][name],
                                       ref[name].numpy(), **GRAD_TOL,
                                       err_msg=name)
        assert out["path"]["dp"] == "uncaptured: the CPU"
        assert "need the card" in out["path"]["dp_compiled"]
        assert out["path"]["cp"] == "uncaptured: " + EAGER_MESH
        assert out["path"]["cp_compiled"] == EAGER_MESH
        assert "need the card" in out["search"]["tp"]
        assert out["search"]["tp_enabled"] is False
        assert out["search"]["cp"] == SEARCH_CP
        assert out["layout"]["ok"] == 1.0
        assert out["layout"]["error"] == LAYOUT_MISMATCH


class _TwoShardRow(Dense):
    """A row layer of one process that computes what the layer split at
    mp=2 computes: each half of the input columns times its half of the
    weight, each product rounded to the compute type, their sum (the
    group's all-reduce of two ranks), then the bias."""

    def forward(self, x):
        w = self.weight.to(x.dtype)
        n = w.shape[1] // 2
        y0, y1 = (F.linear(x[..., i * n:(i + 1) * n].contiguous(),
                           w[:, i * n:(i + 1) * n].contiguous())
                  for i in (0, 1))
        return (y0 + y1) + self.bias.to(x.dtype)


def test_tp_search_bf16_matches_one_process(mesh_steps_run):
    """Beam search (beam 2, 8 steps, "xla") under a tensor-parallel mesh
    (mp=2, 2 gloo ranks, a spawn shared with
    test_mesh_steps_accumulate_path_and_layout) in bf16 compute, where
    the search runs on the serving copy: the two ranks agree in tokens and
    scores, and each rank's tokens and scores equal those of one process
    with the same weights in bf16 compute whose row layers (attention
    out_proj, FFN fc2, as shard_model splits them) sum their two halves'
    bf16 products as the group's all-reduce does (_TwoShardRow). In bf16
    that order of rounding is part of what mp=2 computes: one process's
    single rounding of the whole product moves the scores slightly and
    can flip near-tied beams of these random weights. The serving
    copy keeps the split layers Dense, so a row layer's output is the
    group's sum before its bias; a copy of plain layers returns each
    rank's partial sum plus the whole bias, and the ranks decode other
    tokens than this reference and than each other. Replaying the captured TP search on several cards waits
    for a machine with several cards (ROADMAP A9 (a))."""
    from gtos_tpu_torch.infer.decode import beam_decode_arrays
    from gtos_tpu_torch.models.components import FeedForward
    from gtos_tpu_torch.parallel.tensor_parallel import _attention_modules

    files = mesh_steps_run["files"]
    model = Generator(mesh_steps_run["search_cfg"], device="cpu")
    model.load_state_dict(torch.load(files["state_path"]))
    rows = [m.out_proj for m in _attention_modules(model) if m.heads % 2 == 0]
    rows += [m.fc2 for m in model.modules() if isinstance(m, FeedForward)
             and m.fc1.weight.shape[0] % 2 == 0]
    assert len(rows) == 5    # 3 attentions, 2 FFNs (one layer a stack)
    for layer in rows:
        layer.__class__ = _TwoShardRow
    ref = beam_decode_arrays(model, dict(np.load(files["arrays_path"])),
                             beam_size=2, max_steps=8)
    got = [out["tp_search"] for out in mesh_steps_run["outs"]]
    for out in got:
        np.testing.assert_array_equal(out["seqs"], ref.seqs.numpy())
        np.testing.assert_array_equal(out["scores"], ref.scores.numpy())
    np.testing.assert_array_equal(got[0]["seqs"], got[1]["seqs"])
    np.testing.assert_array_equal(got[0]["scores"], got[1]["scores"])


def test_block_sparse_model_graph2_matches_single_device(tmp_path):
    """The full model under "block_sparse" on a graph=2 mesh (the B5s/B6
    ring, plain versions here) against the JAX package's single-device
    loss on the same kept pairs ("sparse", cp_shards=1) within 2e-4, and
    the gradients within rtol 5e-4 / atol 1e-6."""
    big = dict(corpus=dict(min_nodes=150, max_nodes=220))
    spec = JaxBucketSpec(nodes=(256,), bank=(16384, 65536))
    kw = dict(build_edges=True, build_block_tiles=True, sparse_khop=2)
    jm, params, ja1, _, _, _ = _setup(
        tmp_path, "sparse", "sparse", n=2, seed=17, bucket=2,
        spec=dict(max_target_len=256, sparse_khop=2), jax_spec=spec,
        cp_shards=1, **dict(kw, corpus=big["corpus"]))
    loss, _, norm, ref = _jax_step(jm, params, ja1)
    _, _, _, _, _, files = _setup(
        tmp_path, "block_sparse", "sparse", n=2, seed=17, bucket=2,
        spec=dict(max_target_len=256, sparse_khop=2), jax_spec=spec,
        cp_shards=2, **dict(kw, corpus=big["corpus"]))
    for out in ranks.spawn("train_step", 2, tmp_path, dp=1, mp=1, graph=2,
                           **files):
        np.testing.assert_allclose(out["loss"], loss, rtol=2e-4)
        np.testing.assert_allclose(out["grad_norm"], norm, rtol=1e-4)
        for name, g in out["grads"].items():
            np.testing.assert_allclose(g, ref[name].numpy(), **GRAD_TOL,
                                       err_msg=name)


def test_beam_tokens_under_cp_mesh(tmp_path):
    """Beam search through a model whose encoder runs the edge-cell ring
    over graph=2: every rank decodes the JAX package's single-device
    tokens (sparse, beam 2, 8 steps)."""
    graphs, targets = jax_corpus(6, seed=31, min_nodes=3, max_nodes=6)
    jv = jax_build_vocabs(graphs, targets)
    kw = dict(batch_size_bucket=8, build_edges=True, for_train=False)
    inst = jax_preprocess(graphs, targets)
    j1 = jax_batchify(inst, *jv, cp_shards=1, **kw).arrays()
    j2 = jax_batchify(inst, *jv, cp_shards=2, **kw).arrays()
    tv, cv, rv, chv, _ = jv
    cfg = dict(TINY, token_vocab=len(tv), concept_vocab=len(cv),
               relation_vocab=len(rv), char_vocab=len(chv))
    jm = JaxGenerator(JaxModelConfig(**cfg, attention_impl="sparse"))
    params = jax.jit(lambda key: jm.init({"params": key}, j1,
                                         deterministic=True))(
        jax.random.PRNGKey(0))
    ids = dict(str_id=tv.str_id, end_id=tv.end_id, unk_id=tv.unk_id)
    ref = jax_beam_decode(jm, params, j1, beam_size=2, max_steps=8, **ids)
    torch.save(state_dict_from_flax(jax.device_get(params)),
               tmp_path / "state.pt")
    with open(tmp_path / "batch.pkl", "wb") as f:
        pickle.dump(j2, f)
    pcfg = ModelConfig(**cfg, attention_impl="sparse")
    for seqs in ranks.spawn("decode", 2, tmp_path, cfg_json=pcfg.to_json(),
                            state_path=str(tmp_path / "state.pt"),
                            batch_path=str(tmp_path / "batch.pkl"), beam=2,
                            steps=8):
        np.testing.assert_array_equal(seqs, np.asarray(ref.seqs))


def test_scaling_report_keys(tmp_path):
    """scaling_report on a graph=2 mesh returns the JAX package's keys, on
    the same kept pairs at S = 1 and 2."""
    out = ranks.spawn("scaling", 2, tmp_path, num_nodes=256)[0]
    assert set(out) == {
        "op", "n_devices", "num_nodes", "bank_rows", "edges_1dev",
        "edges_mesh", "edges_per_s_1dev", "ring", "a2a", "faster_schedule",
        "per_device_nodes", "device"}
    assert out["n_devices"] == 2 and out["edges_1dev"] == out["edges_mesh"]
    for name in ("ring", "a2a"):
        assert set(out[name]) == {"edges_per_s_mesh", "speedup",
                                  "efficiency"}
        assert out[name]["edges_per_s_mesh"] > 0
    json.dumps(out)
