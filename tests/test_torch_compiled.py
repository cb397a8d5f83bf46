"""The compiled step and search (the JAX package's make_train_step,
make_eval_step, TrainState and one-program beam search; on the card the
port's CUDA graphs per signature, utils/graphs.py) against the JAX
package on the CPU, where the same step functions run uncaptured: f32,
dropout off, 2+2 layers at d=64, the same numpy-seeded batches in both.

  * `make_train_step` from `train_state_from_jax` of a JAX state past the
    schedule's warm-up, three steps, with and without accumulation;
  * `make_eval_step`;
  * the search with its position and end-of-search flag on the device
    and steps past the end as no-ops: tokens, scores, lengths and the
    final t of the JAX while_loop, on the model (beam 1 and 4,
    "pallas_local" and "pallas") and on a step function of random
    log-probabilities, also when every step up to max_steps is run;
  * serving after a train step uses the new weights;
  * evaluation and search run the model in eval mode.

Tolerances are stated per test."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtos_tpu.data import batchify as jax_batchify
from gtos_tpu.data.dataloader import preprocess as jax_preprocess
from gtos_tpu.data.extract import build_vocabs as jax_build_vocabs
from gtos_tpu.data.synthetic import synthetic_amr_corpus as jax_corpus
from gtos_tpu.infer import beam as jax_beam
from gtos_tpu.models import Generator as JaxGenerator
from gtos_tpu.models.generator import batch_edges as jax_batch_edges
from gtos_tpu.train import TrainState as JaxTrainState
from gtos_tpu.train import make_optimizer
from gtos_tpu.train.trainer import make_eval_step as jax_make_eval_step
from gtos_tpu.train.trainer import make_train_step as jax_make_train_step
from gtos_tpu.utils.config import ModelConfig as JaxModelConfig
from gtos_tpu.utils.config import TrainConfig as JaxTrainConfig
from gtos_tpu_torch.convert import state_dict_from_flax, train_state_from_jax
from gtos_tpu_torch.data import batchify
from gtos_tpu_torch.data.dataloader import preprocess
from gtos_tpu_torch.data.extract import build_vocabs
from gtos_tpu_torch.data.synthetic import synthetic_amr_corpus
from gtos_tpu_torch.infer import beam
from gtos_tpu_torch.infer.decode import beam_decode_arrays, search_graphs
from gtos_tpu_torch.models import Generator
from gtos_tpu_torch.models.generator import batch_to_device
from gtos_tpu_torch.train.optim import Optimizer
from gtos_tpu_torch.train.trainer import (
    Trainer, make_eval_step, make_train_step,
)
from gtos_tpu_torch.utils import graphs, kernel_calls
from gtos_tpu_torch.utils.config import ModelConfig, TrainConfig

torch.set_num_threads(2)

SMALL = dict(d_model=64, d_ff=128, heads=4, enc_layers=2, dec_layers=2,
             char_dim=8, char_filters=16, rel_emb_dim=8, rel_hidden=16,
             max_oov=16, max_target_len=32, dropout=0.0)
# the decoder's attention key biases: zero gradient in exact arithmetic,
# rounding noise in both packages (tests/test_torch_train.py)
ZERO_GRAD = ("self_attn.k_proj.bias", "cross_attn.k_proj.bias")
IMPLS = {"pallas_local": "pallas_local_interpret",
         "pallas": "pallas_interpret",
         "block_sparse": "block_sparse_interpret"}


def _setup(impl="pallas_local", for_train=True, **cfg):
    """Both packages' models from one flax init and the same batch (the
    JAX side made once per arguments; the port's model anew)."""
    s = dict(_jax_side(impl, for_train, tuple(sorted(cfg.items()))))
    pm = Generator(s["pcfg"], device="cpu")
    pm.load_state_dict(state_dict_from_flax(jax.device_get(s["params"])))
    return dict(s, pm=pm)


@functools.lru_cache(maxsize=None)
def _jax_side(impl, for_train, cfg):
    graphs_, targets = jax_corpus(6, seed=3)
    jv = jax_build_vocabs(graphs_, targets)
    kw = dict(batch_size_bucket=8, for_train=for_train,
              build_local_banks=impl == "pallas_local")
    if impl == "block_sparse":      # tile layouts at k-hop 2
        kw.update(build_block_tiles=True, sparse_khop=2)
        cfg = cfg + (("sparse_khop", 2),)
    ja = jax_batchify(jax_preprocess(graphs_, targets), *jv, **kw).arrays()
    g2, t2 = synthetic_amr_corpus(6, seed=3)
    pa = batchify(preprocess(g2, t2), *build_vocabs(g2, t2), **kw).arrays()
    tv, cv, rv, chv, _ = jv
    kw = dict(SMALL, token_vocab=len(tv), concept_vocab=len(cv),
              relation_vocab=len(rv), char_vocab=len(chv), **dict(cfg))
    jm = JaxGenerator(JaxModelConfig(**kw, attention_impl=IMPLS[impl]))
    params = _init(tuple(sorted(kw.items())))
    pcfg = ModelConfig(**kw, attention_impl=impl)
    return dict(jm=jm, params=params, ja=ja, pcfg=pcfg, pa=pa, tv=tv)


@functools.lru_cache(maxsize=None)
def _init(kw):
    """The flax init of the model config `kw` on the training batch:
    every attention impl, copy_impl and batch has the same parameter
    tree, so one init (through "xla", compiled) serves every test."""
    graphs_, targets = jax_corpus(6, seed=3)
    ja = jax_batchify(jax_preprocess(graphs_, targets),
                      *jax_build_vocabs(graphs_, targets),
                      batch_size_bucket=8, for_train=True,
                      build_local_banks=True).arrays()
    cfg = {k: v for k, v in kw if k not in ("copy_impl",
                                            "label_smoothing")}
    init = JaxGenerator(JaxModelConfig(**cfg, attention_impl="xla")).init
    return jax.jit(lambda a: init({"params": jax.random.PRNGKey(0)}, a,
                                  deterministic=True))(ja)


def _two_batches(s):
    """The batch and a second one with every other target row masked."""
    half = dict(s["ja"], token_mask=s["ja"]["token_mask"].copy())
    half["token_mask"][::2] = False
    pb = batch_to_device(s["pa"], "cpu")
    return [s["ja"], half], [pb, dict(pb, token_mask=torch.from_numpy(
        half["token_mask"]))]


def _tree_close(got, ref, names, rtol, atol, what):
    ref = state_dict_from_flax(jax.device_get(ref))
    for name, g in zip(names, got):
        np.testing.assert_allclose(g.detach().numpy(), ref[name].numpy(),
                                   rtol=rtol, atol=atol(name),
                                   err_msg=f"{what} {name}")


def _moments_close(got, ref, names, rtol, frac, what):
    """Each element within rtol of itself or `frac` of its tensor's
    largest; a tensor whose largest element lies below 1e-6 of the
    model's largest (the key biases, whose gradient is zero in exact
    arithmetic) holds rounding noise in both packages and is held under
    that bound instead."""
    ref = {k: v.numpy() for k, v in
           state_dict_from_flax(jax.device_get(ref)).items()}
    noise = 1e-6 * max(float(np.abs(r).max()) for r in ref.values())
    for name, g in zip(names, got):
        g, r = g.detach().numpy(), ref[name]
        largest = float(np.abs(r).max())
        if largest < noise:
            assert float(np.abs(g).max()) < noise, f"{what} {name}"
            continue
        np.testing.assert_allclose(g, r, rtol=rtol, atol=frac * largest,
                                   err_msg=f"{what} {name}")


@pytest.mark.parametrize("accum,impl", [
    pytest.param(1, "pallas_local", id="1"),
    pytest.param(2, "pallas_local", id="2"),
    pytest.param(1, "block_sparse", id="block_sparse")])
def test_train_step_from_a_jax_state_matches_jax(accum, impl):
    """The port's make_train_step from train_state_from_jax of a JAX
    TrainState 4 optimizer steps in (past the 3-step warm-up), then 3
    steps of each package on two alternating batches, a clip every step
    trips: metrics (loss and grad_norm to 1e-5 relative, acc to 1e-6,
    n_tok exactly), parameters (to 5e-4 of the summed learning rates,
    1e-2 for the zero-gradient key biases, as
    test_five_optimizer_steps_match_optax holds them), Adam's moments
    (`_moments_close`: mu to 1e-5 relative or 1e-4 of its tensor's largest
    element, nu to 2e-5 or 2e-4, since the gradients are f32 sums of the
    same terms in another order, off by up to 2e-5 of a tensor's largest
    gradient, and an element near zero keeps that absolute error), the
    count and the step; with accumulation also MultiSteps' running mean
    (as mu) and mini-step. Under "pallas_local" and, with tile layouts at
    k-hop 2, under "block_sparse" (the Pallas kernels in interpret mode
    against B5s's and B6's plain versions, B6b walking the padded backward
    plan built inside the step); each step's "layout_ok" is true."""
    s = _setup(impl, copy_impl="scatter", label_smoothing=0.1)
    kw = dict(warmup_steps=3, grad_clip=0.5, accum_steps=accum,
              adam_eps=1e-6, weight_decay=0.01 if accum == 1 else 0.0)
    tx = make_optimizer(JaxTrainConfig(**kw), SMALL["d_model"])
    params = jax.tree_util.tree_map(jnp.copy, s["params"])  # the step
    jstate = JaxTrainState(params=params,                   # donates it
                           opt_state=tx.init(params),
                           step=jnp.zeros((), jnp.int32),
                           rng=jax.random.PRNGKey(1))
    jstep = jax_make_train_step(s["jm"], tx)
    jbatches, pbatches = _two_batches(s)
    for i in range(4 * accum):
        jstate, _ = jstep(jstate, jbatches[i % 2])
    pm = s["pm"]
    opt = Optimizer(TrainConfig(**kw), SMALL["d_model"],
                    list(pm.parameters()))
    pstate = train_state_from_jax(jax.device_get(jstate), pm, opt)
    assert pstate.step == 4 * accum and int(opt.state["count"]) == 4
    pstep = make_train_step(pm, opt)
    for i in range(3):
        jstate, jmet = jstep(jstate, jbatches[i % 2])
        pstate, pmet = pstep(pstate, pbatches[i % 2])
        np.testing.assert_allclose(pmet["loss"].item(), float(jmet["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(pmet["grad_norm"].item(),
                                   float(jmet["grad_norm"]), rtol=1e-5)
        np.testing.assert_allclose(pmet["acc"].item(), float(jmet["acc"]),
                                   atol=1e-6)
        assert pmet["n_tok"].item() == float(jmet["n_tok"])
        assert pmet["layout_ok"].item() == 1.0
    assert pstate.step == int(jstate.step) == 4 * accum + 3
    names = [n for n, _ in pm.named_parameters()]
    lr_sum = sum(opt.schedule(torch.tensor(c)).item() for c in range(7))
    _tree_close(pstate.params, jstate.params, names, 0, lambda n: lr_sum * (
        1e-2 if n.endswith(ZERO_GRAD) else 5e-4), "param")
    js = jax.device_get(jstate.opt_state)
    from gtos_tpu_torch.convert import _find
    adam = _find(js, ("count", "mu", "nu"))
    assert int(opt.state["count"]) == int(adam.count)
    _moments_close(opt.state["mu"], adam.mu, names, 1e-5, 1e-4, "mu")
    _moments_close(opt.state["nu"], adam.nu, names, 2e-5, 2e-4, "nu")
    if accum > 1:
        multi = _find(js, ("mini_step", "acc_grads"))
        assert opt.state["mini_step"] == int(multi.mini_step)
        _moments_close(opt.state["acc"], multi.acc_grads, names, 1e-5,
                       1e-4, "acc")


def test_eval_step_matches_jax():
    """make_eval_step against the JAX make_eval_step on one batch: loss to
    1e-6 relative, acc to 1e-6, n_tok exactly."""
    s = _setup(copy_impl="scatter", label_smoothing=0.1)
    ref = jax_make_eval_step(s["jm"])(s["params"], s["ja"])
    got = make_eval_step(s["pm"])(batch_to_device(s["pa"], "cpu"))
    np.testing.assert_allclose(got["loss"].item(), float(ref["loss"]),
                               rtol=1e-6)
    np.testing.assert_allclose(got["acc"].item(), float(ref["acc"]),
                               atol=1e-6)
    assert got["n_tok"].item() == float(ref["n_tok"])


@functools.lru_cache(maxsize=None)
def _jax_decode(impl, K, steps):
    """The JAX package's beam_decode_arrays on `_setup(impl)`'s batch, its
    step function counting the while_loop's iterations (the final t)
    through a callback: (result, final t)."""
    s = _jax_side(impl, False, ())
    counter = []
    jm, params, ja = s["jm"], s["params"], s["ja"]
    tv = s["tv"]
    mem = jm.apply(params, ja["concept"], ja["concept_char"],
                   ja["concept_mask"], ja["rel_bank"], ja["rel_length"],
                   ja["rel_index"], True, edges=jax_batch_edges(ja),
                   method=JaxGenerator.encode)
    rep = lambda x: jnp.repeat(x, K, axis=0)  # noqa: E731
    masks = [rep(ja[k]) for k in ("concept_mask", "cp_seq", "copy_mask")]
    caches = jm.apply(params, rep(mem), steps,
                      method=JaxGenerator.init_cache)

    def step_fn(tokens, pos, caches):
        jax.debug.callback(lambda: counter.append(1))
        return jm.apply(params, tokens, pos, caches, *masks,
                        method=JaxGenerator.decode_step)

    def reorder_fn(caches, fp):
        return [{k: (v[fp] if k in ("self_k", "self_v") else v)
                 for k, v in c.items()} for c in caches]

    cfg = jm.cfg
    res = jax.device_get(jax_beam.beam_search(
        step_fn, caches, ja["concept"].shape[0], K, steps, cfg.ext_vocab,
        cfg.token_vocab, str_id=tv.str_id, end_id=tv.end_id,
        unk_id=tv.unk_id, alpha=0.6, reorder_fn=reorder_fn))
    return res, len(counter)


@pytest.mark.parametrize("impl,K,lag", [
    ("pallas_local", 1, None), ("pallas_local", 4, None),
    ("pallas_local", 4, 20), ("pallas", 4, None)])
def test_search_matches_jax_with_its_final_t(impl, K, lag, monkeypatch):
    """beam_decode_arrays (the search whose position and end flag live on
    the device) against the JAX package's while_loop search on the small
    model: the same tokens, lengths and final t, scores to 1e-4 (the
    decoder's f32 sums in another order). A lag of 20 (the host reading
    the end flag 20 steps late) runs all max_steps=20 steps: the steps
    past the JAX loop's end change nothing."""
    if lag is not None:
        monkeypatch.setattr(beam, "LAG", lag)
    s = _setup(impl, for_train=False)
    ref, final_t = _jax_decode(impl, K, 20)
    tv = s["tv"]
    out = beam_decode_arrays(s["pm"], s["pa"], beam_size=K, max_steps=20,
                             str_id=tv.str_id, end_id=tv.end_id,
                             unk_id=tv.unk_id)
    np.testing.assert_array_equal(out.seqs.numpy(), ref.seqs)
    np.testing.assert_array_equal(out.lengths.numpy(), ref.lengths)
    np.testing.assert_allclose(out.scores.numpy(), ref.scores, rtol=1e-4,
                               atol=1e-4)
    assert int(out.steps) == final_t


T, V_TOK, V_EXT, B = 10, 7, 9, 3
IDS = dict(str_id=2, end_id=3, unk_id=1)


@pytest.mark.parametrize("K,alpha,seed,lag", [
    (1, 0.0, 0, None), (4, 0.6, 13, None), (4, 0.6, 13, T - 1),
    (2, 0.6, 2, 2), (4, 1.0, 3, None)])
def test_search_on_random_log_probs_matches_jax(K, alpha, seed, lag,
                                                monkeypatch):
    """A step function from a seeded table of log-probabilities in
    multiples of 1/4 (exact sums in f32, real ties; tests/
    test_torch_beam.py): tokens, lengths and final t equal to the JAX
    search's, scores to 1e-6. Seeds 0, 13 and 2 end before max_steps = T
    - 1 (at t = 3, 8 and 7); the host reads the end flag `lag` steps late
    (default beam.LAG), so the first `lag` steps always run, those past
    the end as no-ops: lag T - 1 runs all T - 1 steps."""
    if lag is not None:
        monkeypatch.setattr(beam, "LAG", lag)
    lag = beam.LAG
    rng = np.random.default_rng(seed)
    table = (rng.integers(-12, 1, (T, V_TOK, V_EXT)) / 4).astype(np.float32)
    jt, pt = jnp.asarray(table), torch.from_numpy(table)
    counter = []

    def jax_step(tokens, pos, caches):
        jax.debug.callback(lambda: counter.append(1))
        st = caches["s"] + tokens
        return jt[pos, tokens] + 0.25 * (st % 3)[:, None], {"s": st}

    calls = []

    def port_step(tokens, pos, caches):
        calls.append(1)
        st = caches["s"] + tokens
        return pt[pos, tokens] + 0.25 * (st % 3)[:, None], {"s": st}

    ref = jax.device_get(jax_beam.beam_search(
        jax_step, {"s": jnp.zeros(B * K, jnp.int32)}, B, K, T - 1, V_EXT,
        V_TOK, alpha=alpha, **IDS))
    out = beam.beam_search(
        port_step, {"s": torch.zeros(B * K, dtype=torch.int64)}, B, K,
        T - 1, V_EXT, V_TOK, alpha=alpha, device="cpu", **IDS)
    np.testing.assert_array_equal(out.seqs.numpy(), ref.seqs)
    np.testing.assert_array_equal(out.lengths.numpy(), ref.lengths)
    np.testing.assert_allclose(out.scores.numpy(), ref.scores, rtol=1e-6,
                               atol=1e-6)
    assert int(out.steps) == len(counter)
    # the CPU's flag is current when read: the search's own steps, and at
    # least the first `lag`
    assert len(calls) == min(T - 1, max(lag, len(counter)))


def test_serving_after_a_train_step_uses_the_new_weights():
    """A bf16 model's serving copy after Trainer.train_step is a new
    rounding of the updated parameters; `mark_updated` (what a replayed
    step calls, since a replay bumps no version counter) alone also makes
    a new copy."""
    g, t = synthetic_amr_corpus(6, seed=3)
    vocabs = build_vocabs(g, t)
    pa = batchify(preprocess(g, t), *vocabs, batch_size_bucket=8,
                  for_train=True, build_local_banks=True).arrays()
    tv, cv, rv, chv, _ = vocabs
    pcfg = ModelConfig(**dict(
        SMALL, token_vocab=len(tv), concept_vocab=len(cv),
        relation_vocab=len(rv), char_vocab=len(chv),
        compute_dtype="bfloat16", attention_impl="pallas_local"))
    pm = Generator(pcfg, device="cpu")
    s = dict(pa=pa)
    trainer = Trainer(pm, pcfg, TrainConfig(warmup_steps=3), pa,
                      device="cpu")
    before = pm.serving_copy()
    trainer.train_step(batch_to_device(s["pa"], "cpu"))
    after = pm.serving_copy()
    assert after is not before
    for p, q in zip(pm.parameters(), after.parameters()):
        assert torch.equal(q, p.detach().to(q.dtype))
    assert not all(torch.equal(p, q) for p, q in
                   zip(before.parameters(), after.parameters()))
    pm.mark_updated()
    assert pm.serving_copy() is not after


def test_evaluate_and_search_run_in_eval_mode():
    """An f32 model with dropout 0.2 (its serving copy is the model
    itself): Trainer.evaluate after a train step leaves it in eval mode,
    and a search right after a train step (the model in train mode) draws
    no dropout mask: the dropout generator keeps its state, and the
    tokens and scores equal those of a fresh model with the same
    weights."""
    g, t = synthetic_amr_corpus(6, seed=3)
    vocabs = build_vocabs(g, t)
    batches = [batchify(preprocess(g, t), *vocabs, batch_size_bucket=8,
                        for_train=train, build_local_banks=True)
               for train in (True, False)]
    tv, cv, rv, chv, _ = vocabs
    pcfg = ModelConfig(**dict(
        SMALL, token_vocab=len(tv), concept_vocab=len(cv),
        relation_vocab=len(rv), char_vocab=len(chv), dropout=0.2,
        attention_impl="pallas_local"))
    pm = Generator(pcfg, device="cpu")
    trainer = Trainer(pm, pcfg, TrainConfig(warmup_steps=3),
                      batches[0].arrays(), device="cpu")
    arrays = batch_to_device(batches[0].arrays(), "cpu")
    trainer.train_step(arrays)
    rng = pm.dropout_rng.get_state()
    trainer.evaluate(batches[:1])
    assert not pm.training
    assert torch.equal(pm.dropout_rng.get_state(), rng)
    trainer.train_step(arrays)
    assert pm.training
    rng = pm.dropout_rng.get_state()
    kw = dict(beam_size=2, max_steps=8, str_id=tv.str_id, end_id=tv.end_id,
              unk_id=tv.unk_id)
    got = beam_decode_arrays(pm, batches[1].arrays(), **kw)
    assert torch.equal(pm.dropout_rng.get_state(), rng)
    fresh = Generator(pcfg, device="cpu")
    fresh.load_state_dict(pm.state_dict())
    ref = beam_decode_arrays(fresh, batches[1].arrays(), **kw)
    assert torch.equal(got.seqs, ref.seqs)
    assert torch.equal(got.scores, ref.scores)


def test_graph_caches_on_the_cpu():
    """On the CPU every step runs uncaptured: for_model hands a disabled
    cache, compiled=True raises, and a swap of the kernel wrappers counts
    (the card's caches drop their graphs on it)."""
    pm = Generator(ModelConfig(**dict(SMALL, token_vocab=20, concept_vocab=20,
                                      relation_vocab=10, char_vocab=10)),
                   device="cpu")
    assert not graphs.for_model(pm).enabled
    assert not search_graphs(pm).enabled
    with pytest.raises(ValueError, match="need the card"):
        graphs.for_model(pm, compiled=True)
    n = kernel_calls.swaps()
    with kernel_calls.replaced("B1", lambda *a, **k: None):
        assert kernel_calls.swaps() == n + 1
    assert kernel_calls.swaps() == n + 2
    calls = []
    assert graphs.Graphs("cpu", False).run("k", lambda: calls.append(1)) \
        is None and calls == [1]
