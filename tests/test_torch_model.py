"""The PyTorch port's model against the JAX package, module by module and
as a whole, on the CPU in f32: the same seeded batch and the JAX init's
parameters converted by gtos_tpu_torch.convert go through both packages.

The JAX side runs as its own tests run it: attention_impl
"pallas_local_interpret" (the Pallas kernel under the interpreter); the
port runs "pallas_local", whose wrapper takes the plain version for CPU
tensors. Tolerances are stated per test: 1e-5 for one module, 1e-4 after
two layers (sums in another order, compounded through LayerNorms)."""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from gtos_tpu.data import BucketSpec as JaxBucketSpec
from gtos_tpu.data import batchify as jax_batchify
from gtos_tpu.data.dataloader import preprocess as jax_preprocess
from gtos_tpu.data.extract import build_vocabs as jax_build_vocabs
from gtos_tpu.data.synthetic import synthetic_amr_corpus as jax_corpus
from gtos_tpu.infer.decode import beam_decode_arrays as jax_beam_decode
from gtos_tpu.models import Generator as JaxGenerator
from gtos_tpu.models.generator import batch_edges as jax_batch_edges
from gtos_tpu.models.generator import (
    resolve_attention_impl as jax_resolve_attention_impl,
)
from gtos_tpu.ops.pallas import relation_attention as jax_ra
from gtos_tpu.utils.config import ModelConfig as JaxModelConfig
from gtos_tpu_torch.convert import state_dict_from_flax
from gtos_tpu_torch.data import BucketSpec, batchify
from gtos_tpu_torch.data.dataloader import preprocess
from gtos_tpu_torch.data.extract import build_vocabs
from gtos_tpu_torch.data.synthetic import synthetic_amr_corpus
from gtos_tpu_torch.infer.decode import beam_decode_arrays
from gtos_tpu_torch.models import Generator
from gtos_tpu_torch.models.generator import (
    batch_edges, batch_to_device, resolve_attention_impl,
)
from gtos_tpu_torch.models.graph_transformer import GraphTransformer
from gtos_tpu_torch.ops import relation_attention as port_ra
from gtos_tpu_torch.train.train import loader_flags
from gtos_tpu_torch.utils.config import ModelConfig

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

SMALL = dict(d_model=32, d_ff=64, heads=2, enc_layers=2, dec_layers=2,
             char_dim=8, char_filters=16, rel_emb_dim=8, rel_hidden=16,
             max_oov=16, max_target_len=32, dropout=0.0)


def _models(**cfg):
    """Both packages' models from one flax init (dropout off, f32), with
    SMALL's widths and `cfg` on top, and the same batch in each."""
    graphs, targets = jax_corpus(6, seed=3)
    tv, cv, rv, chv, lm = jax_build_vocabs(graphs, targets)
    jbatch = jax_batchify(jax_preprocess(graphs, targets), tv, cv, rv, chv,
                          lm, batch_size_bucket=8, for_train=False,
                          build_local_banks=True)
    g2, t2 = synthetic_amr_corpus(6, seed=3)
    pbatch = batchify(preprocess(g2, t2), *build_vocabs(g2, t2),
                      batch_size_bucket=8, for_train=False,
                      build_local_banks=True)
    kw = dict(SMALL, token_vocab=len(tv), concept_vocab=len(cv),
              relation_vocab=len(rv), char_vocab=len(chv), **cfg)
    jm = JaxGenerator(JaxModelConfig(**kw,
                                     attention_impl="pallas_local_interpret"))
    params = jm.init({"params": jax.random.PRNGKey(0)}, jbatch.arrays(),
                     deterministic=True)
    pm = Generator(ModelConfig(**kw, attention_impl="pallas_local"),
                   device="cpu")
    pm.load_state_dict(state_dict_from_flax(jax.device_get(params)))
    return dict(jm=jm, params=params, pm=pm, ja=jbatch.arrays(),
                pa=pbatch.arrays(), tv=tv)


@pytest.fixture(scope="module")
def m():
    return _models()


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(a, b, tol):
    np.testing.assert_allclose(_np(a), _np(b), rtol=tol, atol=tol)


def _encode_jax(m):
    ja = m["ja"]
    return m["jm"].apply(
        m["params"], ja["concept"], ja["concept_char"], ja["concept_mask"],
        ja["rel_bank"], ja["rel_length"], ja["rel_index"], True,
        edges=jax_batch_edges(ja), method=JaxGenerator.encode)


def _encode_port(m):
    t = batch_to_device(m["pa"], "cpu")
    with torch.no_grad():
        return m["pm"].encode(t["concept"], t["concept_char"],
                              t["concept_mask"], t["rel_bank"],
                              t["rel_length"], t["rel_index"],
                              edges=batch_edges(t))


def test_convert_covers_every_parameter(m):
    """convert.py maps the whole flax tree onto the port's state_dict:
    load_state_dict(strict) found every key, and the tied output
    projection is the decoder embedding in both."""
    sd = state_dict_from_flax(jax.device_get(m["params"]))
    assert set(sd) == set(m["pm"].state_dict())
    flax_emb = m["params"]["params"]["decoder"]["embed"]["embedding"]
    np.testing.assert_array_equal(
        _np(m["pm"].decoder.embed.weight), np.asarray(flax_emb))


@pytest.mark.parametrize("positions", [False, True])
def test_token_encoder_matches(m, positions):
    """CharCNN ("SAME" conv, pad-masked max-pool, all-pad words zeroed) +
    embedding + merge (+ sinusoidal node positions, the translator path) +
    LayerNorm(eps 1e-6). Tolerance 1e-5."""
    if positions:
        m = _models(use_node_positions=True, char_widths=(2, 3))
    ja = m["ja"]
    ref = m["jm"].apply(m["params"], ja["concept"], ja["concept_char"],
                        method=lambda mod, i, c: mod.token_encoder(i, c, True))
    t = batch_to_device(m["pa"], "cpu")
    with torch.no_grad():
        out = m["pm"].token_encoder(t["concept"], t["concept_char"])
    _close(out, ref, 1e-5)


def test_relation_encoder_matches(m):
    """BiGRU over the bank (carry frozen at pads, backward direction over
    the reversed padded sequence, pad paths zeroed). Tolerance 1e-5."""
    ja = m["ja"]
    ref = m["jm"].apply(
        m["params"], ja["rel_bank"], ja["rel_length"],
        method=lambda mod, b, ln: mod.relation_encoder(b, ln, True))
    t = batch_to_device(m["pa"], "cpu")
    with torch.no_grad():
        out = m["pm"].relation_encoder(t["rel_bank"], t["rel_length"])
    _close(out, ref, 1e-5)
    assert (_np(out)[m["pa"]["rel_length"] == 0] == 0).all()


@pytest.mark.parametrize("impl", ["pallas_local", "xla"])
def test_graph_transformer_matches(m, impl):
    """Two graph-transformer layers on seeded random inputs, localized
    (per-graph banks, the kernel's plain version) and over the global bank
    ("xla"), with the same weights. Tolerance 1e-4 (two layers)."""
    ja = m["ja"]
    rng = np.random.default_rng(0)
    B, N = ja["concept"].shape
    x = rng.standard_normal((B, N, 32)).astype(np.float32)
    rel = rng.standard_normal((ja["rel_bank"].shape[0], 32)).astype(
        np.float32)
    jm = JaxGenerator(dataclasses.replace(
        m["jm"].cfg, attention_impl="xla")) if impl == "xla" else m["jm"]
    ref = jm.apply(
        m["params"], x, rel, ja["rel_index"], ja["concept_mask"],
        jax_batch_edges(ja),
        method=lambda mod, *a: mod.graph_transformer(*a[:4], True, a[4]))
    gt = m["pm"].graph_transformer
    if impl == "xla":
        state = gt.state_dict()
        gt = GraphTransformer(SMALL["enc_layers"], 32, 64, 2, impl="xla")
        gt.load_state_dict(state)
    t = batch_to_device(m["pa"], "cpu")
    with torch.no_grad():
        out = gt(torch.from_numpy(x), torch.from_numpy(rel), t["rel_index"],
                 t["concept_mask"], batch_edges(t))
    _close(out, ref, 1e-4)


def test_generator_encode_matches(m):
    """Generator.encode end to end on a real batchify batch: token
    encoder, relation GRU, localize, 2 localized layers. Tolerance 1e-4."""
    _close(_encode_port(m), _encode_jax(m), 1e-4)


def test_decoder_steps_and_log_probs_match(m):
    """Decoder.step over a horizon-sized cache (causal mask `<= pos`) and
    Generator.decode_step's extended-vocab log-probs, three steps from the
    same memory. Tolerance 1e-5 on h and align, 1e-4 on log-probs."""
    ja = m["ja"]
    jm, params, pm = m["jm"], m["params"], m["pm"]
    mem = np.array(_encode_jax(m))
    B = mem.shape[0]
    toks = np.random.default_rng(1).integers(4, m["tv"].__len__(), (3, B))
    jcache = jm.apply(params, mem, 5, method=JaxGenerator.init_cache)
    t = batch_to_device(m["pa"], "cpu")
    with torch.no_grad():
        pcache = pm.init_cache(torch.from_numpy(mem), 5)
    for pos in range(3):
        tok = toks[pos].astype(np.int32)
        jh, _, jal = jm.apply(
            params, tok, pos, jcache, ja["concept_mask"],
            method=lambda mod, *a: mod.decoder.step(*a))
        jlogp, jcache = jm.apply(
            params, tok, pos, jcache, ja["concept_mask"], ja["cp_seq"],
            ja["copy_mask"], method=JaxGenerator.decode_step)
        with torch.no_grad():
            ph, _, pal = pm.decoder.step(
                torch.from_numpy(tok), pos,
                [dict(c, self_k=c["self_k"].clone(),
                      self_v=c["self_v"].clone()) for c in pcache],
                t["concept_mask"])
            plogp, pcache = pm.decode_step(
                torch.from_numpy(tok), pos, pcache, t["concept_mask"],
                t["cp_seq"], t["copy_mask"])
        _close(ph, jh, 1e-5)
        _close(pal, jal, 1e-5)
        _close(plogp, jlogp, 1e-4)


@pytest.mark.parametrize("cfg", [
    dict(copy_impl="onehot"), dict(copy_impl="scatter"),
    dict(use_copy=False), dict(tie_embeddings=False)])
def test_ext_log_probs_matches(cfg):
    """The copy mix (head-mean alpha, masked, renormalized; gate; EPS
    1e-9) on seeded random h and attention. The port computes both
    copy_impl values with one f32 scatter-add; the JAX "onehot" value is a
    split-precision bf16 matmul equal to it to about 1e-6 in probability.
    Also without the copy mix and with an untied output projection.
    Tolerance 1e-5 absolute and relative on log-probs."""
    mm = _models(**cfg)
    ja = mm["ja"]
    B, N = ja["cp_seq"].shape
    rng = np.random.default_rng(2)
    h = rng.standard_normal((B, 3, 32)).astype(np.float32)
    logits = rng.standard_normal((B, 3, 2, N)).astype(np.float32)
    align = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    ref = mm["jm"].apply(mm["params"], h, align, ja["cp_seq"],
                         ja["copy_mask"], method=JaxGenerator.ext_log_probs)
    with torch.no_grad():
        out = mm["pm"].ext_log_probs(
            torch.from_numpy(h), torch.from_numpy(align),
            torch.from_numpy(mm["pa"]["cp_seq"]),
            torch.from_numpy(mm["pa"]["copy_mask"]))
    np.testing.assert_allclose(_np(out), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("beam", [1, 4])
def test_beam_decode_token_identical(m, beam):
    """beam_decode_arrays: greedy (K=1) and beam-4 searches give the same
    token sequences and lengths as the JAX package's while_loop search
    (ties broken in index order in both); scores agree to 1e-4."""
    tv = m["tv"]
    ids = dict(str_id=tv.str_id, end_id=tv.end_id, unk_id=tv.unk_id)
    ref = jax_beam_decode(m["jm"], m["params"], m["ja"], beam_size=beam,
                          max_steps=20, **ids)
    out = beam_decode_arrays(m["pm"], m["pa"], beam_size=beam,
                             max_steps=20, **ids)
    np.testing.assert_array_equal(_np(out.seqs), np.asarray(ref.seqs))
    np.testing.assert_array_equal(_np(out.lengths), np.asarray(ref.lengths))
    np.testing.assert_allclose(_np(out.scores), np.asarray(ref.scores),
                               rtol=1e-4, atol=1e-4)


# the other impls' decoding (port impl: JAX impl, sparse_khop): the JAX
# side runs the Pallas kernels under the interpreter, "sparse" as XLA
DECODE_IMPLS = {"pallas": ("pallas", "pallas_interpret", 0),
                "sparse_khop2": ("sparse", "sparse", 2),
                "block_sparse_khop0": ("block_sparse",
                                       "block_sparse_interpret", 0),
                "block_sparse_khop2": ("block_sparse",
                                       "block_sparse_interpret", 2)}


@functools.lru_cache(maxsize=None)
def _impl_models(case):
    """Both packages' models under one DECODE_IMPLS case from one flax init
    (SMALL's widths, f32, dropout off) and the serving batch that impl's
    loader flags build in each package."""
    impl, jax_impl, khop = DECODE_IMPLS[case]
    graphs, targets = jax_corpus(6, seed=3)
    jv = jax_build_vocabs(graphs, targets)
    kw = dict(batch_size_bucket=8, for_train=False,
              **loader_flags(impl, khop))
    ja = jax_batchify(jax_preprocess(graphs, targets), *jv, **kw).arrays()
    g2, t2 = synthetic_amr_corpus(6, seed=3)
    pa = batchify(preprocess(g2, t2), *build_vocabs(g2, t2), **kw).arrays()
    tv, cv, rv, chv, _ = jv
    cfg = dict(SMALL, token_vocab=len(tv), concept_vocab=len(cv),
               relation_vocab=len(rv), char_vocab=len(chv), sparse_khop=khop)
    params = JaxGenerator(JaxModelConfig(**cfg, attention_impl="xla")).init(
        {"params": jax.random.PRNGKey(0)}, ja, deterministic=True)
    jm = JaxGenerator(JaxModelConfig(**cfg, attention_impl=jax_impl))
    pm = Generator(ModelConfig(**cfg, attention_impl=impl), device="cpu")
    pm.load_state_dict(state_dict_from_flax(jax.device_get(params)))
    return dict(jm=jm, params=params, pm=pm, ja=ja, pa=pa, tv=tv)


@pytest.mark.parametrize("beam", [1, 4])
@pytest.mark.parametrize("case", sorted(DECODE_IMPLS))
def test_beam_decode_token_identical_other_impls(case, beam):
    """test_beam_decode_token_identical under the other attention impls:
    "pallas" (the global bank), "sparse" (the edge list, khop 2) and
    "block_sparse" (the tiles, khop 0 and 2), each on the serving batch its
    loader flags build: the same tokens and lengths as the JAX package's
    search under its interpreted kernels (XLA for "sparse"), scores to
    1e-4."""
    test_beam_decode_token_identical(_impl_models(case), beam)


def test_serving_copy_is_the_rounded_model():
    """A bf16 model searches on `serving_copy()`: its weights rounded once
    to bf16 (LayerNorms stay f32) in the plain torch layers, kept until a
    parameter changes in place. It encodes and steps bit for bit as the
    f32-master model, which rounds the same weights at every use, and
    decodes the same tokens."""
    from torch import nn

    from gtos_tpu_torch.infer.decode import decode_batch
    from gtos_tpu_torch.models.components import LayerNorm

    g, t = synthetic_amr_corpus(6, seed=3)
    tv, cv, rv, chv, lm = build_vocabs(g, t)
    batch = batchify(preprocess(g, t), tv, cv, rv, chv, lm,
                     batch_size_bucket=8, for_train=False,
                     build_local_banks=True)
    cfg = ModelConfig(**dict(
        SMALL, token_vocab=len(tv), concept_vocab=len(cv),
        relation_vocab=len(rv), char_vocab=len(chv),
        compute_dtype="bfloat16", attention_impl="pallas_local"))
    model = Generator(cfg, device="cpu")
    copy = model.serving_copy()
    assert copy is model.serving_copy() and not copy.training
    assert all(p.dtype == torch.float32 for p in model.parameters())
    for mod in copy.modules():
        want = torch.float32 if isinstance(mod, LayerNorm) else torch.bfloat16
        assert all(p.dtype == want for p in mod.parameters(recurse=False))
    assert type(copy.decoder.embed) is nn.Embedding
    assert type(copy.token_encoder.merge) is nn.Linear
    t_ = batch_to_device(batch.arrays(), "cpu")
    args = (t_["concept"], t_["concept_char"], t_["concept_mask"],
            t_["rel_bank"], t_["rel_length"], t_["rel_index"])
    with torch.no_grad():
        assert torch.equal(model.encode(*args, edges=batch_edges(t_)),
                           copy.encode(*args, edges=batch_edges(t_)))
    assert decode_batch(model, batch, tv, beam_size=2, max_steps=6) == \
        decode_batch(copy, batch, tv, beam_size=2, max_steps=6)
    with torch.no_grad():
        next(model.parameters()).add_(1.0)
    assert model.serving_copy() is not copy


# configs/c1_toy_parity.json's widths
C1 = dict(d_model=64, d_ff=128, heads=4, enc_layers=2, dec_layers=1,
          char_dim=8, char_filters=16, rel_emb_dim=8, rel_hidden=16,
          max_oov=16, max_target_len=32, dropout=0.0, label_smoothing=0.1,
          copy_impl="scatter")


@pytest.mark.parametrize("route", ["inline", "tables"])
def test_pallas_loss_and_every_gradient_match_jax(route, monkeypatch):
    """Generator.forward under attention_impl "pallas" (the global-bank
    forward B3' or B3, the backward B4 and its table contractions; plain
    versions on the CPU) and autograd of it, against jax.value_and_grad of
    the JAX Generator under "pallas_interpret" on converted weights, c1
    widths, f32, a training batch: loss, acc and every parameter
    gradient. `route` forces the forward kernel in both packages
    (_inline_fits). Tolerance: the loss to 1e-6 relative, gradients to
    1e-4 relative and 1e-6 absolute (f32 sums in another order through
    two encoder layers)."""
    if route == "tables":
        monkeypatch.setattr(jax_ra, "_inline_fits", lambda q, a: False)
        monkeypatch.setattr(port_ra, "_inline_fits", lambda q, a: False)
    graphs, targets = jax_corpus(6, seed=3)
    jv = jax_build_vocabs(graphs, targets)
    ja = jax_batchify(jax_preprocess(graphs, targets), *jv,
                      batch_size_bucket=8, for_train=True).arrays()
    g2, t2 = synthetic_amr_corpus(6, seed=3)
    pa = batchify(preprocess(g2, t2), *build_vocabs(g2, t2),
                  batch_size_bucket=8, for_train=True).arrays()
    tv, cv, rv, chv, _ = jv
    kw = dict(C1, token_vocab=len(tv), concept_vocab=len(cv),
              relation_vocab=len(rv), char_vocab=len(chv))
    jm = JaxGenerator(JaxModelConfig(**kw, attention_impl="pallas_interpret"))
    params = jm.init({"params": jax.random.PRNGKey(0)}, ja,
                     deterministic=True)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.apply(p, ja, deterministic=True), has_aux=True))(params)
    pm = Generator(ModelConfig(**kw, attention_impl="pallas"), device="cpu")
    pm.load_state_dict(state_dict_from_flax(jax.device_get(params)))
    pm.train()
    names, ps = zip(*pm.named_parameters())
    before = port_ra.fused_relation_attention_bwd.launches
    loss, met = pm(batch_to_device(pa, "cpu"))
    grads = torch.autograd.grad(loss, ps)
    assert port_ra.fused_relation_attention_bwd.launches == before
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
    np.testing.assert_allclose(met["acc"].item(), float(jmet["acc"]),
                               atol=1e-6)
    ref = state_dict_from_flax(jax.device_get(jgrads))
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), ref[name].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=name)
    for i in range(C1["enc_layers"]):
        g = dict(zip(names, grads))[
            f"graph_transformer.layer{i}.self_attn.rel_proj.weight"]
        assert g.abs().sum() > 0


def _route_batches():
    """Two batches of the same corpus with the "auto" aux flags: eight
    small graphs over a 1024-row global bank with 128-row local banks (the
    localized route), and two graphs whose local bank is the global one
    (the global route in the JAX package, the localized one in the
    port)."""
    kw = dict(build_block_tiles="auto", build_local_banks="auto")
    out = []
    for corpus, bvocab, bat in ((jax_corpus, jax_build_vocabs, jax_batchify),
                                (synthetic_amr_corpus, build_vocabs,
                                 batchify)):
        pre = jax_preprocess if bat is jax_batchify else preprocess
        spec = (JaxBucketSpec if bat is jax_batchify else BucketSpec)
        g, t = corpus(12, seed=5, min_nodes=3, max_nodes=6)
        vocabs = bvocab(g, t)
        insts = pre(g, t)
        out.append((bat(insts[:8], *vocabs, spec=spec(bank=(1024,),
                                                      local_bank=(128,)),
                        **kw),
                    bat(insts[8:10], *vocabs, **kw), vocabs))
    return out


def test_resolve_attention_impl_matches_jax():
    """resolve_attention_impl on batches that route each way against the
    JAX package's (the counterpart of tests/test_train.py's
    test_auto_impl_dispatch): "auto" sends a batch with local banks of at
    most P / AUTO_LOCAL_RATIO rows local and others global. The port's
    ratio is the card's, 1 (measured on an H100, PERF.md §6), the JAX
    package's the TPU's 4, so the two differ on the batch whose local bank
    is the global one (P_loc = P): local in the port, global in the JAX
    package. They agree on the batch of P_loc = P / 8 (local), on batches
    without local banks (global) and for the other impls (unchanged); and
    the port's model gives one batch the same loss on either route (one
    parameter set)."""
    (j_local, j_global, _), (p_local, p_global, pv) = _route_batches()
    cases = [(j_local.arrays(), p_local.arrays()),
             (j_global.arrays(), p_global.arrays())]
    no_banks = [{k: v for k, v in a.items() if k != "bank_map"}
                for a in cases[0]]
    routes, jax_routes = [], []
    for ja, pa in cases + [tuple(no_banks)]:
        for impl in ("xla", "pallas_local", "sparse"):
            want = jax_resolve_attention_impl(impl, ja)
            assert resolve_attention_impl(impl, pa) == want, impl
            assert resolve_attention_impl(
                impl, batch_to_device(pa, "cpu")) == want
        routes.append(resolve_attention_impl("auto", pa))
        assert resolve_attention_impl(
            "auto", batch_to_device(pa, "cpu")) == routes[-1]
        assert resolve_attention_impl("auto_interpret", pa) == \
            routes[-1] + "_interpret"
        jax_routes.append(jax_resolve_attention_impl("auto", ja))
    assert (p_global.rel_bank.shape[0], p_global.bank_map.shape[1]) == \
        (128, 128)
    assert routes == ["pallas_local", "pallas_local", "pallas"]
    assert jax_routes == ["pallas_local", "pallas", "pallas"]
    tv, cv, rv, chv, _ = pv
    cfg = ModelConfig(**dict(C1, token_vocab=len(tv), concept_vocab=len(cv),
                             relation_vocab=len(rv), char_vocab=len(chv),
                             attention_impl="auto"))
    model = Generator(cfg, device="cpu")
    t = batch_to_device(p_local.arrays(), "cpu")
    with torch.no_grad():
        losses = [model(t)[0].item()]
        for impl in ("pallas", "pallas_local"):
            model.cfg = dataclasses.replace(cfg, attention_impl=impl)
            losses.append(model(t)[0].item())
    assert losses[0] == losses[2]            # auto took the local route
    np.testing.assert_allclose(losses[1], losses[2], rtol=2e-5)


def test_auto_trainer_trains_mixed_batches():
    """One Trainer under attention_impl "auto" trains batches of both
    routes on the CPU (the counterpart of tests/test_train.py's
    test_auto_aux_prefers_local_banks_at_every_bucket): one parameter set
    and one optimizer state, finite losses, and each step's loss equal to
    the loss the same model gives the batch under its fixed route. Under
    the card's AUTO_LOCAL_RATIO every batch that carries local banks goes
    local, so the global route's batch carries none."""
    from gtos_tpu_torch.train.trainer import Trainer
    from gtos_tpu_torch.utils.config import TrainConfig

    _, (p_local, p_global, pv) = _route_batches()
    local_keys = ("bank_map", "rel_index_loc", "loc_perm", "loc_bnd")
    p_global = {k: v for k, v in p_global.arrays().items()
                if k not in local_keys}
    tv, cv, rv, chv, _ = pv
    cfg = ModelConfig(**dict(C1, token_vocab=len(tv), concept_vocab=len(cv),
                             relation_vocab=len(rv), char_vocab=len(chv),
                             attention_impl="auto"))
    model = Generator(cfg, device="cpu")
    trainer = Trainer(model, cfg, TrainConfig(warmup_steps=10),
                      p_local.arrays(), device="cpu")
    torch.set_num_threads(1)   # the same sums in both evaluations
    try:
        routes = []
        for raw in (p_local.arrays(), p_global) * 2:
            arrays = batch_to_device(raw, "cpu")
            route = resolve_attention_impl("auto", arrays)
            routes.append(route)
            model.cfg = dataclasses.replace(cfg, attention_impl=route)
            with torch.no_grad():
                fixed = model.train()(arrays)[0].item()
            model.cfg = cfg
            model.dropout_rng.manual_seed(0)
            m = trainer.train_step(arrays)
            assert m["loss"].item() == fixed, route
            assert np.isfinite(m["grad_norm"].item())
    finally:
        torch.set_num_threads(2)
    assert trainer.step == 4
    assert routes == ["pallas_local", "pallas"] * 2
