"""The global-bank attention (ops/relation_attention.py) on the banks as
the encoder layer hands them under attention_impl "pallas": the two
halves of one [P, 2 H Dh] projection, as strided views (`split_banks`),
which B3' reads without a copy. Held against the JAX package on the CPU,
where the wrappers run their plain versions: the B3' forward, the
trainable entry's gradients (to the projection, through the views) and
two graph-transformer layers with their gradients.

Inputs are seeded numpy arrays handed to both packages (test_torch_cuda
make_global_case; the model's converted flax init). The JAX kernels run
under the Pallas interpreter (interpret=True), as its own tests run them.
Tolerances: 2e-4 absolute and relative for one attention call (as
tests/test_torch_relation_kernel.py, f32 sums in another order); 1e-4
relative and 1e-5 absolute after two layers (the same sums compounded
through two LayerNorms, as tests/test_torch_model.py holds two layers)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtos_tpu.data import batchify as jax_batchify
from gtos_tpu.data.dataloader import preprocess as jax_preprocess
from gtos_tpu.data.extract import build_vocabs as jax_build_vocabs
from gtos_tpu.data.synthetic import synthetic_amr_corpus as jax_corpus
from gtos_tpu.models import Generator as JaxGenerator
from gtos_tpu.models.generator import batch_edges as jax_batch_edges
from gtos_tpu.ops.pallas import relation_attention as jax_ra
from gtos_tpu.utils.config import ModelConfig as JaxModelConfig
from gtos_tpu_torch.convert import state_dict_from_flax
from gtos_tpu_torch.data import batchify
from gtos_tpu_torch.data.dataloader import preprocess
from gtos_tpu_torch.data.extract import build_vocabs
from gtos_tpu_torch.data.synthetic import synthetic_amr_corpus
from gtos_tpu_torch.models import Generator
from gtos_tpu_torch.models.generator import batch_edges, batch_to_device
from gtos_tpu_torch.ops import relation_attention as port_ra
from gtos_tpu_torch.ops.local_relation_attention import (
    bank_row_stride, split_banks,
)
from gtos_tpu_torch.ops.relation_attention import (
    _check_inline_args, fused_relation_attention_inline,
    fused_relation_attention_inline_reference, relation_attention_trainable,
)
from gtos_tpu_torch.utils.config import ModelConfig
from test_torch_cuda import PAD, make_global_case, port_global_args

torch.set_num_threads(2)

TOL = dict(rtol=2e-4, atol=2e-4)
LAYER_TOL = dict(rtol=1e-4, atol=1e-5)
SHAPES = [(N, P) for N in (16, 128) for P in (128, 256)]
B, H, DH = 2, 4, 32


def _halves(a, b):
    """The projection [P, 2 H Dh] whose halves are a and b [P, H, Dh],
    and those halves as the layer takes them (views)."""
    P = a.shape[0]
    ab = torch.cat([a.reshape(P, -1), b.reshape(P, -1)], -1)
    return ab, split_banks(ab, a.shape[1])


def _real_rows(x, N):
    """Graph 0's real query rows and all of graph 1, [B, H, N, Dh]."""
    x = np.asarray(x)
    return np.concatenate([x[0, :, : N - PAD].ravel(), x[1].ravel()])


def test_bank_halves_are_views_b3_inline_takes():
    """split_banks cuts [P, 2 H Dh] into two [P, H, Dh] views 2 H Dh
    elements a row apart, which B3''s check takes and returns that stride
    of; a contiguous bank has stride H Dh."""
    c = make_global_case(B, H, 16, DH, 128)
    q, k, v, a, b, idx, mask = port_global_args(c)
    ab, (a_v, b_v) = _halves(a, b)
    assert a_v.data_ptr() == ab.data_ptr() and not a_v.is_contiguous()
    assert torch.equal(a_v, a) and torch.equal(b_v, b)
    assert bank_row_stride(a_v[None]) == bank_row_stride(b_v[None]) == (
        2 * H * DH)
    assert bank_row_stride(a[None]) == H * DH
    assert _check_inline_args(q, k, v, a_v, b_v, idx, mask) == 2 * H * DH
    assert _check_inline_args(q, k, v, a, b, idx, mask) == H * DH


@pytest.mark.parametrize("N,P", SHAPES)
def test_plain_b3_inline_on_bank_halves_matches_jax(N, P):
    """The plain B3' (what a CPU tensor runs) on the halves of one
    projection against the JAX package's fused_relation_attention_inline
    under the interpreter on the contiguous banks; the same bits as on
    contiguous copies of the halves; no launch."""
    c = make_global_case(B, H, N, DH, P, seed=4)
    q, k, v, a, b, idx, mask = port_global_args(c)
    ref = jax_ra.fused_relation_attention_inline(
        *(jnp.asarray(c[n]) for n in ("q", "k", "v", "a_bank", "b_bank",
                                      "rel_index", "mask")),
        interpret=True)
    _, (a_v, b_v) = _halves(a, b)
    before = fused_relation_attention_inline.launches
    out = fused_relation_attention_inline(q, k, v, a_v, b_v, idx, mask)
    assert fused_relation_attention_inline.launches == before
    np.testing.assert_allclose(_real_rows(out, N), _real_rows(ref, N), **TOL)
    assert torch.equal(out, fused_relation_attention_inline_reference(
        q, k, v, a_v.contiguous(), b_v.contiguous(), idx, mask))


@pytest.mark.parametrize("N,P", SHAPES)
def test_trainable_grads_on_bank_halves_match_jax(N, P):
    """relation_attention_trainable on the halves of one projection (CPU
    tensors: the plain B3'/B3 and B4 with the table contractions) against
    jax.grad of the JAX relation_attention_trainable under the
    interpreter: the output, and the gradient of sum(out^2) to q, k, v and
    to the projection, whose halves are the JAX gradients to a_bank and
    b_bank."""
    c = make_global_case(B, H, N, DH, P, seed=5)
    idx, mask = jnp.asarray(c["rel_index"]), jnp.asarray(c["mask"])

    def jax_loss(q, k, v, ab, bb):
        o = jax_ra.relation_attention_trainable(q, k, v, ab, bb, idx, mask,
                                                interpret=True)
        return (o ** 2).sum(), o

    (_, jout), jgrads = jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2, 3, 4), has_aux=True)(
            *(jnp.asarray(c[n]) for n in ("q", "k", "v", "a_bank",
                                          "b_bank")))
    q, k, v, a, b, pidx, pmask = port_global_args(c)
    ab, _ = _halves(a, b)
    leaves = [x.clone().requires_grad_() for x in (q, k, v, ab)]
    a_v, b_v = split_banks(leaves[3], H)
    out = relation_attention_trainable(*leaves[:3], a_v, b_v, pidx, pmask)
    (out ** 2).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    for name, leaf, ref in zip("qkv", leaves, jgrads):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(ref),
                                   **TOL, err_msg=name)
    ref_ab = np.concatenate([np.asarray(g).reshape(P, -1)
                             for g in jgrads[3:]], -1)
    assert leaves[3].grad.shape == ab.shape
    np.testing.assert_allclose(leaves[3].grad.numpy(), ref_ab, **TOL)


SMALL = dict(d_model=32, d_ff=64, heads=2, enc_layers=2, dec_layers=2,
             char_dim=8, char_filters=16, rel_emb_dim=8, rel_hidden=16,
             max_oov=16, max_target_len=32, dropout=0.0)


@pytest.mark.parametrize("route", ["inline", "tables"])
def test_pallas_layers_on_bank_halves_match_jax(route, monkeypatch):
    """Two graph-transformer layers under attention_impl "pallas" (each
    layer's bank halves handed on as views; B3' or B3 as `route` forces
    through _inline_fits in both packages) against the JAX package's
    under "pallas_interpret" on converted weights and seeded inputs: the
    output and the gradients of a seeded projection of it to the inputs
    and to every parameter of the stack."""
    if route == "tables":
        monkeypatch.setattr(jax_ra, "_inline_fits", lambda q, a: False)
        monkeypatch.setattr(port_ra, "_inline_fits", lambda q, a: False)
    graphs, targets = jax_corpus(6, seed=3)
    tv, cv, rv, chv, lm = jax_build_vocabs(graphs, targets)
    ja = jax_batchify(jax_preprocess(graphs, targets), tv, cv, rv, chv, lm,
                      batch_size_bucket=8, for_train=False).arrays()
    g2, t2 = synthetic_amr_corpus(6, seed=3)
    pa = batch_to_device(batchify(
        preprocess(g2, t2), *build_vocabs(g2, t2), batch_size_bucket=8,
        for_train=False).arrays(), "cpu")
    kw = dict(SMALL, token_vocab=len(tv), concept_vocab=len(cv),
              relation_vocab=len(rv), char_vocab=len(chv))
    jm = JaxGenerator(JaxModelConfig(**kw, attention_impl="pallas_interpret"))
    params = jm.init({"params": jax.random.PRNGKey(0)}, ja,
                     deterministic=True)
    pm = Generator(ModelConfig(**kw, attention_impl="pallas"), device="cpu")
    pm.load_state_dict(state_dict_from_flax(jax.device_get(params)))

    rng = np.random.default_rng(6)
    Bq, N = ja["concept"].shape
    D = SMALL["d_model"]
    x = rng.standard_normal((Bq, N, D)).astype(np.float32)
    rel = rng.standard_normal((ja["rel_bank"].shape[0], D)).astype(
        np.float32)
    cot = rng.standard_normal((Bq, N, D)).astype(np.float32)
    edges = jax_batch_edges(ja)

    def jax_loss(p, x, rel):
        out = jm.apply(p, x, rel, ja["rel_index"], ja["concept_mask"], edges,
                       method=lambda mod, *a: mod.graph_transformer(
                           *a[:4], True, a[4]))
        return (out * cot).sum(), out

    (_, jout), jgrads = jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2), has_aux=True)(params, x, rel)
    gt = pm.graph_transformer
    xt, relt = (torch.from_numpy(y).requires_grad_() for y in (x, rel))
    out = gt(xt, relt, pa["rel_index"], pa["concept_mask"], batch_edges(pa))
    names, ps = zip(*gt.named_parameters())
    grads = torch.autograd.grad((out * torch.from_numpy(cot)).sum(),
                                (xt, relt, *ps))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               **LAYER_TOL)
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jgrads[1]),
                               **LAYER_TOL, err_msg="x")
    np.testing.assert_allclose(grads[1].numpy(), np.asarray(jgrads[2]),
                               **LAYER_TOL, err_msg="rel_vecs")
    ref = state_dict_from_flax(jax.device_get(jgrads[0]))
    for name, g in zip(names, grads[2:]):
        np.testing.assert_allclose(
            g.numpy(), ref[f"graph_transformer.{name}"].numpy(),
            **LAYER_TOL, err_msg=name)
