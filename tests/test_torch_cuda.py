"""The port's CUDA kernels and its serving path on an NVIDIA card.

Every test here is marked `cuda` and skips without a card: a CUDA kernel
has no CPU mode. The file imports neither JAX nor the JAX package, so it
also runs where they are not installed; on a machine with a card:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

(`--noconftest` because tests/conftest.py sets JAX up). It also holds the
seeded numpy inputs that tests/test_torch_kernel.py feeds to both
packages on the CPU."""

import numpy as np
import pytest
import torch

from gtos_tpu_torch.ops.local_relation_attention import (
    RUN_CHUNK, bank_runs, local_relation_attention, local_relation_attention_bwd,
    local_relation_attention_bwd_reference, local_relation_attention_reference,
    local_relation_attention_with_probs,
    local_relation_attention_with_probs_reference, slot_order, split_banks,
)
from gtos_tpu_torch.ops.block_sparse import (
    TILE, pack_block_sparse, pack_block_sparse_src,
)
from gtos_tpu_torch.ops.block_sparse_attention import (
    bank_t4, block_sparse_attention, block_sparse_attention_with_stats,
    block_sparse_attention_with_stats_reference,
)
from gtos_tpu_torch.ops.block_sparse_attention_bwd import (
    backward_plan, block_sparse_attention_bwd_dst,
    block_sparse_attention_bwd_dst_reference, block_sparse_attention_bwd_src,
    block_sparse_attention_bwd_src_reference, block_sparse_bank_grads,
    block_sparse_bank_grads_reference, pair_capacity, prep_bwd_invariants,
)
from gtos_tpu_torch.ops.localize import localize_bank
from gtos_tpu_torch.ops.relation_attention import (
    build_tables, fused_relation_attention, fused_relation_attention_bwd,
    fused_relation_attention_bwd_reference, fused_relation_attention_inline,
    fused_relation_attention_inline_reference,
    fused_relation_attention_reference, walk_orders,
)
from gtos_tpu_torch.utils.graphs import signature

# the three cases of tests/test_local_kernel.py (B, H, N, Dh, P, P_loc)
CASES = [(2, 2, 32, 16, 200, 128), (2, 2, 16, 16, 600, 512),
         (1, 3, 64, 32, 300, 256)]


def make_case(B, H, N, Dh, P, P_loc, seed=0):
    """Seeded numpy inputs: q, k, v, global banks, bank_map, local and
    global pair matrices, and a node mask whose first graph has 5 padded
    nodes (padded query rows and keys)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    q, k, v = (rng.standard_normal((B, H, N, Dh)).astype(f)
               for _ in range(3))
    a_bank = (rng.standard_normal((P, H, Dh)) * 0.5).astype(f)
    b_bank = (rng.standard_normal((P, H, Dh)) * 0.5).astype(f)
    bank_map = np.zeros((B, P_loc), np.int32)
    idx_loc = np.zeros((B, N, N), np.int32)
    rel_index = np.zeros((B, N, N), np.int32)
    for b in range(B):
        nloc = int(rng.integers(P_loc // 2, P_loc))
        rows = np.concatenate([[0], np.sort(rng.choice(
            np.arange(1, P), nloc - 1, replace=False))])
        bank_map[b, :nloc] = rows
        idx_loc[b] = rng.integers(0, nloc, (N, N))
        rel_index[b] = rows[idx_loc[b]]
    mask = np.ones((B, N), bool)
    mask[0, N - 5:] = False
    return dict(q=q, k=k, v=v, a_bank=a_bank, b_bank=b_bank,
                bank_map=bank_map, idx_loc=idx_loc, rel_index=rel_index,
                mask=mask)


def port_local_args(c, dtype=torch.float32, device="cpu"):
    """A case as the localized kernel's arguments: the banks gathered per
    graph with localize_bank, in `dtype` on `device`."""
    t = {k: torch.from_numpy(v) for k, v in c.items()}
    bank_map = t["bank_map"]
    shape = (*bank_map.shape, *c["a_bank"].shape[1:])
    a_loc = localize_bank(t["a_bank"].flatten(1), bank_map).reshape(shape)
    b_loc = localize_bank(t["b_bank"].flatten(1), bank_map).reshape(shape)
    dev = lambda x: x.to(device=device, dtype=dtype).contiguous()  # noqa
    return (dev(t["q"]), dev(t["k"]), dev(t["v"]), dev(a_loc), dev(b_loc),
            t["idx_loc"].to(device), t["mask"].to(device))


PAD = 3  # padded nodes of graph 0 in make_global_case


def make_global_case(B, H, N, Dh, P, seed=0):
    """Seeded numpy inputs of the global-bank attention: q, k, v, the
    banks a_bank/b_bank [P, H, Dh], rel_index [B, N, N] in [0, P), an
    output cotangent g, and a node mask whose first graph has PAD padded
    nodes."""
    rng = np.random.default_rng(seed)
    f = np.float32
    q, k, v, g = (rng.standard_normal((B, H, N, Dh)).astype(f)
                  for _ in range(4))
    a_bank, b_bank = ((rng.standard_normal((P, H, Dh)) * 0.5).astype(f)
                      for _ in range(2))
    rel_index = rng.integers(0, P, (B, N, N)).astype(np.int32)
    mask = np.ones((B, N), bool)
    mask[0, N - PAD:] = False
    return dict(q=q, k=k, v=v, g=g, a_bank=a_bank, b_bank=b_bank,
                rel_index=rel_index, mask=mask)


def port_global_args(c, dtype=torch.float32, device="cpu"):
    """A global case as the kernels' arguments (q, k, v, a_bank, b_bank,
    rel_index, node_mask), in `dtype` on `device`."""
    dev = lambda x: torch.from_numpy(x).to(device=device, dtype=dtype)  # noqa
    return (*(dev(c[n]) for n in ("q", "k", "v", "a_bank", "b_bank")),
            torch.from_numpy(c["rel_index"]).to(device),
            torch.from_numpy(c["mask"]).to(device))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [
    (torch.float32, dict(rtol=1e-4, atol=1e-4)),
    (torch.bfloat16, dict(rtol=2e-2, atol=3e-2)),
])
@pytest.mark.parametrize("B,H,N,Dh,P,P_loc",
                         CASES + [(2, 8, 128, 64, 5000, 4096)])
def test_cuda_kernel_matches_plain_version(card, B, H, N, Dh, P, P_loc,
                                           dtype, tol):
    """The sm_90a kernel against the plain version on the same card
    inputs: f32 to 1e-4 (sums in another order), bf16 to 3e-2 (the
    probabilities are rounded to bf16 before the product with v, and the
    two sides round different sums)."""
    args = port_local_args(make_case(B, H, N, Dh, P, P_loc), dtype, card)
    before = local_relation_attention.launches
    out = local_relation_attention(*args)
    torch.cuda.synchronize()
    assert local_relation_attention.launches == before + 1
    ref = local_relation_attention_reference(*args)
    assert out.dtype == dtype and torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), ref.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [
    (torch.float32, dict(rtol=1e-4, atol=1e-4)),
    (torch.bfloat16, dict(rtol=2e-2, atol=3e-2)),
])
@pytest.mark.parametrize("B,H,N,Dh,P,P_loc",
                         CASES + [(2, 8, 128, 64, 5000, 4096)])
def test_cuda_b1p_and_b2_match_plain_versions(card, B, H, N, Dh, P, P_loc,
                                              dtype, tol):
    """B1p (forward with the f32 probabilities) and B2 (the backward from
    them) against their plain versions on the same card inputs: out, gq,
    gk, gv, g_a_loc and g_b_loc to B1's tolerances (f32 sums in another
    order; in bf16 one rounding of each output), the probabilities to 1e-5
    in both types (they are f32 from the same inputs). Each launch counts
    once, and B2 gives the same bits on a second run (no atomics)."""
    args = port_local_args(make_case(B, H, N, Dh, P, P_loc), dtype, card)
    q = args[0]
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(1)
                    ).to(card)
    before = (local_relation_attention_with_probs.launches,
              local_relation_attention_bwd.launches)
    out, probs = local_relation_attention_with_probs(*args)
    grads = local_relation_attention_bwd(*args[:3], g, probs, *args[3:6])
    again = local_relation_attention_bwd(*args[:3], g, probs, *args[3:6])
    torch.cuda.synchronize()
    assert (local_relation_attention_with_probs.launches,
            local_relation_attention_bwd.launches) == (before[0] + 1,
                                                       before[1] + 2)
    ref_out, ref_probs = local_relation_attention_with_probs_reference(*args)
    torch.testing.assert_close(out.float(), ref_out.float(), **tol)
    torch.testing.assert_close(probs, ref_probs, rtol=1e-4, atol=1e-5)
    ref = local_relation_attention_bwd_reference(*args[:3], g, probs,
                                                 *args[3:6])
    for name, x, y, z in zip(("gq", "gk", "gv", "g_a_loc", "g_b_loc"),
                             grads, ref, again):
        assert x.dtype == dtype and torch.isfinite(x.float()).all(), name
        torch.testing.assert_close(x.float(), y.float(), **tol, msg=name)
        assert torch.equal(x, z), name


# edge cases of the redesigned B1/B1p/B2 (B, H, N, Dh, P_loc, layout): one
# node; N=17 (not a multiple of 8 or 32) with H=12 (two head blocks); N=128
# with P_loc=4096; Dh=32, Dh=128 (two 16-byte chunks a lane) and Dh=20 (not
# a multiple of 8: a value at a time); B=1; every pair of an N=128 graph on
# one slot (a run of 16384 pairs: 512 chunks of RUN_CHUNK = 32 pairs);
# every key but one masked.
# "random": slots drawn per pair, the pairs of a graph's padded nodes on
# the pad slot 0, as batchify lays them out
LOCAL_EDGE_CASES = {"N1": (2, 8, 1, 64, 16, "random"),
                    "N17_H12": (2, 12, 17, 64, 300, "random"),
                    "N128_P4096": (2, 8, 128, 64, 4096, "random"),
                    # a lone graph's rung above the bank ladders
                    "N128_P16384": (1, 8, 128, 64, 16384, "random"),
                    "Dh32": (2, 8, 32, 32, 512, "random"),
                    "Dh128": (2, 8, 32, 128, 512, "random"),
                    "Dh20": (2, 4, 24, 20, 256, "random"),
                    "B1": (1, 8, 64, 64, 1024, "random"),
                    "one_slot": (2, 8, 128, 64, 256, "one_slot"),
                    "one_key": (2, 8, 32, 64, 512, "one_key")}


def make_local_edge_case(B, H, N, Dh, P_loc, layout, seed=0):
    """Seeded numpy inputs of B1/B2: q, k, v, g [B, H, N, Dh], the bank
    projection ab [B, P_loc, 2 H Dh], idx [B, N, N] and mask [B, N]; the
    top slots of each graph are referenced by no pair."""
    rng = np.random.default_rng(seed)
    f = np.float32
    q, k, v, g = (rng.standard_normal((B, H, N, Dh)).astype(f)
                  for _ in range(4))
    ab = (rng.standard_normal((B, P_loc, 2 * H * Dh)) * 0.5).astype(f)
    idx = rng.integers(1, max(2, P_loc - 8), (B, N, N))
    mask = np.ones((B, N), bool)
    if layout == "one_slot":
        idx[:] = 0
    elif layout == "one_key":
        mask[0, 1:] = False
    else:
        for b in range(B):
            n = int(rng.integers((N + 1) // 2, N + 1))
            mask[b, n:] = False
            idx[b, n:], idx[b, :, n:] = 0, 0
    return dict(q=q, k=k, v=v, g=g, ab=ab, idx=idx.astype(np.int32),
                mask=mask)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [
    (torch.float32, dict(rtol=1e-4, atol=1e-4)),
    (torch.bfloat16, dict(rtol=2e-2, atol=3e-2)),
])
@pytest.mark.parametrize("case", sorted(LOCAL_EDGE_CASES))
def test_cuda_local_edge_cases(card, case, dtype, tol):
    """B1, B1p and B2 on LOCAL_EDGE_CASES, the banks the two halves of one
    [B, P_loc, 2 H Dh] tensor (split_banks, rows 2 H Dh apart), against
    their plain versions at test_cuda_b1p_and_b2_match_plain_versions'
    tolerances (probabilities 1e-5); the same bits as on contiguous copies
    of the halves; B2 the same bits on a second call, its bank gradients
    written in full (the unreferenced rows exactly 0) into memory that
    held NaN before (the caching allocator hands the freed NaN blocks to
    the wrapper's torch.empty)."""
    B, H, N, Dh, P_loc, layout = LOCAL_EDGE_CASES[case]
    c = make_local_edge_case(B, H, N, Dh, P_loc, layout)
    dev = lambda x: torch.from_numpy(x).to(card)  # noqa: E731
    q, k, v = (dev(c[n]).to(dtype) for n in "qkv")
    ab, idx, mask = dev(c["ab"]).to(dtype), dev(c["idx"]), dev(c["mask"])
    g = dev(c["g"]).to(dtype).float()
    a_v, b_v = split_banks(ab, H)
    a_c, b_c = a_v.contiguous(), b_v.contiguous()
    args = (q, k, v, a_v, b_v, idx, mask)
    out = local_relation_attention(*args)
    out_p, probs = local_relation_attention_with_probs(*args)
    ref_out, ref_probs = local_relation_attention_with_probs_reference(*args)
    torch.testing.assert_close(out.float(), ref_out.float(), **tol)
    torch.testing.assert_close(out_p.float(), ref_out.float(), **tol)
    torch.testing.assert_close(probs, ref_probs, rtol=1e-4, atol=1e-5)
    assert torch.equal(out, local_relation_attention(q, k, v, a_c, b_c, idx,
                                                     mask))
    assert torch.equal(probs, local_relation_attention_with_probs(
        q, k, v, a_c, b_c, idx, mask)[1])
    order, start = slot_order(idx, P_loc)
    plan = bank_runs(start, N)
    if layout == "one_slot":
        assert int(plan[:, 0, 0].min()) == N * N // RUN_CHUNK
    calls = []
    for banks in ((a_v, b_v), (a_v, b_v), (a_c, b_c)):
        junk = [torch.full((B, P_loc, 2, H, Dh), float("nan"), dtype=dtype,
                           device=card) for _ in range(2)]
        del junk
        calls.append(local_relation_attention_bwd(
            q, k, v, g, probs, *banks, idx, order, start, runs=plan))
    ref = local_relation_attention_bwd_reference(q, k, v, g, probs, a_v, b_v,
                                                 idx)
    torch.cuda.synchronize()
    used = torch.zeros(B, P_loc, dtype=torch.bool, device=card)
    used.scatter_(1, idx.long().flatten(1), True)
    for name, x, again, contig, y in zip(
            ("gq", "gk", "gv", "g_a_loc", "g_b_loc"), *calls, ref):
        assert x.dtype == dtype and torch.isfinite(x.float()).all(), name
        assert torch.equal(x, again) and torch.equal(x, contig), name
        torch.testing.assert_close(x.float(), y.float(), **tol, msg=name)
        if name.startswith("g_"):
            assert not used.all()
            assert torch.equal(x[~used], torch.zeros_like(x[~used])), name


@pytest.mark.cuda
def test_cuda_serving_goes_through_the_kernel(card):
    """A small f32 model serves a batch on the card: its encoder agrees
    with the same weights on the CPU to 1e-4 (two layers), decode_batch
    returns strings, and the kernel ran once per encoder layer."""
    from gtos_tpu_torch.data import batchify
    from gtos_tpu_torch.data.dataloader import preprocess
    from gtos_tpu_torch.data.extract import build_vocabs
    from gtos_tpu_torch.data.synthetic import synthetic_amr_corpus
    from gtos_tpu_torch.infer.decode import decode_batch
    from gtos_tpu_torch.models import Generator
    from gtos_tpu_torch.models.generator import batch_edges, batch_to_device
    from gtos_tpu_torch.utils.config import ModelConfig

    g, t = synthetic_amr_corpus(8, seed=4)
    tv, cv, rv, chv, lm = build_vocabs(g, t)
    batch = batchify(preprocess(g, t), tv, cv, rv, chv, lm,
                     for_train=False, build_local_banks=True)
    cfg = ModelConfig(token_vocab=len(tv), concept_vocab=len(cv),
                      relation_vocab=len(rv), char_vocab=len(chv),
                      d_model=64, d_ff=128, heads=4, enc_layers=2,
                      dec_layers=2, max_target_len=32, dropout=0.0,
                      attention_impl="pallas_local")
    models = {d: Generator(cfg, device=d) for d in ("cpu", "cuda")}

    def encode(m):
        a = batch_to_device(batch.arrays(), m.device)
        with torch.inference_mode():
            return m.encode(a["concept"], a["concept_char"],
                            a["concept_mask"], a["rel_bank"],
                            a["rel_length"], a["rel_index"],
                            edges=batch_edges(a)).cpu()

    torch.testing.assert_close(encode(models["cuda"]), encode(models["cpu"]),
                               rtol=1e-4, atol=1e-4)
    before = local_relation_attention.launches
    hyps = decode_batch(models["cuda"], batch, tv, beam_size=4, max_steps=8)
    assert local_relation_attention.launches == before + cfg.enc_layers
    assert len(hyps) == 8
    assert all(isinstance(w, str) for h in hyps for w in h)


@pytest.mark.cuda
def test_cuda_train_step_goes_through_b1p_and_b2(card):
    """One training forward and backward of a small f32 model (dropout 0)
    on the card: B1p and B2 launch once per encoder layer and B1 not at
    all; every encoder layer's q/k/v/rel projections get a non-zero
    gradient through the attention; the loss and every parameter gradient
    agree with the same weights on the CPU (plain versions) to 1e-4
    relative, 1e-6 absolute (f32 sums in another order)."""
    from gtos_tpu_torch.data import batchify
    from gtos_tpu_torch.data.dataloader import preprocess
    from gtos_tpu_torch.data.extract import build_vocabs
    from gtos_tpu_torch.data.synthetic import synthetic_amr_corpus
    from gtos_tpu_torch.models import Generator
    from gtos_tpu_torch.models.generator import batch_to_device
    from gtos_tpu_torch.utils.config import ModelConfig

    g, t = synthetic_amr_corpus(8, seed=5)
    tv, cv, rv, chv, lm = build_vocabs(g, t)
    batch = batchify(preprocess(g, t), tv, cv, rv, chv, lm, for_train=True,
                     build_local_banks=True)
    cfg = ModelConfig(token_vocab=len(tv), concept_vocab=len(cv),
                      relation_vocab=len(rv), char_vocab=len(chv),
                      d_model=64, d_ff=128, heads=4, enc_layers=2,
                      dec_layers=2, max_target_len=32, dropout=0.0,
                      label_smoothing=0.1, attention_impl="pallas_local")
    out = {}
    counts = (local_relation_attention.launches,
              local_relation_attention_with_probs.launches,
              local_relation_attention_bwd.launches)
    for dev in ("cpu", "cuda"):
        model = Generator(cfg, device=dev).train()
        names, params = zip(*model.named_parameters())
        loss, _ = model(batch_to_device(batch.arrays(), dev))
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        out[dev] = loss, dict(zip(names, grads))
    torch.cuda.synchronize()
    assert (local_relation_attention.launches,
            local_relation_attention_with_probs.launches,
            local_relation_attention_bwd.launches) == (
        counts[0], counts[1] + cfg.enc_layers, counts[2] + cfg.enc_layers)
    (cpu_loss, cpu_grads), (loss, grads) = out["cpu"], out["cuda"]
    torch.testing.assert_close(loss.cpu(), cpu_loss, rtol=1e-4, atol=1e-6)
    for i in range(cfg.enc_layers):
        for proj in ("q_proj", "k_proj", "v_proj", "rel_proj"):
            grad = grads[f"graph_transformer.layer{i}.self_attn.{proj}.weight"]
            assert grad is not None and grad.abs().sum() > 0, (i, proj)
    for name, grad in grads.items():
        torch.testing.assert_close(grad.cpu(), cpu_grads[name], rtol=1e-4,
                                   atol=1e-6, msg=name)


GLOBAL_CASES = [(2, 4, 16, 32, 128), (2, 4, 128, 32, 256),
                (16, 8, 32, 64, 4096), (8, 8, 128, 64, 2048)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [
    (torch.float32, dict(rtol=1e-4, atol=1e-4)),
    (torch.bfloat16, dict(rtol=2e-2, atol=3e-2)),
])
@pytest.mark.parametrize("B,H,N,Dh,P", GLOBAL_CASES)
def test_cuda_global_kernels_match_plain_versions(card, B, H, N, Dh, P,
                                                  dtype, tol):
    """B3 (from the tables), B3' (from the banks) and B4 (the backward)
    against their plain versions on the same card inputs, to B1's
    tolerances (f32 sums in another order; in bf16 one rounding of each
    output, the probabilities rounded before the product with v), each
    output also within the rtol of its plain version's own largest value
    (a training step's table gradients lie far below the atol; the two
    tables: of the larger of their two, `_table_scale`). Each call
    counts once (B4's two launches are one call), and B4 gives the same
    bits on a second call (no atomics)."""
    c = make_global_case(B, H, N, Dh, P)
    q, k, v, a, b, idx, mask = port_global_args(c, dtype, card)
    g = torch.from_numpy(c["g"]).to(card, dtype)
    t2, t3 = build_tables(q, k, a, b)
    rows, cols = walk_orders(idx)
    before = (fused_relation_attention.launches,
              fused_relation_attention_inline.launches,
              fused_relation_attention_bwd.launches)
    out = fused_relation_attention(q, k, v, t2, t3, idx, mask)
    out_inline = fused_relation_attention_inline(q, k, v, a, b, idx, mask)
    grads = fused_relation_attention_bwd(q, k, v, g, t2, t3, idx, mask, rows,
                                         cols)
    again = fused_relation_attention_bwd(q, k, v, g, t2, t3, idx, mask, rows,
                                         cols)
    torch.cuda.synchronize()
    assert (fused_relation_attention.launches,
            fused_relation_attention_inline.launches,
            fused_relation_attention_bwd.launches) == (
        before[0] + 1, before[1] + 1, before[2] + 2)
    torch.testing.assert_close(
        out.float(), fused_relation_attention_reference(
            q, k, v, t2, t3, idx, mask).float(), **tol)
    torch.testing.assert_close(
        out_inline.float(), fused_relation_attention_inline_reference(
            q, k, v, a, b, idx, mask).float(), **tol)
    ref = fused_relation_attention_bwd_reference(q, k, v, g, t2, t3, idx,
                                                 mask)
    top = _table_scale(ref)
    for name, x, y, z in zip(("gq", "gk", "gv", "g_t2", "g_t3"), grads, ref,
                             again):
        assert x.dtype == y.dtype and torch.isfinite(x.float()).all(), name
        torch.testing.assert_close(x.float(), y.float(), **tol, msg=name)
        assert _rel_to_largest(x, y, top.get(name)) <= tol["rtol"], name
        assert torch.equal(x, z), name
    for x, y in ((out, fused_relation_attention_reference(
            q, k, v, t2, t3, idx, mask)),
                 (out_inline, fused_relation_attention_inline_reference(
                     q, k, v, a, b, idx, mask))):
        assert _rel_to_largest(x, y) <= tol["rtol"]


def _rel_to_largest(x, ref, top=None):
    """The largest error of x against ref relative to ref's own largest
    magnitude, or to `top` where given."""
    if top is None:
        top = ref.float().abs().max().item()
    return (x.float() - ref.float()).abs().max().item() / max(top, 1e-30)


def _table_scale(ref):
    """The scale of B4's table gradients in _rel_to_largest: the larger of
    g_t2's and g_t3's largest values (as chip_smoke.py's b4_largest). Each
    row of ge sums to 0, so a table row whose pairs all share one bank row
    holds rounding noise only (every g_t2 row at P=1)."""
    top = max(ref[3].float().abs().max().item(),
              ref[4].float().abs().max().item())
    return {"g_t2": top, "g_t3": top}


# (B, H, N, Dh, P, layout) of the global-bank kernels' edge cases, as
# chip_smoke.py's GLOBAL_EDGES: "one_run" puts every pair of graph 0 on one
# bank row (each row and each column one run of N); "padded" pads each
# graph to N (pairs of padded nodes on row 0) and the last graph whole;
# "random" draws each pair's row. P=1001 is not a multiple of 8 (B4 stores
# its table-gradient rows a value at a time); at P=65536, the ladders'
# largest bank, B4 stages each dense row in many tiles (f32: 64)
GLOBAL_EDGE_CASES = {"one_run": (2, 8, 32, 64, 512, "one_run"),
                     "padded": (4, 8, 32, 64, 1024, "padded"),
                     "N1": (2, 8, 1, 64, 16, "random"),
                     "P1": (2, 8, 16, 64, 1, "random"),
                     "P1001": (2, 8, 32, 64, 1001, "random"),
                     "Dh32": (2, 8, 32, 32, 512, "random"),
                     "Dh128": (2, 8, 32, 128, 512, "random"),
                     "H12": (2, 12, 17, 64, 300, "random"),
                     "P65536": (1, 8, 16, 64, 65536, "random")}


def make_global_edge_case(B, H, N, Dh, P, layout, seed=0):
    """Seeded numpy inputs of B3'/B4: q, k, v, g [B, H, N, Dh], the bank
    projection ab [P, 2 H Dh], rel_index [B, N, N] and mask [B, N]."""
    rng = np.random.default_rng(seed)
    f = np.float32
    q, k, v, g = (rng.standard_normal((B, H, N, Dh)).astype(f)
                  for _ in range(4))
    ab = (rng.standard_normal((P, 2 * H * Dh)) * 0.5).astype(f)
    idx = rng.integers(0, P, (B, N, N))
    mask = np.ones((B, N), bool)
    if layout == "one_run":
        idx[0] = P // 2
    elif layout == "padded":
        for b in range(B):
            n = 0 if b == B - 1 else int(rng.integers(N // 2, N))
            mask[b, n:] = False
            idx[b, n:], idx[b, :, n:] = 0, 0
    return dict(q=q, k=k, v=v, g=g, ab=ab, idx=idx.astype(np.int32),
                mask=mask)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [
    (torch.float32, dict(rtol=1e-4, atol=1e-4)),
    (torch.bfloat16, dict(rtol=2e-2, atol=3e-2)),
])
@pytest.mark.parametrize("case", sorted(GLOBAL_EDGE_CASES))
def test_cuda_global_edge_cases(card, case, dtype, tol):
    """B3', B3 and B4 on GLOBAL_EDGE_CASES, the banks the two halves of one
    [P, 2 H Dh] tensor (split_banks, rows 2 H Dh apart), against their
    plain versions at test_cuda_global_kernels_match_plain_versions'
    tolerances, each output also within the rtol of its own largest value
    (the table gradients: of the larger of their two, `_table_scale`); B3'
    the same bits on the halves as on contiguous copies; B4 the
    same bits on a second call, its dense table gradients written in full
    (entries no pair refers to exactly 0) into memory that held NaN (the
    caching allocator hands the freed NaN blocks to the wrapper's
    torch.empty)."""
    B, H, N, Dh, P, layout = GLOBAL_EDGE_CASES[case]
    c = make_global_edge_case(B, H, N, Dh, P, layout)
    dev = lambda x: torch.from_numpy(x).to(card)  # noqa: E731
    q, k, v, g = (dev(c[n]).to(dtype) for n in "qkvg")
    ab, idx, mask = dev(c["ab"]).to(dtype), dev(c["idx"]), dev(c["mask"])
    a, b = split_banks(ab, H)
    out = fused_relation_attention_inline(q, k, v, a, b, idx, mask)
    assert torch.equal(out, fused_relation_attention_inline(
        q, k, v, a.contiguous(), b.contiguous(), idx, mask))
    t2, t3 = build_tables(q, k, a, b)
    out_t = fused_relation_attention(q, k, v, t2, t3, idx, mask)
    rows, cols = walk_orders(idx)
    calls = []
    for _ in range(2):
        junk = [torch.full((B, N, H, P), float("nan"), dtype=dtype,
                           device=card) for _ in range(2)]
        del junk
        calls.append(fused_relation_attention_bwd(q, k, v, g, t2, t3, idx,
                                                  mask, rows, cols))
    ref = fused_relation_attention_bwd_reference(q, k, v, g, t2, t3, idx,
                                                 mask)
    torch.cuda.synchronize()
    top = _table_scale(ref)
    pairs = [("out", out, fused_relation_attention_inline_reference(
                 q, k, v, a, b, idx, mask)),
             ("out_tables", out_t, fused_relation_attention_reference(
                 q, k, v, t2, t3, idx, mask)),
             *zip(("gq", "gk", "gv", "g_t2", "g_t3"), calls[0], ref)]
    for name, x, y in pairs:
        assert torch.isfinite(x.float()).all(), name
        torch.testing.assert_close(x.float(), y.float(), **tol, msg=name)
        assert _rel_to_largest(x, y, top.get(name)) <= tol["rtol"], name
    for x, again in zip(*calls):
        assert torch.equal(x, again)
    il = idx.long()
    for x, keys in ((calls[0][3], il), (calls[0][4], il.transpose(1, 2))):
        used = torch.zeros(B, N, P, dtype=torch.bool, device=card)
        used.scatter_(2, keys, True)
        if not used.all():
            assert torch.count_nonzero(x.permute(0, 1, 3, 2)[~used]) == 0


@pytest.mark.cuda
def test_cuda_pallas_train_step_goes_through_b3_and_b4(card):
    """One training forward and backward of a small f32 model (dropout 0,
    attention_impl "pallas") on the card: B3 or B3' launches once per
    encoder layer and B4 once per encoder layer, the localized kernels
    not at all; every encoder layer's q/k/v/rel projections get a non-zero
    gradient through the attention; the loss and every parameter gradient
    agree with the same weights on the CPU (plain versions) to 1e-4
    relative, 1e-6 absolute (f32 sums in another order)."""
    from gtos_tpu_torch.data import batchify
    from gtos_tpu_torch.data.dataloader import preprocess
    from gtos_tpu_torch.data.extract import build_vocabs
    from gtos_tpu_torch.data.synthetic import synthetic_amr_corpus
    from gtos_tpu_torch.models import Generator
    from gtos_tpu_torch.models.generator import batch_to_device
    from gtos_tpu_torch.utils.config import ModelConfig

    g, t = synthetic_amr_corpus(8, seed=5)
    tv, cv, rv, chv, lm = build_vocabs(g, t)
    batch = batchify(preprocess(g, t), tv, cv, rv, chv, lm, for_train=True)
    cfg = ModelConfig(token_vocab=len(tv), concept_vocab=len(cv),
                      relation_vocab=len(rv), char_vocab=len(chv),
                      d_model=64, d_ff=128, heads=4, enc_layers=2,
                      dec_layers=2, max_target_len=32, dropout=0.0,
                      label_smoothing=0.1, attention_impl="pallas")
    wrappers = (fused_relation_attention, fused_relation_attention_inline,
                fused_relation_attention_bwd, local_relation_attention,
                local_relation_attention_with_probs,
                local_relation_attention_bwd)
    counts = [w.launches for w in wrappers]
    out = {}
    for dev in ("cpu", "cuda"):
        model = Generator(cfg, device=dev).train()
        names, params = zip(*model.named_parameters())
        loss, _ = model(batch_to_device(batch.arrays(), dev))
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        out[dev] = loss, dict(zip(names, grads))
    torch.cuda.synchronize()
    delta = [w.launches - c for w, c in zip(wrappers, counts)]
    assert delta[0] + delta[1] == cfg.enc_layers
    assert delta[2:] == [cfg.enc_layers, 0, 0, 0]
    (cpu_loss, cpu_grads), (loss, grads) = out["cpu"], out["cuda"]
    torch.testing.assert_close(loss.cpu(), cpu_loss, rtol=1e-4, atol=1e-6)
    for i in range(cfg.enc_layers):
        for proj in ("q_proj", "k_proj", "v_proj", "rel_proj"):
            grad = grads[f"graph_transformer.layer{i}.self_attn.{proj}.weight"]
            assert grad is not None and grad.abs().sum() > 0, (i, proj)
    for name, grad in grads.items():
        torch.testing.assert_close(grad.cpu(), cpu_grads[name], rtol=1e-4,
                                   atol=1e-6, msg=name)


# block-sparse cases (B, H, N, Dh, P, p_pair, banded): the shapes and
# densities of tests/test_block_sparse.py, an N that is not a multiple of
# the tile, and a c5 width (H=8, Dh=64); then the backward kernels' edges
# (every case's last 20 rows keep no pair, so their slots' plane rows are
# empty): N=200 with Dh=64; Dh=128 (two 16-byte chunks a lane); Dh=24 at
# N=130 (three chunks a row, a last tile of 2 nodes); 32 graphs of 512
# nodes (16384 B6d/B6s blocks); H=12 (a B6d/B6s block covers 8 heads: a
# second block of heads, half its warps idle); and one graph of a real
# batch at khop 4 (p_pair "khop4": the port's batchify tile layout of a
# 410-510 node synthetic AMR graph)
BLOCK_CASES = [(2, 2, 128, 32, 200, 1.0, False),
               (2, 2, 256, 32, 200, 0.05, False),
               (1, 2, 300, 16, 100, 0.2, False),
               (1, 2, 512, 32, 150, 0.2, True),
               (2, 8, 256, 64, 3000, 0.1, False),
               (2, 2, 200, 64, 300, 0.1, False),
               (2, 4, 256, 128, 500, 0.1, False),
               (1, 2, 130, 24, 100, 0.3, False),
               (32, 8, 512, 64, 3000, 0.02, False),
               (1, 12, 256, 32, 300, 0.1, False),
               (1, 8, 512, 64, None, "khop4", False)]


def khop_block_case(H, Dh, seed=0):
    """make_block_case's arrays for one synthetic AMR graph of 410-510
    nodes batched by the port's batchify at node bucket 512 with
    sparse_khop 4 (the c5 tiles of a one-graph batch); P is its bank."""
    from gtos_tpu_torch.data import BucketSpec, batchify
    from gtos_tpu_torch.data.dataloader import preprocess
    from gtos_tpu_torch.data.extract import build_vocabs
    from gtos_tpu_torch.data.synthetic import synthetic_amr_corpus

    graphs, targets = synthetic_amr_corpus(1, seed=seed, min_nodes=410,
                                           max_nodes=510)
    spec = BucketSpec(nodes=(512,), bank=(4096, 8192, 16384, 32768, 65536),
                      edge_cells=(16384, 65536))
    batch = batchify(preprocess(graphs, targets),
                     *build_vocabs(graphs, targets), batch_size_bucket=1,
                     for_train=True, spec=spec, build_block_tiles=True,
                     sparse_khop=4)
    B, N = batch.concept_mask.shape
    P = batch.rel_bank.shape[0]
    rng = np.random.default_rng(seed)
    f = np.float32
    q, k, v, g = (rng.standard_normal((B, H, N, Dh)).astype(f)
                  for _ in range(4))
    a_bank, b_bank = ((rng.standard_normal((P, H, Dh)) * 0.5).astype(f)
                      for _ in range(2))
    return dict(q=q, k=k, v=v, g=g, a_bank=a_bank, b_bank=b_bank,
                tile_src=batch.tile_src, tile_rel=batch.tile_rel,
                tile_dst=batch.tile_dst, tile_rel_src=batch.tile_rel_src)


def make_block_case(B, H, N, Dh, P, p_pair, banded=False, seed=0, rows=None,
                    hot=0.0):
    """Seeded numpy inputs of the block-sparse attention: q, k, v, an output
    cotangent g, banks [P, H, Dh], rel_index [B, N, N] (bank rows drawn
    from [0, rows or P), a `hot` share of the pairs on row 0) and the
    kept-pair mask keep [B, N, N] (each pair with probability p_pair, the
    self pairs always; with banded, only the blocks of the tile diagonal
    band, as tests/test_block_sparse.py builds them; the last graph's last
    20 rows empty), and the packed tile layouts of the node bucket padded
    to the tile (tile_src, tile_rel, tile_dst, tile_rel_src)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    q, k, v, g = (rng.standard_normal((B, H, N, Dh)).astype(f)
                  for _ in range(4))
    a_bank, b_bank = ((rng.standard_normal((P, H, Dh)) * 0.5).astype(f)
                      for _ in range(2))
    rel_index = rng.integers(0, rows or P, (B, N, N)).astype(np.int32)
    rel_index[rng.random((B, N, N)) < hot] = 0
    keep = rng.random((B, N, N)) < p_pair
    if banded:
        t = np.arange(N) // TILE
        keep &= np.abs(t[:, None] - t[None, :])[None] <= 1
    keep[:, np.arange(N), np.arange(N)] = True
    keep[-1, N - 20:] = False
    Np = -(-N // TILE) * TILE
    kp = np.zeros((B, Np, Np), bool)
    kp[:, :N, :N] = keep
    rp = np.zeros((B, Np, Np), np.int32)
    rp[:, :N, :N] = rel_index
    ts, tr = pack_block_sparse(kp, rp)
    td, trs = pack_block_sparse_src(kp, rp)
    return dict(q=q, k=k, v=v, g=g, a_bank=a_bank, b_bank=b_bank,
                rel_index=rel_index, keep=keep, tile_src=ts, tile_rel=tr,
                tile_dst=td, tile_rel_src=trs)


def port_block_args(c, dtype=torch.float32, device="cpu"):
    """A block-sparse case as the kernels' arguments: (q, k, v, a_bank,
    b_bank, tile_src, tile_rel) in `dtype` on `device`, and the src-major
    layout (tile_dst, tile_rel_src) and the cotangent g."""
    dev = lambda x: torch.from_numpy(x).to(device=device, dtype=dtype)  # noqa
    idx = lambda x: torch.from_numpy(x).to(device)  # noqa: E731
    return ((*(dev(c[n]) for n in ("q", "k", "v", "a_bank", "b_bank")),
             idx(c["tile_src"]), idx(c["tile_rel"])),
            (idx(c["tile_dst"]), idx(c["tile_rel_src"])), dev(c["g"]))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [
    (torch.float32, dict(rtol=1e-4, atol=1e-4)),
    (torch.bfloat16, dict(rtol=2e-2, atol=3e-2)),
])
@pytest.mark.parametrize("B,H,N,Dh,P,p_pair,banded", BLOCK_CASES)
def test_cuda_block_sparse_kernels_match_plain_versions(
        card, B, H, N, Dh, P, p_pair, banded, dtype, tol):
    """B5, B5s, B6d, B6s and B6b against their plain versions on the same
    card inputs: outputs and gradients to 1e-4 in f32 and 3e-2 in bf16
    (sums in another order; the online softmax rounds its probabilities
    to bf16 against a running max), the statistics m, l to 1e-5 (f32 sums
    of the same f32 scores); the backward kernels give the same bits on a
    second launch (no atomics)."""
    case = (khop_block_case(H, Dh) if p_pair == "khop4"
            else make_block_case(B, H, N, Dh, P, p_pair, banded))
    args, (td, trs), g = port_block_args(case, dtype, card)
    q, k, v, a, b, ts, tr = args
    N, P = q.shape[2], a.shape[0]
    t4 = bank_t4(a, b)
    counts = [w.launches for w in (
        block_sparse_attention, block_sparse_attention_with_stats,
        block_sparse_attention_bwd_dst, block_sparse_attention_bwd_src,
        block_sparse_bank_grads)]
    out = block_sparse_attention(*args)
    out_s, m, l = block_sparse_attention_with_stats(*args)
    ref, m_ref, l_ref = block_sparse_attention_with_stats_reference(*args)
    torch.testing.assert_close(out.float(), ref.float(), **tol)
    assert torch.equal(out, out_s)
    torch.testing.assert_close(m, m_ref, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(l, l_ref, rtol=1e-4, atol=1e-5)
    gp, delta = prep_bwd_invariants(q, g, out)
    plan = backward_plan(ts, tr, td, trs, N, P, pair_capacity(tr))
    bwd = (q, k, v, a, b, t4, gp, m, l, delta)
    runs = []
    E = int(plan["E"])   # ge, pair_s: [H, E_cap], the first E columns real
    for _ in range(2):
        dst = block_sparse_attention_bwd_dst(*bwd, ts, tr, plan)
        runs.append((dst, block_sparse_attention_bwd_src(
            *bwd, td, trs, plan, dst[2])))
    banks = [block_sparse_bank_grads(q, k, a, b, dst[1], plan)
             for dst, _ in runs]
    runs = [((dq, ge[:, :E], ps[:, :E]), src)
            for (dq, ge, ps), src in runs]
    (dq, ge, _), (dk, dv) = runs[0]
    dq_ref, ge_ref = block_sparse_attention_bwd_dst_reference(*bwd, ts, tr)
    dk_ref, dv_ref = block_sparse_attention_bwd_src_reference(*bwd, td, trs)
    ga_ref, gb_ref = block_sparse_bank_grads_reference(q, k, a, b, ge_ref,
                                                       plan)
    torch.cuda.synchronize()
    assert ge.shape == ge_ref.shape == (H, E)
    for x, y in zip((dq, ge, dk, dv, *banks[0]),
                    (dq_ref, ge_ref, dk_ref, dv_ref, ga_ref, gb_ref)):
        assert x.dtype == y.dtype
        torch.testing.assert_close(x.float(), y.float(), **tol)
    for x, y in zip((*runs[0][0], *runs[0][1], *banks[0]),
                    (*runs[1][0], *runs[1][1], *banks[1])):
        assert torch.equal(x, y)
    after = [w.launches for w in (
        block_sparse_attention, block_sparse_attention_with_stats,
        block_sparse_attention_bwd_dst, block_sparse_attention_bwd_src,
        block_sparse_bank_grads)]
    assert [x - y for x, y in zip(after, counts)] == [1, 1, 2, 2, 2]


@pytest.mark.cuda
def test_cuda_block_sparse_train_step_and_serving(card):
    """A small f32 model under attention_impl "block_sparse" (4-hop pairs,
    dropout 0) on the card: a training forward and backward launches B5s,
    B6d, B6s and B6b once per encoder layer and B5 not at all, and its loss
    and every parameter gradient agree with the same weights on the CPU
    (plain versions) to 1e-4 relative, 1e-6 absolute; an encode without
    gradients launches B5 once per layer and nothing else."""
    from gtos_tpu_torch.data import BucketSpec, batchify
    from gtos_tpu_torch.data.dataloader import preprocess
    from gtos_tpu_torch.data.extract import build_vocabs
    from gtos_tpu_torch.data.synthetic import synthetic_amr_corpus
    from gtos_tpu_torch.models import Generator
    from gtos_tpu_torch.models.generator import batch_edges, batch_to_device
    from gtos_tpu_torch.utils.config import ModelConfig

    g, t = synthetic_amr_corpus(4, seed=5, min_nodes=100, max_nodes=140)
    tv, cv, rv, chv, lm = build_vocabs(g, t)
    batch = batchify(preprocess(g, t), tv, cv, rv, chv, lm, for_train=True,
                     spec=BucketSpec(nodes=(128, 256), bank=(4096, 8192)),
                     build_edges=True, build_block_tiles=True, sparse_khop=4)
    cfg = ModelConfig(token_vocab=len(tv), concept_vocab=len(cv),
                      relation_vocab=len(rv), char_vocab=len(chv),
                      d_model=64, d_ff=128, heads=4, enc_layers=2,
                      dec_layers=2, max_target_len=128, dropout=0.0,
                      label_smoothing=0.1, attention_impl="block_sparse",
                      sparse_khop=4)
    wrappers = (block_sparse_attention, block_sparse_attention_with_stats,
                block_sparse_attention_bwd_dst, block_sparse_attention_bwd_src,
                block_sparse_bank_grads)
    counts = [w.launches for w in wrappers]
    out = {}
    for dev in ("cpu", "cuda"):
        model = Generator(cfg, device=dev).train()
        names, params = zip(*model.named_parameters())
        loss, _ = model(batch_to_device(batch.arrays(), dev))
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        out[dev] = loss, dict(zip(names, grads))
    torch.cuda.synchronize()
    L = cfg.enc_layers
    assert [w.launches - c for w, c in zip(wrappers, counts)] == [0, L, L, L,
                                                                  L]
    (cpu_loss, cpu_grads), (loss, grads) = out["cpu"], out["cuda"]
    torch.testing.assert_close(loss.cpu(), cpu_loss, rtol=1e-4, atol=1e-6)
    for name, grad in grads.items():
        torch.testing.assert_close(grad.cpu(), cpu_grads[name], rtol=1e-4,
                                   atol=1e-6, msg=name)
    counts = [w.launches for w in wrappers]
    arrays = batch_to_device(batch.arrays(), "cuda")
    with torch.inference_mode():
        model.encode(arrays["concept"], arrays["concept_char"],
                     arrays["concept_mask"], arrays["rel_bank"],
                     arrays["rel_length"], arrays["rel_index"],
                     edges=batch_edges(arrays))
    torch.cuda.synchronize()
    assert [w.launches - c for w, c in zip(wrappers, counts)] == [L, 0, 0, 0,
                                                                  0]


# edge cases of the redesigned B5/B5s and B6b (B, H, N, Dh, P, p_pair,
# rows, hot): a bank row whose run spans many 256-pair chunks of B6b (half
# the kept pairs on row 0: ~6.6k pairs, 26 chunks); half the bank rows
# referenced by no pair; and a khop-0 (dense) node of N=1100 whose 9 slots
# overflow one round of the shared pair list (8 slots, one a head warp)
EDGE_CASES = {"long_run": (2, 8, 256, 64, 500, 0.2, None, 0.5),
              "unreferenced_rows": (2, 4, 256, 32, 3000, 0.1, 1500, 0.0),
              "dense_N1100": (1, 8, 1100, 16, 300, 1.0, None, 0.0)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [
    (torch.float32, dict(rtol=1e-4, atol=1e-4)),
    (torch.bfloat16, dict(rtol=2e-2, atol=3e-2)),
])
@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_cuda_block_sparse_edge_cases(card, case, dtype, tol):
    """B5s, B6d and B6b on the EDGE_CASES against their plain versions (as
    test_cuda_block_sparse_kernels_match_plain_versions); the dst rows with
    no kept pair (the last graph's last 20) give out 0, m -1e9 and l 0; B6b
    writes every bank row, the unreferenced ones as exactly 0, into
    gradients whose memory held NaN before (the card's caching allocator
    hands the freed NaN blocks to the wrapper's torch.empty), the same
    bits on a second launch."""
    B, H, N, Dh, P, p_pair, rows, hot = EDGE_CASES[case]
    c = make_block_case(B, H, N, Dh, P, p_pair, rows=rows, hot=hot)
    args, (td, trs), g = port_block_args(c, dtype, card)
    q, k, v, a, b, ts, tr = args
    t4 = bank_t4(a, b)
    out, m, l = block_sparse_attention_with_stats(*args)
    ref, m_ref, l_ref = block_sparse_attention_with_stats_reference(*args)
    torch.testing.assert_close(out.float(), ref.float(), **tol)
    torch.testing.assert_close(m, m_ref, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(l, l_ref, rtol=1e-4, atol=1e-5)
    empty = torch.from_numpy(~c["keep"].any(-1)).to(card)     # [B, N]
    assert int(empty.sum()) >= 20
    rows_out = out.transpose(1, 2)[empty]                      # [n, H, Dh]
    assert torch.equal(rows_out, torch.zeros_like(rows_out))
    assert bool((m.transpose(1, 2)[empty] == -1e9).all())
    assert bool((l.transpose(1, 2)[empty] == 0).all())
    plan = backward_plan(ts, tr, td, trs, N, P, pair_capacity(tr))
    gp, delta = prep_bwd_invariants(q, g, out)
    bwd = (q, k, v, a, b, t4, gp, m, l, delta)
    dq, ge, _ = block_sparse_attention_bwd_dst(*bwd, ts, tr, plan)
    dq_ref, ge_ref = block_sparse_attention_bwd_dst_reference(*bwd, ts, tr)
    torch.testing.assert_close(dq.float(), dq_ref.float(), **tol)
    banks = []
    for _ in range(2):
        junk = [torch.full_like(a, float("nan")) for _ in range(2)]
        del junk
        banks.append(block_sparse_bank_grads(q, k, a, b, ge, plan))
    refs = block_sparse_bank_grads_reference(q, k, a, b, ge, plan)
    torch.cuda.synchronize()
    used = plan["bank_used"].bool()
    if case == "long_run":
        n_multi = int(plan["bank_counts"][2])
        assert n_multi >= 1
        assert int(plan["bank_multi"][:n_multi, 1].max()) > 2
    if case == "unreferenced_rows":
        assert int((~used).sum()) >= P - rows
    for x, y, again in zip(banks[0], refs, banks[1]):
        assert x.dtype == y.dtype
        assert torch.equal(x, again)
        assert bool(torch.isfinite(x.float()).all())
        assert torch.equal(x[~used], torch.zeros_like(x[~used]))
        torch.testing.assert_close(x.float(), y.float(), **tol)


@pytest.mark.cuda
def test_cuda_timers_read_events_and_device_time(card):
    """utils/benchlib.py on the card: cold event samples of B2 (three
    launches) above its bound, the profiler's device time of each call
    (the kernels between two flushes) no more than the event window that
    holds it and its host gaps, and a reading below its bound refused."""
    from gtos_tpu_torch.utils import benchlib

    B, H, N, Dh, P, P_loc = CASES[0]
    q, k, v, a, b, idx, mask = port_local_args(
        make_case(B, H, N, Dh, P, P_loc), torch.bfloat16, card)
    g = torch.randn(q.shape, device=card)
    _, probs = local_relation_attention_with_probs(q, k, v, a, b, idx, mask)
    order, start = slot_order(idx, P_loc)
    runs = bank_runs(start, N)

    def b2():
        return local_relation_attention_bwd(q, k, v, g, probs, a, b, idx,
                                            order, start, runs=runs)

    bound_ms = benchlib.local_attention_bwd_bound(
        idx.cpu().numpy(), H, Dh, P_loc, "bfloat16")[0]
    events = benchlib.time_samples(b2, iters=20, cold=True,
                                   bound_s=bound_ms * 1e-3)
    device = benchlib.device_ms(b2, iters=10, bound_ms=bound_ms)
    assert events["n"] == 20 and device["n"] == 10
    assert 0 < device["median"] <= events["median"] * 1e3 * 1.05
    with pytest.raises(benchlib.ImpossibleReading):
        benchlib.time_samples(b2, iters=3, cold=True, bound_s=1.0)


def _small_train_setup(seed, dtype="float32", dropout=0.1,
                       impl="pallas_local"):
    """A 2+2-layer d=64 model config and a training batch of 8 synthetic
    graphs under `impl` ("block_sparse": tile layouts at k-hop 2)."""
    from gtos_tpu_torch.data import batchify
    from gtos_tpu_torch.data.dataloader import preprocess
    from gtos_tpu_torch.data.extract import build_vocabs
    from gtos_tpu_torch.data.synthetic import synthetic_amr_corpus
    from gtos_tpu_torch.utils.config import ModelConfig

    g, t = synthetic_amr_corpus(8, seed=seed)
    tv, cv, rv, chv, lm = build_vocabs(g, t)
    flags = (dict(build_block_tiles=True, sparse_khop=2)
             if impl == "block_sparse" else dict(build_local_banks=True))
    batch = batchify(preprocess(g, t), tv, cv, rv, chv, lm, for_train=True,
                     **flags)
    cfg = ModelConfig(token_vocab=len(tv), concept_vocab=len(cv),
                      relation_vocab=len(rv), char_vocab=len(chv),
                      d_model=64, d_ff=128, heads=4, enc_layers=2,
                      dec_layers=2, max_target_len=32, dropout=dropout,
                      label_smoothing=0.1, compute_dtype=dtype,
                      attention_impl=impl,
                      sparse_khop=2 if impl == "block_sparse" else 0)
    return cfg, batch


def _train_three(cfg, batch, compiled, mesh=None):
    from gtos_tpu_torch.models import Generator
    from gtos_tpu_torch.train.trainer import Trainer
    from gtos_tpu_torch.utils.config import TrainConfig

    model = Generator(cfg, device="cuda",
                      rng=torch.Generator().manual_seed(0))
    trainer = Trainer(model, cfg, TrainConfig(warmup_steps=2),
                      batch.arrays(), device="cuda", compiled=compiled,
                      mesh=mesh)
    arrays = trainer._put(batch.arrays())
    losses = torch.stack([trainer.train_step(arrays)["loss"]
                          for _ in range(3)]).cpu()
    return (losses, [p.detach().clone() for p in model.parameters()],
            model.dropout_rng.get_state(), trainer)


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["pallas_local", "block_sparse"])
def test_cuda_captured_train_steps_match_eager(card, impl):
    """Three Trainer steps on one batch (dropout 0.1, so the dropout
    generator is in the graph) on the CUDA graph (the first step runs
    uncaptured and captures, the others replay) against three uncaptured
    steps from the same start, all under deterministic algorithms (the
    default ones sum the char CNN's and the embeddings' gradients in no
    fixed order, and Adam makes a step of the learning rate of a last-bit
    change near 0): the losses and parameters as close as a second
    uncaptured run comes (twice its gap), and the dropout generator ends
    in the same state. Under "block_sparse" (the backward plan built
    inside the step): the captured run's losses, parameters, Adam's
    moments and count the same bits as the uncaptured run's; building the
    plan and an uncaptured step read nothing from the card
    (set_sync_debug_mode "error"); and B6b on the plan at the batch's
    pair capacity gives the same bits as on the plan padded to exactly E."""
    from gtos_tpu_torch.utils.benchlib import deterministic_algorithms

    cfg, batch = _small_train_setup(6, impl=impl)
    with deterministic_algorithms():
        e1, e2, got = (_train_three(cfg, batch, c)
                       for c in (False, False, None))
    assert got[3]._step.graphs.replays == 2
    assert torch.equal(got[2], e1[2]) and torch.equal(e2[2], e1[2])

    def gap(a, b):
        return max([(a[0] - b[0]).abs().max().item()]
                   + [(x - y).abs().max().item() for x, y in
                      zip(a[1], b[1])])

    assert gap(got, e1) <= 2 * gap(e2, e1)
    if impl == "block_sparse":
        assert torch.equal(got[0], e1[0])
        assert all(torch.equal(x, y) for x, y in zip(got[1], e1[1]))
        sg, se = got[3].opt.state, e1[3].opt.state
        assert int(sg["count"]) == int(se["count"]) == 3
        for key in ("mu", "nu"):
            assert all(torch.equal(x, y) for x, y in zip(sg[key], se[key]))
        _block_sparse_step_reads_nothing(cfg, batch)


def _block_sparse_step_reads_nothing(cfg, batch):
    """The plan and an uncaptured block_sparse step under sync debug
    "error", and B6b on the padded plan against the plan cut to E."""
    from gtos_tpu_torch.models.generator import batch_to_device
    from gtos_tpu_torch.ops.block_sparse_attention_bwd import pair_cap

    a = batch_to_device(batch.arrays(), "cuda")
    N, P = a["concept"].shape[1], a["rel_bank"].shape[0]
    layouts = (a["tile_src"], a["tile_rel"], a["tile_dst"],
               a["tile_rel_src"])
    *_, trainer = _train_three(cfg, batch, False)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        plan = backward_plan(*layouts, N, P, pair_cap(a))
        trainer.train_step(a)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    E = int(plan["E"])
    assert bool(plan["ok"]) and E <= plan["cap"]
    plan = backward_plan(*layouts, N, P, 2 * plan["cap"])   # padding, surely
    tight = backward_plan(*layouts, N, P, E)
    rng = torch.Generator(device="cuda").manual_seed(0)
    H, Dh = cfg.heads, cfg.d_model // cfg.heads
    q, k = (torch.randn(a["concept"].shape[0], H, N, Dh, device="cuda",
                        generator=rng) for _ in range(2))
    ab = [torch.randn(P, H, Dh, device="cuda", generator=rng)
          for _ in range(2)]
    ge = torch.randn(H, plan["cap"], device="cuda", generator=rng)
    got = block_sparse_bank_grads(q, k, *ab, ge, plan)
    want = block_sparse_bank_grads(q, k, *ab, ge[:, :E].contiguous(), tight)
    assert all(torch.equal(x, y) for x, y in zip(got, want))


@pytest.mark.cuda
def test_cuda_train_step_spans_show_the_capture_then_the_replay(card):
    """Under the profiler (host and card), a signature's first Trainer
    step records "gtos/graphs/first" and then "gtos/graphs/capture" inside
    its "gtos/train/step", and the next step on that signature exactly one
    "gtos/graphs/replay" inside its own (utils/graphs.py)."""
    from torch.profiler import ProfilerActivity, profile

    from gtos_tpu_torch.models import Generator
    from gtos_tpu_torch.train.trainer import Trainer
    from gtos_tpu_torch.utils.config import TrainConfig

    cfg, batch = _small_train_setup(6)
    model = Generator(cfg, device="cuda",
                      rng=torch.Generator().manual_seed(0))
    trainer = Trainer(model, cfg, TrainConfig(warmup_steps=2),
                      batch.arrays(), device="cuda")
    arrays = trainer._put(batch.arrays())
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trainer.train_step(arrays)
        trainer.train_step(arrays)
        torch.cuda.synchronize()
    spans = [(e.name(), e.start_ns(), e.end_ns())
             for e in prof.profiler.kineto_results.events()
             if e.name().startswith("gtos/")
             and str(e.device_type()) == "DeviceType.CPU"]

    def inside(step, name):
        return [s for s in spans
                if s[0] == name and step[1] <= s[1] and s[2] <= step[2]]

    steps = sorted((s for s in spans if s[0] == "gtos/train/step"),
                   key=lambda s: s[1])
    assert len(steps) == 2
    first = inside(steps[0], "gtos/graphs/first")
    capture = inside(steps[0], "gtos/graphs/capture")
    assert len(first) == 1 and len(capture) == 1
    assert first[0][2] <= capture[0][1]
    assert not inside(steps[0], "gtos/graphs/replay")
    assert len(inside(steps[1], "gtos/graphs/replay")) == 1
    assert not inside(steps[1], "gtos/graphs/first")
    assert trainer._step.graphs.replays == 1


@pytest.fixture
def nccl_mesh(card, tmp_path):
    """A data-parallel mesh of one NCCL rank (this process), destroyed
    after the test: its loss and gradient all-reduces run on the card."""
    import torch.distributed as dist

    from gtos_tpu_torch.parallel.mesh import init_distributed, make_mesh

    init_distributed(0, 1, f"file://{tmp_path / 'rdv'}", "cuda")
    try:
        yield make_mesh(dp=1)
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["pallas_local", "block_sparse"])
def test_cuda_captured_mesh_steps_match_uncaptured(nccl_mesh, impl):
    """On a one-rank NCCL mesh, three Trainer steps captured (the first
    call uncaptured and capturing, with the token-count, metric and
    gradient all-reduces inside the graph; two replays) against three
    uncaptured and three on one device with no mesh, dropout 0.1, under
    deterministic algorithms: the losses, parameters, Adam's moments and
    count and the dropout generator the same bits in all three; the step
    path "captured"; then the eval step, captured (a capture and a
    replay), gives the uncaptured eval step's metrics bit for bit."""
    from gtos_tpu_torch.train.trainer import check_metrics
    from gtos_tpu_torch.utils.benchlib import deterministic_algorithms

    cfg, batch = _small_train_setup(9, impl=impl)
    with deterministic_algorithms():
        runs = [_train_three(cfg, batch, c, m) for c, m in
                ((False, nccl_mesh), (None, nccl_mesh), (None, None))]
        evals = [[{k: v.clone() for k, v in
                   r[3]._eval_step(r[3]._put(batch.arrays())).items()}
                  for _ in range(2)] for r in runs[:2]]
    got = runs[1][3]
    assert got.step_path(batch.arrays()) == "captured"
    assert got._step.graphs.replays >= 2
    for r in (runs[0], runs[2]):
        assert torch.equal(r[0], runs[1][0])
        assert all(torch.equal(x, y) for x, y in zip(r[1], runs[1][1]))
        assert torch.equal(r[2], runs[1][2])
        for key in ("mu", "nu"):
            assert all(torch.equal(x, y) for x, y in
                       zip(r[3].opt.state[key], got.opt.state[key]))
        assert int(r[3].opt.state["count"]) == 3
    for m in (*evals[0], *evals[1]):
        check_metrics(m)
        assert all(torch.equal(m[k], evals[0][0][k]) for k in m)


@pytest.mark.cuda
def test_cuda_mesh_layout_mismatch_raises_when_read(nccl_mesh):
    """A captured block-sparse mesh step whose src-major tile layout holds
    none of the dst-major layout's pairs (the same signature: a replay)
    runs without a host read, and check_metrics raises LAYOUT_MISMATCH
    when its metrics are read."""
    from gtos_tpu_torch.ops.block_sparse_attention_bwd import LAYOUT_MISMATCH
    from gtos_tpu_torch.train.trainer import check_metrics

    cfg, batch = _small_train_setup(10, impl="block_sparse")
    *_, trainer = _train_three(cfg, batch, None, nccl_mesh)
    raw = batch.arrays()
    wrong = dict(raw, tile_rel_src=np.full_like(raw["tile_rel_src"], -1))
    replays = trainer._step.graphs.replays
    metrics = trainer.train_step(trainer._put(wrong))
    assert trainer._step.graphs.replays == replays + 1
    with pytest.raises(ValueError) as err:
        check_metrics(metrics)
    assert str(err.value) == LAYOUT_MISMATCH


@pytest.mark.cuda
def test_cuda_captured_c2_decode_matches_eager(card):
    """The c2 model at full width (configs/c2_amr2.json, bf16, random
    weights from seed 0) serves a batch of the bench's c2 requests on the
    CUDA graphs (captured, then replayed) and uncaptured: the same
    tokens, lengths and final t, and scores within 2^-17 of the largest
    score (a few f32 roundings of a sum of up to 64 log-probabilities:
    the copy mix's scatter-add sums colliding copy targets in no fixed
    order, so two uncaptured searches differ by a few ulps too)."""
    from gtos_tpu_torch.bench import configs, corpus, raw_corpus
    from gtos_tpu_torch.data import batchify
    from gtos_tpu_torch.data.dataloader import preprocess
    from gtos_tpu_torch.infer.decode import beam_decode_arrays
    from gtos_tpu_torch.models import Generator

    cfg, _ = configs("c2")
    vocabs = corpus("c2")[1]
    graphs, targets = raw_corpus("c2", seed=1, n=16)
    batch = batchify(preprocess(graphs, targets), *vocabs, for_train=False,
                     build_local_banks=True)
    model = Generator(cfg, device="cuda",
                      rng=torch.Generator().manual_seed(0))
    tv = vocabs[0]
    kw = dict(beam_size=8, max_steps=64, str_id=tv.str_id,
              end_id=tv.end_id, unk_id=tv.unk_id)
    eager = beam_decode_arrays(model, batch.arrays(), compiled=False, **kw)
    for _ in range(2):
        got = beam_decode_arrays(model, batch.arrays(), **kw)
        for field in ("seqs", "lengths", "steps"):
            assert torch.equal(getattr(got, field), getattr(eager, field))
        limit = 2.0 ** -17 * eager.scores.abs().max().item()
        assert (got.scores - eager.scores).abs().max().item() <= limit


@pytest.mark.cuda
def test_cuda_serving_after_a_replayed_step_uses_the_new_weights(card):
    """A bf16 model's train step replayed from its CUDA graph changes the
    parameters without moving their version counters; the serving copy
    after it is a new rounding of the new parameters."""
    from gtos_tpu_torch.models.generator import batch_to_device

    cfg, batch = _small_train_setup(7, dtype="bfloat16", dropout=0.0)
    *_, trainer = _train_three(cfg, batch, None)
    model = trainer.model
    before = model.serving_copy()
    trainer.train_step(batch_to_device(batch.arrays(), "cuda"))
    assert trainer._step.graphs.replays == 3
    after = model.serving_copy()
    assert after is not before
    for p, q in zip(model.parameters(), after.parameters()):
        assert torch.equal(q, p.detach().to(q.dtype))


@pytest.mark.cuda
def test_cuda_evaluate_and_search_after_captured_steps_run_in_eval_mode(
        card):
    """An f32 model with dropout (its serving copy is the model itself)
    on the CUDA graphs: train step, evaluate, train step, evaluate (the
    second evaluate replays), then a search of a batch shape not seen
    before, whose first call runs uncaptured: the dropout generator keeps
    its state through the evaluations and the search, and the search
    gives a fresh eval-mode model's tokens, lengths and final t with the
    same weights, scores within 2^-17 of the largest."""
    from gtos_tpu_torch.data import batchify
    from gtos_tpu_torch.data.dataloader import preprocess
    from gtos_tpu_torch.data.extract import build_vocabs
    from gtos_tpu_torch.data.synthetic import synthetic_amr_corpus
    from gtos_tpu_torch.infer.decode import beam_decode_arrays
    from gtos_tpu_torch.models import Generator
    from gtos_tpu_torch.models.generator import batch_to_device

    cfg, batch = _small_train_setup(8, dropout=0.2)
    *_, trainer = _train_three(cfg, batch, None)
    model = trainer.model
    arrays = batch_to_device(batch.arrays(), "cuda")
    for _ in range(2):
        trainer.train_step(arrays)
        rng = model.dropout_rng.get_state()
        trainer.evaluate([batch])
        assert not model.training
        assert torch.equal(model.dropout_rng.get_state(), rng)
    trainer.train_step(arrays)
    rng = model.dropout_rng.get_state()
    g, t = synthetic_amr_corpus(8, seed=8)
    tv, cv, rv, chv, lm = build_vocabs(g, t)
    serve = batchify(preprocess(g, t)[:5], tv, cv, rv, chv, lm,
                     for_train=False, build_local_banks=True).arrays()
    kw = dict(beam_size=4, max_steps=16, str_id=tv.str_id,
              end_id=tv.end_id, unk_id=tv.unk_id)
    got = beam_decode_arrays(model, serve, **kw)
    assert torch.equal(model.dropout_rng.get_state(), rng)
    fresh = Generator(cfg, device="cuda")
    fresh.load_state_dict(model.state_dict())
    ref = beam_decode_arrays(fresh, serve, **kw)
    for field in ("seqs", "lengths", "steps"):
        assert torch.equal(getattr(got, field), getattr(ref, field))
    limit = 2.0 ** -17 * ref.scores.abs().max().item()
    assert (got.scores - ref.scores).abs().max().item() <= limit


def _c4_feed_setup(dropout=0.1):
    """The c4 translator's shape at small widths (no copy, node positions,
    localized banks; dropout in the graph) and the training loader of 64
    dependency trees of 10-15 tokens in 256-token batches (4 an epoch,
    the first, second and fourth of one signature)."""
    from gtos_tpu_torch.data import DataLoader
    from gtos_tpu_torch.data.dataloader import preprocess
    from gtos_tpu_torch.data.extract import build_vocabs
    from gtos_tpu_torch.data.synthetic import synthetic_dependency_corpus
    from gtos_tpu_torch.utils.config import ModelConfig

    g, t = synthetic_dependency_corpus(64, seed=3, min_len=10, max_len=15)
    tv, cv, rv, chv, lm = build_vocabs(g, t)
    dl = DataLoader(preprocess(g, t), tv, cv, rv, chv, lm,
                    batch_size_tokens=256, for_train=True,
                    build_local_banks=True)
    cfg = ModelConfig(token_vocab=len(tv), concept_vocab=len(cv),
                      relation_vocab=len(rv), char_vocab=len(chv),
                      d_model=64, d_ff=128, heads=4, enc_layers=2,
                      dec_layers=2, max_target_len=32, dropout=dropout,
                      label_smoothing=0.1, use_copy=False,
                      use_node_positions=True, attention_impl="pallas_local")
    return cfg, dl


def _c4_trainer(cfg, example, **kw):
    from gtos_tpu_torch.models import Generator
    from gtos_tpu_torch.train.trainer import Trainer
    from gtos_tpu_torch.utils.config import TrainConfig

    model = Generator(cfg, device="cuda",
                      rng=torch.Generator().manual_seed(0))
    return Trainer(model, cfg, TrainConfig(warmup_steps=2, **kw), example,
                   device="cuda")


# card cycles of torch.cuda._sleep for about 50 ms (an H100 runs at up to
# 1.98 GHz)
SLEEP_50MS = 100_000_000


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["pallas_local", "block_sparse"])
def test_cuda_staged_copy_equals_batch_to_device(card, impl):
    """The training feed's staged copy (train/feed.py) of a batch with
    its pair capacity, waited for on the current stream: the keys,
    dtypes, shapes and values of batch_to_device's, bit for bit, and the
    same signature; the copy counted."""
    from gtos_tpu_torch.models.generator import batch_to_device
    from gtos_tpu_torch.ops.block_sparse_attention_bwd import with_pair_cap
    from gtos_tpu_torch.train.feed import StagedCopy

    if impl == "pallas_local":
        raw = next(iter(_c4_feed_setup()[1])).arrays()
    else:
        raw = _small_train_setup(6, impl=impl)[1].arrays()
    copy = StagedCopy("cuda")
    got = copy(with_pair_cap(raw))
    got.wait(torch.cuda.current_stream())
    want = batch_to_device(raw, "cuda")
    assert copy.batches == 1 and list(got) == list(want)
    for k, w in want.items():
        assert got[k].device == w.device and got[k].dtype == w.dtype, k
        assert got[k].shape == w.shape and torch.equal(got[k], w), k
    assert signature(got) == signature(want)


@pytest.mark.cuda
def test_cuda_held_back_staged_copies_give_the_synchronous_steps(card):
    """Two Trainers from one state: one signature captured on the first
    batch by each, then three replayed steps on three batches of that
    signature, one Trainer's through batch_to_device, the other's staged
    with its copy stream held ~100 ms by a sleep queued before each copy
    and the copy's device buffer left holding zeros, a batch with no
    tokens: the same metrics, bit for bit (deterministic algorithms), so
    each replay read its batch only after the copy landed."""
    from gtos_tpu_torch.ops.block_sparse_attention_bwd import with_pair_cap
    from gtos_tpu_torch.train.feed import layout
    from gtos_tpu_torch.utils.benchlib import deterministic_algorithms

    cfg, dl = _c4_feed_setup()
    batches = list(dl)
    dl.close()
    same = [batches[i] for i in (0, 1, 3, 0)]
    assert len({signature(b.arrays()) for b in same}) == 1
    with deterministic_algorithms():
        sync, staged = (_c4_trainer(cfg, same[0].arrays()) for _ in "ab")
        got, want = [], []
        for tr in (sync, staged):
            tr.train_step(tr._put(same[0].arrays()))
        copy = staged.staged_copy
        copy.stream = torch.cuda.Stream()
        for b in same[1:]:
            want.append(sync.train_step(sync._put(b.arrays())))
            size = layout(with_pair_cap(b.arrays()))[1]
            with torch.cuda.stream(copy.stream):
                junk = torch.zeros(size, dtype=torch.uint8, device="cuda")
            torch.cuda.synchronize()
            del junk        # the block the staged copy's buffer reuses
            with torch.cuda.stream(copy.stream):
                torch.cuda._sleep(2 * SLEEP_50MS)
            got.append(staged.train_step(staged._prep(b)[1]))
        torch.cuda.synchronize()
    assert copy.batches == 3 and staged._step.graphs.replays == 3
    for g, w in zip(got, want):
        assert float(w["n_tok"]) > 0
        for k in w:
            assert torch.equal(g[k], w[k]), k


@pytest.mark.cuda
def test_cuda_prep_does_not_wait_on_the_card(card):
    """With ~50 ms of sleep queued on the default stream, Trainer._prep
    (pack and staged copy) returns in under 20 ms, while the synchronous
    copy (_put) waits for the sleep."""
    import time

    cfg, dl = _c4_feed_setup()
    batch = next(iter(dl))
    dl.close()
    trainer = _c4_trainer(cfg, batch.arrays())
    trainer._prep(batch)                # the stream and the pinned pool
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_50MS)
    t0 = time.perf_counter()
    trainer._prep(batch)
    staged = time.perf_counter() - t0
    trainer._put(batch.arrays())
    sync = time.perf_counter() - t0
    torch.cuda.synchronize()
    assert staged < 0.020 and sync >= 0.040, (staged, sync)


@pytest.mark.cuda
def test_cuda_fit_stages_every_step(card):
    """Trainer.fit on the card over one epoch (4 batches, prefetch 2):
    every step's batch went through the staged copy, and the loss is
    finite."""
    cfg, dl = _c4_feed_setup()
    example = next(iter(dl)).arrays()
    assert len(dl) == 4
    trainer = _c4_trainer(cfg, example, total_steps=4)
    try:
        last = trainer.fit(dl, log_every=1)
    finally:
        dl.close()
    assert trainer.step == 4 == trainer.staged_copy.batches
    assert np.isfinite(last["loss"])


@pytest.mark.cuda
def test_cuda_fit_reads_a_step_without_waiting_for_later_ones(card):
    """A Trainer step, then ~50 ms of sleep queued on the default stream
    behind it: fit's read of that step's metrics (Trainer._reading with
    its step_done) returns before the sleep ends, with the loss a read on
    the default stream gives afterwards."""
    import time

    cfg, dl = _c4_feed_setup()
    batch = next(iter(dl))
    dl.close()
    trainer = _c4_trainer(cfg, batch.arrays())
    trainer.train_step(trainer._prep(batch)[1])        # the capture
    torch.cuda.synchronize()
    m = trainer.train_step(trainer._prep(batch)[1])     # a replay
    done = trainer.step_done
    torch.cuda._sleep(SLEEP_50MS)
    t0 = time.perf_counter()
    with trainer._reading(done):
        loss = float(m["loss"])
    read = time.perf_counter() - t0
    torch.cuda.synchronize()
    waited = time.perf_counter() - t0
    assert read < 0.020 and waited >= 0.040, (read, waited)
    assert loss == float(m["loss"]) and np.isfinite(loss)
