"""The port's search (infer/beam.py) and plain attention helpers
(models/components.py) against the JAX package's, on the CPU, without a
model: a step function made from a seeded table of log-probabilities that
are multiples of 1/4, so that sums are exact in f32 in both frameworks
and ties are real (equal candidates, and dead beams at -1e9). A per-beam
state in the cache makes the step depend on the beam's history, so a
wrong reorder changes the tokens."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtos_tpu.infer import beam as jax_beam
from gtos_tpu.models import components as jax_components
from gtos_tpu_torch.infer import beam
from gtos_tpu_torch.models import components

torch.set_num_threads(2)

T, V_TOK, V_EXT, B = 10, 7, 9, 3
IDS = dict(str_id=2, end_id=3, unk_id=1)


def _table(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(-12, 1, (T, V_TOK, V_EXT)) / 4).astype(np.float32)


def _steps(table):
    jt, pt = jnp.asarray(table), torch.from_numpy(table)

    def jax_step(tokens, pos, caches):
        s = caches["s"] + tokens
        return jt[pos, tokens] + 0.25 * (s % 3)[:, None], {"s": s}

    def port_step(tokens, pos, caches):
        s = caches["s"] + tokens
        return pt[pos, tokens] + 0.25 * (s % 3)[:, None], {"s": s}

    return jax_step, port_step


@pytest.mark.parametrize("K,alpha,seed", [(1, 0.0, 0), (2, 0.6, 1),
                                          (4, 0.6, 2), (4, 1.0, 3)])
def test_beam_search_matches_jax(K, alpha, seed):
    """Token-identical sequences, equal lengths and scores, with the
    default reorder of every cache leaf and copy ids fed back as UNK."""
    jax_step, port_step = _steps(_table(seed))
    ref = jax_beam.beam_search(
        jax_step, {"s": jnp.zeros(B * K, jnp.int32)}, B, K, T - 1, V_EXT,
        V_TOK, alpha=alpha, **IDS)
    out = beam.beam_search(
        port_step, {"s": torch.zeros(B * K, dtype=torch.int64)}, B, K,
        T - 1, V_EXT, V_TOK, alpha=alpha, device="cpu", **IDS)
    np.testing.assert_array_equal(out.seqs.numpy(), np.asarray(ref.seqs))
    np.testing.assert_array_equal(out.lengths.numpy(),
                                  np.asarray(ref.lengths))
    np.testing.assert_allclose(out.scores.numpy(), np.asarray(ref.scores),
                               rtol=1e-6, atol=1e-6)


def test_greedy_search_matches_jax():
    jax_step, port_step = _steps(_table(4))
    ref = jax_beam.greedy_search(jax_step, {"s": jnp.zeros(B, jnp.int32)},
                                 B, T - 1, V_EXT, V_TOK, **IDS)
    out = beam.greedy_search(port_step, {"s": torch.zeros(B, dtype=torch.int64)},
                             B, T - 1, V_EXT, V_TOK, device="cpu", **IDS)
    np.testing.assert_array_equal(out.seqs.numpy(), np.asarray(ref.seqs))
    np.testing.assert_array_equal(out.lengths.numpy(),
                                  np.asarray(ref.lengths))


def test_tile_for_beams_and_detokenize_match_jax():
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    tree = {"a": x, "b": [x[:, :2], x[:, 0]]}
    ref = jax_beam.tile_for_beams(tree, 3)
    out = beam.tile_for_beams({"a": torch.from_numpy(x),
                               "b": [torch.from_numpy(x[:, :2]),
                                     torch.from_numpy(x[:, 0])]}, 3)
    np.testing.assert_array_equal(out["a"].numpy(), np.asarray(ref["a"]))
    for o, r in zip(out["b"], ref["b"]):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    itos = ["<pad>", "<unk>", "<s>", "</s>", "boy", "go"]
    seq = [2, 4, 6, 5, 7, 9, 3, 4]
    assert (beam.detokenize(seq, itos, ["Ann", "Bo"], end_id=3)
            == jax_beam.detokenize(seq, itos, ["Ann", "Bo"], end_id=3)
            == ["boy", "Ann", "go", "Bo", "<UNK>"])


@pytest.mark.parametrize("dim", [8, 9])
def test_positions_and_masks_match_jax(dim):
    np.testing.assert_allclose(
        components.sinusoidal_positions(12, dim).numpy(),
        np.asarray(jax_components.sinusoidal_positions(12, dim)),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(components.causal_mask(5).numpy(),
                                  np.asarray(jax_components.causal_mask(5)))


def test_attend_matches_jax():
    """Scaled dot-product attention with a causal mask, f32 softmax;
    tolerance 1e-6 (one f32 product and a softmax)."""
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((2, 3, 5, 8)).astype(np.float32)
               for _ in range(3))
    mask = np.asarray(jax_components.causal_mask(5))
    ref_out, ref_p = jax_components.attend(q, k, v, mask)
    out, p = components.attend(*(torch.from_numpy(a) for a in (q, k, v)),
                               components.causal_mask(5))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(p.numpy(), np.asarray(ref_p), rtol=1e-6,
                               atol=1e-6)
