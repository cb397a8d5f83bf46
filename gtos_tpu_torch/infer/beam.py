"""Batched beam search.

Port of gtos_tpu/infer/beam.py, whose search is one `lax.while_loop`
under `jax.jit`. Here the loop's state is one set of tensors that each
step rewrites in place (`Search`), so that one CUDA graph of the step
(utils/graphs.py) serves every step of a search and every search of the
same shapes:

  * beams are flattened into the batch dimension (B*K), so every decode
    step is one batched forward;
  * the caches are reordered by the previous step's parents at the START
    of the next step (only the per-beam leaves, via reorder_fn). The
    search keeps two sets of cache tensors and each step gathers from one
    into the other, by the step's parity, so that no step copies them
    back (a CUDA graph per parity);
  * finished hypotheses live in a fixed-size pool merged by top-k each
    step, with GNMT length normalization;
  * the position `t` is a tensor on the card, and so is the JAX loop's
    `cond` (t < max_steps and some alive beam can still beat the worst
    finished score): each step computes it, and a step taken once it is
    false changes no state buffer (`torch.where` on each, `t` included),
    so steps replayed past the end leave tokens, scores, lengths and the
    final `t` as the JAX loop leaves them. The host reads the flag LAG
    steps late, through pinned memory and an event on the card, so the
    card always has steps queued (at most LAG - 1 of them past the end).
    The CPU runs the same loop; its copy of the flag is synchronous, so
    there it is current when read. `Search.launched_steps` counts the
    steps every search of the process has launched; each launch is the
    span "gtos/search/step" and each wait for the flag
    "gtos/search/wait_flag" (utils/profiling.py).

Top-k keeps `jax.lax.top_k`'s order on ties (lower index first) by a
stable descending sort; dead beams tie at -1e9, so this matters for token
equality with the JAX package. Copy-extended ids (>= token_vocab) are fed
back as UNK.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

from gtos_tpu_torch.utils.device import resolve_device
from gtos_tpu_torch.utils.profiling import annotate

NEG_INF = -1e9
# steps the host reads the end-of-search flag behind the card
LAG = 3


@dataclasses.dataclass
class BeamResult:
    """seqs: [B, K, Tmax+1] ext-vocab ids (position 0 is STR; END included);
    scores: [B, K] length-normalized log-probs, best first;
    lengths: [B, K] number of emitted tokens incl. END;
    steps: the final t, the number of steps the search took (0-d)."""

    seqs: torch.Tensor
    scores: torch.Tensor
    lengths: torch.Tensor
    steps: Optional[torch.Tensor] = None


def _length_penalty(length: torch.Tensor, alpha: float) -> torch.Tensor:
    # GNMT-style normalization ((5 + len) / 6)^alpha in f32, as the JAX
    # package computes it; alpha=0 -> pure logp.
    return ((5.0 + length) / 6.0) ** alpha


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top k along the last axis, ties in index order (jax.lax.top_k)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, M, ...] rows picked along axis 1 by idx [B, K]."""
    idx = idx.reshape(*idx.shape, *([1] * (x.dim() - 2)))
    return torch.gather(x, 1, idx.expand(*idx.shape[:2], *x.shape[2:]))


def _gather_all(caches, flat_parent, out):
    for src, dst in zip(_leaves(caches), _leaves(out)):
        torch.index_select(src, 0, flat_parent, out=dst)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def write_back(static, new):
    """Copy each leaf of `new` into the same leaf of `static` (the
    search's own cache tensors), skipping leaves that are already it."""
    for a, b in zip(_leaves(static), _leaves(new)):
        if b is not a:
            a.copy_(b)


class Search:
    """The state of one batched beam search as tensors on `device` that
    each step rewrites in place: t, alive_logp, alive_seq, fin_seq,
    fin_scores, fin_len, parent, the flag `go` (the JAX loop's cond for
    the next step) and its host copy `flag` (pinned on the card).
    `caches` (two sets of the caller's cache tensors with leading dim B*K,
    rewritten in place; one set, twice, for K = 1), `step_fn` and
    `reorder_fn` are set before the first step. step_fn(tokens [B*K]
    int64, pos (0-d int64), caches) -> (log_probs [B*K, ext_vocab] f32,
    caches); reorder_fn(caches, flat_parent [B*K] int64, out) writes the
    reordered per-beam leaves of `caches` into `out` (default: every
    leaf; leaves the two sets share are left as they are)."""

    # steps launched by `run`, summed over every search of the process
    launched_steps = 0

    def __init__(self, batch_size: int, beam_size: int, max_steps: int,
                 ext_vocab: int, token_vocab: int, str_id: int, end_id: int,
                 unk_id: int, alpha: float = 0.6, device=None):
        self.dev = dev = torch.device(device)
        self.B, self.K, self.V, self.Tmax = (batch_size, beam_size,
                                             ext_vocab, max_steps)
        self.token_vocab, self.str_id, self.end_id, self.unk_id = (
            token_vocab, str_id, end_id, unk_id)
        self.alpha = alpha
        B, K, T = batch_size, beam_size, max_steps
        i64, f32 = torch.int64, torch.float32
        self.t = torch.zeros((), dtype=i64, device=dev)
        self.alive_seq = torch.zeros(B, K, T + 1, dtype=i64, device=dev)
        self.alive_logp = torch.zeros(B, K, dtype=f32, device=dev)
        self.fin_seq = torch.zeros(B, K, T + 1, dtype=i64, device=dev)
        self.fin_scores = torch.zeros(B, K, dtype=f32, device=dev)
        self.fin_len = torch.zeros(B, K, dtype=i64, device=dev)
        self.parent = torch.zeros(B, K, dtype=i64, device=dev)
        self.go = torch.zeros((), dtype=torch.bool, device=dev)
        self.flag = torch.zeros((), dtype=torch.bool,
                                pin_memory=dev.type == "cuda")
        self.base = (torch.arange(B, device=dev) * K)[:, None]
        self.beams = torch.arange(K, device=dev).repeat(B, 1)
        self.best_bound = _length_penalty(
            torch.tensor(float(T), dtype=f32, device=dev), alpha)
        self.caches = None
        self.step_fn = self.reorder_fn = None

    def reset(self):
        """The state before the first step, written in place."""
        self.t.zero_()
        self.alive_seq.zero_()
        self.alive_seq[:, :, 0] = self.str_id
        # only beam 0 is live at t=0 (all beams hold identical state)
        self.alive_logp.fill_(NEG_INF)
        self.alive_logp[:, 0] = 0.0
        self.fin_seq.zero_()
        self.fin_scores.fill_(NEG_INF)
        self.fin_len.zero_()
        self.parent.copy_(self.beams)
        self.go.copy_(self._cond())

    def _cond(self):
        """The JAX loop's cond: t < max_steps and the best score an alive
        beam could still reach (no further logp decrease, maximal length
        normalization at alpha >= 0) beats the worst finished one."""
        best_alive = self.alive_logp.max(-1).values / self.best_bound
        improving = (best_alive > self.fin_scores.min(-1).values).any()
        return (self.t < self.Tmax) & improving

    def parity(self, s: int) -> int:
        """Which cache set step s reads (K = 1 has one set)."""
        return s % 2 if self.K > 1 else 0

    def step(self, parity: int = 0):
        """One step of the JAX loop's body where `go` holds, else a step
        that leaves every state buffer as it is; then `go` for the next
        step. It reads cache set `parity` and, when K > 1, leaves the
        caches in the other set."""
        B, K, V, T = self.B, self.K, self.V, self.Tmax
        t, caches = self.t, self.caches[parity]
        if K > 1:
            # apply the PREVIOUS step's re-ranking to the caches now
            out = self.caches[1 - parity]
            self.reorder_fn(caches, (self.base + self.parent).reshape(-1),
                            out)
            caches = out
        static = caches
        tok_t = self.alive_seq.index_select(2, t.reshape(1)).reshape(B * K)
        tok_t = torch.where(tok_t >= self.token_vocab, self.unk_id, tok_t)
        # a step past the end (t == T) is discarded: its position only
        # has to lie inside the caches
        logp, caches = self.step_fn(tok_t, t.clamp_max(T - 1), caches)
        write_back(static, caches)
        cand = self.alive_logp[:, :, None] + logp.reshape(B, K, V).float()
        topv, topi = _top_k(cand.reshape(B, K * V), 2 * K)
        cand_parent = topi // V
        tok = topi % V
        is_end = tok == self.end_id

        # candidate sequences [B, 2K, Tmax+1]
        seqs = _take(self.alive_seq, cand_parent)
        seqs.index_copy_(2, (t + 1).clamp_max(T).reshape(1), tok[..., None])

        # ---- merge finished candidates into the pool ----
        norm = topv / _length_penalty((t + 1).float(), self.alpha)
        all_scores = torch.cat(
            [self.fin_scores, torch.where(is_end, norm, NEG_INF)], dim=1)
        fin_scores, fi = _top_k(all_scores, K)
        fin_seq = _take(torch.cat([self.fin_seq, seqs], dim=1), fi)
        fin_len = torch.gather(torch.cat(
            [self.fin_len, (t + 1).expand(B, 2 * K)], dim=1), 1, fi)

        # ---- keep top-K non-finished as the new alive set ----
        alive_logp, ai = _top_k(torch.where(is_end, NEG_INF, topv), K)
        alive_seq = _take(seqs, ai)
        parent = torch.gather(cand_parent, 1, ai)  # applied next step
        go = self.go
        for buf, new in ((self.fin_scores, fin_scores),
                         (self.fin_seq, fin_seq), (self.fin_len, fin_len),
                         (self.alive_logp, alive_logp),
                         (self.alive_seq, alive_seq), (self.parent, parent),
                         (self.t, t + 1)):
            buf.copy_(torch.where(go, new, buf))
        go.copy_(go & self._cond())

    def result(self) -> BeamResult:
        """The search's answer, from its state (new tensors)."""
        t = self.t
        # fall back to alive beams where nothing finished
        alive_norm = self.alive_logp / _length_penalty(t.float(), self.alpha)
        no_fin = self.fin_scores <= NEG_INF / 2
        final_scores = torch.where(no_fin, alive_norm, self.fin_scores)
        final_seq = torch.where(no_fin[:, :, None], self.alive_seq,
                                self.fin_seq)
        final_len = torch.where(no_fin, t, self.fin_len)
        order = torch.argsort(-final_scores, dim=1, stable=True)
        return BeamResult(seqs=_take(final_seq, order),
                          scores=torch.gather(final_scores, 1, order),
                          lengths=torch.gather(final_len, 1, order),
                          steps=t.clone())

    def run(self, step: Callable[[int], Any]):
        """Call `step(parity)` (this search's step, or a replay of its
        graph for that parity) until the host learns that the search has
        ended, or max_steps times. The host reads the flag LAG steps
        behind (module docstring): the first LAG steps always run."""
        cuda = self.dev.type == "cuda"
        lag = LAG
        done = [None] * lag     # per ring slot: the step's event
        launched = 0
        for s in range(self.Tmax):
            if s >= lag:
                with annotate("gtos/search/wait_flag"):
                    ev = done[s % lag]
                    if ev is not None:
                        ev.synchronize()
                    # the flag was copied by step s - lag or a later one:
                    # it only ever turns false
                    go = bool(self.flag)
                if not go:
                    break
            with annotate("gtos/search/step"):
                step(self.parity(s))
            launched += 1
            self.flag.copy_(self.go, non_blocking=cuda)
            if cuda:
                done[s % lag] = torch.cuda.Event()
                done[s % lag].record()
        Search.launched_steps += launched


def beam_search(
    step_fn: Callable[[torch.Tensor, torch.Tensor, Any],
                      Tuple[torch.Tensor, Any]],
    init_caches: Any,
    batch_size: int,
    beam_size: int,
    max_steps: int,
    ext_vocab: int,
    token_vocab: int,
    str_id: int,
    end_id: int,
    unk_id: int,
    alpha: float = 0.6,
    reorder_fn: Callable[[Any, torch.Tensor, Any], None] | None = None,
    device=None,
) -> BeamResult:
    """Run batched beam search on `device` (the CUDA card unless given),
    uncaptured (infer/decode.py runs the same `Search` with its step in a
    CUDA graph).

    step_fn(tokens [B*K] int64, pos 0-d int64 tensor, caches) ->
        (log_probs [B*K, ext_vocab] f32, new_caches)
    init_caches: caches with leading dim B*K (memory tiled per beam); the
    search keeps copies (two sets when K > 1) and writes each step's
    caches into them.
    reorder_fn(caches, flat_parent [B*K] int64, out): writes the per-beam
    state permuted for the re-ranked beams into the other set `out`;
    defaults to every leaf. Callers whose caches hold beam-invariant
    leaves (the decoder's memory K/V) should skip them and share them
    between the sets."""
    dev = resolve_device(device)
    search = Search(batch_size, beam_size, max_steps, ext_vocab,
                    token_vocab, str_id, end_id, unk_id, alpha, dev)
    first = _clone(init_caches)
    search.caches = [first, _clone(init_caches) if beam_size > 1 else first]
    search.step_fn = step_fn
    search.reorder_fn = reorder_fn or _gather_all
    search.reset()
    search.run(search.step)
    return search.result()


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone(v) for v in tree)
    return tree.clone()


def greedy_search(step_fn, init_caches, batch_size, max_steps, ext_vocab,
                  token_vocab, str_id, end_id, unk_id, device=None):
    """Greedy decode = beam_search with K=1, alpha=0."""
    return beam_search(
        step_fn, init_caches, batch_size, 1, max_steps, ext_vocab,
        token_vocab, str_id, end_id, unk_id, alpha=0.0, device=device)


def tile_for_beams(tree, beam_size: int):
    """Repeat every leaf's batch dim K times: [B, ...] -> [B*K, ...]."""
    if isinstance(tree, dict):
        return {k: tile_for_beams(v, beam_size) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tile_for_beams(v, beam_size) for v in tree)
    return tree.repeat_interleave(beam_size, dim=0)


def detokenize(seq, token_itos, oov_list, end_id):
    """Host-side: ext-vocab id sequence -> list of token strings.

    seq: [T+1] ids (position 0 = STR); oov_list: this instance's OOV
    strings (ids >= len(token_itos) index into it)."""
    V = len(token_itos)
    out = []
    for idx in list(seq)[1:]:
        idx = int(idx)
        if idx == end_id:
            break
        if idx >= V:
            j = idx - V
            out.append(oov_list[j] if j < len(oov_list) else "<UNK>")
        else:
            out.append(token_itos[idx])
    return out
