"""The plain reference of the graph-to-sequence model: Cai & Lam's Graph
Transformer (arXiv:1911.07470) as the configurations state it, in plain
torch and float32, with no kernel, cache, batching or capture. It imports
nothing of the program.

A model is a dict of parameters, name -> tensor, whose names and shapes
`param_spec` states; the benchmark makes the values (`init_weights`) and
gives the same ones to the program. The forward pass takes one batch's
arrays as the program's loader lays them out (node 0 the global node, a
batch-wide bank of relation paths and each pair's row in it):

  token encoder   concept embedding and a char CNN ("SAME" convolutions,
                  max-pooled over each word's real chars), merged by a
                  dense layer, sinusoidal node positions on the translator
                  path, LayerNorm, dropout
  relation GRU    a bidirectional GRU over each bank row's label path, the
                  carry frozen past the path's length; a dense layer of
                  both last carries; pad rows zero
  graph layers    post-LN layers of relation-aware attention over every
                  node pair, e_ij = (q_i + a_ij).(k_j + b_ij) / sqrt(Dh)
                  with a_ij, b_ij the two halves of a dense layer of the
                  pair's relation vector, gathered per pair here; then the
                  FFN; padded nodes zeroed at the end
  decoder         post-LN transformer layers (causal self-attention,
                  cross-attention on the nodes, FFN); the output layer tied
                  to the token embedding
  copy            P(w) = g P_vocab(w) + (1 - g) sum_i alpha_i [cp_i = w],
                  alpha the last layer's cross-attention averaged over its
                  heads and renormalised over copyable nodes
  loss            token NLL over the extended vocabulary, label-smoothed
                  over the token vocabulary, averaged over target tokens

Dropout (training) keeps an element where a uniform draw is below 1 - p
and scales it by 1 / (1 - p). The draws come from a torch.Generator, one
uniform tensor per dropout site of the activation's shape, in the order
of the layers above; given the generator the program's dropout starts
from, the two draw the same masks.

precision "fp8" is the control: every matrix product's operands and
result, every embedding row and every LayerNorm output (and in training
their cotangents) rounded to float8 (e4m3 forward, e5m2 backward) with a
per-tensor scale; softmax, the GRU's gates and the loss as in float32.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

NEG_INF = -1e9
EPS = 1e-9
LN_EPS = 1e-6


# ---------------------------------------------------------------- params


def param_spec(cfg: dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of every parameter, in a fixed order. cfg: the
    model's sizes (d_model, d_ff, heads, enc_layers, dec_layers, char_dim,
    char_filters, char_widths, rel_emb_dim, rel_hidden, use_copy) and
    vocabulary sizes (token_vocab, concept_vocab, relation_vocab,
    char_vocab)."""
    D, F_, Hr = cfg["d_model"], cfg["d_ff"], cfg["rel_hidden"]
    spec = []

    def dense(name, n_in, n_out):
        spec.extend([(f"{name}.weight", (n_out, n_in)),
                     (f"{name}.bias", (n_out,))])

    def ln(name):
        spec.extend([(f"{name}.weight", (D,)), (f"{name}.bias", (D,))])

    te = "token_encoder"
    spec.append((f"{te}.embed.weight", (cfg["concept_vocab"], D)))
    spec.append((f"{te}.char_cnn.char_embed.weight",
                 (cfg["char_vocab"], cfg["char_dim"])))
    for w in cfg["char_widths"]:
        spec.extend([(f"{te}.char_cnn.conv{w}.weight",
                      (cfg["char_filters"], cfg["char_dim"], w)),
                     (f"{te}.char_cnn.conv{w}.bias", (cfg["char_filters"],))])
    dense(f"{te}.char_cnn.char_proj",
          cfg["char_filters"] * len(cfg["char_widths"]), D)
    dense(f"{te}.merge", 2 * D, D)
    ln(f"{te}.ln")
    re = "relation_encoder"
    spec.append((f"{re}.rel_embed.weight",
                 (cfg["relation_vocab"], cfg["rel_emb_dim"])))
    for d in ("fwd", "bwd"):
        spec.extend([(f"{re}.gru_{d}.weight_ih", (3 * Hr, cfg["rel_emb_dim"])),
                     (f"{re}.gru_{d}.bias_ih", (3 * Hr,)),
                     (f"{re}.gru_{d}.weight_hh", (3 * Hr, Hr)),
                     (f"{re}.gru_{d}.bias_hn", (Hr,))])
    dense(f"{re}.out_proj", 2 * Hr, D)
    for i in range(cfg["enc_layers"]):
        p = f"graph_transformer.layer{i}"
        for proj in ("q_proj", "k_proj", "v_proj"):
            dense(f"{p}.self_attn.{proj}", D, D)
        dense(f"{p}.self_attn.rel_proj", D, 2 * D)
        dense(f"{p}.self_attn.out_proj", D, D)
        ln(f"{p}.attn_res.ln")
        dense(f"{p}.ffn.fc1", D, F_)
        dense(f"{p}.ffn.fc2", F_, D)
        ln(f"{p}.ffn_res.ln")
    spec.append(("decoder.embed.weight", (cfg["token_vocab"], D)))
    for i in range(cfg["dec_layers"]):
        p = f"decoder.layer{i}"
        for att, res in (("self_attn", "self_res"), ("cross_attn",
                                                     "cross_res")):
            for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                dense(f"{p}.{att}.{proj}", D, D)
            ln(f"{p}.{res}.ln")
        dense(f"{p}.ffn.fc1", D, F_)
        dense(f"{p}.ffn.fc2", F_, D)
        ln(f"{p}.ffn_res.ln")
    if cfg["use_copy"]:
        dense("copy_gate", D, 1)
    return spec


def init_weights(spec, seed: int, device) -> Dict[str, torch.Tensor]:
    """Seeded f32 weights on `device`, from one draw of a torch.Generator
    on that device: matrices and convolutions N(0, 1/fan_in), embeddings
    N(0, 1/rows), LayerNorm scales 1 + N(0, 0.1^2), biases N(0, 0.02^2)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    total = sum(math.prod(s) for _, s in spec)
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape in spec:
        n = math.prod(shape)
        x = flat[at:at + n].view(shape)
        at += n
        if name.endswith("ln.weight"):
            x = 1.0 + 0.1 * x
        elif len(shape) == 1:
            x = 0.02 * x
        elif "embed" in name:
            x = x * shape[0] ** -0.5
        else:
            x = x * math.prod(shape[1:]) ** -0.5
        out[name] = x
    return out


# ---------------------------------------------------------------- numerics


class _Round8(torch.autograd.Function):
    """x rounded to float8 e4m3 with a per-tensor scale; its cotangent
    rounded to e5m2 the same way."""

    @staticmethod
    def forward(ctx, x):
        return _q8(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _q8(g, torch.float8_e5m2, 57344.0)


def _q8(x, dtype, top):
    scale = x.detach().abs().amax().clamp_min(1e-30) / top
    return (x / scale).to(dtype).to(x.dtype) * scale


class Numerics:
    """Where the reference rounds: nowhere ("f32"), or ("fp8", the
    control) every matrix product's operands and result, every embedding
    row and every LayerNorm output, as a float8 pipeline carries its
    activations."""

    def __init__(self, precision: str = "f32"):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"precision {precision!r}")
        self.fp8 = precision == "fp8"

    def r(self, x):
        return _Round8.apply(x) if self.fp8 else x

    def linear(self, x, w, b=None):
        return self.r(F.linear(self.r(x), self.r(w), b))

    def matmul(self, a, b):
        return self.r(torch.matmul(self.r(a), self.r(b)))


class Dropout:
    """The dropout draws (module docstring): off where gen is None."""

    def __init__(self, p: float, gen: Optional[torch.Generator]):
        self.p, self.gen = p, gen

    def __call__(self, x):
        if self.gen is None or self.p == 0.0:
            return x
        keep = torch.rand(x.shape, generator=self.gen,
                          device=x.device) < 1.0 - self.p
        return torch.where(keep, x / (1.0 - self.p), torch.zeros_like(x))


def layer_norm(P, name, x):
    return F.layer_norm(x, x.shape[-1:], P[f"{name}.weight"],
                        P[f"{name}.bias"], LN_EPS)


def sinusoid(length: int, dim: int, device) -> torch.Tensor:
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=device) / half)
    ang = pos * freqs[None]
    emb = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
    return F.pad(emb, (0, dim % 2))


# ---------------------------------------------------------------- model


class Reference:
    """The model of `cfg` (param_spec's keys, plus dropout,
    label_smoothing, max_oov, use_node_positions, max_target_len) on the
    parameters P."""

    def __init__(self, cfg: dict, P: Dict[str, torch.Tensor],
                 precision: str = "f32"):
        self.cfg, self.P = cfg, P
        self.num = Numerics(precision)

    def dense(self, name, x):
        P = self.P
        return self.num.linear(x, P[f"{name}.weight"], P[f"{name}.bias"])

    def ln(self, name, x):
        return self.num.r(layer_norm(self.P, name, x))

    def embed(self, name, ids):
        return self.num.r(self.P[name][ids.long()])

    # ---- encoder

    def token_encoder(self, concept, chars, drop):
        P, cfg, te = self.P, self.cfg, "token_encoder"
        B, N, C = chars.shape
        emb = self.embed(f"{te}.embed.weight", concept)
        x = self.embed(f"{te}.char_cnn.char_embed.weight", chars)
        x = x.reshape(B * N, C, -1).transpose(1, 2)
        real = chars.reshape(B * N, C) != 0
        pooled = []
        for w in cfg["char_widths"]:
            h = F.conv1d(self.num.r(F.pad(x, ((w - 1) // 2, w // 2))),
                         self.num.r(P[f"{te}.char_cnn.conv{w}.weight"]),
                         P[f"{te}.char_cnn.conv{w}.bias"])
            h = torch.relu(h).masked_fill(~real[:, None, :], NEG_INF)
            pooled.append(h.amax(dim=2))
        h = torch.cat(pooled, -1).masked_fill(~real.any(1, keepdim=True), 0.0)
        ch = self.dense(f"{te}.char_cnn.char_proj", h).reshape(B, N, -1)
        x = self.dense(f"{te}.merge", torch.cat([emb, ch], -1))
        if cfg["use_node_positions"]:
            x = x + sinusoid(N, x.shape[-1], x.device)[None]
        return drop(self.ln(f"{te}.ln", x))

    def gru(self, name, xs, valid):
        P, Hr = self.P, self.cfg["rel_hidden"]
        gi = self.num.linear(xs, P[f"{name}.weight_ih"], P[f"{name}.bias_ih"])
        w_hh, b_hn = P[f"{name}.weight_hh"], P[f"{name}.bias_hn"]
        h = xs.new_zeros(xs.shape[1], Hr)
        for t in range(xs.shape[0]):
            gi_r, gi_z, gi_n = gi[t].split(Hr, -1)
            gh_r, gh_z, gh_n = self.num.linear(h, w_hh).split(Hr, -1)
            r = torch.sigmoid(gi_r + gh_r)
            z = torch.sigmoid(gi_z + gh_z)
            n = torch.tanh(gi_n + r * (gh_n + b_hn))
            h = torch.where(valid[t][:, None], (1.0 - z) * n + z * h, h)
        return h

    def relation_encoder(self, bank, lengths, drop):
        re = "relation_encoder"
        L = bank.shape[1]
        xs = drop(self.embed(f"{re}.rel_embed.weight", bank)).transpose(0, 1)
        valid = (torch.arange(L, device=bank.device)[:, None]
                 < lengths[None, :].long())
        h = torch.cat([self.gru(f"{re}.gru_fwd", xs, valid),
                       self.gru(f"{re}.gru_bwd", xs.flip(0), valid.flip(0))],
                      -1)
        out = self.dense(f"{re}.out_proj", h)
        return drop(out.masked_fill((lengths == 0)[:, None], 0.0))

    def graph_layer(self, i, x, rel, rel_index, node_mask, drop):
        p = f"graph_transformer.layer{i}.self_attn"
        B, N, D = x.shape
        H = self.cfg["heads"]
        Dh = D // H
        heads = lambda t: t.reshape(B, N, H, Dh)           # noqa: E731
        q, k, v = (heads(self.dense(f"{p}.{n}", x))
                   for n in ("q_proj", "k_proj", "v_proj"))
        ab = self.dense(f"{p}.rel_proj", rel)                # [P, 2D]
        idx = rel_index.long()
        a = ab[:, :D][idx].reshape(B, N, N, H, Dh)           # a_ij
        b = ab[:, D:][idx].reshape(B, N, N, H, Dh)           # b_ij
        qa = self.num.r(q[:, :, None] + a)
        kb = self.num.r(k[:, None] + b)
        e = (qa * kb).sum(-1).permute(0, 3, 1, 2) * Dh ** -0.5
        e = e + torch.where(node_mask[:, None, None, :], 0.0, NEG_INF)
        attn = torch.softmax(e, -1)                          # [B,H,N,N]
        out = self.num.matmul(attn, v.transpose(1, 2))       # [B,H,N,Dh]
        out = self.dense(f"{p}.out_proj",
                         out.transpose(1, 2).reshape(B, N, D))
        q = f"graph_transformer.layer{i}"
        x = self.ln(f"{q}.attn_res.ln", x + drop(out))
        f = self.dense(f"{q}.ffn.fc2",
                       drop(torch.relu(self.dense(f"{q}.ffn.fc1", x))))
        return self.ln(f"{q}.ffn_res.ln", x + drop(f))

    def encode(self, t, drop):
        x = self.token_encoder(t["concept"], t["concept_char"], drop)
        rel = self.relation_encoder(t["rel_bank"], t["rel_length"], drop)
        for i in range(self.cfg["enc_layers"]):
            x = self.graph_layer(i, x, rel, t["rel_index"],
                                 t["concept_mask"], drop)
        return x.masked_fill(~t["concept_mask"][:, :, None], 0.0)

    # ---- decoder

    def attention(self, name, x, mem, mask):
        B, T, D = x.shape
        H = self.cfg["heads"]
        split = lambda t: t.reshape(t.shape[0], t.shape[1], H,  # noqa: E731
                                    D // H).transpose(1, 2)
        q = split(self.dense(f"{name}.q_proj", x))
        k = split(self.dense(f"{name}.k_proj", mem))
        v = split(self.dense(f"{name}.v_proj", mem))
        s = self.num.matmul(q, k.transpose(-1, -2)) * (D // H) ** -0.5
        probs = torch.softmax(s.masked_fill(~mask, NEG_INF), -1)
        out = self.num.matmul(probs, v).transpose(1, 2).reshape(B, T, D)
        return self.dense(f"{name}.out_proj", out), probs

    def decode(self, token_in, mem, mem_mask, drop):
        """Teacher-forced decoder: (h [B, T, D], the last layer's
        cross-attention [B, H, T, N])."""
        D = self.cfg["d_model"]
        T = token_in.shape[1]
        x = self.embed("decoder.embed.weight", token_in) * D ** 0.5
        x = drop(x + sinusoid(self.cfg["max_target_len"], D,
                              x.device)[:T][None])
        causal = torch.tril(torch.ones(T, T, dtype=torch.bool,
                                       device=x.device))[None, None]
        align = None
        for i in range(self.cfg["dec_layers"]):
            p = f"decoder.layer{i}"
            sa, _ = self.attention(f"{p}.self_attn", x, x, causal)
            x = self.ln(f"{p}.self_res.ln", x + drop(sa))
            ca, align = self.attention(f"{p}.cross_attn", x, mem,
                                       mem_mask[:, None, None, :])
            x = self.ln(f"{p}.cross_res.ln", x + drop(ca))
            f = self.dense(f"{p}.ffn.fc2",
                           drop(torch.relu(self.dense(f"{p}.ffn.fc1", x))))
            x = self.ln(f"{p}.ffn_res.ln", x + drop(f))
        return x, align

    def log_probs(self, h, align, cp_seq, copy_mask):
        """Extended-vocabulary log P [B, T, V + max_oov] (module
        docstring)."""
        cfg = self.cfg
        logits = self.num.matmul(h, self.P["decoder.embed.weight"].t())
        p_vocab = torch.softmax(logits, -1)
        tail = cfg["max_oov"]
        if not cfg["use_copy"]:
            return torch.log(F.pad(p_vocab, (0, tail)) + EPS)
        alpha = align.transpose(1, 2).mean(-2)               # [B, T, N]
        alpha = alpha.masked_fill(~copy_mask[:, None, :], 0.0)
        alpha = alpha / (alpha.sum(-1, keepdim=True) + EPS)
        g = torch.sigmoid(self.dense("copy_gate", h))
        ext = F.pad(g * p_vocab, (0, tail))
        cp = cp_seq.long()[:, None, :].expand_as(alpha)
        ext = ext.scatter_add(-1, cp, (1.0 - g) * alpha)
        return torch.log(ext + EPS)

    def loss(self, t, gen: Optional[torch.Generator] = None):
        """The batch's training loss, with dropout drawn from `gen` (none
        where gen is None)."""
        cfg = self.cfg
        drop = Dropout(cfg["dropout"], gen)
        mem = self.encode(t, drop)
        h, align = self.decode(t["token_in"], mem, t["concept_mask"], drop)
        logp = self.log_probs(h, align, t["cp_seq"], t["copy_mask"])
        tgt = t["token_out"].long()
        mask = t["token_mask"].float()
        n_tok = mask.sum() + EPS
        nll = -logp.gather(-1, tgt[..., None])[..., 0]
        loss = (nll * mask).sum() / n_tok
        ls = cfg["label_smoothing"]
        if ls > 0.0:
            smooth = -(logp[..., :cfg["token_vocab"]].mean(-1)
                       * mask).sum() / n_tok
            loss = (1.0 - ls) * loss + ls * smooth
        return loss

    @torch.no_grad()
    def sequence_log_probs(self, t, seqs, unk_id: int):
        """Per request b, the log P of each token of seqs[b] (ids over the
        extended vocabulary, position 0 the start token) given the tokens
        before it, teacher-forced with copied ids fed back as UNK:
        [B, T - 1]. No dropout."""
        drop = Dropout(0.0, None)
        mem = self.encode(t, drop)
        tok_in = seqs[:, :-1].clone()
        tok_in[tok_in >= self.cfg["token_vocab"]] = unk_id
        h, align = self.decode(tok_in, mem, t["concept_mask"], drop)
        logp = self.log_probs(h, align, t["cp_seq"], t["copy_mask"])
        return logp.gather(-1, seqs[:, 1:, None].long())[..., 0]


# ---------------------------------------------------------------- Adam


class Adam:
    """The configurations' optimizer, as the published model trains:
    global-norm clipping (scaled only where the norm reaches the limit),
    Adam with bias correction, the inverse-square-root schedule
    lr(s) = d^-0.5 min(s^-0.5, s warmup^-1.5), s the step counted from 1."""

    def __init__(self, params: Dict[str, torch.Tensor], d_model: int,
                 warmup: int, b1=0.9, b2=0.98, eps=1e-9, clip=1.0,
                 lr_scale=1.0):
        self.P = params
        self.d, self.warmup, self.lr_scale = d_model, warmup, lr_scale
        self.b1, self.b2, self.eps, self.clip = b1, b2, eps, clip
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0

    def clipped(self, grads):
        norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
        f = 1.0 if float(norm) < self.clip else self.clip / norm
        return {k: g * f for k, g in grads.items()}

    @torch.no_grad()
    def step(self, grads):
        """One update in place; returns the clipped gradients it took."""
        grads = self.clipped(grads)
        s = self.count + 1.0
        lr = self.lr_scale * self.d ** -0.5 * min(s ** -0.5,
                                                  s * self.warmup ** -1.5)
        self.count += 1
        c = float(self.count)
        for k, p in self.P.items():
            g = grads[k]
            self.mu[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.nu[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            den = (self.nu[k] / (1 - self.b2 ** c)).sqrt_().add_(self.eps)
            p.add_(-lr * (self.mu[k] / (1 - self.b1 ** c)) / den)
        return grads
