"""Optimizer: Adam with the inverse-sqrt warmup transformer schedule.

Port of gtos_tpu/train/optim.py, whose optax chain it reproduces step for
step rather than torch.optim's conventions:

  * clip_by_global_norm: g * (max_norm / norm) only when norm >= max_norm
    (torch's clip_grad_norm_ divides by norm + 1e-6, always);
  * Adam(b1, b2, eps) with optax's bias correction, then decoupled weight
    decay on every parameter (adamw, no mask), then the learning rate
    schedule(count) with the count BEFORE its increment (the schedule
    itself adds one: 1-indexed like the reference);
  * accumulation (accum_steps k > 1, optax.MultiSteps): a running mean of
    k gradients, and every k-th call one step of the chain above, clip
    included, on that mean; the other calls leave the parameters alone.

The state is plain tensors (f32, on the parameters' device), so a
checkpoint restores it bit for bit.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from gtos_tpu_torch.utils.config import TrainConfig


def inverse_sqrt_schedule(d_model: int, warmup_steps: int,
                          scale: float = 1.0):
    """lr(count) = scale * d^-0.5 * min(s^-0.5, s * warmup^-1.5), s =
    count + 1, in f32."""

    def schedule(count: torch.Tensor) -> torch.Tensor:
        s = count.float() + 1.0
        return scale * (d_model ** -0.5) * torch.minimum(
            s ** -0.5, s * (warmup_steps ** -1.5))

    return schedule


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of every element's square (optax.global_norm)."""
    return torch.sqrt(sum((t.float() ** 2).sum() for t in tensors))


def make_optimizer(cfg: TrainConfig, d_model: int,
                   params: List[torch.Tensor]) -> "Optimizer":
    """The JAX package's make_optimizer(cfg, d_model), which returns the
    optax chain that a train state initialises on the parameters: here
    the Optimizer over `params`, the chain with its state."""
    return Optimizer(cfg, d_model, params)


class Optimizer:
    """The optax chain of gtos_tpu/train/optim.py over `params` (f32
    tensors updated in place). `step(grads)` takes one gradient per
    parameter. The update runs as a few foreach kernels over all
    parameters and never reads a value back to the host, so the host can
    queue the next step while the card works. `norm_fn(grads)` is the
    clip's global norm (tensor parallelism replaces it: a shard's norm
    is summed over its group)."""

    def __init__(self, cfg: TrainConfig, d_model: int,
                 params: List[torch.Tensor]):
        self.cfg = cfg
        self.params = list(params)
        self.norm_fn = global_norm
        self.schedule = inverse_sqrt_schedule(d_model, cfg.warmup_steps,
                                              cfg.lr_scale)
        dev = self.params[0].device
        zeros = lambda: [torch.zeros_like(p) for p in self.params]  # noqa
        self.state: Dict[str, object] = {
            "count": torch.zeros((), dtype=torch.int32, device=dev),
            "mu": zeros(), "nu": zeros()}
        if cfg.accum_steps > 1:
            self.state.update(mini_step=0, acc=zeros())

    @property
    def phase(self) -> int:
        """The accumulation phase of the next step: the mini-step among
        accum_steps (0 without accumulation)."""
        return self.state.get("mini_step", 0)

    def step(self, grads: List[torch.Tensor]):
        self.update(grads, self.phase)
        self.advance()

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor], phase: int):
        """The device side of a step in accumulation phase `phase`: no
        host state is read or written, so a CUDA graph captured for one
        phase replays every step of that phase (the train step's
        signature holds the phase)."""
        cfg, st = self.cfg, self.state
        if cfg.accum_steps > 1:
            torch._foreach_add_(st["acc"], torch._foreach_div(
                torch._foreach_sub(grads, st["acc"]), float(phase + 1)))
            if phase + 1 < cfg.accum_steps:
                return
            grads = [a.clone() for a in st["acc"]]
            torch._foreach_zero_(st["acc"])
        norm = self.norm_fn(grads)
        factor = torch.where(norm < cfg.grad_clip, 1.0,
                             cfg.grad_clip / norm)
        grads = torch._foreach_mul(grads, factor)
        lr = self.schedule(st["count"])
        st["count"] += 1
        b1, b2 = cfg.adam_b1, cfg.adam_b2
        c = st["count"].float()
        mu, nu = st["mu"], st["nu"]
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, grads, alpha=1 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1 - b2)
        den = torch._foreach_div(nu, 1.0 - b2 ** c)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, cfg.adam_eps)
        upd = torch._foreach_div(torch._foreach_div(mu, 1.0 - b1 ** c), den)
        if cfg.weight_decay > 0:
            torch._foreach_add_(upd, self.params, alpha=cfg.weight_decay)
        torch._foreach_mul_(upd, -lr)
        torch._foreach_add_(self.params, upd)

    def advance(self):
        """The host side of a step: the next accumulation phase."""
        if self.cfg.accum_steps > 1:
            self.state["mini_step"] = ((self.state["mini_step"] + 1)
                                       % self.cfg.accum_steps)

    def state_dict(self) -> Dict[str, object]:
        return self.state

    def load_state_dict(self, state: Dict[str, object]):
        for key, value in state.items():
            mine = self.state[key]
            if isinstance(mine, list):
                for a, b in zip(mine, value):
                    a.copy_(b)
            elif isinstance(mine, torch.Tensor):
                mine.copy_(value)
            else:
                self.state[key] = value
