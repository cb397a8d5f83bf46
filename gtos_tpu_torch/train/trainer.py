"""Training driver: train step, epoch loop, eval, checkpointing.

Port of gtos_tpu/train/trainer.py: batchify -> forward -> backward ->
clip -> scheduled Adam step -> periodic dev eval and checkpoint. PyTorch
runs eagerly, so a step is the model's loss, its gradients by autograd
(on the card the encoder attention's backward is kernel B2, B4 or B6) and the
optimizer's foreach update; the host queues work for the card and reads a
loss back only `max_inflight` steps later. Batches are packed and copied to the
device `prefetch` ahead in a background thread. A non-finite loss stops
training with a resumable checkpoint on disk.

Under attention_impl "auto" the model resolves each batch's route itself
(Generator.forward): one model, one parameter set and one optimizer state
for every route, and no per-route step cache, since nothing is compiled.
The JAX package's meshes (data, tensor and context parallelism) are not
ported: `mesh` raises (ROADMAP A9).
"""

from __future__ import annotations

import itertools
from collections import deque
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from gtos_tpu_torch.data.prefetch import prefetch_iter
from gtos_tpu_torch.models.generator import Generator, batch_to_device
from gtos_tpu_torch.train.optim import Optimizer, global_norm
from gtos_tpu_torch.utils.config import ModelConfig, TrainConfig
from gtos_tpu_torch.utils.device import resolve_device
from gtos_tpu_torch.utils.profiling import StepTimer


def _batch_edges_count(arrays) -> int:
    """Pairs scored by the encoder for one batch: the real edge-cell
    entries in sparse mode, B*N^2 ordered pairs in dense mode."""
    if "edge_mask" in arrays:
        return int(np.asarray(arrays["edge_mask"]).sum())
    b, n = arrays["concept"].shape
    return b * n * n


class Trainer:
    """Drives training of `model` (a Generator with f32 parameters) over a
    DataLoader with periodic eval and checkpointing.

    device: where training runs — the CUDA card unless "cpu" is passed
    (raises when no card is visible); the model must already be there.
    The dropout generator is seeded with train_cfg.seed. Metrics go to a
    JSONL writer (utils/metrics.py). dev_bleu_fn(model) -> float is called
    at each eval."""

    def __init__(
        self,
        model: Generator,
        model_cfg: ModelConfig,
        train_cfg: TrainConfig,
        example_arrays: Dict[str, np.ndarray],
        metrics_writer=None,
        checkpoint_manager=None,
        mesh=None,
        dev_bleu_fn: Optional[Callable] = None,
        prefetch: int = 2,
        max_inflight: int = 2,
        device=None,
    ):
        self.device = resolve_device(device)
        if mesh is not None:
            raise NotImplementedError(
                "meshes (data/tensor/context parallelism) are not ported "
                "yet (ROADMAP A9)")
        if model.device.type != self.device.type:
            raise ValueError(f"the model is on {model.device}, training "
                             f"runs on {self.device}")
        # extended target ids must fit the copy scatter: a mismatch between
        # the batchify OOV cap and ModelConfig.max_oov gives a wrong loss
        tok_out_max = int(np.max(example_arrays["token_out"]))
        if tok_out_max >= model_cfg.ext_vocab:
            raise ValueError(
                f"token_out id {tok_out_max} >= ext_vocab "
                f"{model_cfg.ext_vocab}; the DataLoader's BucketSpec.max_oov "
                "must equal ModelConfig.max_oov (BucketSpec."
                "for_model_max_oov)")
        self.model = model
        self.model_cfg = model_cfg
        self.train_cfg = train_cfg
        self.params = [p for p in model.parameters()]
        self.opt = Optimizer(train_cfg, model_cfg.d_model, self.params)
        self.step = 0
        model.dropout_rng.manual_seed(train_cfg.seed)
        self.metrics = metrics_writer
        self.ckpt = checkpoint_manager
        self.dev_bleu_fn = dev_bleu_fn
        self.prefetch = prefetch
        self.max_inflight = max_inflight
        self._resume_cursor = None

    # ---------------- state ----------------

    def state_dict(self) -> dict:
        """Everything a resume needs: parameters, optimizer state, step and
        the dropout generator's state."""
        return {"params": self.model.state_dict(),
                "opt_state": self.opt.state_dict(), "step": self.step,
                "rng": self.model.dropout_rng.get_state()}

    def load_state_dict(self, state: dict):
        self.model.load_state_dict(state["params"])
        self.opt.load_state_dict(state["opt_state"])
        self.step = int(state["step"])
        self.model.dropout_rng.set_state(state["rng"])

    def restore_if_available(self) -> int:
        if self.ckpt is not None:
            state = self.ckpt.restore_latest()
            if state is not None:
                self.load_state_dict(state)
                # resume mid-epoch in the same deterministic batch order
                self._resume_cursor = self.ckpt.load_cursor()
        return self.step

    # ---------------- steps ----------------

    def _prep(self, batch):
        """Host-side work per batch (runs in the prefetch thread): pack to
        numpy, then copy to the device."""
        raw = batch.arrays()
        return raw, batch_to_device(raw, self.device)

    def train_step(self, arrays: Dict[str, torch.Tensor]) -> dict:
        """One optimizer step on a batch on the device. Returns its metrics
        (loss, acc, n_tok, grad_norm) as device scalars, unread."""
        self.model.train()
        loss, metrics = self.model(arrays)
        grads = torch.autograd.grad(loss, self.params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(self.params, grads)]
        self.opt.step(grads)
        self.step += 1
        return {k: v.detach() for k, v in
                dict(metrics, grad_norm=global_norm(grads)).items()}

    @torch.no_grad()
    def evaluate(self, dev_loader) -> Dict[str, float]:
        self.model.eval()
        tot_loss, tot_tok, tot_acc = 0.0, 0.0, 0.0
        for batch in dev_loader:
            m = self.model(batch_to_device(batch.arrays(), self.device))[1]
            n = float(m["n_tok"])
            tot_loss += float(m["loss"]) * n
            tot_acc += float(m["acc"]) * n
            tot_tok += n
        ppl = float(np.exp(min(tot_loss / max(tot_tok, 1.0), 20.0)))
        return {"dev_loss": tot_loss / max(tot_tok, 1.0),
                "dev_acc": tot_acc / max(tot_tok, 1.0), "dev_ppl": ppl}

    def fit(self, train_loader: Iterable, dev_loader=None,
            log_every: int = 50) -> Dict[str, float]:
        cfg = self.train_cfg
        timer = StepTimer()
        timer.start()
        last: Dict[str, float] = {}
        batch_idx = skip = 0
        # (step, device metrics) of queued but unread steps: reading a loss
        # waits for its step, so the deque keeps the host max_inflight
        # steps ahead of the card
        pending: deque = deque()
        drained = [None]  # (step, metrics, loss) of the newest read step

        def drain(to_len: int = 0):
            while len(pending) > to_len:
                s, m = pending.popleft()
                loss_val = float(m["loss"])
                if not np.isfinite(loss_val):
                    if self.ckpt is not None:
                        self.ckpt.wait()
                    raise FloatingPointError(
                        f"non-finite loss {loss_val} at step {s}; restart "
                        "with --resume from the last checkpoint")
                drained[0] = (s, m, loss_val)

        def save():
            self.ckpt.save(self.step, self.state_dict(), cursor={
                "epoch": getattr(train_loader, "epoch", 0),
                "batch": batch_idx})

        if self._resume_cursor is not None and hasattr(train_loader,
                                                       "epoch"):
            # replay the interrupted epoch's plan, skipping the batches
            # consumed before the checkpoint
            train_loader.epoch = self._resume_cursor["epoch"] - 1
            skip = self._resume_cursor["batch"]
            self._resume_cursor = None
        while self.step < cfg.total_steps:
            # resumed-past batches are dropped before _prep, so they cost
            # no packing or copy
            batch_idx = skip
            src = itertools.islice(iter(train_loader), skip, None)
            skip = 0
            for raw, arrays in prefetch_iter(src, self._prep,
                                             depth=self.prefetch):
                batch_idx += 1
                pending.append((self.step + 1, self.train_step(arrays)))
                timer.step(n_tokens=int(raw["token_mask"].sum()),
                           n_edges=_batch_edges_count(raw))
                drain(self.max_inflight)
                step = self.step
                if step % log_every == 0 or step == cfg.total_steps:
                    drain(0)
                    _, m, loss_val = drained[0]
                    rates = timer.rates()
                    last = {"step": step, "loss": loss_val,
                            "acc": float(m["acc"]),
                            "grad_norm": float(m["grad_norm"]),
                            "tokens_per_s": rates["tokens_per_s"],
                            "edges_per_s": rates["edges_per_s"]}
                    if self.metrics is not None:
                        self.metrics.write(dict(last, kind="train"))
                if dev_loader is not None and step % cfg.eval_every == 0:
                    drain(0)
                    ev = self.evaluate(dev_loader)
                    if self.dev_bleu_fn is not None:
                        ev["dev_bleu"] = float(self.dev_bleu_fn(self.model))
                    if self.metrics is not None:
                        self.metrics.write(dict(ev, step=step, kind="eval"))
                if self.ckpt is not None and step % cfg.checkpoint_every == 0:
                    drain(0)
                    save()
                if step >= cfg.total_steps:
                    break
        drain(0)
        if self.ckpt is not None:
            save()
            self.ckpt.wait()
        return last
