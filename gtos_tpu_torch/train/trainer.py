"""Training driver: train step, epoch loop, eval, checkpointing.

Port of gtos_tpu/train/trainer.py: batchify -> forward -> backward ->
clip -> scheduled Adam step -> periodic dev eval and checkpoint. A step
is the model's loss, its gradients by autograd (on the card the encoder
attention's backward is kernel B2, B4 or B6) and the optimizer's foreach
update. The JAX package compiles that whole update into one donated
program per batch signature (`make_train_step`); the port captures it
into one CUDA graph per signature (utils/graphs.py): the route, every
array's shape and the accumulation phase. `make_train_step` and
`make_eval_step` keep the JAX names: the step copies the batch into the
signature's static inputs and replays forward, `autograd.grad`, the
optimizer's update and the metrics (loss, acc, n_tok, grad_norm) into
static outputs, reading nothing back. `TrainState` is the state such a
step updates in place. Every single-device route is captured, the
block-sparse one included: its backward plan is built inside the step on
the card with no host read, padded to the batch's pair capacity, which
the signature holds (ops/block_sparse_attention_bwd.py backward_plan).
The plan's check that the batch's two tile layouts hold the same pairs is
a device flag that the step returns with its metrics ("layout_ok");
`check_metrics` raises its ValueError when they are read. On the CPU, or
with compiled=False, the same step functions run uncaptured. The host
queues work for the card and reads a loss back only `max_inflight` steps
later, on the card on a stream of its own that waits for that step alone
(an `.item()` on the step's stream would wait for the steps queued after
it too, and the card would run dry while the host queues the next).
Batches are packed `prefetch` ahead in a background thread. On one card
that thread also stages each batch's copy to the card (train/feed.py: one
pinned buffer, one asynchronous copy on a stream of its own) and waits for
nothing there; the step makes its stream wait for the copy's event.
Evaluation, the CPU and a mesh copy synchronously (`_put`). A non-finite
loss stops training with a resumable checkpoint on disk.

Spans (utils/profiling.py), for a profile of `fit`: on the prefetch thread
"gtos/trainer/prep" with its children "gtos/trainer/pack" and
"gtos/trainer/to_device"; on the main thread "gtos/prefetch/wait" (the
step waits for the feed), "gtos/train/step" (the host's part of a step,
around utils/graphs.py's "gtos/graphs/*"), "gtos/fit/read_metrics" (the
host waits for the card to read a loss) and "gtos/fit/checkpoint".

Under attention_impl "auto" the model resolves each batch's route itself
(Generator.forward): one model, one parameter set and one optimizer state
for every route; the step cache holds each route's graphs, as the JAX
Trainer keeps a step per resolved route.

With a mesh (parallel/mesh.py; this process is one rank of it) the model
is split for tensor parallelism before the optimizer is built, each batch
goes through shard_arrays to this rank's part, and the steps are these
same ones with the mesh's data group (parallel/train.py: the loss over
the global token count, the gradients summed over the group, evaluation's
metrics global; under tensor parallelism the clip's norm summed over the
model group). On the card they are captured as on one device, their NCCL
collectives inside the graph, and a signature's first call, uncaptured,
creates the communicators before any capture. Every data rank gets the
same shapes for a batch (shard_arrays splits the rows evenly), so the
ranks capture at the same call, except where a block-sparse batch's pair
capacity, which each rank counts from its own rows, differs between
them: there they capture at different calls, and their collectives stay
matched, since a call runs them once whether it captures or replays. A
context-parallel mesh (graph > 1) runs its steps uncaptured
(`EAGER_MESH`). Each rank's
dropout generator is seeded from (seed,
data rank): the ranks of one data rank draw the same masks, as their
activations are the same, and data rank 0 draws the single-device
run's (the JAX package draws one mask over the global batch, which no
per-rank draw reproduces). A checkpoint holds every data rank's generator
state, so a resumed rank draws the masks it would have drawn. Metrics and
checkpoints are written by rank 0 alone; under TP a checkpoint holds the
whole parameters and moments, gathered over the model group. On resume
rank 0 reads the checkpoint and broadcasts it: the other hosts need no
view of its directory.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
from collections import deque
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from gtos_tpu_torch.data.prefetch import prefetch_iter
from gtos_tpu_torch.models.generator import (
    Generator, batch_to_device, resolve_attention_impl,
)
from gtos_tpu_torch.ops.block_sparse_attention_bwd import (
    LAYOUT_MISMATCH, PAIR_CAP, with_pair_cap,
)
from gtos_tpu_torch.parallel.train import all_reduce_grads
from gtos_tpu_torch.train.feed import StagedBatch, StagedCopy
from gtos_tpu_torch.train.optim import Optimizer
from gtos_tpu_torch.utils import graphs
from gtos_tpu_torch.utils.config import ModelConfig, TrainConfig
from gtos_tpu_torch.utils.device import resolve_device
from gtos_tpu_torch.utils.profiling import StepTimer, annotate

# why a mesh step runs uncaptured on the card (ROADMAP A9)
EAGER_MESH = ("a context-parallel mesh (graph > 1) runs its steps "
              "uncaptured: its rings exchange node blocks point to point "
              "(parallel/comm.py), some posted in one autograd function and "
              "waited in another, which one card cannot check (two NCCL "
              "ranks cannot share it); ROADMAP A9")
METRICS = ("loss", "acc", "n_tok", "grad_norm")


def mesh_compiled(mesh, compiled: Optional[bool]) -> Optional[bool]:
    """`compiled` for the steps of a model under `mesh`: as given without
    a mesh or under data and tensor parallelism; False under a
    context-parallel mesh (EAGER_MESH), where compiled=True raises."""
    if mesh is None or mesh.size("graph") == 1:
        return compiled
    if compiled:
        raise ValueError(EAGER_MESH)
    return False


def check_metrics(metrics: Dict[str, torch.Tensor]):
    """Raise what a step deferred to the reading of its metrics: the
    block-sparse backward plan's ValueError where its two tile layouts
    did not hold the same pairs ("layout_ok" false; a read of the card).
    Trainer.fit calls it on every step it reads; a caller of train_step
    or make_train_step's step calls it on each step's metrics."""
    ok = metrics.get("layout_ok")
    if ok is not None and not bool(ok):
        raise ValueError(LAYOUT_MISMATCH)


def _batch_edges_count(arrays) -> int:
    """Pairs scored by the encoder for one batch: the real edge-cell
    entries in sparse mode, B*N^2 ordered pairs in dense mode."""
    if "edge_mask" in arrays:
        return int(np.asarray(arrays["edge_mask"]).sum())
    b, n = arrays["concept"].shape
    return b * n * n


@dataclasses.dataclass
class TrainState:
    """The JAX package's TrainState as the port holds it: `params` (the
    model's parameters, in `model.parameters()` order) and `opt_state`
    (`Optimizer.state`: count, mu, nu; acc and mini_step under
    accumulation) are the tensors a step updates in place, as the JAX
    step donates its buffers; `step` counts steps; `rng` is the dropout
    generator."""

    params: List[torch.Tensor]
    opt_state: Dict[str, object]
    step: int
    rng: torch.Generator


def init_state(model: Generator, opt: Optimizer, step: int = 0
               ) -> TrainState:
    return TrainState(params=opt.params, opt_state=opt.state, step=step,
                      rng=model.dropout_rng)


def train_grads(model: Generator, params, arrays, data_group=None):
    """(loss, metrics, one gradient per parameter) of a batch in train
    mode. data_group: under a mesh, the group the batch rows are split
    over: the loss is this rank's term of the global loss and the
    gradients are summed over the group (parallel/train.py)."""
    model.train()
    loss, metrics = model(arrays, data_group=data_group)
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(params, grads)]
    if data_group is not None:
        grads = all_reduce_grads(grads, data_group)
    return loss, metrics, grads


class _TrainStep:
    """One optimizer step of `model` with `opt`, captured per signature
    on the card (module docstring). Called with a batch on the device,
    returns its metrics as device scalars, unread: copies of the graph's
    outputs, so they outlive the next replay. data_group: under a mesh
    (parallel/train.py make_sharded_train_step), as train_grads."""

    def __init__(self, model: Generator, opt: Optimizer,
                 compiled: Optional[bool] = None, data_group=None):
        self.model, self.opt, self.data_group = model, opt, data_group
        self.graphs = graphs.for_model(model, compiled)

    def route(self, arrays) -> str:
        return resolve_attention_impl(self.model.cfg.attention_impl, arrays)

    def _update(self, arrays, phase):
        _, metrics, grads = train_grads(self.model, self.opt.params, arrays,
                                        self.data_group)
        self.opt.update(grads, phase)
        ok = metrics.get("layout_ok")
        if ok is None:      # no block-sparse plan: nothing to check
            ok = torch.ones((), dtype=torch.bool, device=grads[0].device)
        return torch.stack([metrics["loss"].detach(), metrics["acc"].detach(),
                            metrics["n_tok"].detach().float(),
                            self.opt.norm_fn(grads), ok.float()])

    def __call__(self, arrays) -> Dict[str, torch.Tensor]:
        phase = self.opt.phase
        self.model.train()
        key = ("train", self.route(arrays), graphs.signature(arrays), phase)
        static = self.graphs.inputs(key, arrays)
        out = self.graphs.run(key, lambda: self._update(static, phase),
                              generators=(self.model.dropout_rng,))
        if self.graphs.enabled:
            out = out.clone()
        self.opt.advance()
        self.model.mark_updated()
        return dict(zip(METRICS + ("layout_ok",), out.unbind()))


def make_train_step(model: Generator, opt: Optimizer,
                    compiled: Optional[bool] = None) -> Callable:
    """The JAX package's make_train_step: train_step(state, arrays) ->
    (state, metrics), one CUDA graph per batch signature on the card
    (compiled=False: uncaptured there too; the CPU: uncaptured). `state`
    is `init_state(model, opt)` or `train_state_from_jax(...)`: its
    tensors are updated in place; metrics are device scalars, with
    "layout_ok" (check_metrics raises on a false one)."""
    step = _TrainStep(model, opt, compiled)

    def train_step(state: TrainState, arrays: Dict[str, torch.Tensor]):
        if state.opt_state is not opt.state or state.rng is not \
                model.dropout_rng:
            raise ValueError("the state is not this model's and "
                             "optimizer's (init_state)")
        metrics = step(arrays)
        return dataclasses.replace(state, step=state.step + 1), metrics

    return train_step


def make_eval_step(model: Generator, compiled: Optional[bool] = None,
                   data_group=None) -> Callable:
    """The JAX package's make_eval_step: eval_step(arrays) -> metrics
    (loss, acc, n_tok; device scalars, copies of the graph's outputs) of
    the model in eval mode, one CUDA graph per batch signature on the
    card. data_group: under a mesh, the group the batch rows are split
    over (the metrics global)."""
    cache = graphs.for_model(model, compiled)

    def run(arrays):
        with torch.no_grad():
            m = model(arrays, data_group=data_group)[1]
            return torch.stack([m["loss"], m["acc"], m["n_tok"].float()])

    def eval_step(arrays: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        # every call: a replay runs no Python, and the calls that do run
        # (a new signature's first) must not draw dropout masks
        model.eval()
        # no backward plan: the pair capacity stays out of the signature
        arrays = {k: v for k, v in arrays.items() if k != PAIR_CAP}
        route = resolve_attention_impl(model.cfg.attention_impl, arrays)
        key = ("eval", route, graphs.signature(arrays))
        static = cache.inputs(key, arrays)
        return dict(zip(METRICS, cache.run(key, lambda: run(static))
                        .clone().unbind()))

    return eval_step


class Trainer:
    """Drives training of `model` (a Generator with f32 parameters) over a
    DataLoader with periodic eval and checkpointing.

    device: where training runs — the CUDA card unless "cpu" is passed
    (raises when no card is visible); the model must already be there.
    The dropout generator is seeded with train_cfg.seed. Metrics go to a
    JSONL writer (utils/metrics.py). dev_bleu_fn(model) -> float is called
    at each eval. mesh: this rank's mesh (module docstring). compiled:
    None captures the steps on the card (module docstring), False runs
    them uncaptured there too; True raises where they cannot be captured
    (the CPU, a context-parallel mesh)."""

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
        compiled: Optional[bool] = None,
    ):
        self.device = resolve_device(device)
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
        self.mesh = mesh
        seed = train_cfg.seed
        if mesh is not None:
            from gtos_tpu_torch.parallel.tensor_parallel import shard_model
            shard_model(model, mesh)
            seed += 1000003 * mesh.index("data")
        self.params = [p for p in model.parameters()]
        self.opt = Optimizer(train_cfg, model_cfg.d_model, self.params)
        self.step = 0
        model.dropout_rng.manual_seed(seed)
        self.lead = mesh is None or torch.distributed.get_rank() == 0
        if mesh is not None:
            from gtos_tpu_torch.parallel.train import (
                make_sharded_eval_step, make_sharded_train_step)
            self._step = make_sharded_train_step(model, self.opt, mesh,
                                                 compiled)
            self._eval_step = make_sharded_eval_step(model, mesh, compiled)
        else:
            self._step = _TrainStep(model, self.opt, compiled)
            self._eval_step = make_eval_step(model, compiled)
        self.metrics = metrics_writer if self.lead else None
        self.ckpt = checkpoint_manager
        self.dev_bleu_fn = dev_bleu_fn
        self.prefetch = prefetch
        self.max_inflight = max_inflight
        # the training feed's copy on one card (_prep); `.batches` counts
        # the batches it staged, 0 on the CPU and under a mesh
        self.staged_copy = StagedCopy(self.device)
        # on the card: the event after the newest queued step, and the
        # stream fit reads metrics on (_reading)
        self.step_done = None
        self._read_stream = None
        self._resume_cursor = None

    # ---------------- state ----------------

    def _split(self) -> bool:
        return self.mesh is not None and self.mesh.size("model") > 1

    def state_dict(self) -> dict:
        """Everything a resume needs: parameters, optimizer state, step and
        the dropout generator's state; under a mesh also every data rank's
        generator state ("rng_data", by data rank) and under TP the whole
        tensors (every rank must call it)."""
        if not self._split():
            params, opt_state = self.model.state_dict(), self.opt.state_dict()
        else:
            from gtos_tpu_torch.parallel import tensor_parallel as tp
            params = tp.full_state_dict(self.model)
            opt_state = dict(self.opt.state_dict())
            for key in ("mu", "nu", "acc"):
                if key in opt_state:
                    opt_state[key] = [tp.gather_full(t, p) for t, p in
                                      zip(opt_state[key], self.params)]
        rng = self.model.dropout_rng.get_state()
        state = {"params": params, "opt_state": opt_state, "step": self.step,
                 "rng": rng}
        if self.mesh is not None:
            states = [None] * self.mesh.size("data")
            torch.distributed.all_gather_object(
                states, rng, group=self.mesh.group("data"))
            state["rng_data"] = states
        return state

    def load_state_dict(self, state: dict):
        params, opt_state = state["params"], state["opt_state"]
        if self._split():
            from gtos_tpu_torch.parallel.tensor_parallel import take_shard
            own = dict(self.model.named_parameters())
            params = {k: (take_shard(v, own[k]) if k in own else v)
                      for k, v in params.items()}
            opt_state = {k: ([take_shard(t, p) for t, p in
                              zip(v, self.params)]
                             if isinstance(v, list) else v)
                         for k, v in opt_state.items()}
        self.model.load_state_dict(params)
        self.opt.load_state_dict(opt_state)
        self.step = int(state["step"])
        rng = state["rng"]
        if self.mesh is not None and "rng_data" in state:
            states, dp = state["rng_data"], self.mesh.size("data")
            if len(states) != dp:
                raise ValueError(f"the checkpoint holds the dropout states "
                                 f"of {len(states)} data ranks, the mesh "
                                 f"has {dp}")
            rng = states[self.mesh.index("data")]
        elif self.mesh is not None and self.mesh.index("data") > 0:
            rng = None    # a one-device checkpoint: keep this rank's seed
        if rng is not None:
            self.model.dropout_rng.set_state(rng)

    def restore_if_available(self) -> int:
        if self.ckpt is None:
            return self.step
        if self.mesh is None:
            state = self.ckpt.restore_latest()
            cursor = None if state is None else self.ckpt.load_cursor()
        else:
            # rank 0 reads and every rank receives: the other hosts need
            # no view of the checkpoint directory
            box = ([self.ckpt.restore_latest(), self.ckpt.load_cursor()]
                   if self.lead else [None, None])
            torch.distributed.broadcast_object_list(box, src=0)
            state, cursor = box
        if state is not None:
            self.load_state_dict(state)
            # resume mid-epoch in the same deterministic batch order
            self._resume_cursor = cursor
        return self.step

    # ---------------- steps ----------------

    def _put(self, raw):
        if self.mesh is None:
            return batch_to_device(raw, self.device)
        from gtos_tpu_torch.parallel.mesh import shard_arrays
        return shard_arrays(self.mesh, raw, self.model_cfg.cp_schedule)

    def _prep(self, batch):
        """Host-side work per batch (runs in the prefetch thread): pack to
        numpy, then copy (this rank's part) to the device; on one card a
        staged copy (train/feed.py), queued and not waited for."""
        with annotate("gtos/trainer/prep"):
            with annotate("gtos/trainer/pack"):
                raw = batch.arrays()
            with annotate("gtos/trainer/to_device"):
                if self.mesh is None and self.device.type == "cuda":
                    return raw, self.staged_copy(with_pair_cap(raw))
                return raw, self._put(raw)

    def train_step(self, arrays: Dict[str, torch.Tensor]) -> dict:
        """One optimizer step on a batch on the device (a replay of its
        signature's graph on the card). Returns its metrics (loss, acc,
        n_tok, grad_norm, layout_ok) as device scalars, unread: the caller
        passes them to check_metrics when it reads them, as fit does. A
        staged batch (_prep) is waited for on the card first; on the card
        `step_done` is then an event recorded after the step."""
        with annotate("gtos/train/step"):
            if isinstance(arrays, StagedBatch):
                arrays.wait(torch.cuda.current_stream(self.device))
            metrics = self._step(arrays)
            if self.device.type == "cuda":
                self.step_done = torch.cuda.Event()
                self.step_done.record()
        self.step += 1
        return metrics

    def _reading(self, done):
        """Where fit reads a queued step's metrics: on the card, the read
        stream, made to wait for `done` (that step's `step_done`) alone;
        elsewhere, where the caller is. Called inside a span."""
        if done is None:
            return contextlib.nullcontext()
        if self._read_stream is None:
            self._read_stream = torch.cuda.Stream(self.device)
        self._read_stream.wait_event(done)
        return torch.cuda.stream(self._read_stream)

    def step_path(self, arrays) -> str:
        """How a step on this batch runs: "captured", or "uncaptured: "
        and why (a context-parallel mesh, the CPU, compiled=False)."""
        if self.mesh is not None and self.mesh.size("graph") > 1:
            return "uncaptured: " + EAGER_MESH
        if not self._step.graphs.enabled:
            return "uncaptured: " + ("the CPU" if self.device.type == "cpu"
                                     else "compiled=False")
        return "captured"

    @torch.no_grad()
    def evaluate(self, dev_loader) -> Dict[str, float]:
        self.model.eval()   # also for dev_bleu_fn, which fit calls next
        tot_loss, tot_tok, tot_acc = 0.0, 0.0, 0.0
        for batch in dev_loader:
            arrays = self._put(batch.arrays())
            m = self._eval_step(arrays)
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
        # (step, device metrics, step_done) of queued but unread steps:
        # reading a loss waits for its step alone (_reading), so the deque
        # keeps the host max_inflight steps ahead of the card
        pending: deque = deque()
        # (step, metrics, loss, step_done) of the newest read step
        drained = [None]

        def drain(to_len: int = 0):
            while len(pending) > to_len:
                s, m, done = pending.popleft()
                with annotate("gtos/fit/read_metrics"), self._reading(done):
                    loss_val = float(m["loss"])
                    check_metrics(m)
                if not np.isfinite(loss_val):
                    if self.ckpt is not None:
                        self.ckpt.wait()
                    raise FloatingPointError(
                        f"non-finite loss {loss_val} at step {s}; restart "
                        "with --resume from the last checkpoint")
                drained[0] = (s, m, loss_val, done)

        def save():
            with annotate("gtos/fit/checkpoint"):
                state = self.state_dict()   # every rank: TP gathers
                if self.lead:
                    self.ckpt.save(self.step, state, cursor={
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
                metrics = self.train_step(arrays)
                pending.append((self.step, metrics, self.step_done))
                timer.step(n_tokens=int(raw["token_mask"].sum()),
                           n_edges=_batch_edges_count(raw))
                drain(self.max_inflight)
                step = self.step
                if step % log_every == 0 or step == cfg.total_steps:
                    drain(0)
                    _, m, loss_val, done = drained[0]
                    rates = timer.rates()
                    with annotate("gtos/fit/read_metrics"), \
                            self._reading(done):
                        acc, grad_norm = float(m["acc"]), float(m["grad_norm"])
                    last = {"step": step, "loss": loss_val, "acc": acc,
                            "grad_norm": grad_norm,
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
