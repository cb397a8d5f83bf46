"""Rank workers for the port's multi-device tests (no jax here: the ranks
are spawned processes, and a spawned child imports the module that holds
its function). `spawn(name, world, tmp, **kw)` starts `world` gloo ranks
on the CPU, rendezvousing on a file under `tmp`, runs `WORKERS[name](mesh
or rank, **kw)` in each and returns their results (torch.save'd), rank
order, within SPAWN_TIMEOUT seconds or failing with each rank's error.
The JAX references reach the ranks as files under `tmp`."""

from __future__ import annotations

import os

import numpy as np
import torch


# seconds the ranks of one spawn may take, all together: a rank that hangs
# fails its test with every rank's error instead of the suite's clock
SPAWN_TIMEOUT = 300


def spawn(name, world, tmp, **kw):
    import time

    import torch.multiprocessing as mp

    tmp = str(tmp)
    init = f"file://{os.path.join(tmp, f'rdv_{name}_{world}')}"
    ctx = mp.start_processes(_entry, args=(name, world, init, tmp, kw),
                             nprocs=world, start_method="spawn", join=False)
    deadline = time.monotonic() + SPAWN_TIMEOUT
    while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
        if time.monotonic() >= deadline:
            alive = [r for r, p in enumerate(ctx.processes) if p.is_alive()]
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(
                f"{name}: ranks {alive} of {world} still running after "
                f"{SPAWN_TIMEOUT} s;\n" + _errors(name, world, tmp))
    return [torch.load(os.path.join(tmp, f"out_{name}_{r}.pt"),
                       weights_only=False) for r in range(world)]


def _errors(name, world, tmp):
    out = []
    for r in range(world):
        path = os.path.join(tmp, f"err_{name}_{r}.txt")
        out.append(f"rank {r}: " + (open(path).read() if os.path.exists(path)
                                    else "no error recorded"))
    return "\n".join(out)


def _entry(rank, name, world, init, tmp, kw):
    import traceback

    import torch.distributed as dist

    from gtos_tpu_torch.parallel.mesh import init_distributed

    torch.set_num_threads(1)
    init_distributed(rank, world, init, "cpu")
    try:
        out = WORKERS[name](**kw)
        torch.save(out, os.path.join(tmp, f"out_{name}_{rank}.pt"))
        # no rank leaves while another still talks to it
        dist.barrier()
    except BaseException:
        with open(os.path.join(tmp, f"err_{name}_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def _mesh(dp=None, mp=1, graph=1):
    from gtos_tpu_torch.parallel.mesh import make_mesh
    return make_mesh(dp=dp, mp=mp, graph=graph, device="cpu")


def mesh_layout(dp, mp, graph):
    """This rank's coordinates and each axis group's global ranks."""
    import torch.distributed as dist

    mesh = _mesh(dp, mp, graph)
    return dict(rank=dist.get_rank(), coords=dict(mesh.coords),
                groups={a: dist.get_process_group_ranks(mesh.group(a))
                        for a in ("data", "model", "graph")})


def shard_layout(path, dp, graph, cp_schedule):
    """shard_arrays' part of a whole batch (numpy)."""
    from gtos_tpu_torch.parallel.mesh import shard_arrays

    arrays = dict(np.load(path))
    mesh = _mesh(dp, 1, graph)
    return {k: v.numpy() for k, v in
            shard_arrays(mesh, arrays, cp_schedule).items()}


def cp_attention(path, schedules):
    """{schedule: [out, dq, dk, dv, g_a, g_b]}: each CP schedule's output
    and the gradients of sum(out * cot) with respect to the whole q, k, v
    and the banks, on this rank (graph = world)."""
    return {s: _cp_attention(path, s) for s in schedules}


def _cp_attention(path, schedule):
    import torch.distributed as dist

    from gtos_tpu_torch.parallel import (
        a2a_attention, ring_attention, ring_block_sparse)

    mesh = _mesh(1, 1, dist.get_world_size())
    d = {k: torch.from_numpy(v) for k, v in np.load(path).items()}
    leaves = [d[k].clone().requires_grad_() for k in ("q", "k", "v", "a",
                                                      "b")]
    cells = [d[k] for k in ("edge_src", "edge_dst", "edge_rel",
                            "edge_mask")]
    if schedule == "ring":
        out = ring_attention.ring_sparse_relation_attention(
            mesh, *leaves, *cells)
    elif schedule == "a2a":
        out = a2a_attention.a2a_sparse_relation_attention(
            mesh, *leaves, *cells)
    else:
        tiles = [d[k] for k in ("ctile_src", "ctile_rel", "ctile_dst",
                                "ctile_rel_src")]
        if schedule == "block_sparse_edge_bwd":   # no src-major cells
            tiles[2:] = [None, None]
        out = ring_block_sparse.ring_block_sparse_relation_attention(
            mesh, *leaves, *tiles[:2], *cells, ctile_dst=tiles[2],
            ctile_rel_src=tiles[3])
    grads = torch.autograd.grad((out * d["cot"]).sum(), leaves)
    return [out.detach().numpy()] + [g.numpy() for g in grads]


def _model(cfg_json, state_path, mesh=None):
    from gtos_tpu_torch.models import Generator
    from gtos_tpu_torch.utils.config import ModelConfig

    cfg = ModelConfig.from_json(cfg_json)
    model = Generator(cfg, device="cpu", cp_mesh=(
        mesh if mesh is not None and mesh.size("graph") > 1 else None))
    model.load_state_dict(torch.load(state_path))
    return model


def train_step(cfg_json, state_path, arrays_path, dp, mp, graph):
    """This rank's loss metrics, gradient norm and every parameter's
    gradient (whole: TP shards gathered), summed over the data group, as
    the sharded step computes them; and the token count of its rows."""
    from gtos_tpu_torch.parallel import tensor_parallel as tp
    from gtos_tpu_torch.parallel.mesh import shard_arrays
    from gtos_tpu_torch.train.optim import global_norm
    from gtos_tpu_torch.train.trainer import train_grads

    mesh = _mesh(dp, mp, graph)
    model = tp.shard_model(_model(cfg_json, state_path, mesh), mesh)
    names, params = zip(*model.named_parameters())
    arrays = shard_arrays(mesh, dict(np.load(arrays_path)),
                          model.cfg.cp_schedule)
    _, metrics, grads = train_grads(model, params, arrays,
                                    mesh.group("data"))
    norm = (tp.global_norm(grads, params, mesh.group("model"))
            if mp > 1 else global_norm(grads))
    whole = {n: tp.gather_full(g, p).numpy()
             for n, g, p in zip(names, grads, params)}
    return dict(loss=metrics["loss"].item(), acc=metrics["acc"].item(),
                n_tok=metrics["n_tok"].item(), grad_norm=norm.item(),
                rows_tok=int(arrays["token_mask"].sum()), grads=whole,
                shapes={n: tuple(p.shape) for n, p in zip(names, params)})


def trainer_steps(cfg_json, state_path, arrays_path, dp, mp, graph, steps):
    """The Trainer's losses over `steps` steps on one batch under a mesh,
    and its checkpoint state (whole under TP)."""
    from gtos_tpu_torch.train.trainer import Trainer
    from gtos_tpu_torch.utils.config import TrainConfig

    mesh = _mesh(dp, mp, graph)
    model = _model(cfg_json, state_path, mesh)
    raw = dict(np.load(arrays_path))
    trainer = Trainer(model, model.cfg, TrainConfig(warmup_steps=3), raw,
                      mesh=mesh, device="cpu")
    losses = [trainer.train_step(trainer._put(raw))["loss"].item()
              for _ in range(steps)]
    state = trainer.state_dict()
    return dict(losses=losses, params={k: v.numpy() for k, v in
                                       state["params"].items()},
                mu=[t.numpy() for t in state["opt_state"]["mu"]])


def mesh_steps(cfg_json, state_path, arrays_path, bs_cfg_json,
               bs_arrays_path, train_kw, search_cfg_json):
    """The mesh steps' cases on two ranks, in one spawn:

      accum   dp=2, TrainConfig(**train_kw) (accum_steps=2): the
              Trainer's parameters, Adam's moments and count after two
              steps on the whole batch;
      path    step_path at dp=2, and the error of compiled=True there
              (the CPU's); under a context-parallel mesh (graph=2) its
              step_path and the error of compiled=True (EAGER_MESH);
      search  search_graphs(compiled=True)'s error under a tensor-
              parallel mesh (mp=2) and under graph=2;
      tp_search  beam_decode_arrays (beam 2, 8 steps) of the batch by the
              model of search_cfg_json (bf16 compute) split at mp=2: its
              tokens and scores, searched on the serving copy;
      layout  block_sparse at dp=2: the layout flag of a step on
              matching tile layouts, and the error of a step whose
              src-major layout holds no pair."""
    from gtos_tpu_torch.infer.decode import beam_decode_arrays, search_graphs
    from gtos_tpu_torch.models import Generator
    from gtos_tpu_torch.parallel import tensor_parallel as tp
    from gtos_tpu_torch.train.trainer import Trainer, check_metrics
    from gtos_tpu_torch.utils.config import ModelConfig, TrainConfig

    def error(fn):
        try:
            fn()
        except ValueError as e:
            return str(e)
        return None

    dp, tpm, cp = _mesh(2), _mesh(1, 2), _mesh(1, 1, 2)
    raw = dict(np.load(arrays_path))
    tcfg = TrainConfig(**train_kw)

    def new(mesh, model=None, **kw):
        model = model or _model(cfg_json, state_path, mesh)
        return Trainer(model, model.cfg, tcfg, raw, mesh=mesh,
                       device="cpu", **kw)

    trainer = new(dp)
    for _ in range(2):
        check_metrics(trainer.train_step(trainer._put(raw)))
    state = trainer.state_dict()
    out = dict(accum=dict(
        params={k: v.numpy() for k, v in state["params"].items()},
        names=[n for n, _ in trainer.model.named_parameters()],
        mu=[t.numpy() for t in state["opt_state"]["mu"]],
        nu=[t.numpy() for t in state["opt_state"]["nu"]],
        count=int(state["opt_state"]["count"]),
        mini_step=state["opt_state"]["mini_step"]))
    cp_model = _model(cfg_json, state_path, cp)
    out["path"] = dict(
        dp=trainer.step_path(raw),
        dp_compiled=error(lambda: new(dp, compiled=True)),
        cp=new(cp, cp_model).step_path(raw),
        cp_compiled=error(lambda: new(cp, compiled=True)))
    tp_model = tp.shard_model(_model(cfg_json, state_path), tpm)
    out["search"] = dict(
        tp=error(lambda: search_graphs(tp_model, compiled=True)),
        tp_enabled=search_graphs(tp_model).enabled,
        cp=error(lambda: search_graphs(cp_model, compiled=True)))
    bf16 = tp.shard_model(_model(search_cfg_json, state_path), tpm)
    res = beam_decode_arrays(bf16, raw, beam_size=2, max_steps=8)
    out["tp_search"] = dict(seqs=res.seqs.numpy(), scores=res.scores.numpy())
    bs_raw = dict(np.load(bs_arrays_path))
    bs_cfg = ModelConfig.from_json(bs_cfg_json)
    bs = Trainer(Generator(bs_cfg, device="cpu"), bs_cfg, tcfg, bs_raw,
                 mesh=dp, device="cpu")
    metrics = bs.train_step(bs._put(bs_raw))
    check_metrics(metrics)
    wrong = dict(bs_raw, tile_rel_src=np.full_like(bs_raw["tile_rel_src"],
                                                   -1))
    out["layout"] = dict(ok=float(metrics["layout_ok"]), error=error(
        lambda: bs.train_step(bs._put(wrong))))
    return out


def decode(cfg_json, state_path, batch_path, beam, steps):
    """beam_decode_arrays' tokens under a CP mesh (graph = world)."""
    import pickle

    import torch.distributed as dist

    from gtos_tpu_torch.infer.decode import beam_decode_arrays

    mesh = _mesh(1, 1, dist.get_world_size())
    model = _model(cfg_json, state_path, mesh)
    with open(batch_path, "rb") as f:
        arrays = pickle.load(f)
    res = beam_decode_arrays(model, arrays, beam_size=beam, max_steps=steps)
    return res.seqs.numpy()


def scaling(num_nodes):
    import torch.distributed as dist

    from gtos_tpu_torch.parallel.scaling import scaling_report

    return scaling_report(_mesh(1, 1, dist.get_world_size()),
                          num_nodes=num_nodes, heads=2, dim=16)


WORKERS = dict(mesh_layout=mesh_layout, shard_layout=shard_layout,
               cp_attention=cp_attention, train_step=train_step,
               trainer_steps=trainer_steps, mesh_steps=mesh_steps,
               decode=decode, scaling=scaling)
