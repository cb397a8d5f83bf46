"""A lone graph over the relation-bank ladders, on the CPU.

The DataLoader batches one instance whose relation paths overflow the last
rung of `bank` or `local_bank` alone, at a rung of its own (doublings of
the last rung), with the arrays that a BucketSpec ending at that rung
gives, equal to the JAX package's batchify at that spec; a group of
several graphs over the ladders still bisects into the JAX package's
batches; the loader counts the lone rungs it yields; and a c2 training
step (copy on, no node positions, `pallas_local` through its CPU path) on
such a batch matches the benchmark's plain reference
(perfbench/reference/model.py)."""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from gtos_tpu.data import DataLoader as JaxDataLoader
from gtos_tpu.data.batching import BucketSpec as JaxBucketSpec
from gtos_tpu.data.batching import batchify as jax_batchify
from gtos_tpu.data.dataloader import preprocess as jax_preprocess
from gtos_tpu.data.extract import build_vocabs as jax_build_vocabs
from gtos_tpu.graph.amr import read_amr_file as jax_read_amr_file
from gtos_tpu_torch.data.batching import (
    BankOverflowError, BucketSpec, batchify,
)
from gtos_tpu_torch.data.dataloader import DataLoader
from gtos_tpu_torch.train.train import load_corpus, loader_flags
from perfbench.harness import program
from perfbench.reference.model import Adam, Reference, init_weights, \
    param_spec
from perfbench.traffic import corpora
from perfbench.traffic.train import STILL_SHARE

ROOT = Path(__file__).resolve().parents[1]
# AMR 2.0-shaped graphs of up to 30 concepts: several hold 300-700
# distinct relation paths
CORPUS = dict(generator="amr2", max_nodes=30, max_target=24)
# a ladder that those graphs overflow: lone rungs 512 and 1024 (32**2)
SPEC = BucketSpec(nodes=(16, 32), bank=(64, 128, 256),
                  local_bank=(64, 128, 256))
FLAGS = loader_flags("pallas_local")


@pytest.fixture(scope="module")
def amr(tmp_path_factory):
    """The corpus as the port and the JAX package read it from one PENMAN
    file: (port instances, port vocabs, JAX instances, JAX vocabs,
    triples)."""
    corpus = corpora.generate(CORPUS, 40, 3)
    path, _ = corpora.write_files("amr", corpus,
                                  str(tmp_path_factory.mktemp("amr")), "x")
    graphs, targets = load_corpus("amr", path, None)
    jg = jax_read_amr_file(path)
    jt = [g.meta["snt"].split() for g in jg]
    return (program.preprocess(program.Data(corpus, graphs, targets)),
            program.vocabularies(program.Data(corpus, graphs, targets)),
            jax_preprocess(jg, jt), jax_build_vocabs(jg, jt), corpus)


def _epoch(loader):
    return [([i.orig_index for i in group], batch)
            for batch, group in loader.iter_with_instances()]


@pytest.mark.parametrize("workers", [0, 2])
def test_lone_graph_takes_its_rung_and_is_counted(amr, workers):
    """Each lone graph over the ladders comes alone at the smallest
    doubling of the last rung that holds it, with the arrays of the
    port's and the JAX package's batchify at a spec ending at that rung
    (an explicit batchify at the loader's spec still raises); every other
    batch keeps to the ladders; the counters count the lone rungs (a
    thread pool too)."""
    pi, pv, ji, jv, _ = amr
    loader = DataLoader(pi, *pv, batch_size_tokens=512, spec=SPEC,
                        for_train=True, workers=workers,
                        worker_mode="thread", **FLAGS)
    batches = _epoch(loader)
    loader.close()
    lone = [(idx, b) for idx, b in batches if b.rel_bank.shape[0] > 256]
    assert len(lone) >= 2
    assert {b.rel_bank.shape[0] for _, b in lone} == {512, 1024}
    assert loader.lone_rung_batches == len(lone)
    assert loader.lone_rung_largest == 1024
    for idx, batch in lone:
        assert len(idx) == 1 and batch.batch_size == 1
        rung = batch.rel_bank.shape[0]
        assert batch.bank_map.shape[1] == rung
        group = [pi[idx[0]]]
        spec = dataclasses.replace(SPEC, bank=SPEC.bank + (rung,),
                                   local_bank=SPEC.local_bank + (rung,))
        want = batchify(group, *pv, spec=spec, **FLAGS).arrays()
        jax = jax_batchify([ji[idx[0]]], *jv, spec=JaxBucketSpec(
            nodes=spec.nodes, bank=spec.bank, local_bank=spec.local_bank),
            **FLAGS).arrays()
        got = batch.arrays()
        assert got.keys() == want.keys() == jax.keys()
        for k in got:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            np.testing.assert_array_equal(got[k], jax[k], err_msg=k)
        # the smallest doubling that holds it; the loader's own spec raises
        lower = (rung // 2,) if rung // 2 > SPEC.bank[-1] else ()
        with pytest.raises(BankOverflowError):
            batchify(group, *pv, spec=dataclasses.replace(
                SPEC, bank=SPEC.bank + lower,
                local_bank=SPEC.local_bank + lower), **FLAGS)
    assert all(b.rel_bank.shape[0] <= 256 and b.bank_map.shape[1] <= 256
               for idx, b in batches if len(idx) > 1)


def test_lone_rung_span_is_recorded(amr, tmp_path):
    """Under utils/profiling.trace the batchify of a lone graph records
    "gtos/loader/lone_rung" inside "gtos/loader/emit", once a lone
    graph."""
    from gtos_tpu_torch.utils import profiling

    pi, pv, _, _, _ = amr
    loader = DataLoader(pi, *pv, batch_size_tokens=512, spec=SPEC,
                        for_train=False, **FLAGS)
    with profiling.trace(str(tmp_path)):
        list(loader)
    with open(tmp_path / "trace.json") as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    lone = [e for e in events if e["name"] == "gtos/loader/lone_rung"]
    emit = [e for e in events if e["name"] == "gtos/loader/emit"]
    assert len(lone) == loader.lone_rung_batches >= 2
    for e in lone:
        assert any(o["ts"] <= e["ts"] and e["ts"] + e["dur"] <= o["ts"] +
                   o["dur"] for o in emit)


def test_groups_over_the_ladder_bisect_as_before(amr):
    """Without a lone graph over the ladders, a group of several graphs
    over them bisects into the JAX package's batches, array for array,
    and no lone rung is counted."""
    pi, pv, ji, jv, _ = amr
    spec = dataclasses.replace(SPEC, bank=(64, 128, 256, 1024),
                               local_bank=(64, 128, 256, 1024))
    kw = dict(batch_size_tokens=2048, for_train=True, **FLAGS)
    got = _epoch(DataLoader(pi, *pv, spec=spec, **kw))
    ref = [([i.orig_index for i in group], batch) for batch, group in
           JaxDataLoader(ji, *jv, spec=JaxBucketSpec(
               nodes=spec.nodes, bank=spec.bank,
               local_bank=spec.local_bank), **kw).iter_with_instances()]
    loader = DataLoader(pi, *pv, spec=spec, **kw)
    assert len(got) > len(loader._plan_batches())      # bisected
    assert len(got) == len(ref)
    for (ia, a), (ib, b) in zip(got, ref):
        assert ia == ib
        a, b = a.arrays(), b.arrays()
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    list(loader)
    assert loader.lone_rung_batches == 0


SIZES = dict(d_model=32, d_ff=64, heads=2, enc_layers=2, dec_layers=1,
             compute_dtype="float32")


def test_c2_step_on_a_lone_rung_matches_the_reference(amr):
    """The port's c2 training step (copy, no node positions, `pallas_local`
    on the CPU, dropout on) on the largest lone-rung batch: loss and
    gradients equal the plain float32 reference's, and so does the Adam
    step (leaves whose gradient is nought to rounding left out, as the
    benchmark's check leaves them)."""
    from gtos_tpu_torch.models.generator import batch_to_device
    from gtos_tpu_torch.train.optim import Optimizer

    pi, pv, _, _, _ = amr
    config = json.loads((ROOT / "perfbench" / "configs" /
                         "c2_amr2_full.json").read_text())
    config["model"] = dict(config["model"], **SIZES)
    assert config["model"]["use_copy"] and \
        not config["model"]["use_node_positions"]
    assert config["model"]["attention_impl"] == "pallas_local"
    cfg = program.sizes(config, pv)
    loader = DataLoader(pi, *pv, batch_size_tokens=512, spec=SPEC,
                        for_train=True, **FLAGS)
    batch = max(loader, key=lambda b: b.rel_bank.shape[0])
    assert batch.rel_bank.shape[0] == batch.bank_map.shape[1] == 1024
    torch.manual_seed(0)
    dev = torch.device("cpu")
    model = program.model(cfg, 11, dev).train()
    model.dropout_rng.manual_seed(5)
    loss, _ = model(batch_to_device(batch.arrays(), dev))
    params = list(model.parameters())
    grads = torch.autograd.grad(loss, params)
    w = init_weights(param_spec(cfg), 11, dev)
    P = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    r_loss = Reference(cfg, P).loss(program.to_device(batch.arrays(), dev),
                                    torch.Generator().manual_seed(5))
    r_grads = torch.autograd.grad(r_loss, list(P.values()))
    assert float(loss.detach()) == pytest.approx(float(r_loss.detach()),
                                                rel=1e-5)
    for (k, _), g, rg in zip(model.named_parameters(), grads, r_grads):
        torch.testing.assert_close(g, rg, rtol=1e-4, atol=1e-6, msg=k)
    tcfg = program.train_config(config)
    Optimizer(tcfg, cfg["d_model"], params).step([g.clone() for g in grads])
    Adam(P, cfg["d_model"], tcfg.warmup_steps).step(dict(zip(P, r_grads)))
    norms = {k: float(g.norm()) for k, g in zip(P, r_grads)}
    still = STILL_SHARE * float(np.median(list(norms.values())))
    for k, p in model.named_parameters():
        if norms[k] >= still:
            torch.testing.assert_close(p.detach(), P[k].detach(), rtol=1e-5,
                                       atol=1e-7, msg=k)
