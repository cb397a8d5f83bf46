"""The program's spans (utils/profiling.py annotate) on the CPU at tiny
widths: with no profiler running no span enters record_function; under
utils/profiling.trace, which records every thread, Trainer.fit records
its step, prep, feed-wait and metric-read spans on the threads that do
that work, and a served batch records one search-step span per step the
search launched (infer/beam.py's counter), all inside the batch's span."""

import json
import os
import threading

import torch

from gtos_tpu_torch.data import DataLoader
from gtos_tpu_torch.data.dataloader import preprocess
from gtos_tpu_torch.data.extract import build_vocabs
from gtos_tpu_torch.data.synthetic import synthetic_amr_corpus
from gtos_tpu_torch.infer.beam import LAG, Search
from gtos_tpu_torch.infer.decode import decode_batch
from gtos_tpu_torch.models import Generator
from gtos_tpu_torch.train.trainer import Trainer
from gtos_tpu_torch.utils import profiling
from gtos_tpu_torch.utils.config import ModelConfig, TrainConfig

torch.set_num_threads(2)

TINY = dict(d_model=16, d_ff=32, heads=2, enc_layers=1, dec_layers=1,
            char_dim=4, char_filters=8, rel_emb_dim=4, rel_hidden=8,
            max_oov=8, max_target_len=16, dropout=0.0,
            attention_impl="pallas_local")
# 8 graphs in 32-token batches: 3 batches an epoch, so fit's 3 steps take
# the whole epoch and the prefetch thread preps no batch ahead of them
STEPS = 3
MAX_STEPS = 6


def _setup():
    """A tiny model on the CPU, a training loader over 8 synthetic graphs
    (3 batches an epoch, a 2-thread batchify pool), the arrays of the
    first training batch and the first serving batch."""
    g, t = synthetic_amr_corpus(8, seed=0)
    tv, cv, rv, chv, lm = build_vocabs(g, t)
    instances = preprocess(g, t)

    def loader(for_train, workers):
        return DataLoader(instances, tv, cv, rv, chv, lm,
                          batch_size_tokens=32, for_train=for_train,
                          build_local_banks=True, workers=workers,
                          worker_mode="thread")

    served = next(iter(loader(False, 0)))
    dl = loader(True, 2)
    dl.epoch = 1            # the plan of fit's first pass
    assert len(dl) == STEPS
    dl.epoch = 0
    cfg = ModelConfig(token_vocab=len(tv), concept_vocab=len(cv),
                      relation_vocab=len(rv), char_vocab=len(chv), **TINY)
    model = Generator(cfg, device="cpu",
                      rng=torch.Generator().manual_seed(0))
    example = next(iter(loader(True, 0))).arrays()
    return dl, model, cfg, tv, example, served


def _fit(dl, model, cfg, example):
    trainer = Trainer(model, cfg, TrainConfig(warmup_steps=2,
                                              total_steps=STEPS),
                      example, prefetch=2, device="cpu")
    try:
        trainer.fit(dl, log_every=1)
    finally:
        dl.close()
    return trainer


def _spans(prof):
    """(name, thread's native id, start ns, end ns) of the program's host
    spans in the profile."""
    return [(e.name(), e.device_resource_id(), e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith("gtos/")
            and str(e.device_type()) == "DeviceType.CPU"]


def _inside(inner, outer):
    return (inner[1] == outer[1] and outer[2] <= inner[2]
            and inner[3] <= outer[3])


def test_no_span_enters_record_function_without_a_profiler(monkeypatch):
    """Three fit steps (prefetch 2 over a 2-thread batchify pool) and one
    served batch, with record_function made to raise: no span of the
    program enters it while no profiler runs."""
    def refuse(name):
        raise AssertionError(f"span {name} entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    dl, model, cfg, tv, example, served = _setup()
    assert _fit(dl, model, cfg, example).step == STEPS
    hyps = decode_batch(model, served, tv, beam_size=2,
                        max_steps=MAX_STEPS)
    assert len(hyps) == len(served.oov_lists)


def test_fit_records_its_spans_on_the_threads_that_do_the_work(tmp_path):
    """Under trace() (every thread): one "gtos/train/step" and one
    "gtos/trainer/prep" per step, each prep with its pack and copy inside
    it on a thread other than the main one, and the feed's wait and the
    metric reads on the main thread; the Chrome trace holds them."""
    dl, model, cfg, _, example, _ = _setup()
    with profiling.trace(str(tmp_path)) as prof:
        _fit(dl, model, cfg, example)
    spans = _spans(prof)
    main = threading.main_thread().native_id

    def named(name):
        return [s for s in spans if s[0] == name]

    steps, preps = named("gtos/train/step"), named("gtos/trainer/prep")
    assert len(steps) == STEPS and len(preps) == STEPS
    assert all(s[1] == main for s in steps)
    assert all(p[1] != main for p in preps)
    for child in ("gtos/trainer/pack", "gtos/trainer/to_device"):
        kids = named(child)
        assert len(kids) == STEPS
        assert all(any(_inside(k, p) for p in preps) for k in kids)
    for name in ("gtos/prefetch/wait", "gtos/fit/read_metrics"):
        assert named(name) and all(s[1] == main for s in named(name))
    # the prefetch thread waits on the pool, whose threads batchify
    assert named("gtos/loader/pool_wait")
    assert all(s[1] != main for s in named("gtos/loader/pool_wait"))
    assert all(s[1] != main for s in named("gtos/loader/emit"))
    with open(os.path.join(tmp_path, "trace.json")) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"gtos/train/step", "gtos/trainer/prep"} <= names


def test_a_served_batch_records_one_step_span_per_launched_step():
    """One decode_batch under the profiler: as many "gtos/search/step"
    spans as the search's counter grew by, between LAG and max_steps, and
    every "gtos/search/*" span inside the batch's "gtos/decode/batch"."""
    dl, model, _, tv, _, served = _setup()
    dl.close()
    before = Search.launched_steps
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        decode_batch(model, served, tv, beam_size=2, max_steps=MAX_STEPS)
    launched = Search.launched_steps - before
    spans = _spans(prof)
    batch = [s for s in spans if s[0] == "gtos/decode/batch"]
    assert len(batch) == 1
    steps = [s for s in spans if s[0] == "gtos/search/step"]
    assert len(steps) == launched
    assert LAG <= launched <= MAX_STEPS
    search = [s for s in spans if s[0].startswith("gtos/search/")]
    assert all(_inside(s, batch[0]) for s in search)
    for name in ("gtos/decode/to_device", "gtos/decode/prep",
                 "gtos/decode/read", "gtos/decode/detok"):
        assert [s for s in spans if s[0] == name]
