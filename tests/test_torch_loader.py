"""The port's DataLoader options against the JAX package's on the CPU:
batch_multiple and max_batch_instances give the same plan and arrays,
worker pools (processes from a forkserver, or threads) give the same
batches as building them in order, and host_count > 1 (a rank's rows)
gives the JAX package's batches. Exact equality: the data layer has no
floating point."""

import dataclasses
import inspect
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from gtos_tpu.data import DataLoader as JaxDataLoader
from gtos_tpu.data.dataloader import preprocess as jax_preprocess
from gtos_tpu.data.extract import build_vocabs as jax_build_vocabs
from gtos_tpu.data.synthetic import (
    synthetic_dependency_corpus as jax_dependency_corpus,
)
from gtos_tpu_torch.data import DataLoader
from gtos_tpu_torch.data.dataloader import preprocess
from gtos_tpu_torch.data.extract import build_vocabs
from gtos_tpu_torch.data.synthetic import synthetic_dependency_corpus

# 60 translator sentences of 10-50 tokens: node buckets 16-64, several
# batches per bucket at 512 tokens, bank overflows that bisect
CORPUS = dict(n=60, seed=0, min_len=10, max_len=50)


@pytest.fixture(scope="module")
def corpora():
    jg, jt = jax_dependency_corpus(**CORPUS)
    pg, pt = synthetic_dependency_corpus(**CORPUS)
    return ((jax_preprocess(jg, jt), jax_build_vocabs(jg, jt)),
            (preprocess(pg, pt), build_vocabs(pg, pt)))


def _epochs(loader, n=2):
    """n epochs of (instance indices, arrays) per batch."""
    out = []
    for _ in range(n):
        out.append([([i.orig_index for i in group], batch.arrays())
                    for batch, group in loader.iter_with_instances()])
    return out


def _assert_same(a, b):
    assert len(a) == len(b)
    for ea, eb in zip(a, b):
        assert len(ea) == len(eb) > 1
        for (ia, xa), (ib, xb) in zip(ea, eb):
            assert ia == ib
            assert xa.keys() == xb.keys()
            for k in xa:
                assert xa[k].dtype == xb[k].dtype, k
                np.testing.assert_array_equal(xa[k], xb[k], err_msg=k)


def test_signature_is_the_jax_packages():
    """Every keyword of the JAX package's DataLoader, in its order, with
    its default."""
    ref = inspect.signature(JaxDataLoader.__init__).parameters
    got = inspect.signature(DataLoader.__init__).parameters
    assert list(got) == list(ref)
    for name, p in ref.items():
        want, have = p.default, got[name].default
        if name == "spec":  # each package's own BucketSpec
            want, have = dataclasses.asdict(want), dataclasses.asdict(have)
        assert have == want, name


@pytest.mark.parametrize("cap", [None, 2, 5])
@pytest.mark.parametrize("multiple", [1, 3, 4])
def test_batch_multiple_and_max_batch_instances_match_jax(
        corpora, multiple, cap):
    """batch_multiple pads the batch dimension, after the power of two, up
    to a multiple; max_batch_instances cuts a planned batch at that many
    instances. Training loaders (local banks and the localize
    auxiliaries) over two epochs: the same plan and every array equal to
    the JAX package's."""
    (ji, jv), (pi, pv) = corpora
    kw = dict(batch_size_tokens=512, for_train=True, seed=5,
              build_local_banks=True, batch_multiple=multiple,
              max_batch_instances=cap)
    ref = _epochs(JaxDataLoader(ji, *jv, **kw))
    got = _epochs(DataLoader(pi, *pv, **kw))
    _assert_same(ref, got)
    for idx, arrays in got[0]:
        B = arrays["concept"].shape[0]
        assert B % multiple == 0 and B >= len(idx)
        assert cap is None or len(idx) <= cap
    if multiple == 3:  # B not a power of two: 1 or 2 -> 3, 4 -> 6, 8 -> 9
        assert any(a["concept"].shape[0] & (a["concept"].shape[0] - 1)
                   for _, a in got[0])


@pytest.mark.parametrize("mode", ["process", "thread"])
def test_worker_pools_give_the_in_order_batches(corpora, mode):
    """workers=4 in "process" mode (a forkserver pool; each worker unpickles
    the loader once and is sent instance indices) and in "thread" mode:
    over two epochs of a training loader, the same batches in the same
    order with every array equal to workers=0's; close() shuts the pool
    down and a later epoch starts a new one."""
    _, (pi, pv) = corpora
    kw = dict(batch_size_tokens=512, for_train=True, seed=5,
              build_local_banks=True)
    ref = _epochs(DataLoader(pi, *pv, **kw))
    loader = DataLoader(pi, *pv, workers=4, worker_mode=mode, **kw)
    try:
        got = _epochs(loader)
        assert loader._pool is not None
        _assert_same(ref, got)
        loader.close()
        assert loader._pool is None
        loader.close()
        loader.epoch = 0
        _assert_same(ref[:1], _epochs(loader, 1))
    finally:
        loader.close()


def test_worker_pool_yields_the_loaders_own_instances(corpora):
    """A process pool sends back batches and instance counts, not
    instances: the groups a pooled loader yields are the loader's own
    Instance objects, as without workers."""
    _, (pi, pv) = corpora
    loader = DataLoader(pi, *pv, batch_size_tokens=512, for_train=False,
                        build_local_banks=True, workers=2)
    try:
        ids = {id(i) for i in pi}
        groups = [g for _, g in loader.iter_with_instances()]
        assert sum(len(g) for g in groups) == len(pi)
        assert all(id(i) in ids for g in groups for i in g)
    finally:
        loader.close()


@pytest.mark.parametrize("kw,err,match", [
    # ids kept from when multi-host sharding raised naming ROADMAP A9
    pytest.param(dict(host_count=2), ValueError, "batch_multiple",
                 id="kw0-NotImplementedError-ROADMAP A9"),
    pytest.param(dict(host_count=2, host_rank=1, batch_multiple=2), None,
                 None, id="kw1-NotImplementedError-ROADMAP A9"),
    (dict(workers=2, worker_mode="fork"), ValueError, "worker_mode"),
])
def test_unported_and_bad_loader_options_raise(corpora, kw, err, match):
    """Multi-host row sharding (host_count > 1: batchify's host_shard,
    ported with ROADMAP A9) needs batch_multiple to be a multiple of
    host_count, else it raises (the JAX package asserts it); with it, the
    loader gives the JAX package's batches over an epoch, this rank's
    rows filled (err None). An unknown worker_mode raises."""
    (ji, jv), (pi, pv) = corpora
    if err is None:
        ref = list(JaxDataLoader(ji, *jv, seed=3, **kw))
        got = list(DataLoader(pi, *pv, seed=3, **kw))
        assert len(ref) == len(got) > 1
        for jb, pb in zip(ref, got):
            ja, pa = jb.arrays(), pb.arrays()
            assert ja.keys() == pa.keys()
            for k in ja:
                np.testing.assert_array_equal(ja[k], pa[k], err_msg=k)
        return
    with pytest.raises(err, match=match):
        DataLoader(pi, *pv, **kw)


# packs training batches (local banks, the localize auxiliaries) and the
# tile layouts in a fresh interpreter, through a 2-worker process pool,
# and reports whether torch was imported there
NO_TORCH_SCRIPT = textwrap.dedent("""
    import json, sys
    from gtos_tpu_torch.data import DataLoader
    from gtos_tpu_torch.data.dataloader import preprocess
    from gtos_tpu_torch.data.extract import build_vocabs
    from gtos_tpu_torch.data.synthetic import synthetic_dependency_corpus

    def main():
        g, t = synthetic_dependency_corpus(24, seed=1)
        inst, vocabs = preprocess(g, t), build_vocabs(g, t)
        loader = DataLoader(inst, *vocabs, batch_size_tokens=128,
                            build_local_banks=True, workers=2)
        n = len(list(loader))
        loader.close()
        tiles = DataLoader(inst, *vocabs, for_train=False,
                           build_block_tiles=True)
        n += len(list(tiles))
        print(json.dumps({"batches": n, "torch": "torch" in sys.modules}))

    if __name__ == "__main__":
        main()
""")


def test_packing_imports_no_torch(tmp_path):
    """The data layer (preprocess, batchify with local banks, the localize
    auxiliaries and the tile layouts, the DataLoader and its process pool)
    runs in a fresh interpreter without importing torch: packing calls no
    torch op, and a pool worker starts without torch's import time."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp_path / "pack.py"
    script.write_text(NO_TORCH_SCRIPT)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root, os.environ.get("PYTHONPATH", "")]))
    res = subprocess.run([sys.executable, str(script)], cwd=root, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    report = json.loads(res.stdout.strip().splitlines()[-1])
    assert report["batches"] > 2 and report["torch"] is False


def test_abandoned_prefetch_joins_its_thread():
    """A consumer that stops early (Trainer.fit at total_steps) leaves no
    prefetch thread running: the thread finishes the item in hand and is
    joined when the iterator closes. A daemon thread still inside torch
    when the interpreter exits can abort the process ("terminate called
    without an active exception", seen at the train CLI's exit)."""
    import threading
    import time

    from gtos_tpu_torch.data.prefetch import prefetch_iter

    def slow(x):
        time.sleep(0.05)
        return x

    it = prefetch_iter(range(100), slow, depth=2)
    assert next(it) == 0
    it.close()
    assert not any(t.name == "gtos-prefetch" and t.is_alive()
                   for t in threading.enumerate())
    assert list(prefetch_iter(range(5), slow, depth=2)) == list(range(5))
