"""The JAX package's package-level names (each `__all__` of its
`__init__` files) resolve from the port's packages of the same name, the
five of gtos_tpu.ops.pallas from gtos_tpu_torch.ops (the port has no
`pallas` subpackage). The only names left out are the JAX package's
sharding helpers, which lay JAX arrays out over a device mesh
(gtos_tpu_torch/parallel/__init__.py says why). The port's train, ops
and parallel packages give theirs lazily: importing them loads no
torch."""

import importlib
import json
import os
import subprocess
import sys

import pytest
import torch

# gtos_tpu.parallel's names that place JAX arrays on a mesh
JAX_ONLY = {"parallel": {"batch_sharding", "replicate", "param_spec",
                         "shard_state", "state_shardings"}}
PACKAGES = [("train", "train"), ("parallel", "parallel"), ("ops", "ops"),
            ("ops.pallas", "ops"), ("graph", "graph"), ("utils", "utils"),
            ("models", "models"), ("data", "data"), ("infer", "infer")]


@pytest.mark.parametrize("jax_pkg,port_pkg", PACKAGES,
                         ids=[j for j, _ in PACKAGES])
def test_jax_package_names_resolve_in_the_port(jax_pkg, port_pkg):
    """Every name of gtos_tpu.<jax_pkg>.__all__ but JAX_ONLY's is in
    gtos_tpu_torch.<port_pkg>.__all__ and resolves there: a callable
    where the JAX package's is one, else an equal value; JAX_ONLY's do
    not resolve."""
    jax_mod = importlib.import_module(f"gtos_tpu.{jax_pkg}")
    port = importlib.import_module(f"gtos_tpu_torch.{port_pkg}")
    left_out = JAX_ONLY.get(jax_pkg, set())
    assert left_out <= set(jax_mod.__all__)
    for name in jax_mod.__all__:
        if name in left_out:
            assert not hasattr(port, name), name
            continue
        assert name in port.__all__, name
        mine, theirs = getattr(port, name), getattr(jax_mod, name)
        if callable(theirs):
            assert callable(mine), name
        else:
            assert mine == theirs, name


def test_ported_names_are_the_modules_own():
    """The lazy names are the objects of the modules that define them;
    make_optimizer returns the port's Optimizer over the parameters it is
    given; `gtos_tpu_torch.ops.local_relation_attention` is the module
    ops/local_relation_attention.py, and calling it calls its function of
    that name."""
    import gtos_tpu_torch.ops as ops
    import gtos_tpu_torch.parallel as parallel
    import gtos_tpu_torch.train as train
    from gtos_tpu_torch.ops import local_relation_attention as lra
    from gtos_tpu_torch.ops import relation_attention, segment
    from gtos_tpu_torch.ops.local_relation_attention import (
        local_relation_attention_reference)
    from gtos_tpu_torch.parallel import mesh, ring_block_sparse
    from gtos_tpu_torch.train import optim, trainer
    from gtos_tpu_torch.utils.config import TrainConfig
    from test_torch_cuda import make_case, port_local_args

    assert train.Trainer is trainer.Trainer
    assert train.make_train_step is trainer.make_train_step
    params = [torch.zeros(3, requires_grad=True)]
    opt = train.make_optimizer(TrainConfig(), 32, params)
    assert isinstance(opt, optim.Optimizer) and opt.params == params
    assert parallel.make_mesh is mesh.make_mesh
    assert (parallel.ring_block_sparse_relation_attention
            is ring_block_sparse.ring_block_sparse_relation_attention)
    assert ops.segment_softmax is segment.segment_softmax
    assert (ops.pallas_relation_attention
            is relation_attention.pallas_relation_attention)
    assert ops.local_relation_attention is lra
    args = port_local_args(make_case(2, 2, 16, 8, 64, 32))
    torch.testing.assert_close(lra(*args),
                               local_relation_attention_reference(*args),
                               rtol=0, atol=0)
    with pytest.raises(AttributeError):
        ops.no_such_name


def test_lazy_packages_import_no_torch():
    """In a fresh interpreter, importing gtos_tpu_torch.train, .ops and
    .parallel loads no torch (the DataLoader's pool workers import
    train/train.py; data/batching.py imports ops/block_sparse.py); the
    first of their names asked for does."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = (
        "import json, sys\n"
        "import gtos_tpu_torch.train, gtos_tpu_torch.ops, "
        "gtos_tpu_torch.parallel\n"
        "before = 'torch' in sys.modules\n"
        "from gtos_tpu_torch.ops import segment_softmax\n"
        "print(json.dumps([before, 'torch' in sys.modules]))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root, os.environ.get("PYTHONPATH", "")]))
    res = subprocess.run([sys.executable, "-c", script], cwd=root, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1]) == [False, True]
