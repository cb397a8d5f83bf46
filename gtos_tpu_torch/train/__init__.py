"""Training: the optimizer, the checkpoint format, the Trainer and the
`python -m gtos_tpu_torch.train.train` CLI.

The JAX package's package-level names (gtos_tpu/train/__init__.py) are
given lazily (PEP 562): importing this package loads nothing, since the
DataLoader's pool workers import train/train.py and must start without
torch. `make_optimizer(cfg, d_model, params)` returns the port's
Optimizer over `params`: the JAX package's returns an optax chain that a
train state then initialises on the parameters; here the chain and its
state are one object."""

import importlib

_NAMES = {"inverse_sqrt_schedule": "optim", "make_optimizer": "optim",
          "TrainState": "trainer", "Trainer": "trainer",
          "make_train_step": "trainer"}
__all__ = list(_NAMES)


def __getattr__(name):
    if name not in _NAMES:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_NAMES[name]}"),
                   name)
