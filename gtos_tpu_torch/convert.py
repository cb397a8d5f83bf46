"""The JAX package's parameter tree -> the port's state_dict.

The port's modules carry the flax module names, so a flax path maps onto a
torch key name for name (`token_encoder/char_cnn/conv3/kernel` ->
`token_encoder.char_cnn.conv3.weight`). The leaves are re-laid out:

  * Dense kernels are [in, out]; torch Linear weights are [out, in];
  * Conv kernels are [width, in, out]; torch conv1d wants [out, in, width];
  * Embed `embedding` and LayerNorm `scale` become `weight`;
  * a flax GRUCell's six dense layers (ir, iz, in with biases; hr, hz
    without; hn with) become the port's fused GRUCell: weight_ih / bias_ih
    and weight_hh in gate order (r, z, n), and bias_hn.

The output projection is tied to the decoder embedding in both packages,
so it has no leaf of its own. The tree is passed as nested dicts of numpy
arrays (e.g. `jax.device_get(params)`); this module imports no JAX.

`train_state_from_jax` carries a whole JAX TrainState across: the
parameters, optax's Adam moments (which have the parameters' tree, and
are re-laid out the same way) and count, and under accumulation
optax.MultiSteps' running mean and mini-step, onto the port's model and
`Optimizer`, with the step count.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

_GRU_GATES = ("ir", "iz", "in", "hr", "hz", "hn")


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _gru(cell: Mapping) -> Dict[str, torch.Tensor]:
    return {
        "weight_ih": torch.cat([_t(cell[g]["kernel"]).T
                                for g in ("ir", "iz", "in")]),
        "bias_ih": torch.cat([_t(cell[g]["bias"]) for g in ("ir", "iz", "in")]),
        "weight_hh": torch.cat([_t(cell[g]["kernel"]).T
                                for g in ("hr", "hz", "hn")]),
        "bias_hn": _t(cell["hn"]["bias"]),
    }


def _leaf(name: str, value) -> tuple:
    x = _t(value)
    if name == "kernel":
        if x.dim() == 2:
            return "weight", x.T.contiguous()
        if x.dim() == 3:
            return "weight", x.permute(2, 1, 0).contiguous()
        raise ValueError(f"kernel of rank {x.dim()}")
    if name in ("embedding", "scale"):
        return "weight", x
    if name == "bias":
        return "bias", x
    raise ValueError(f"unknown flax leaf {name!r}")


def state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax params ({"params": tree} or the tree itself) -> state_dict for
    `gtos_tpu_torch.models.Generator.load_state_dict` (f32 tensors; the
    load casts them to the model's compute dtype)."""
    tree = params.get("params", params)
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Mapping, prefix: str):
        if "cell" in node and set(node["cell"]) == set(_GRU_GATES):
            for k, v in _gru(node["cell"]).items():
                out[f"{prefix}{k}"] = v
            return
        for name, child in node.items():
            if isinstance(child, Mapping):
                walk(child, f"{prefix}{name}.")
            else:
                key, value = _leaf(name, child)
                out[f"{prefix}{key}"] = value

    walk(tree, "")
    return out


def _find(tree, fields):
    """The first node of an optax state (tuples and named tuples) that has
    all of `fields`, or None."""
    if all(hasattr(tree, f) for f in fields):
        return tree
    if isinstance(tree, tuple):
        for child in tree:
            hit = _find(child, fields)
            if hit is not None:
                return hit
    return None


def train_state_from_jax(state, model, opt):
    """A JAX TrainState (`jax.device_get` of gtos_tpu.train.TrainState:
    numpy leaves, optax's state as its named tuples) loaded into the
    port's `model` (a Generator) and `opt` (train/optim.py Optimizer):
    parameters; Adam's mu, nu and count; with accumulation MultiSteps'
    acc_grads and mini_step. Returns the port's TrainState with the JAX
    step (a Trainer resuming from it sets `Trainer.step` to it). The JAX
    state's PRNG key has no torch counterpart: the dropout generator is
    left as it is. Raises when the two optimizers' accumulation differs."""
    from gtos_tpu_torch.train.trainer import init_state

    model.load_state_dict(state_dict_from_flax(state.params))
    names = [n for n, _ in model.named_parameters()]

    def by_name(tree):
        sd = state_dict_from_flax(tree)
        return [sd[n] for n in names]

    adam = _find(state.opt_state, ("count", "mu", "nu"))
    if adam is None:
        raise ValueError("no Adam state (count, mu, nu) in the JAX state")
    multi = _find(state.opt_state, ("mini_step", "acc_grads"))
    if (multi is not None) != ("mini_step" in opt.state):
        raise ValueError("the JAX optimizer and the port's differ in "
                         "accumulation (optax.MultiSteps vs accum_steps)")
    new = {"count": torch.tensor(int(np.asarray(adam.count)),
                                 dtype=torch.int32),
           "mu": by_name(adam.mu), "nu": by_name(adam.nu)}
    if multi is not None:
        new.update(mini_step=int(np.asarray(multi.mini_step)),
                   acc=by_name(multi.acc_grads))
    opt.load_state_dict(new)
    return init_state(model, opt, step=int(np.asarray(state.step)))
