"""Plain torch ops and the hand-written CUDA kernels with their wrappers.
Nothing here touches CUDA or nvcc at import time: a kernel is built and
loaded by its wrapper at its first launch (ops/build.py).

The JAX package's package-level names of gtos_tpu/ops/__init__.py and of
gtos_tpu/ops/pallas/__init__.py are given here, lazily (PEP 562), so that
importing the package loads nothing (data/batching.py imports
ops/block_sparse.py, and the data layer runs without torch). The port
has no `pallas` subpackage: each Pallas kernel's counterpart lives in the
ops module of the same name beside its plain version, and the JAX
package's pallas entries are those modules' functions. One name is both:
`local_relation_attention` is the module ops/local_relation_attention.py,
which the port imports by that name, and calling it calls its function
`local_relation_attention`."""

import importlib

_NAMES = {"bank_relation_attention": "attention",
          "bank_relation_scores": "attention",
          "dense_relation_scores_reference": "attention",
          "segment_softmax": "segment", "sparse_sddmm": "segment",
          "sparse_spmm": "segment",
          "fused_relation_attention": "relation_attention",
          "pallas_relation_attention": "relation_attention",
          "relation_attention_trainable": "relation_attention",
          "local_relation_attention_trainable": "local_relation_attention"}
__all__ = list(_NAMES) + ["local_relation_attention"]


def __getattr__(name):
    if name == "local_relation_attention":
        return importlib.import_module(f"{__name__}.{name}")
    if name not in _NAMES:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_NAMES[name]}"),
                   name)
