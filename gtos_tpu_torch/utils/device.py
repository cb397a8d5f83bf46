"""Where the port runs: on the card unless the caller asks for the CPU.

torch is imported at the call, so that importing gtos_tpu_torch.utils
(the data layer takes its spans from utils/profiling.py) leaves the
batchify pool's workers free of it."""

from __future__ import annotations


def resolve_device(device=None) -> "torch.device":
    """`None` means the CUDA card. Raises when CUDA is asked for (or
    implied) and no card is visible: the port never carries on quietly on
    the CPU; pass device="cpu" for the plain versions there."""
    import torch

    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "gtos_tpu_torch runs on an NVIDIA GPU unless told otherwise, and "
            "torch sees no CUDA device; pass device='cpu' to run on the CPU")
    return device
