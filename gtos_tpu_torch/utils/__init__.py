from gtos_tpu_torch.utils.config import ModelConfig, TrainConfig
from gtos_tpu_torch.utils.device import resolve_device

__all__ = ["ModelConfig", "TrainConfig", "resolve_device"]
