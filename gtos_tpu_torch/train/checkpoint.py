"""Checkpoint/resume in the port's own format (torch.save).

Port of gtos_tpu/train/checkpoint.py's contract, not of its orbax files:
each step is a directory `step_<n>/` holding `params.pt` (the model's
state_dict, f32) and `train_state.pt` (optimizer state, step, and the
dropout generator's state), so inference reads the parameters without the
Adam moments. `cursor.json` holds the data loader's position at the latest
save. The configs ride along as `model_config.json` / `train_config.json`
(the args-in-checkpoint contract: a model is rebuilt from the directory
alone, with `vocabs/` beside them).
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Optional

import torch

from gtos_tpu_torch.utils.config import ModelConfig, TrainConfig

PARAMS, TRAIN_STATE = "params.pt", "train_state.pt"


class CheckpointManager:
    def __init__(self, directory: str, model_cfg: ModelConfig,
                 train_cfg: Optional[TrainConfig] = None,
                 max_to_keep: int = 3, write_configs: bool = True):
        """write_configs=False: a reader only (the ranks but the first of
        a multi-rank run, which write nothing)."""
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        if not write_configs:
            return
        os.makedirs(self.directory, exist_ok=True)
        with open(os.path.join(self.directory, "model_config.json"),
                  "w") as f:
            f.write(model_cfg.to_json())
        if train_cfg is not None:
            with open(os.path.join(self.directory, "train_config.json"),
                      "w") as f:
                f.write(train_cfg.to_json())

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}")

    def steps(self):
        """Saved steps, ascending (a step counts once both files are in
        place)."""
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and name[5:].isdigit() and \
                    os.path.exists(os.path.join(self.directory, name,
                                                TRAIN_STATE)):
                out.append(int(name[5:]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: dict, cursor: Optional[dict] = None):
        """state: {"params": state_dict, "opt_state", "step", "rng"} (the
        Trainer's). cursor: the data loader's position {"epoch", "batch"}
        so resume continues mid-epoch. Written to a temporary directory
        and renamed, so a step directory is complete or absent."""
        final = self._step_dir(step)
        tmp = final + f".tmp{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(state["params"], os.path.join(tmp, PARAMS))
        torch.save({k: v for k, v in state.items() if k != "params"},
                   os.path.join(tmp, TRAIN_STATE))
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        if cursor is not None:
            with open(os.path.join(self.directory, "cursor.json"), "w") as f:
                json.dump(dict(cursor, step=step), f)
        for old in self.steps()[:-self.max_to_keep]:
            shutil.rmtree(self._step_dir(old), ignore_errors=True)

    def wait(self):
        """Saves are synchronous; kept for the JAX package's interface."""

    def restore_latest(self) -> Optional[dict]:
        """The latest saved state (tensors on the CPU), None if none."""
        step = self.latest_step()
        if step is None:
            return None
        d = self._step_dir(step)
        state = torch.load(os.path.join(d, TRAIN_STATE), map_location="cpu")
        state["params"] = torch.load(os.path.join(d, PARAMS),
                                     map_location="cpu")
        return state

    def restore_params(self) -> Optional[dict]:
        """The latest parameters only (a state_dict), None if none."""
        step = self.latest_step()
        if step is None:
            return None
        return torch.load(os.path.join(self._step_dir(step), PARAMS),
                          map_location="cpu")

    def load_cursor(self) -> Optional[dict]:
        """The data loader cursor saved with the latest step (None if
        absent or stale)."""
        path = os.path.join(self.directory, "cursor.json")
        step = self.latest_step()
        if step is None or not os.path.exists(path):
            return None
        with open(path) as f:
            cur = json.load(f)
        return cur if cur.get("step") == step else None

    @staticmethod
    def load_model_config(directory: str) -> ModelConfig:
        with open(os.path.join(directory, "model_config.json")) as f:
            return ModelConfig.from_json(f.read())
