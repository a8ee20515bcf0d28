"""Checkpoint and resume with `torch.save` (counterpart of
`alphafold2_tpu/train/checkpoint.py`, which uses orbax).

One file per step, `<directory>/step_<step>.pt`, holding the parameters,
the optimizer state (Adam moments, update count, accumulator and its
micro-step), the train step and the generator's state. A save writes a
temporary file and renames it over the final name, so a crash never
leaves a partial checkpoint; the newest `max_to_keep` are kept (all of them when it is None or
0).
"""

from __future__ import annotations

import os
import re
from typing import List, Optional

import torch

from alphafold2_tpu_torch.train.state import TrainState

_NAME = re.compile(r"^step_(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.pt")

    def steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(
            _NAME.match, os.listdir(self.directory)) if m)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, state: TrainState, step: Optional[int] = None) -> int:
        step = int(state.step) if step is None else step
        payload = {"params": state.model.state_dict(),
                   "optimizer": state.optimizer.state_dict(),
                   "step": int(state.step),
                   "generator": state.generator.get_state()}
        final = self.path(step)
        tmp = f"{final}.tmp{os.getpid()}"
        torch.save(payload, tmp)
        os.replace(tmp, final)
        if self.max_to_keep:
            for old in self.steps()[:-self.max_to_keep]:
                os.remove(self.path(old))
        return step

    def restore(self, state: TrainState,
                step: Optional[int] = None) -> TrainState:
        """Load a checkpoint into `state` in place (its model, optimizer
        and generator supply the layout and the device)."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        device = next(state.model.parameters()).device
        payload = torch.load(self.path(step), map_location=device,
                             weights_only=True)
        state.model.load_state_dict(payload["params"])
        state.optimizer.load_state_dict(payload["optimizer"])
        state.step = int(payload["step"])
        state.generator.set_state(payload["generator"].cpu())
        return state
