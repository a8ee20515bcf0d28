"""Failure detection and recovery for training (counterpart of
`alphafold2_tpu/train/guard.py`).

- `guarded_train_step`: wraps a train step so that a non-finite loss,
  gradient, parameter or accumulator update is skipped: the parameters
  and the optimizer state (moments, count, accumulator) are put back as
  they were, while `step` and the generator still advance, so a skipped
  batch is not replayed with the same randomness. `metrics['skipped']`
  is 1.0 for a rejected step;
- `AutoCheckpointer`: periodic and on-failure checkpointing around the
  host loop, resuming from the latest checkpoint after a crash.

The step updates the state in place, so the guard keeps a copy of the
parameters and optimizer state from before it (one device-to-device
copy per guarded step) and reads one flag back to the host.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

import torch

from alphafold2_tpu_torch.train.checkpoint import CheckpointManager
from alphafold2_tpu_torch.train.state import TrainState


def all_finite(tensors: Iterable[torch.Tensor]) -> bool:
    """True when every floating-point tensor holds only finite values."""
    flags = [torch.isfinite(t).all() for t in tensors
             if torch.is_floating_point(t)]
    if not flags:
        return True
    return bool(torch.stack(flags).all())


def guarded_train_step(train_step: Callable) -> Callable:
    """state, batch -> state, metrics with metrics['skipped'] = 1.0 when a
    non-finite update was rejected (the state's parameters and optimizer
    state pass through)."""

    def step(state: TrainState, batch):
        opt = state.optimizer
        tensors = list(state.params) + opt.tensors()
        with torch.no_grad():
            saved = [t.clone() for t in tensors]
        counters = (opt.count, opt.mini_step)
        state, metrics = train_step(state, batch)
        # the accumulator matters on its own: a non-finite micro-step
        # gradient can poison it while the loss and parameters stay
        # finite, and later steps would accumulate onto the poison
        ok = all_finite([metrics["loss"]] + tensors)
        if not ok:
            with torch.no_grad():
                torch._foreach_copy_(tensors, saved)
            opt.count, opt.mini_step = counters
        metrics = dict(metrics)
        metrics["skipped"] = torch.tensor(0.0 if ok else 1.0)
        return state, metrics

    return step


class AutoCheckpointer:
    """Host-loop companion: save every `every` steps and on failure."""

    def __init__(self, directory: str, every: int = 100,
                 max_to_keep: int = 3):
        self.manager = CheckpointManager(directory, max_to_keep=max_to_keep)
        self.every = every

    def maybe_save(self, state: TrainState, step: Optional[int] = None):
        step = int(state.step) if step is None else step
        if step > 0 and step % self.every == 0:
            self.manager.save(state, step)

    def resume_or(self, state: TrainState) -> TrainState:
        """Restore the latest checkpoint if one exists, else return
        state."""
        if self.manager.latest_step() is None:
            return state
        return self.manager.restore(state)

    def on_failure(self, state: TrainState):
        try:
            self.manager.save(state, int(state.step))
        except Exception:  # best effort, as in the JAX package
            pass
