"""Train state: model, optimizer, step and generator (counterpart of
`alphafold2_tpu/train/state.py`).

`adam(...)` reproduces the JAX package's optax chain as one optimizer:

- `clip_by_global_norm(max_grad_norm)`, which scales every gradient by
  `max_norm / max(norm, max_norm)` (no epsilon, unlike
  `torch.nn.utils.clip_grad_norm_`);
- Adam with optax's defaults (b1 0.9, b2 0.999, eps 1e-8, eps_root 0),
  its learning rate taken from the schedule at the inner update count
  (0 for the first update), as optax's `scale_by_learning_rate` does;
- `optax.MultiSteps(every_k_schedule=grad_accum_every)`: the running mean
  of k micro-step gradients (`acc + (g - acc) / (n + 1)`), applied on the
  k-th step, and no update in between.

A None gradient is a zero one (a parameter the loss does not reach, to
which `jax.grad` gives zeros). A parameter that has had no gradient
since the optimizer was made (or loaded with zero moments) keeps exact
zeros in its moments and accumulator, and a zero gradient leaves them
and the parameter bit-equal, so the chain leaves such parameters out
(the full model's extra-MSA stack and templates in a train step that
feeds neither); the global norm still counts them, as zeros in their
places.

The three schedules of `alphafold2_tpu/train/state.py:33-71`: constant;
warmup alone (a linear ramp from 0, then the peak held); warmup then
cosine decay to `end_lr_ratio * learning_rate`.

On a mesh, `Adam.place` (what `parallel.shard_pytree_tp_zero` calls on a
TrainState) turns the moments and the accumulator into DTensors placed
by the ZeRO / tensor-parallel specs of their parameters: each rank keeps
and updates its block of them, from its block of the (whole) gradient,
and the updated blocks are gathered back into the whole parameters.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import torch
from torch import nn

Schedule = Callable[[int], float]


def _linear(init: float, end: float, steps: int) -> Schedule:
    if steps <= 0:
        return lambda count: init

    def schedule(count):
        count = min(max(count, 0), steps)
        return (init - end) * (1 - count / steps) + end

    return schedule


def _cosine(init: float, decay_steps: int, alpha: float) -> Schedule:
    if not decay_steps > 0:
        raise ValueError(f"cosine decay needs positive decay_steps, got "
                         f"{decay_steps}")

    def schedule(count):
        count = min(count, decay_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * count / decay_steps))
        return init * ((1 - alpha) * cosine + alpha)

    return schedule


def _join(schedules: Sequence[Schedule], boundaries: Sequence[int]
          ) -> Schedule:
    def schedule(count):
        out = schedules[0](count)
        for boundary, sched in zip(boundaries, schedules[1:]):
            if count >= boundary:
                out = sched(count - boundary)
        return out

    return schedule


def learning_rate_schedule(learning_rate: float, warmup_steps: int = 0,
                           decay_steps: Optional[int] = None,
                           end_lr_ratio: float = 0.1) -> Schedule:
    """The learning rate at each inner update count."""
    if decay_steps is not None:
        init = 0.0 if warmup_steps > 0 else learning_rate
        end = end_lr_ratio * learning_rate
        alpha = 0.0 if learning_rate == 0.0 else end / learning_rate
        decay = max(decay_steps, warmup_steps + 1)
        return _join([_linear(init, learning_rate, warmup_steps),
                      _cosine(learning_rate, decay - warmup_steps, alpha)],
                     [warmup_steps])
    if warmup_steps > 0:
        # warmup alone: ramp to the peak, then hold it
        return _join([_linear(0.0, learning_rate, warmup_steps),
                      lambda count: learning_rate], [warmup_steps])
    return lambda count: learning_rate


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float,
                        positions: Optional[Sequence[int]] = None,
                        size: Optional[int] = None) -> List[torch.Tensor]:
    """`optax.clip_by_global_norm`: every gradient scaled by
    max_norm / max(global norm, max_norm), without a host sync. With
    `positions`, `grads` are the entries at those places of a list of
    `size` gradients whose other entries are zero: the norm is taken over
    the whole list's per-tensor norms, zeros in their places, so it has
    the bits of the norm over the full list."""
    norms = list(torch._foreach_norm(list(grads)))
    if positions is not None and len(norms) < size:
        full = [norms[0].new_zeros(())] * size
        for at, norm in zip(positions, norms):
            full[at] = norm
        norms = full
    norm = torch.linalg.vector_norm(torch.stack(norms))
    return torch._foreach_mul(list(grads),
                              max_norm / torch.clamp(norm, min=max_norm))


class Adam:
    """The optax chain over a list of fp32 parameters. `update(grads)`
    accumulates or applies; state lives in `mu`, `nu` (Adam moments),
    `count` (updates applied), `mini_step` and `acc` (the MultiSteps
    accumulator, None when grad_accum_every is 1); `reached` marks the
    parameters that have had a gradient (the others are left out of the
    chain, bit-equal)."""

    def __init__(self, params: Sequence[torch.Tensor], schedule: Schedule,
                 grad_accum_every: int = 1,
                 max_grad_norm: Optional[float] = None, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        if grad_accum_every < 1:
            raise ValueError(f"grad_accum_every must be >= 1, got "
                             f"{grad_accum_every}")
        self.params: List[torch.Tensor] = list(params)
        self.schedule = schedule
        self.grad_accum_every = grad_accum_every
        self.max_grad_norm = max_grad_norm
        self.b1, self.b2, self.eps = b1, b2, eps
        zeros = lambda: [torch.zeros_like(p) for p in self.params]  # noqa: E731
        self.mu, self.nu = zeros(), zeros()
        self.count = 0
        self.mini_step = 0
        self.acc = zeros() if grad_accum_every > 1 else None
        self.reached = [False] * len(self.params)
        self.mesh = None
        self.specs = None

    def tensors(self) -> List[torch.Tensor]:
        """Every state tensor (moments and accumulator)."""
        return self.mu + self.nu + (self.acc or [])

    def place(self, mesh, specs) -> None:
        """Place the moments and the accumulator by one PartitionSpec
        per parameter (ZeRO stage 1: the parameters stay whole)."""
        from alphafold2_tpu_torch.parallel.sharding import place
        self.mesh, self.specs = mesh, list(specs)
        for name in ("mu", "nu", "acc"):
            xs = getattr(self, name)
            if xs is not None:
                setattr(self, name, [place(x, mesh, spec) for x, spec
                                     in zip(xs, self.specs)])

    def _local(self, at: int, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of a whole tensor of parameter `at`."""
        if self.mesh is None:
            return t
        from alphafold2_tpu_torch.parallel.sharding import (clean_spec,
                                                            local_part)
        return local_part(t, self.mesh, clean_spec(
            self.mesh, self.specs[at], t.shape))

    def _gather(self, at: int, block: torch.Tensor) -> torch.Tensor:
        """A parameter's whole value from every rank's block."""
        from torch.distributed.tensor import DTensor
        placements = self.mu[at].placements
        return DTensor.from_local(block.contiguous(),
                                  self.mesh.device_mesh, placements,
                                  run_check=False).full_tensor()

    @torch.no_grad()
    def update(self, grads: Sequence[Optional[torch.Tensor]]) -> bool:
        """One micro-step over one gradient (or None, a zero gradient)
        per parameter; True when the parameters were updated."""
        grads = list(grads)
        if len(grads) != len(self.params):
            raise ValueError(f"{len(grads)} gradients for "
                             f"{len(self.params)} parameters")
        for at, grad in enumerate(grads):
            if grad is not None:
                self.reached[at] = True
        live = [at for at, reached in enumerate(self.reached) if reached]
        grads = [torch.zeros_like(self.params[at]) if grads[at] is None
                 else grads[at] for at in live]
        mu, nu = ([_to_local(xs[at]) for at in live]
                  for xs in (self.mu, self.nu))
        if self.acc is not None:
            acc = [_to_local(self.acc[at]) for at in live]
            if live:
                if self.mesh is not None:
                    grads = [self._local(at, g) for at, g in zip(live, grads)]
                diff = torch._foreach_sub(grads, acc)
                torch._foreach_div_(diff, float(self.mini_step + 1))
                torch._foreach_add_(acc, diff)
            self.mini_step = (self.mini_step + 1) % self.grad_accum_every
            if self.mini_step:
                return False
            grads = [a.clone() for a in acc]
            for a in acc:
                a.zero_()
            if self.mesh is not None:
                # the clip's global norm reads whole gradients
                grads = [self._gather(at, g) for at, g in zip(live, grads)]
        if self.max_grad_norm is not None and live:
            grads = clip_by_global_norm(grads, self.max_grad_norm,
                                        positions=live,
                                        size=len(self.params))
        if self.mesh is not None:
            grads = [self._local(at, g) for at, g in zip(live, grads)]
        params = [self._local(at, self.params[at]).clone()
                  if self.mesh is not None else self.params[at]
                  for at in live]
        lr = self.schedule(self.count)
        self.count += 1
        if not live:
            return True
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - self.b2)
        step = torch._foreach_div(mu, 1.0 - self.b1 ** self.count)
        denom = torch._foreach_div(nu, 1.0 - self.b2 ** self.count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_div_(step, denom)
        torch._foreach_add_(params, step, alpha=-lr)
        if self.mesh is not None:
            for at, block in zip(live, params):
                self.params[at].copy_(self._gather(at, block))
        return True

    def state_dict(self) -> dict:
        """The state with whole tensors (placed ones gathered), so a
        checkpoint loads onto any mesh or none."""
        def whole(xs):
            return None if xs is None else [
                x.full_tensor() if hasattr(x, "full_tensor") else x
                for x in xs]

        return {"count": self.count, "mini_step": self.mini_step,
                "mu": whole(self.mu), "nu": whole(self.nu),
                "acc": whole(self.acc)}

    @torch.no_grad()
    def load_state_dict(self, state: dict):
        self.count = int(state["count"])
        self.mini_step = int(state["mini_step"])
        for name in ("mu", "nu", "acc"):
            mine, theirs = getattr(self, name), state[name]
            if (mine is None) != (theirs is None):
                raise ValueError(f"optimizer state {name!r} does not match "
                                 f"this optimizer's accumulation")
            for at, (dst, src) in enumerate(zip(mine or [],
                                                theirs or [])):
                _to_local(dst).copy_(self._local(at, src))
        # a parameter with any nonzero state has had a gradient
        # (read from the whole saved tensors: every rank agrees)
        flags = [torch.stack([t.ne(0).any() for t in states]).any()
                 for states in zip(*(state[name] for name in
                                     ("mu", "nu", "acc") if state[name]))]
        self.reached = torch.stack(flags).tolist() if flags else []


def _to_local(t):
    """A placed state tensor's block on this rank (a plain one as is)."""
    return t.to_local() if hasattr(t, "to_local") else t


@dataclass
class AdamSpec:
    """What `adam(...)` returns: the chain's settings, and a factory that
    builds the optimizer over a model's parameters."""

    learning_rate: float = 3e-4
    grad_accum_every: int = 1
    max_grad_norm: Optional[float] = None
    warmup_steps: int = 0
    decay_steps: Optional[int] = None
    end_lr_ratio: float = 0.1

    @property
    def schedule(self) -> Schedule:
        return learning_rate_schedule(self.learning_rate, self.warmup_steps,
                                      self.decay_steps, self.end_lr_ratio)

    def __call__(self, params: Sequence[torch.Tensor]) -> Adam:
        return Adam(params, self.schedule, self.grad_accum_every,
                    self.max_grad_norm)


def adam(learning_rate: float = 3e-4, grad_accum_every: int = 1,
         max_grad_norm: Optional[float] = None, warmup_steps: int = 0,
         decay_steps: Optional[int] = None,
         end_lr_ratio: float = 0.1) -> AdamSpec:
    """The reference's optimizer (Adam 3e-4) as the JAX package's optax
    chain; warmup, cosine decay and clipping default off."""
    return AdamSpec(learning_rate, grad_accum_every, max_grad_norm,
                    warmup_steps, decay_steps, end_lr_ratio)


def model_device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


@dataclass
class TrainState:
    """The model (its parameters are the trained state), the optimizer,
    the number of train steps taken (micro-steps included, as flax's
    `TrainState.step`) and the generator that MLM noise, dropout and the
    recycle count draw from (the counterpart of `state.rng`)."""

    model: nn.Module
    optimizer: Adam
    generator: torch.Generator
    step: int = 0

    @classmethod
    def create(cls, model: nn.Module, tx: Callable[..., Adam],
               generator: Optional[torch.Generator] = None,
               seed: int = 0) -> "TrainState":
        """`tx` is `adam(...)` (or any factory of params -> optimizer);
        the generator defaults to one on the model's device seeded with
        `seed`."""
        if generator is None:
            generator = torch.Generator(
                device=model_device(model)).manual_seed(seed)
        return cls(model, tx(list(model.parameters())), generator)

    @property
    def params(self) -> List[torch.Tensor]:
        return self.optimizer.params

    @property
    def accumulator(self) -> Optional[List[torch.Tensor]]:
        return self.optimizer.acc

    def apply_gradients(self, grads: Sequence[Optional[torch.Tensor]]
                        ) -> "TrainState":
        """One optimizer micro-step; a None gradient is a zero one."""
        self.optimizer.update(grads)
        self.step += 1
        return self
