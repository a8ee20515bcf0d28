"""Training step and loop (counterpart of `alphafold2_tpu/train/loop.py`).

- loss = distogram CE [+ coords Kabsch-RMSD + dispersion term + MLM +
  confidence regression + trRosetta angle CEs], selected by what the
  batch provides and the model's config;
- gradient accumulation lives in the optimizer (`state.adam`'s MultiSteps
  semantics), so every step is one forward and one backward;
- the recycled step draws r ~ U{0..max_recycles} from the state's
  generator, runs r passes under `torch.no_grad()` and takes the gradient
  through the last pass only.

The step runs eagerly on the model's device; the attention forward is
kernel K1 on the card, and its backward recomputes the plain attention
(`ops/attention.py`), as the JAX package's VJP does. Under a mesh
(`fit(mesh=...)` or an active `parallel.use_mesh`) every rank runs the
step on the whole batch, whose rows the model's `shard_*` placements
shard over ``data``; forward and backward run under the mesh, and a
pipelined trunk's stage gradients are summed over ``pipe``.
"""

from __future__ import annotations

from typing import Optional

import torch

from alphafold2_tpu_torch.parallel.mesh import PIPE_AXIS
from alphafold2_tpu_torch.parallel.sharding import active_mesh, use_mesh
from alphafold2_tpu_torch.train import losses
from alphafold2_tpu_torch.train.state import TrainState, model_device


def _mask_of(batch):
    mask = batch.get("mask")
    if mask is None:
        return torch.ones(batch["seq"].shape, dtype=torch.bool,
                          device=batch["seq"].device)
    return mask.bool()


def compute_loss(model, batch, generator: Optional[torch.Generator] = None,
                 train: bool = True, recyclables=None):
    """Forward + composite loss. Returns (loss, metrics). MLM noise and
    dropout draw from `generator` when `train`; `recyclables` feeds the
    recycling embedder."""
    metrics = {}
    wants_coords = model.predict_coords and "coords" in batch
    mask = _mask_of(batch)
    kwargs = dict(msa=batch.get("msa"), mask=mask,
                  msa_mask=batch.get("msa_mask"), train=train,
                  recyclables=recyclables,
                  generator=generator if train else None)

    if wants_coords:
        coords, ret = model(batch["seq"], **kwargs, return_aux_logits=True)
        loss = losses.coords_loss(coords, batch["coords"], mask,
                                  distogram_logits=ret.distance)
        metrics["coords_loss"] = loss
        if ret.confidence is not None:
            c_loss = losses.lddt_confidence_loss(
                ret.confidence, coords, batch["coords"], mask)
            metrics["confidence_loss"] = c_loss
            loss = loss + c_loss
    elif model.predict_coords:
        # a coords model without a coords target: only the MLM term below
        # can contribute
        _, ret = model(batch["seq"], **kwargs, return_aux_logits=True)
        loss = torch.zeros((), device=mask.device)
    else:
        ret = model(batch["seq"], **kwargs)
        loss = torch.zeros((), device=mask.device)

    if "coords" in batch and not wants_coords:
        d_loss = losses.distogram_loss(ret.distance, batch["coords"], mask)
        metrics["distogram_loss"] = d_loss
        loss = loss + d_loss

    if model.predict_angles and "theta" in batch:
        a_loss = losses.angle_loss(ret.theta, ret.phi, ret.omega,
                                   batch["theta"], batch["phi"],
                                   batch["omega"])
        metrics["angle_loss"] = a_loss
        loss = loss + a_loss

    if ret.msa_mlm_loss is not None:
        metrics["mlm_loss"] = ret.msa_mlm_loss
        loss = loss + ret.msa_mlm_loss

    metrics["loss"] = loss
    return loss, metrics


def _gradients(loss, params, model=None):
    """d loss / d params; a parameter the loss does not reach (the
    recycling embedder of a step without recycles, the templates and the
    extra-MSA stack of a batch without them) gets None, which the
    optimizer takes as the zero gradient `jax.grad` gives it. Under a
    mesh with a ``pipe`` axis, the stage parameters of a pipelined trunk
    in `model` get their gradients summed over the stages."""
    grads = list(torch.autograd.grad(loss, params, allow_unused=True))
    mesh = active_mesh()
    if model is None or mesh is None or mesh.shape.get(PIPE_AXIS, 1) <= 1:
        return grads
    from alphafold2_tpu_torch.parallel.pipeline import sync_stage_grads
    staged = {id(p) for mod in model.modules()
              for p in getattr(mod, "pipelined_parameters", list)()}
    at = [i for i, p in enumerate(params) if id(p) in staged]
    if at:
        synced = sync_stage_grads([grads[i] for i in at],
                                  [params[i] for i in at], mesh)
        for i, g in zip(at, synced):
            grads[i] = g
    return grads


def _apply(state: TrainState, loss, metrics):
    state.apply_gradients(_gradients(loss, state.params, state.model))
    return state, {k: v.detach() for k, v in metrics.items()}


def make_train_step(model):
    """state, batch -> state, metrics (the state is updated in place).
    The step runs the state's model, whose parameters are the trained
    state (`model` names the architecture, as the JAX module does)."""

    def train_step(state: TrainState, batch):
        loss, metrics = compute_loss(state.model, batch, state.generator,
                                     train=True)
        return _apply(state, loss, metrics)

    return train_step


def draw_recycles(generator: torch.Generator, max_recycles: int) -> int:
    """r ~ U{0..max_recycles} from `generator` (one host sync)."""
    return int(torch.randint(0, max_recycles + 1, (1,), generator=generator,
                             device=generator.device).item())


def make_recycled_train_step(model, max_recycles: int = 3):
    """Train step with sampled recycling: r ~ U{0..max_recycles}, r passes
    without gradients threading `Recyclables` (detached by the model),
    and the gradient through the final pass only, so one set of weights
    serves every inference recycle count. metrics['recycles'] is r."""
    if not model.predict_coords:
        raise ValueError("recycled training needs predict_coords")
    if max_recycles < 1:
        raise ValueError(f"max_recycles must be >= 1, got {max_recycles}")

    def train_step(state: TrainState, batch):
        model = state.model
        r = draw_recycles(state.generator, max_recycles)
        rec = None
        with torch.no_grad():
            for _ in range(r):
                _, ret = model(batch["seq"], msa=batch.get("msa"),
                               mask=_mask_of(batch),
                               msa_mask=batch.get("msa_mask"),
                               recyclables=rec, return_aux_logits=True,
                               return_recyclables=True)
                rec = ret.recyclables
        loss, metrics = compute_loss(model, batch, state.generator,
                                     train=True, recyclables=rec)
        metrics["recycles"] = torch.tensor(float(r))
        return _apply(state, loss, metrics)

    return train_step


def make_eval_step(model):
    def eval_step(state: TrainState, batch):
        with torch.no_grad():
            _, metrics = compute_loss(state.model, batch, None, train=False)
        return metrics

    return eval_step


def shard_batch(batch, mesh=None, device=None):
    """Place a host batch on `device` (the model's device in `fit`). On
    a mesh (`mesh`, or the active one) the batch goes whole to this
    rank's device: every rank holds the global batch, and the model's
    `shard_*` placements shard its rows over ``data``."""
    mesh = mesh or active_mesh()
    if mesh is not None:
        device = mesh.device
    return {k: torch.as_tensor(v).to(device, non_blocking=True)
            if device is not None else torch.as_tensor(v)
            for k, v in batch.items()}


def fit(model, state: TrainState, batches, num_steps: int,
        log_every: int = 10, logger=None, step_timer=None,
        prefetch: int = 2, registry=None, mesh=None):
    """Host loop: consumes an iterator of batches, runs the train step,
    logs scalar metrics. `prefetch` stages that many batches onto the
    device from a background thread (`train/prefetch.py`); 0 disables.
    `mesh` (default: the active one) runs every step under it; place the
    state first (`parallel.shard_pytree_tp_zero`) to shard its optimizer
    state.

    Reports into the process-wide metrics registry (`registry=None` =
    `obs.registry.get_registry()`): `train_steps_total`, a
    `train_step_seconds` histogram (when a `step_timer` measures steps),
    and the last logged loss terms as `train_metric{name=...}` gauges.
    Metrics are read back to the host only at log steps."""
    from alphafold2_tpu_torch.obs.registry import get_registry

    reg = registry or get_registry()
    m_steps = reg.counter("train_steps_total", "optimizer steps run")
    m_step_s = reg.histogram("train_step_seconds",
                             "wall time per training step")
    m_metric = reg.gauge("train_metric",
                         "last logged training metric value", ("name",))

    mesh = mesh or active_mesh()
    device = model_device(model)
    pre_placed = prefetch > 0
    if pre_placed:
        from alphafold2_tpu_torch.train.prefetch import device_prefetch
        batches = device_prefetch(batches, size=prefetch, mesh=mesh,
                                  device=device)
    train_step = make_train_step(model)
    history = []
    try:
        for i in range(num_steps):
            batch = next(batches)
            if step_timer is not None:
                step_timer.start()
            with use_mesh(mesh):
                state, metrics = train_step(
                    state, batch if pre_placed else
                    shard_batch(batch, mesh, device=device))
            if step_timer is not None:
                step_timer.stop()
                # a StepTimer wired to a registry histogram records itself
                if getattr(step_timer, "histogram", None) is None:
                    m_step_s.observe(step_timer.durations[-1])
            m_steps.inc()
            if i % log_every == 0:
                scalars = {k: float(v) for k, v in metrics.items()}
                history.append(scalars)
                for k, v in scalars.items():
                    m_metric.set(v, name=k)
                if logger is not None:
                    logger.log(step=i, **scalars)
    finally:
        if pre_placed:
            batches.close()
    return state, history
