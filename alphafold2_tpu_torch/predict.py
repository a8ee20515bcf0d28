"""Inference API: fold sequences with recycling and confidence
(counterpart of `alphafold2_tpu/predict.py:20-260`).

`fold` runs the first pass and `num_recycles` recycling passes;
`fold_init` / `fold_step` split the same loop into steps a scheduler can
own, and `fold_init_rows` re-initialises chosen batch rows. Every entry
point runs one function per pass (`_one_pass`), under
`torch.inference_mode()`, on the CUDA card unless `device` names another
(the model must already live there).

`**extra` are the model's other inputs (templates, template angles, the
extra MSA, pretrained embeddings, `seq_index`), passed to every pass as
the JAX package's entry points pass them; `_prepare` moves them onto
the model's device, float features in fp32, masks as bool, token and
index arrays as long.

`kernel` (an `ops.block_sparse.KernelSpec`) runs every pass under
`kernel_context`: the residue-axis self-attention of the bucket's length
goes through the block-sparse kernel. `plan` is the spec's plan on the
device; the serving executor passes the one it holds per key, and an
entry point given none uploads one per call.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import torch

from alphafold2_tpu_torch.device import resolve_device
from alphafold2_tpu_torch.model.alphafold2 import Recyclables
from alphafold2_tpu_torch.ops.block_sparse import (BlockPlan, KernelSpec,
                                                   kernel_context)


class FoldResult(NamedTuple):
    coords: torch.Tensor          # (b, n, 3)
    confidence: torch.Tensor      # (b, n) in [0, 1]
    distogram: torch.Tensor       # (b, n, n, buckets)
    recyclables: Recyclables


class FoldStepState(NamedTuple):
    """One recycle iteration's output, the carry of a step loop. After
    the last step the state is the fold result; `recyclables` is the only
    part the next step reads."""

    coords: torch.Tensor
    confidence: torch.Tensor
    distogram: torch.Tensor
    recyclables: Recyclables


# the one source of the recycling default
DEFAULT_NUM_RECYCLES = 3


# the model inputs an entry point takes through **extra, with the type
# each is moved in
_EXTRA_DTYPES = {
    "templates_feats": torch.float32, "templates_angles": torch.float32,
    "seq_embed": torch.float32, "msa_embed": torch.float32,
    "embedds": torch.float32, "templates_mask": torch.bool,
    "extra_msa_mask": torch.bool, "extra_msa": torch.long,
    "seq_index": torch.long}


def _prepare(model, device, seq, msa, mask, msa_mask, kernel, plan, extra):
    """Check the call, move the inputs onto the model's device and make
    the kernel's device plan when none was given."""
    unknown = sorted(set(extra) - set(_EXTRA_DTYPES))
    if unknown:
        raise TypeError(f"fold got unexpected model inputs {unknown}; it "
                        f"takes {sorted(_EXTRA_DTYPES)}")
    if not model.predict_coords:
        raise ValueError("folding needs a model built with "
                         "predict_coords=True")
    if kernel is not None and not isinstance(kernel, KernelSpec):
        raise TypeError(f"kernel must be a KernelSpec, got {type(kernel)}")
    device = resolve_device(device)
    if model.device != device:
        raise ValueError(f"the model lives on {model.device}, the fold was "
                         f"asked to run on {device}")
    if kernel is not None and kernel.backend == "auto" and plan is None:
        plan = kernel.device_plan(device)

    def put(t, dtype):
        return None if t is None else torch.as_tensor(
            t, device=device).to(dtype)

    extra = {name: put(value, _EXTRA_DTYPES[name])
             for name, value in extra.items() if value is not None}
    return (put(seq, torch.long), put(msa, torch.long),
            put(mask, torch.bool), put(msa_mask, torch.bool), plan, extra)


def _one_pass(model, seq, msa, mask, msa_mask, recyclables, extra,
              kernel=None, plan: Optional[BlockPlan] = None):
    """One trunk + structure pass: what fold's loop and the step-mode
    entry points all run, under the kernel's context when one is given."""
    ctx = kernel_context(kernel, plan) if kernel is not None \
        else contextlib.nullcontext()
    with ctx:
        return model(seq, msa=msa, mask=mask, msa_mask=msa_mask,
                     recyclables=recyclables, return_aux_logits=True,
                     return_recyclables=True, **extra)


def _step_state(coords, ret) -> FoldStepState:
    conf = torch.sigmoid(ret.confidence[..., 0].float())
    return FoldStepState(coords, conf, ret.distance, ret.recyclables)


def fold(model, seq, msa=None, mask=None, msa_mask=None,
         num_recycles: int = DEFAULT_NUM_RECYCLES, device=None,
         kernel: Optional[KernelSpec] = None,
         plan: Optional[BlockPlan] = None, **extra) -> FoldResult:
    """Run the model with `num_recycles` recycling iterations."""
    seq, msa, mask, msa_mask, plan, extra = _prepare(
        model, device, seq, msa, mask, msa_mask, kernel, plan, extra)
    with torch.inference_mode():
        coords, ret = _one_pass(model, seq, msa, mask, msa_mask, None,
                                extra, kernel, plan)
        for _ in range(num_recycles):
            coords, ret = _one_pass(model, seq, msa, mask, msa_mask,
                                    ret.recyclables, extra, kernel, plan)
        return FoldResult(*_step_state(coords, ret))


def fold_init(model, seq, msa=None, mask=None, msa_mask=None, device=None,
              kernel: Optional[KernelSpec] = None,
              plan: Optional[BlockPlan] = None, **extra) -> FoldStepState:
    """The first pass of step-mode folding: fold(..., num_recycles=0) as
    a FoldStepState whose `recyclables` seed `fold_step`. fold_init then
    R x fold_step computes what fold(..., num_recycles=R) does."""
    seq, msa, mask, msa_mask, plan, extra = _prepare(
        model, device, seq, msa, mask, msa_mask, kernel, plan, extra)
    with torch.inference_mode():
        return _step_state(*_one_pass(model, seq, msa, mask, msa_mask,
                                      None, extra, kernel, plan))


def fold_step(model, seq, recyclables: Recyclables, msa=None, mask=None,
              msa_mask=None, device=None,
              kernel: Optional[KernelSpec] = None,
              plan: Optional[BlockPlan] = None, **extra) -> FoldStepState:
    """One recycle iteration, fed the previous state's `recyclables`."""
    seq, msa, mask, msa_mask, plan, extra = _prepare(
        model, device, seq, msa, mask, msa_mask, kernel, plan, extra)
    with torch.inference_mode():
        return _step_state(*_one_pass(model, seq, msa, mask, msa_mask,
                                      recyclables, extra, kernel, plan))


def _select_rows(row_mask, new, old):
    if isinstance(new, tuple):
        return type(new)(*(_select_rows(row_mask, a, b)
                           for a, b in zip(new, old)))
    m = row_mask.reshape(row_mask.shape + (1,) * (new.dim() - 1))
    return torch.where(m, new, old)


def fold_init_rows(model, seq, row_mask, state: FoldStepState, msa=None,
                   mask=None, msa_mask=None, device=None,
                   kernel: Optional[KernelSpec] = None,
                   plan: Optional[BlockPlan] = None,
                   **extra) -> FoldStepState:
    """Row-masked init: rows where `row_mask` (b,) is True restart from
    the current batch tensors (fold_init's pass); the other rows keep the
    carried `state` unchanged."""
    fresh = fold_init(model, seq, msa=msa, mask=mask, msa_mask=msa_mask,
                      device=device, kernel=kernel, plan=plan, **extra)
    row_mask = torch.as_tensor(row_mask, device=fresh.coords.device).bool()
    with torch.inference_mode():
        return _select_rows(row_mask, fresh, state)
