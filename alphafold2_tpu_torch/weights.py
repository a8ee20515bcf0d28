"""Weight bridge: fill the port's `Alphafold2` from the JAX package's
`Alphafold2.init` params.

The caller hands over the flax params tree as nested dicts of numpy
arrays (`jax.tree.map(np.asarray, params)`); this module never sees
JAX. Leaf rules:

- Dense `kernel (in, out)` -> Linear `weight (out, in)`; `bias` as is;
- Conv `kernel (kh, kw, in, out)` (a `conv_<kh>x<kw>_d<d>` branch of
  the conv blocks) -> Conv2d `weight (out, in, kh, kw)`;
- `Embed.embedding` -> Embedding `weight`;
- the LayerNorm wrapper nests a flax LayerNorm: `<name>/LayerNorm_0/
  {scale, bias}` -> `<name>.{weight, bias}`;
- a scanned stack (the trunk `net/layers/block/...`, the extra-MSA
  stack `extra_msa_evoformer/layers/block/...`) carries a leading depth
  axis, unstacked into `<stack>.layers.<i>....`; an unrolled stack's
  `<stack>/layers_<i>/...` maps to the same names; the reversible
  trunk's `net/rev/rev_layers/...`, stacked over depth by its own
  initialiser, is unstacked into `net.rev.rev_layers.<i>....`;
- flax's auto-named submodules map to the port's attribute names
  (`_RENAMES`); IPA's `point_weights` keeps its name; the refiners'
  (`structure_module_refiner`, `coords_refiner`, `atom_refiner`) keep
  their flax names.

Every leaf of a JAX `Alphafold2.init` tree has a port parameter: a JAX
leaf without one raises, and so does any port parameter left unset.
"""

from __future__ import annotations

from typing import Iterator, Mapping, Tuple

import numpy as np
import torch

# flax auto-generated module names -> the port's attribute names
_RENAMES = {"LayerNorm_0": "norm", "LayerNorm_1": "out_norm",
            "Dense_0": "proj_in", "Dense_1": "proj_out"}
_LEAVES = {"kernel": "weight", "scale": "weight", "embedding": "weight",
           "bias": "bias", "point_weights": "point_weights"}


def _flatten(tree: Mapping, prefix=()) -> Iterator[Tuple[tuple, np.ndarray]]:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(value)


def _translate(parts: tuple, value: np.ndarray):
    """JAX leaf path (without 'params') -> [(port name, array)]."""
    parts = list(parts)
    leaf = parts.pop()
    if leaf not in _LEAVES:
        return []
    if leaf in ("scale", "bias") and parts and parts[-1] == "LayerNorm_0":
        parts.pop()   # the wrapper's inner flax LayerNorm
    if leaf == "kernel" and parts and parts[-1].startswith("conv_"):
        value = np.moveaxis(value, (-4, -3, -2, -1), (-2, -1, -3, -4))
    elif leaf == "kernel":
        value = np.swapaxes(value, -1, -2)

    def name(ps):
        return ".".join([_RENAMES.get(p, p) for p in ps] + [_LEAVES[leaf]])

    for at, part in enumerate(parts):
        if part == "layers" and parts[at + 1:at + 2] == ["block"]:
            # scanned stack: one stacked leaf per parameter
            return [(name(parts[:at] + ["layers", str(i)] + parts[at + 2:]),
                     value[i]) for i in range(value.shape[0])]
        if part == "rev_layers":
            return [(name(parts[:at + 1] + [str(i)] + parts[at + 1:]),
                     value[i]) for i in range(value.shape[0])]
        if part.startswith("layers_"):
            return [(name(parts[:at] + ["layers", part[len("layers_"):]]
                          + parts[at + 1:]), value)]
    return [(name(parts), value)]


def load_jax_params(model: torch.nn.Module, params: Mapping) -> None:
    """Copy the JAX params tree (nested dicts of numpy arrays, with or
    without the top-level 'params' key) into `model` in place."""
    if "params" in params:
        params = params["params"]
    state = dict(model.named_parameters())
    assigned = set()
    stray = []
    for path, value in _flatten(params):
        pairs = _translate(path, value)
        if not pairs:
            stray.append("/".join(path))
        for name, array in pairs:
            param = state.get(name)
            if param is None:
                stray.append("/".join(path))
                continue
            tensor = torch.from_numpy(np.array(array))
            if tuple(tensor.shape) != tuple(param.shape):
                raise ValueError(
                    f"{'/'.join(path)} -> {name}: shape "
                    f"{tuple(tensor.shape)} != {tuple(param.shape)}")
            with torch.no_grad():
                param.copy_(tensor.to(param.dtype))
            assigned.add(name)
    if stray:
        raise ValueError("JAX params with no port parameter: "
                         + ", ".join(sorted(set(stray))))
    unset = sorted(set(state) - assigned)
    if unset:
        raise ValueError("port parameters the JAX params left unset: "
                         + ", ".join(unset))
