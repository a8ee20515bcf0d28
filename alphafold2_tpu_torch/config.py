"""Model configuration (counterpart of `alphafold2_tpu/config.py:20-74`).

`ModelConfig` keeps the JAX package's fields and defaults so one config
dict builds either model. `build()` returns the port's `Alphafold2`.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch


@dataclass
class ModelConfig:
    dim: int = 256
    depth: int = 6
    heads: int = 8
    dim_head: int = 64
    max_rel_dist: int = 32
    predict_angles: bool = False
    symmetrize_omega: bool = False
    predict_coords: bool = False
    structure_module_depth: int = 4
    structure_module_heads: int = 1
    structure_module_type: str = "ipa"
    structure_module_refinement_iters: int = 0
    structure_module_refinement: str = "residue"   # 'residue' | 'egnn-atom'
    reversible: bool = False
    ring_attention: bool = False
    pipeline_stages: int = 1
    pipeline_microbatches: int = 0
    use_conv: bool = False
    sparse_self_attn: Any = False
    linear_attn: Any = False
    kron_attn: Any = False
    kv_compress_ratio: Any = 0
    linear_attn_kind: str = "favor"
    performer_nb_features: int = 256
    sparse_block: int = 32
    sparse_num_global: int = 1
    sparse_window: int = 1
    extra_msa_evoformer_layers: int = 4
    attn_dropout: float = 0.0
    ff_dropout: float = 0.0
    bfloat16: bool = True

    def build(self, device=None, generator: Optional[torch.Generator] = None):
        """The port's `Alphafold2` for this config: bf16 trunk when
        `bfloat16`, on `device` (CUDA unless the caller names another),
        weights drawn from `generator`."""
        from alphafold2_tpu_torch.model.alphafold2 import Alphafold2
        kwargs = dataclasses.asdict(self)
        use_bf16 = kwargs.pop("bfloat16")
        return Alphafold2(
            **kwargs, dtype=torch.bfloat16 if use_bf16 else torch.float32,
            device=device, generator=generator)

    def sparse_kwargs(self) -> Dict[str, int]:
        """The one set of block-sparsity knobs, shared by the model-level
        `sparse_self_attn` menu and the serving kernel policy
        (`serve.kernelpolicy.KernelPolicy.from_model_config`)."""
        return {"block": self.sparse_block,
                "num_global": self.sparse_num_global,
                "window": self.sparse_window}
