"""One configuration tree for model, data, mesh and training (counterpart
of `alphafold2_tpu/config.py`).

`ModelConfig`, `DataConfig`, `MeshConfig`, `TrainConfig` and `Experiment`
keep the JAX package's field names and defaults, so one experiment JSON
builds either package's run. `ModelConfig.build()` returns the port's
`Alphafold2`; `Experiment.build()` returns (model, optimizer factory,
None): a mesh of more than one device is not ported and raises.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
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
        `bfloat16`, dropout at `attn_dropout`/`ff_dropout`, on `device`
        (CUDA unless the caller names another), weights drawn from
        `generator`."""
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



def draft_preset(base: ModelConfig) -> ModelConfig:
    """The draft-tier config derived from a flagship config: half the
    width, a third of the depth (floored at 1) and half the structure
    module, as the JAX package's `draft_preset`. The architecture,
    attention menu and structure module stay the flagship's, so every
    serving path (bucketing, kernel policy, memory planning) works on
    the draft unchanged. The draft is a different model with different
    weights; the cascade keys its cache entries apart by `model_tag`."""
    return dataclasses.replace(
        base,
        dim=max(base.dim // 2, 1),
        depth=max(base.depth // 3, 1),
        structure_module_depth=max(base.structure_module_depth // 2, 1),
    )

@dataclass
class DataConfig:
    crop_len: int = 128
    msa_depth: int = 5
    batch_size: int = 1
    root: Optional[str] = None        # trrosetta-style data dir; None=synthetic


@dataclass
class MeshConfig:
    pipe: int = 1
    data: int = 1
    i: int = 1
    j: int = 1

    def build(self):
        """None for one device; a mesh is not ported yet."""
        if self.pipe * self.data * self.i * self.j == 1:
            return None
        raise NotImplementedError(
            f"a device mesh ({dataclasses.asdict(self)}) is not ported to "
            f"PyTorch yet (ROADMAP.md, queue 1, item 10)")


@dataclass
class TrainConfig:
    learning_rate: float = 3e-4
    grad_accum_every: int = 16
    max_grad_norm: Optional[float] = None
    # warmup+cosine schedule (0 / None = the reference's constant LR)
    warmup_steps: int = 0
    decay_steps: Optional[int] = None
    num_steps: int = 1000
    log_every: int = 10
    checkpoint_dir: Optional[str] = None
    seed: int = 0


@dataclass
class Experiment:
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Experiment":
        return cls(
            model=ModelConfig(**d.get("model", {})),
            data=DataConfig(**d.get("data", {})),
            mesh=MeshConfig(**d.get("mesh", {})),
            train=TrainConfig(**d.get("train", {})),
        )

    @classmethod
    def from_json(cls, text: str) -> "Experiment":
        return cls.from_dict(json.loads(text))

    def build(self, device=None, generator: Optional[torch.Generator] = None):
        """(model, optimizer factory, None); the mesh raises when it has
        more than one device."""
        from alphafold2_tpu_torch.train.state import adam
        mesh = self.mesh.build()
        model = self.model.build(device=device, generator=generator)
        tx = adam(self.train.learning_rate, self.train.grad_accum_every,
                  self.train.max_grad_norm,
                  warmup_steps=self.train.warmup_steps,
                  decay_steps=self.train.decay_steps)
        return model, tx, mesh
