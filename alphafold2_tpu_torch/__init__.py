"""alphafold2_tpu_torch: the PyTorch and CUDA port of alphafold2_tpu.

The JAX package `alphafold2_tpu` stays the reference; this package holds
its counterparts under the same paths and names, written for an NVIDIA
H100, with the TPU kernels rewritten by hand for Hopper (`csrc/`).
Entry points run on the CUDA card unless the caller passes `device=`.
"""

from alphafold2_tpu_torch.config import ModelConfig
from alphafold2_tpu_torch.model.alphafold2 import (Alphafold2, Recyclables,
                                                   ReturnValues)
from alphafold2_tpu_torch.predict import (DEFAULT_NUM_RECYCLES, FoldResult,
                                          FoldStepState, fold,
                                          fold_and_write, fold_init,
                                          fold_init_rows, fold_step,
                                          restore_step_state,
                                          snapshot_step_state)
from alphafold2_tpu_torch.weights import load_jax_params

__all__ = [
    "Alphafold2", "DEFAULT_NUM_RECYCLES", "FoldResult", "FoldStepState",
    "ModelConfig", "Recyclables", "ReturnValues", "fold", "fold_and_write",
    "fold_init", "fold_init_rows", "fold_step", "load_jax_params",
    "restore_step_state", "snapshot_step_state",
]
