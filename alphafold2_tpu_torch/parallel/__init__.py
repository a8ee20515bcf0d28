"""Multi-device execution over `torch.distributed` (counterpart of
`alphafold2_tpu/parallel/`): the (pipe, data, i, j) mesh, DTensor
placement of the pair and MSA activations, ZeRO and tensor-parallel
placement of the train state, ring attention and the GPipe trunk."""

from alphafold2_tpu_torch.parallel.mesh import (  # noqa: F401
    AXIS_NAMES,
    DATA_AXIS,
    PAIR_I_AXIS,
    PAIR_J_AXIS,
    PIPE_AXIS,
    Mesh,
    make_mesh,
    single_device_mesh,
)
from alphafold2_tpu_torch.parallel.sharding import (  # noqa: F401
    NamedSharding,
    PartitionSpec,
    active_mesh,
    fold_input_shardings,
    fold_input_specs,
    is_dtensor,
    msa_spec,
    pair_spec,
    pytree_bytes_per_device,
    seq_spec,
    shard_msa,
    shard_pair,
    shard_pytree_tp,
    shard_pytree_tp_zero,
    shard_pytree_zero,
    shard_seq,
    tp_param_specs,
    unshard,
    use_mesh,
    zero_param_specs,
)
from alphafold2_tpu_torch.parallel.pipeline import (  # noqa: F401
    make_pipeline_mesh,
    microbatch,
    pipeline_apply,
    stack_stage_params,
    unmicrobatch,
)
