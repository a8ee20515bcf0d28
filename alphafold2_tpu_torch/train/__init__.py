"""Training for the PyTorch port (counterpart of `alphafold2_tpu/train/`):
losses, the optimizer chain and train state, the train steps and host
loop, the guard, checkpoints and input prefetch."""

from alphafold2_tpu_torch.train import losses  # noqa: F401
from alphafold2_tpu_torch.train.checkpoint import CheckpointManager  # noqa: F401
from alphafold2_tpu_torch.train.loop import (  # noqa: F401
    compute_loss,
    fit,
    make_eval_step,
    make_recycled_train_step,
    make_train_step,
    shard_batch,
)
from alphafold2_tpu_torch.train.prefetch import device_prefetch  # noqa: F401
from alphafold2_tpu_torch.train.state import TrainState, adam  # noqa: F401
