from alphafold2_tpu_torch.utils.logging import MetricsLogger  # noqa: F401
from alphafold2_tpu_torch.utils.profiling import (  # noqa: F401
    StepTimer,
    percentile,
)
