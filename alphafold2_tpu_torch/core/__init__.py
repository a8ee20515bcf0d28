from alphafold2_tpu_torch.core import (geometry, mds, nerf,  # noqa: F401
                                       quaternion, rigid)
from alphafold2_tpu_torch.core.mds import MDSResult, mdscaling  # noqa: F401
from alphafold2_tpu_torch.core.nerf import (nerf_place,  # noqa: F401
                                            sidechain_container)
from alphafold2_tpu_torch.core.rigid import Rigid  # noqa: F401
