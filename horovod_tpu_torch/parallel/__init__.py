"""parallel of the PyTorch/CUDA port: the process mesh (named axes over
process groups), ZeRO-1, and sequence parallelism (ring attention,
Ulysses)."""

from horovod_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    DCN_AXIS,
    axis_index,
    axis_size,
    build_mesh,
    data_axis_names,
    get_mesh,
    ici_axis_names,
    set_mesh,
)
from horovod_tpu_torch.parallel.ring import (default_positions,
                                             ring_attention,
                                             ulysses_attention)

__all__ = [
    "DATA_AXIS", "DCN_AXIS", "axis_index", "axis_size", "build_mesh",
    "data_axis_names", "get_mesh", "ici_axis_names", "set_mesh",
    "default_positions", "ring_attention", "ulysses_attention",
]
