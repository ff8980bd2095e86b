"""parallel of the PyTorch/CUDA port: the process mesh (named axes over
process groups), ZeRO-1, sequence parallelism (ring attention,
Ulysses), tensor and expert parallelism (``tensor``, whose names are
imported at first use: it imports the models, which import this
package), and pipeline parallelism (``pipeline``: GPipe and 1F1B)."""

import importlib


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
from horovod_tpu_torch.parallel.pipeline import (pipeline_train_1f1b,
                                                 pipelined_forward,
                                                 split_stages, stack_params)
from horovod_tpu_torch.parallel.ring import (default_positions,
                                             ring_attention,
                                             ulysses_attention)

__all__ = [
    "DATA_AXIS", "DCN_AXIS", "axis_index", "axis_size", "build_mesh",
    "data_axis_names", "get_mesh", "ici_axis_names", "set_mesh",
    "pipeline_train_1f1b", "pipelined_forward", "split_stages",
    "stack_params", "default_positions", "ring_attention",
    "ulysses_attention",
    "Shard", "make_tp_lm_train_step", "shard_lm_state",
    "transformer_param_specs",
]

_TENSOR = ("Shard", "make_tp_lm_train_step", "shard_lm_state",
           "transformer_param_specs")


def __getattr__(name):
    if name not in _TENSOR:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.tensor"), name)
    globals()[name] = value
    return value
