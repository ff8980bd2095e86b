"""horovod_tpu_torch: the PyTorch/CUDA port of horovod_tpu.

Horovod's contract on an NVIDIA GPU: ``init()``, the rank/size identity
from the launcher's env (``run``, the port's hvdrun), ``DistributedOptimizer``
averaging gradients through fused buckets over NCCL (allreduce, or
ZeRO-1's reduce-scatter and all-gather), startup broadcasts and the
training callbacks (``callbacks``), named process-mesh axes
(``build_mesh``) with sequence parallelism over them (ring attention,
Ulysses, ``make_lm_train_step(seq_axis=)``), ``training.make_train_step``'s
microbatched, overlapped bucket pipeline, fed by the prefetch loader
of ``data``; checkpoints (``ckpt``, ``checkpoint``) on the JAX package's
disk format. The attention of the transformer LM runs through
hand-written CUDA kernels (``ops/flash_attention.py``). The JAX package
``horovod_tpu`` is the reference; this package imports neither it nor
JAX.

The names below are imported at first use, so that the launcher and its
middleman, which run ``python -m horovod_tpu_torch.run...`` and need no
torch, start without importing it.
"""

import importlib

__version__ = "0.1.0"

# public name -> the submodule that defines it
_EXPORTS = {
    **dict.fromkeys(("init", "shutdown", "is_initialized", "rank", "size",
                     "local_rank", "local_size", "cross_rank", "cross_size",
                     "device"), "basics"),
    **dict.fromkeys(("DistributedOptimizer", "broadcast_parameters",
                     "broadcast_optimizer_state", "allreduce_metrics",
                     "join"), "hvd_torch"),
    **dict.fromkeys(("allreduce", "allreduce_", "allgather", "broadcast",
                     "broadcast_", "reducescatter", "alltoall", "ppermute",
                     "mesh_rank", "mesh_size"), "ops.collective"),
    **dict.fromkeys(("build_mesh", "axis_index", "axis_size"),
                    "parallel.mesh"),
    **dict.fromkeys(("ring_attention", "ulysses_attention"),
                    "parallel.ring"),
    "fused_allreduce_": "ops.fusion",
    **dict.fromkeys(("Sum", "Average", "Adasum", "Min", "Max"),
                    "ops.reduction"),
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{module}"), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
