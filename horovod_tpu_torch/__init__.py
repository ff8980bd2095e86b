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

The names below, and the subpackages ``checkpoint``, ``ckpt`` and
``data``, are imported at first use, so that the launcher and its
middleman, which run ``python -m horovod_tpu_torch.run...`` and need no
torch, start without importing it. Of the JAX package's top-level names
the port leaves out ``distributed_grad``, ``DistributedGradientTransform``,
``HorovodOptimizer`` and ``compat`` (optax's and JAX's forms, which
``DistributedOptimizer`` and ``distributed_value_and_grad`` stand for
here), and the planes not yet ported: ``elastic``, ``telemetry`` and
``autotune_fusion_threshold``.
"""

import importlib

__version__ = "0.1.0"

# public name -> the submodule that defines it
_EXPORTS = {
    **dict.fromkeys(("init", "shutdown", "is_initialized", "rank", "size",
                     "local_rank", "local_size", "cross_rank", "cross_size",
                     "device", "num_devices", "mesh", "data_axes",
                     "nccl_built", "gloo_built", "mpi_built", "mpi_enabled",
                     "mpi_threads_supported", "ccl_built", "ddl_built"),
                    "basics"),
    **dict.fromkeys(("DistributedOptimizer", "distributed_value_and_grad",
                     "broadcast_variables", "broadcast_parameters",
                     "broadcast_optimizer_state", "allreduce_metrics",
                     "join"), "hvd_torch"),
    **dict.fromkeys(("allreduce", "allreduce_", "allgather", "broadcast",
                     "broadcast_", "reducescatter", "alltoall", "ppermute",
                     "mesh_rank", "mesh_size"), "ops.collective"),
    **dict.fromkeys(("build_mesh", "axis_index", "axis_size"),
                    "parallel.mesh"),
    **dict.fromkeys(("ring_attention", "ulysses_attention"),
                    "parallel.ring"),
    **dict.fromkeys(("fused_allreduce", "fused_allreduce_"), "ops.fusion"),
    "Compression": "ops.compression",
    **dict.fromkeys(("Sum", "Average", "Adasum", "Min", "Max"),
                    "ops.reduction"),
}

_SUBPACKAGES = ("checkpoint", "ckpt", "data")

__all__ = list(_EXPORTS) + list(_SUBPACKAGES)


def __getattr__(name):
    if name in _SUBPACKAGES:
        value = importlib.import_module(f"{__name__}.{name}")
    elif name in _EXPORTS:
        value = getattr(importlib.import_module(
            f"{__name__}.{_EXPORTS[name]}"), name)
    else:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
