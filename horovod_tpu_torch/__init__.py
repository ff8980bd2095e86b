"""horovod_tpu_torch: the PyTorch/CUDA port of horovod_tpu.

Horovod's contract on an NVIDIA GPU: ``init()``, the rank/size identity
from the launcher's env, ``DistributedOptimizer`` averaging gradients
through fused buckets over NCCL (allreduce, or ZeRO-1's reduce-scatter
and all-gather), startup broadcasts, and ``training.make_train_step``'s
microbatched, overlapped bucket pipeline, fed by the prefetch loader
of ``data``; checkpoints (``ckpt``, ``checkpoint``) on the JAX package's
disk format. The attention of the transformer LM runs through
hand-written CUDA kernels (``ops/flash_attention.py``). The JAX package
``horovod_tpu`` is the reference; this package imports neither it nor
JAX.
"""

from horovod_tpu_torch.basics import (cross_rank, cross_size, device, init,
                                      is_initialized, local_rank, local_size,
                                      rank, shutdown, size)
from horovod_tpu_torch.hvd_torch import (DistributedOptimizer,
                                         allreduce_metrics,
                                         broadcast_optimizer_state,
                                         broadcast_parameters, join)
from horovod_tpu_torch.ops.collective import (allgather, allreduce,
                                              allreduce_, alltoall,
                                              broadcast, broadcast_,
                                              mesh_rank, mesh_size,
                                              reducescatter)
from horovod_tpu_torch.ops.fusion import fused_allreduce_
from horovod_tpu_torch.ops.reduction import Adasum, Average, Max, Min, Sum

__all__ = [
    "init", "shutdown", "is_initialized", "rank", "size", "local_rank",
    "local_size", "cross_rank", "cross_size", "device",
    "DistributedOptimizer", "broadcast_parameters",
    "broadcast_optimizer_state", "allreduce_metrics", "join", "allreduce",
    "allreduce_", "allgather", "broadcast", "broadcast_", "reducescatter",
    "alltoall", "mesh_rank", "mesh_size", "fused_allreduce_", "Sum",
    "Average", "Adasum", "Min", "Max",
]
