"""Collectives over the data axis (the world process group).

The port of ``horovod_tpu/ops/collective.py``'s ``allreduce``,
``allgather`` and ``broadcast``: ``torch.distributed`` calls on the group
``init()`` installed (NCCL on the card, gloo on the CPU). Average is a
Sum followed by a division by the world size, one path for both
backends (gloo has no AVG).
"""

import torch
import torch.distributed as dist

from horovod_tpu_torch.ops.reduction import Adasum, Average, Max, Min, Sum
from horovod_tpu_torch.parallel import mesh as mesh_lib

_OPS = {Sum: dist.ReduceOp.SUM, Average: dist.ReduceOp.SUM,
        Min: dist.ReduceOp.MIN, Max: dist.ReduceOp.MAX}


def allreduce_(x, op=Average):
    """Reduce ``x`` in place across all ranks; every rank gets the
    result."""
    if op == Adasum:
        raise NotImplementedError("Adasum is not ported to "
                                  "horovod_tpu_torch yet")
    if op not in _OPS:
        raise ValueError(f"unknown reduction op: {op!r}")
    if op == Average and not x.is_floating_point():
        raise TypeError(f"Average needs a floating tensor, got {x.dtype}")
    m = mesh_lib.get_mesh()
    dist.all_reduce(x, op=_OPS[op], group=m.group)
    if op == Average and m.size > 1:
        x.div_(m.size)
    return x


def allreduce(x, op=Average):
    """Out-of-place ``allreduce_``."""
    return allreduce_(x.clone(), op=op)


def allgather(x):
    """Concatenate ``x`` from all ranks along dim 0 (equal shapes)."""
    m = mesh_lib.get_mesh()
    x = x.contiguous()
    out = torch.empty((m.size * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x, group=m.group)
    return out


def broadcast_(x, root_rank=0):
    """Overwrite ``x`` in place with rank ``root_rank``'s value."""
    m = mesh_lib.get_mesh()
    dist.broadcast(x, src=root_rank, group=m.group)
    return x


def broadcast(x, root_rank=0):
    """Out-of-place ``broadcast_``."""
    return broadcast_(x.clone(), root_rank=root_rank)
