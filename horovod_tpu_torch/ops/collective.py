"""Collectives over the data axis (the world process group).

The port of ``horovod_tpu/ops/collective.py``'s ``allreduce``,
``allgather``, ``broadcast``, ``reducescatter``, ``alltoall``,
``mesh_size`` and ``mesh_rank``: ``torch.distributed`` calls on the group
``init()`` installed (NCCL on the card, gloo on the CPU). Average is a
Sum followed by a division by the world size, one path for both
backends (gloo has no AVG). Chunk ``i`` of dim 0 belongs to rank ``i``
in every collective that splits or concatenates along it.
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


def mesh_size():
    """Number of ranks on the data axis."""
    return mesh_lib.get_mesh().size


def mesh_rank():
    """This process's index on the data axis."""
    return mesh_lib.get_mesh().rank


class Pending:
    """A reduce-scatter issued with ``async_op=True``: ``wait()`` blocks
    (on the card: makes the current stream wait) until it has ended and
    returns its output. It holds the input until then, so the buffer
    outlives the collective that reads it."""

    def __init__(self, work, out, inp, divisor):
        self._work, self._out, self._inp = work, out, inp
        self._divisor = divisor

    def wait(self):
        self._work.wait()
        self._inp = None
        if self._divisor > 1:
            self._out.div_(self._divisor)
        return self._out


def allgather(x):
    """Concatenate ``x`` from all ranks along dim 0 (equal shapes)."""
    m = mesh_lib.get_mesh()
    x = x.contiguous()
    out = torch.empty((m.size * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x, group=m.group)
    return out


def reducescatter(x, op=Sum, async_op=False):
    """Reduce ``x`` across ranks and scatter the result along dim 0:
    rank ``i`` receives reduced chunk ``i`` (dim 0 must divide by the
    world size). Sum or Average only. With ``async_op`` returns a
    ``Pending``."""
    if op not in (Sum, Average):
        raise ValueError("reducescatter supports Sum or Average")
    m = mesh_lib.get_mesh()
    if x.shape[0] % m.size:
        raise ValueError(f"reducescatter: dim 0 ({x.shape[0]}) does not "
                         f"divide by the world size {m.size}")
    x = x.contiguous()
    out = torch.empty((x.shape[0] // m.size,) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    work = dist.reduce_scatter_tensor(out, x, op=dist.ReduceOp.SUM,
                                      group=m.group, async_op=True)
    pending = Pending(work, out, x, m.size if op == Average else 1)
    return pending if async_op else pending.wait()


def alltoall(x):
    """Split dim 0 into world-size chunks, send chunk ``i`` to rank
    ``i``, and concatenate what arrives along dim 0 in rank order."""
    m = mesh_lib.get_mesh()
    if x.shape[0] % m.size:
        raise ValueError(f"alltoall: dim 0 ({x.shape[0]}) does not divide "
                         f"by the world size {m.size}")
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=m.group)
    return out


def broadcast_(x, root_rank=0):
    """Overwrite ``x`` in place with rank ``root_rank``'s value."""
    m = mesh_lib.get_mesh()
    dist.broadcast(x, src=root_rank, group=m.group)
    return x


def broadcast(x, root_rank=0):
    """Out-of-place ``broadcast_``."""
    return broadcast_(x.clone(), root_rank=root_rank)
