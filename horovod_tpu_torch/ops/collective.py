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

from horovod_tpu_torch.ops import compression as compression_lib
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


def allreduce(x, op=Average, compression=None):
    """Out-of-place ``allreduce_``. ``compression`` (a compressor or a
    wire name, ``ops/compression.py``) casts ``x`` to a narrow wire dtype,
    reduces at that dtype and casts back. Only cast wires sum on the wire:
    a chunked quantizer raises, since its per-chunk scales cannot be summed
    in flight (``fusion.fused_allreduce_`` exchanges and then reduces)."""
    compression = compression_lib.resolve(compression)
    if compression is None:
        return allreduce_(x.clone(), op=op)
    if compression.chunked:
        raise ValueError(
            f"{compression.name} is a chunked quantizer: its per-chunk "
            "scales cannot be summed on the wire, so a plain allreduce "
            "cannot carry it. Use fusion.fused_allreduce_(...) or "
            "DistributedOptimizer(compression=...), which exchange the "
            "compressed chunks and reduce after decoding.")
    wire, ctx = compression.compress(x)
    if wire is x:
        wire = x.clone()
    return compression.decompress(allreduce_(wire, op=op), ctx)


def mesh_size():
    """Number of ranks on the data axis."""
    return mesh_lib.get_mesh().size


def mesh_rank():
    """This process's index on the data axis."""
    return mesh_lib.get_mesh().rank


class Pending:
    """A collective issued with ``async_op=True``: ``wait()`` blocks (on
    the card: makes the current stream wait) until its works have ended
    and returns ``finish()``, the output. It holds ``keep`` (the input
    buffers) until then, so they outlive the collective that reads them.

    ``finish`` runs once: a second ``wait()`` returns the same output
    (an Average is not divided twice). The first drops the works and
    ``finish``, whose closure holds the mesh, so a waited ``Pending``
    kept past ``shutdown()`` does not keep the process group alive into
    interpreter exit, where destroying it can abort the process."""

    def __init__(self, works, finish, keep=()):
        self._works, self._finish, self._keep = works, finish, keep
        self._out = None

    def wait(self):
        if self._finish is not None:
            for work in self._works:
                work.wait()
            self._out = self._finish()
            self._works, self._finish, self._keep = (), None, ()
        return self._out


# fp8 payloads cross the wire as their bytes: gloo has no fp8 type, and
# nothing is summed at fp8
_AS_BYTES = (torch.float8_e4m3fn, torch.float8_e5m2)


def _wire_view(x):
    return x.view(torch.uint8) if x.dtype in _AS_BYTES else x


def allgather(x, async_op=False):
    """Concatenate ``x`` from all ranks along dim 0 (equal shapes). With
    ``async_op`` returns a ``Pending``."""
    m = mesh_lib.get_mesh()
    x = x.contiguous()
    out = torch.empty((m.size * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    work = dist.all_gather_into_tensor(_wire_view(out), _wire_view(x),
                                       group=m.group, async_op=True)
    pending = Pending((work,), lambda: out, (x,))
    return pending if async_op else pending.wait()


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

    def finish():
        return out.div_(m.size) if op == Average and m.size > 1 else out

    pending = Pending((work,), finish, (x,))
    return pending if async_op else pending.wait()


def alltoall(x, async_op=False):
    """Split dim 0 into world-size chunks, send chunk ``i`` to rank
    ``i``, and concatenate what arrives along dim 0 in rank order. With
    ``async_op`` returns a ``Pending``."""
    m = mesh_lib.get_mesh()
    if x.shape[0] % m.size:
        raise ValueError(f"alltoall: dim 0 ({x.shape[0]}) does not divide "
                         f"by the world size {m.size}")
    x = x.contiguous()
    out = torch.empty_like(x)
    work = dist.all_to_all_single(_wire_view(out), _wire_view(x),
                                  group=m.group, async_op=True)
    pending = Pending((work,), lambda: out, (x,))
    return pending if async_op else pending.wait()


def broadcast_(x, root_rank=0):
    """Overwrite ``x`` in place with rank ``root_rank``'s value."""
    m = mesh_lib.get_mesh()
    dist.broadcast(x, src=root_rank, group=m.group)
    return x


def broadcast(x, root_rank=0):
    """Out-of-place ``broadcast_``."""
    return broadcast_(x.clone(), root_rank=root_rank)
