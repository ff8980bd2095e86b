"""Collectives over named axes of the process mesh.

The port of ``horovod_tpu/ops/collective.py``'s ``allreduce``,
``allgather``, ``broadcast``, ``reducescatter``, ``alltoall``,
``mesh_size`` and ``mesh_rank``, and of ``lax.ppermute``:
``torch.distributed`` calls on a process group of the installed mesh
(``parallel/mesh.py``; NCCL on the card, gloo on the CPU). ``axes`` names
the mesh axes a collective runs over: None for the whole mesh (the
world), a name, or a tuple in mesh order. (The JAX package's default is
the data axes, ``data_axis_names()``; on a 1-D mesh the two are the
world.) Average is a Sum followed by a division by the group's size, one
path for both backends (gloo has no AVG). Chunk ``i`` of dim 0 belongs to
the rank whose ``mesh_rank(axes)`` is ``i`` in every collective that
splits or concatenates along it.

``ppermute``, the synchronous ``allgather`` and ``alltoall`` are
``torch.autograd.Function``s, so a model's forward may call them:
``ppermute``'s backward is ``ppermute`` with the inverse permutation,
``alltoall``'s the reverse all-to-all and ``allgather``'s a Sum
reduce-scatter.
"""

import torch
import torch.distributed as dist

from horovod_tpu_torch.ops import compression as compression_lib
from horovod_tpu_torch.ops.reduction import Adasum, Average, Max, Min, Sum
from horovod_tpu_torch.parallel import mesh as mesh_lib

_OPS = {Sum: dist.ReduceOp.SUM, Average: dist.ReduceOp.SUM,
        Min: dist.ReduceOp.MIN, Max: dist.ReduceOp.MAX}


def _group(axes):
    """``(group, ranks, index of this rank in ranks)`` over ``axes``."""
    m = mesh_lib.get_mesh()
    group, ranks = m.group_of(axes)
    return group, ranks, ranks.index(m.rank)


def allreduce_(x, op=Average, axes=None):
    """Reduce ``x`` in place across the ranks of ``axes``; every rank
    gets the result."""
    if op == Adasum:
        raise NotImplementedError("Adasum is not ported to "
                                  "horovod_tpu_torch yet")
    if op not in _OPS:
        raise ValueError(f"unknown reduction op: {op!r}")
    if op == Average and not x.is_floating_point():
        raise TypeError(f"Average needs a floating tensor, got {x.dtype}")
    group, ranks, _ = _group(axes)
    dist.all_reduce(x, op=_OPS[op], group=group)
    if op == Average and len(ranks) > 1:
        x.div_(len(ranks))
    return x


def allreduce(x, op=Average, compression=None, axes=None):
    """Out-of-place ``allreduce_``. ``compression`` (a compressor or a
    wire name, ``ops/compression.py``) casts ``x`` to a narrow wire dtype,
    reduces at that dtype and casts back. Only cast wires sum on the wire:
    a chunked quantizer raises, since its per-chunk scales cannot be summed
    in flight (``fusion.fused_allreduce_`` exchanges and then reduces)."""
    compression = compression_lib.resolve(compression)
    if compression is None:
        return allreduce_(x.clone(), op=op, axes=axes)
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
    return compression.decompress(allreduce_(wire, op=op, axes=axes), ctx)


def mesh_size(axes=None):
    """Number of ranks across ``axes``."""
    return len(_group(axes)[1])


def mesh_rank(axes=None):
    """This rank's index across ``axes`` (row-major over them)."""
    return _group(axes)[2]


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


def _allgather(x, axes, async_op=False):
    group, ranks, _ = _group(axes)
    x = x.contiguous()
    out = torch.empty((len(ranks) * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    work = dist.all_gather_into_tensor(_wire_view(out), _wire_view(x),
                                       group=group, async_op=True)
    pending = Pending((work,), lambda: out, (x,))
    return pending if async_op else pending.wait()


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes):
        ctx.axes = axes
        return _allgather(x, axes)

    @staticmethod
    def backward(ctx, g):
        return _reducescatter(g, Sum, ctx.axes), None


def allgather(x, async_op=False, axes=None):
    """Concatenate ``x`` from the ranks of ``axes`` along dim 0 (equal
    shapes). With ``async_op`` returns a ``Pending``; without, the call
    is differentiable."""
    if async_op:
        return _allgather(x, axes, async_op=True)
    return _AllGather.apply(x, axes)


def _reducescatter(x, op, axes, async_op=False):
    group, ranks, _ = _group(axes)
    n = len(ranks)
    if x.shape[0] % n:
        raise ValueError(f"reducescatter: dim 0 ({x.shape[0]}) does not "
                         f"divide by the group's size {n}")
    x = x.contiguous()
    out = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    work = dist.reduce_scatter_tensor(out, x, op=dist.ReduceOp.SUM,
                                      group=group, async_op=True)

    def finish():
        return out.div_(n) if op == Average and n > 1 else out

    pending = Pending((work,), finish, (x,))
    return pending if async_op else pending.wait()


def reducescatter(x, op=Sum, async_op=False, axes=None):
    """Reduce ``x`` across the ranks of ``axes`` and scatter the result
    along dim 0: the rank whose ``mesh_rank(axes)`` is ``i`` receives
    reduced chunk ``i`` (dim 0 must divide by their number). Sum or
    Average only. With ``async_op`` returns a ``Pending``."""
    if op not in (Sum, Average):
        raise ValueError("reducescatter supports Sum or Average")
    return _reducescatter(x, op, axes, async_op=async_op)


def _alltoall(x, axes, split_dim=0, concat_dim=0, async_op=False):
    group, ranks, _ = _group(axes)
    n = len(ranks)
    if x.shape[split_dim] % n:
        raise ValueError(f"alltoall: dim {split_dim} ({x.shape[split_dim]})"
                         f" does not divide by the group's size {n}")
    if split_dim == concat_dim == 0:
        send = x.contiguous()
    else:  # chunk j of split_dim to rank j, stacked along a new dim 0
        send = torch.stack(x.chunk(n, dim=split_dim)).contiguous()
    out = torch.empty_like(send)
    work = dist.all_to_all_single(_wire_view(out), _wire_view(send),
                                  group=group, async_op=True)

    def finish():
        if split_dim == concat_dim == 0:
            return out
        return torch.cat(out.unbind(0), dim=concat_dim)

    pending = Pending((work,), finish, (send,))
    return pending if async_op else pending.wait()


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, split_dim, concat_dim):
        ctx.args = (axes, concat_dim, split_dim)
        return _alltoall(x, axes, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        return _alltoall(g, *ctx.args), None, None, None


def alltoall(x, async_op=False, axes=None, split_dim=0, concat_dim=0):
    """Split ``split_dim`` of ``x`` into one chunk per rank of ``axes``,
    send chunk ``i`` to the rank whose ``mesh_rank(axes)`` is ``i``, and
    concatenate what arrives along ``concat_dim`` in rank order (the JAX
    package's ``lax.all_to_all(x, axes, split_dim, concat_dim,
    tiled=True)``). With ``async_op`` (dims 0 and 0 only) returns a
    ``Pending``; without, the call is differentiable."""
    if async_op:
        if split_dim or concat_dim:
            raise ValueError("alltoall(async_op=True) splits and "
                             "concatenates dim 0")
        return _alltoall(x, axes, async_op=True)
    return _AllToAll.apply(x, axes, split_dim, concat_dim)


def _ppermute(x, axis, perm):
    m = mesh_lib.get_mesh()
    n, me = m.axis_size(axis), m.axis_index(axis)
    srcs, dsts = [s for s, _ in perm], [d for _, d in perm]
    if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts) or \
            not all(0 <= i < n for i in srcs + dsts):
        raise ValueError(f"ppermute over {axis!r} (size {n}): {perm} is "
                         "not a partial permutation")
    x = x.contiguous()
    send_to = [d for s, d in perm if s == me]
    recv_from = [s for s, d in perm if d == me]
    if recv_from == [me]:  # a pair to self: no wire
        return x.clone()
    out = torch.empty_like(x) if recv_from else torch.zeros_like(x)
    group, _ = m.group_of(axis)
    ops = [dist.P2POp(dist.isend, x, m.peer(axis, d), group)
           for d in send_to if d != me]
    ops += [dist.P2POp(dist.irecv, out, m.peer(axis, s), group)
            for s in recv_from]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return out


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, perm):
        ctx.axis, ctx.perm = axis, perm
        return _ppermute(x, axis, perm)

    @staticmethod
    def backward(ctx, g):
        inverse = [(d, s) for s, d in ctx.perm]
        return _ppermute(g, ctx.axis, inverse), None, None


def ppermute(x, axis, perm):
    """``lax.ppermute`` over one mesh axis: for each pair ``(i, j)`` of
    ``perm`` the rank at index ``i`` of ``axis`` sends ``x`` to the rank
    at index ``j``; a rank that receives nothing gets zeros. P2P over the
    axis's group; a pair to self is a copy, with nothing on the wire.
    Differentiable."""
    return _PPermute.apply(x, axis, [tuple(p) for p in perm])


def broadcast_(x, root_rank=0, axes=None):
    """Overwrite ``x`` in place with the value of the rank whose
    ``mesh_rank(axes)`` is ``root_rank``."""
    group, ranks, _ = _group(axes)
    dist.broadcast(x, src=ranks[root_rank], group=group)
    return x


def broadcast(x, root_rank=0, axes=None):
    """Out-of-place ``broadcast_``."""
    return broadcast_(x.clone(), root_rank=root_rank, axes=axes)
