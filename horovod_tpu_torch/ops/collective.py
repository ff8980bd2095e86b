"""Collectives over named axes of the process mesh.

The port of ``horovod_tpu/ops/collective.py``'s ``allreduce``,
``allgather``, ``broadcast``, ``reducescatter``, ``alltoall``,
``mesh_size`` and ``mesh_rank``, and of ``lax.ppermute``:
``torch.distributed`` calls on a process group of the installed mesh
(``parallel/mesh.py``; NCCL on the card, gloo on the CPU). ``axes`` names
the mesh axes a collective runs over: a name, a tuple, or None for the
data axes (``data_axis_names()``, as the JAX package's
``_resolve_axes``; every axis of a mesh without one; the world on a 1-D
mesh and on ``init()``'s ``(dcn, data)`` mesh). Average is
a Sum followed by a division by the group's size, one path for both
backends (gloo has no AVG). Chunk ``i`` of dim 0 belongs to the rank
whose ``mesh_rank(axes)`` is ``i`` in every collective that splits or
concatenates along it: row-major over ``axes`` in the order given, so a
tuple out of mesh order, such as the ``("data", "dcn")`` of a
hierarchical bucket schedule, runs on the group of the same ranks with
its chunks permuted. ``op=Adasum`` reduces by ``ops/adasum.py``: its XOR
tree over one axis, its two-level composite over several.

``ppermute``, the synchronous ``allgather`` and ``alltoall`` are
``torch.autograd.Function``s, so a model's forward may call them:
``ppermute``'s backward is ``ppermute`` with the inverse permutation,
``alltoall``'s the reverse all-to-all and ``allgather``'s a Sum
reduce-scatter.

Telemetry (JAX ``ops/collective.py:26-60``). Every call runs eagerly in
the port, so each one is recorded when it is issued: its op name, wire
bytes and logical bytes into ``hvd_collective_*``
(``telemetry/instruments.record_collective``, one count a call), and a
flight-recorder entry (``mode="eager"``) closed when its works end
(``Pending.wait``), so a rank parked in a collective, or killed inside
one, leaves an open entry naming it. The desync digest hashes each
call's ``op|name|shape|dtype``, dtypes under numpy's names
(``diag/recorder.py``); ``allgather`` leaves its shape out, as the JAX
eager ``allgather`` does. As in the JAX package, only the collectives a
user calls outside a train step (``hvd.allreduce`` and its siblings)
charge the goodput ledger's ``exposed_collective`` with the host time
from issue to the end of their wait: the collectives inside a step
builder's body (``training.py`` brackets them with ``in_step``) book as
the step's ``compute``, where the JAX package compiles them into the
step.
"""

import contextlib
import time

import numpy as np
import torch
import torch.distributed as dist

from horovod_tpu_torch.diag import recorder as _flightrec
from horovod_tpu_torch.telemetry import instruments as _tele
from horovod_tpu_torch.telemetry import ledger as _ledger

from horovod_tpu_torch.ops import compression as compression_lib
from horovod_tpu_torch.ops.reduction import Adasum, Average, Max, Min, Sum
from horovod_tpu_torch.parallel import mesh as mesh_lib

_OPS = {Sum: dist.ReduceOp.SUM, Average: dist.ReduceOp.SUM,
        Min: dist.ReduceOp.MIN, Max: dist.ReduceOp.MAX}


# how many step bodies are running (``in_step``): a module count, not a
# thread-local, since a backward on the card runs on autograd's threads
_step_depth = 0


@contextlib.contextmanager
def in_step():
    """Bracket a train step's body: its collectives book as the step's
    compute, not as exposed collective time. The bracket is the
    process's, not the thread's: an ``hvd.allreduce`` that another
    thread calls while a step runs books as that step's compute too."""
    global _step_depth
    _step_depth += 1
    try:
        yield
    finally:
        _step_depth -= 1


def _nbytes(x):
    return x.numel() * x.element_size()


class _Record:
    """One collective's telemetry, from issue (``__init__``) to the end
    of its wait (``close``): counters, the recorder's entry and exit,
    and outside a step the ledger's ``exposed_collective``."""

    __slots__ = ("op", "seq", "t0", "exposed")

    def __init__(self, op, x, nbytes=None, logical_nbytes=None,
                 hash_shape=True):
        nbytes = _nbytes(x) if nbytes is None else nbytes
        _tele.record_collective(op, nbytes, logical_nbytes=logical_nbytes)
        self.op = op
        self.seq = _flightrec.collective_enter(op, x, nbytes=nbytes,
                                               hash_shape=hash_shape)
        self.exposed = _step_depth == 0
        self.t0 = time.perf_counter() if self.exposed else 0.0

    def close(self, ok=True):
        if self.exposed:
            _ledger.get_ledger().charge("exposed_collective",
                                        time.perf_counter() - self.t0)
        _flightrec.collective_exit(self.op, self.seq, ok=ok)


@contextlib.contextmanager
def _recorded(op, x, **kwargs):
    rec = _Record(op, x, **kwargs)
    ok = False
    try:
        yield
        ok = True
    finally:
        rec.close(ok)


def _in_mesh_order(m, axes):
    if axes is None:
        return None
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    return tuple(sorted(axes, key=m._axis))


def _group(axes):
    """``(group, ranks, index of this rank in ranks)`` over ``axes``, the
    ranks in mesh order."""
    m = mesh_lib.get_mesh()
    group, ranks = m.group_of(_in_mesh_order(m, axes))
    return group, ranks, ranks.index(m.rank)


def _linear(axes):
    """For each rank of the group over ``axes`` (in mesh order), its index
    row-major over ``axes`` in the order given; None where the two orders
    agree."""
    m = mesh_lib.get_mesh()
    ordered = _in_mesh_order(m, axes)
    if ordered is None or tuple(ordered) == (
            (axes,) if isinstance(axes, str) else tuple(axes)):
        return None
    _, ranks = m.group_of(ordered)
    lin = []
    for r in ranks:
        coords = np.unravel_index(r, m.shape)
        idx = 0
        for a in axes:
            idx = idx * m.axis_size(a) + int(coords[m._axis(a)])
        lin.append(idx)
    return lin


def _permute(parts, order):
    return [parts[i] for i in order]


def _inverse(lin):
    return [lin.index(i) for i in range(len(lin))]


def allreduce_(x, op=Average, axes=None, logical_nbytes=None):
    """Reduce ``x`` in place across the ranks of ``axes``; every rank
    gets the result. ``op=Adasum`` runs ``ops/adasum.py``'s
    ``adasum_allreduce`` over ``axes`` (None: the data axes):
    its XOR tree over one axis (a power of 2 of ranks, else
    ``ValueError``), its two-level composite over several.
    ``logical_nbytes`` is the uncompressed width behind a payload a
    caller narrowed (telemetry's logical bytes; default: ``x``'s)."""
    if op == Adasum:
        from horovod_tpu_torch.ops import adasum
        axes = mesh_lib.get_mesh().resolve(axes)
        return x.copy_(adasum.adasum_allreduce(x, axes))
    if op not in _OPS:
        raise ValueError(f"unknown reduction op: {op!r}")
    if op == Average and not x.is_floating_point():
        raise TypeError(f"Average needs a floating tensor, got {x.dtype}")
    group, ranks, _ = _group(axes)
    with _recorded("allreduce", x, logical_nbytes=logical_nbytes):
        dist.all_reduce(x, op=_OPS[op], group=group)
    if op == Average and len(ranks) > 1:
        x.div_(len(ranks))
    return x


def allreduce(x, op=Average, compression=None, axes=None,
              logical_nbytes=None):
    """Out-of-place ``allreduce_``. ``compression`` (a compressor or a
    wire name, ``ops/compression.py``) casts ``x`` to a narrow wire dtype,
    reduces at that dtype and casts back. Only cast wires sum on the wire:
    a chunked quantizer raises, since its per-chunk scales cannot be summed
    in flight (``fusion.fused_allreduce_`` exchanges and then reduces).
    ``logical_nbytes``: as in ``allreduce_`` (None: ``x``'s bytes)."""
    compression = compression_lib.resolve(compression)
    if compression is None:
        return allreduce_(x.clone(), op=op, axes=axes,
                          logical_nbytes=logical_nbytes)
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
    if logical_nbytes is None:
        logical_nbytes = _nbytes(x)
    return compression.decompress(
        allreduce_(wire, op=op, axes=axes, logical_nbytes=logical_nbytes),
        ctx)


def mesh_size(axes=None):
    """Number of ranks across ``axes``."""
    return len(_group(axes)[1])


def mesh_rank(axes=None):
    """This rank's index across ``axes`` (row-major over them, in the
    order given)."""
    _, _, me = _group(axes)
    lin = _linear(axes)
    return me if lin is None else lin[me]


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

    def __init__(self, works, finish, keep=(), record=None):
        self._works, self._finish, self._keep = works, finish, keep
        self._record = record  # the collective's telemetry (_Record)
        self._out = None

    def wait(self):
        if self._finish is not None:
            rec, self._record = self._record, None
            ok = False
            try:
                for work in self._works:
                    work.wait()
                ok = True
            finally:
                if rec is not None:
                    rec.close(ok)
            self._out = self._finish()
            self._works, self._finish, self._keep = (), None, ()
        return self._out


# fp8 payloads cross the wire as their bytes: gloo has no fp8 type, and
# nothing is summed at fp8
_AS_BYTES = (torch.float8_e4m3fn, torch.float8_e5m2)


def _wire_view(x):
    return x.view(torch.uint8) if x.dtype in _AS_BYTES else x


def _allgather(x, axes, async_op=False, logical_nbytes=None):
    group, ranks, _ = _group(axes)
    lin = _linear(axes)
    x = x.contiguous()
    out = torch.empty((len(ranks) * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    # the shape stays out of the digest, as the JAX eager allgather's
    rec = _Record("allgather", x, logical_nbytes=logical_nbytes,
                  hash_shape=False)
    work = dist.all_gather_into_tensor(_wire_view(out), _wire_view(x),
                                       group=group, async_op=True)

    def finish():
        if lin is None:
            return out
        return torch.cat(_permute(out.chunk(len(ranks)), _inverse(lin)))

    pending = Pending((work,), finish, (x,), record=rec)
    return pending if async_op else pending.wait()


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, logical_nbytes):
        ctx.axes = axes
        return _allgather(x, axes, logical_nbytes=logical_nbytes)

    @staticmethod
    def backward(ctx, g):
        return _reducescatter(g, Sum, ctx.axes), None, None


def allgather(x, async_op=False, axes=None, logical_nbytes=None,
              tiled=True):
    """Concatenate ``x`` from the ranks of ``axes`` along dim 0 (equal
    shapes). With ``tiled=False`` stack them instead, on one new leading
    dim for each axis, in the order given: ``[n_a, n_b, ..., *x.shape]``
    for axes ``(a, b, ...)``, as JAX's ``lax.all_gather(tiled=False)``
    over each axis. With ``async_op`` returns a ``Pending``; without, the
    call is differentiable. ``logical_nbytes``: as in ``allreduce_``."""
    if not tiled:
        m = mesh_lib.get_mesh()
        names = (m.resolve(None) if axes is None
                 else (axes,) if isinstance(axes, str) else tuple(axes))
        shape = tuple(m.axis_size(a) for a in names) + tuple(x.shape)
        out = allgather(x.unsqueeze(0), async_op=async_op, axes=axes,
                        logical_nbytes=logical_nbytes)
        if not async_op:
            return out.reshape(shape)
        return Pending((), lambda: out.wait().reshape(shape))
    if async_op:
        return _allgather(x, axes, async_op=True,
                          logical_nbytes=logical_nbytes)
    return _AllGather.apply(x, axes, logical_nbytes)


def _reducescatter(x, op, axes, async_op=False, logical_nbytes=None):
    group, ranks, _ = _group(axes)
    n = len(ranks)
    if x.shape[0] % n:
        raise ValueError(f"reducescatter: dim 0 ({x.shape[0]}) does not "
                         f"divide by the group's size {n}")
    lin = _linear(axes)
    if lin is not None:  # group member g receives chunk lin[g]
        x = torch.cat(_permute(x.chunk(n), lin))
    x = x.contiguous()
    out = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    rec = _Record("reducescatter", x, logical_nbytes=logical_nbytes)
    work = dist.reduce_scatter_tensor(out, x, op=dist.ReduceOp.SUM,
                                      group=group, async_op=True)

    def finish():
        return out.div_(n) if op == Average and n > 1 else out

    pending = Pending((work,), finish, (x,), record=rec)
    return pending if async_op else pending.wait()


def reducescatter(x, op=Sum, async_op=False, axes=None,
                  logical_nbytes=None):
    """Reduce ``x`` across the ranks of ``axes`` and scatter the result
    along dim 0: the rank whose ``mesh_rank(axes)`` is ``i`` receives
    reduced chunk ``i`` (dim 0 must divide by their number). Sum or
    Average only. With ``async_op`` returns a ``Pending``.
    ``logical_nbytes``: as in ``allreduce_``."""
    if op not in (Sum, Average):
        raise ValueError("reducescatter supports Sum or Average")
    return _reducescatter(x, op, axes, async_op=async_op,
                          logical_nbytes=logical_nbytes)


def _alltoall(x, axes, split_dim=0, concat_dim=0, async_op=False,
              logical_nbytes=None):
    group, ranks, _ = _group(axes)
    n = len(ranks)
    if x.shape[split_dim] % n:
        raise ValueError(f"alltoall: dim {split_dim} ({x.shape[split_dim]})"
                         f" does not divide by the group's size {n}")
    lin = _linear(axes)
    if split_dim == concat_dim == 0 and lin is None:
        send = x.contiguous()
    else:  # chunk j of split_dim to rank j, stacked along a new dim 0
        parts = x.chunk(n, dim=split_dim)
        send = torch.stack(parts if lin is None else _permute(parts, lin))
        send = send.contiguous()
    out = torch.empty_like(send)
    rec = _Record("alltoall", x, nbytes=_nbytes(send),
                  logical_nbytes=logical_nbytes)
    work = dist.all_to_all_single(_wire_view(out), _wire_view(send),
                                  group=group, async_op=True)

    def finish():
        if split_dim == concat_dim == 0 and lin is None:
            return out
        parts = out.unbind(0)
        if lin is not None:
            parts = _permute(parts, _inverse(lin))
        return torch.cat(parts, dim=concat_dim)

    pending = Pending((work,), finish, (send,), record=rec)
    return pending if async_op else pending.wait()


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, split_dim, concat_dim):
        ctx.args = (axes, concat_dim, split_dim)
        return _alltoall(x, axes, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        return _alltoall(g, *ctx.args), None, None, None


def alltoall(x, async_op=False, axes=None, split_dim=0, concat_dim=0,
             logical_nbytes=None):
    """Split ``split_dim`` of ``x`` into one chunk per rank of ``axes``,
    send chunk ``i`` to the rank whose ``mesh_rank(axes)`` is ``i``, and
    concatenate what arrives along ``concat_dim`` in rank order (the JAX
    package's ``lax.all_to_all(x, axes, split_dim, concat_dim,
    tiled=True)``). With ``async_op`` (dims 0 and 0 only) returns a
    ``Pending``; without, the call is differentiable.
    ``logical_nbytes``: as in ``allreduce_``."""
    if async_op:
        if split_dim or concat_dim:
            raise ValueError("alltoall(async_op=True) splits and "
                             "concatenates dim 0")
        return _alltoall(x, axes, async_op=True,
                         logical_nbytes=logical_nbytes)
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
        with _recorded("ppermute", x):
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


def root_of(root_rank=0, axes=None):
    """``(group, global rank)`` of the rank whose ``mesh_rank(axes)`` is
    ``root_rank``: the group over ``axes`` and the ``src`` a
    ``torch.distributed`` broadcast from that rank takes."""
    group, ranks, _ = _group(axes)
    lin = _linear(axes)
    return group, ranks[root_rank if lin is None else lin.index(root_rank)]


def broadcast_(x, root_rank=0, axes=None):
    """Overwrite ``x`` in place with the value of the rank whose
    ``mesh_rank(axes)`` is ``root_rank``."""
    group, src = root_of(root_rank, axes)
    with _recorded("broadcast", x):
        dist.broadcast(x, src=src, group=group)
    return x


def broadcast(x, root_rank=0, axes=None):
    """Out-of-place ``broadcast_``."""
    return broadcast_(x.clone(), root_rank=root_rank, axes=axes)
