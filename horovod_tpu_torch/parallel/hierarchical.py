"""Two-level reduction: within a host (the ICI axes), then across hosts
(``dcn``).

The port of ``horovod_tpu/parallel/hierarchical.py`` (after Horovod's
``NCCLHierarchicalAllreduce``): a reduce-scatter over the intra-host
axes, an allreduce of the 1/ici_size shard across hosts, and an
all-gather back, so the cross-host stage moves 1/ici_size of the bytes.
Zero padding to equal shards replaces the reference's remainder path, as
in the JAX package. Sum and Average only: Adasum has its own two-level
composite (``ops/adasum.py``) and Min/Max do not reduce-scatter.

Each function takes mesh axis names and runs on the installed mesh's
process groups. The algorithms are written once, over the axis objects
of ``parallel/axis.py`` (``_reducescatter`` and ``_allgather`` take
lists of shards and the axes in stage order, ``_allreduce`` the ICI axes
and ``dcn``): ``GroupAxis`` in a job, ``LocalAxis`` for every rank of a
mesh held in one process. The bucket exchange of ``ops/fusion.py`` runs
the same stages over its schedule's order of axes
(``staged_reducescatter``, ``staged_allgather``).
"""

import torch

from horovod_tpu_torch.ops import collective
from horovod_tpu_torch.parallel.axis import GroupAxis
from horovod_tpu_torch.parallel.mesh import DATA_AXIS, DCN_AXIS


def _names(ici_axes):
    return (ici_axes,) if isinstance(ici_axes, str) else tuple(ici_axes)


def _check_op(what, op):
    if op not in ("sum", "average"):
        raise ValueError(f"{what} supports sum/average, got {op!r}")


def _group_axes(ici_axes, dcn_axis):
    """The ICI axes, then ``dcn_axis``, as ``GroupAxis`` objects."""
    return [GroupAxis(a) for a in _names(ici_axes) + (dcn_axis,)]


def hierarchical_reducescatter(x, ici_axes=(DATA_AXIS,), dcn_axis=DCN_AXIS,
                               op="sum"):
    """Reduce-scatter composed ICI-first: scatter over the intra-host
    axes, then the 1/ici_size shard over ``dcn_axis``. Dim 0 must divide
    by the number of ranks. Chunk ownership is row-major over
    ``(*ici_axes, dcn_axis)`` (``collective.mesh_rank`` of that tuple),
    which ``hierarchical_allgather`` inverts exactly."""
    return _reducescatter([x], _group_axes(ici_axes, dcn_axis), op)[0]


def hierarchical_allgather(x, ici_axes=(DATA_AXIS,), dcn_axis=DCN_AXIS):
    """Inverse of ``hierarchical_reducescatter``: gather over ``dcn_axis``
    first, then over the ICI axes in reverse."""
    return _allgather([x], _group_axes(ici_axes, dcn_axis))[0]


def hierarchical_allreduce(x, ici_axes=(DATA_AXIS,), dcn_axis=DCN_AXIS,
                           op="average"):
    """Allreduce ``x`` over ``ici_axes + (dcn_axis,)`` in three stages: a
    reduce-scatter over the ICI axes (``x`` flattened and zero-padded to
    a multiple of their size), an allreduce of the shard over
    ``dcn_axis``, an all-gather over the ICI axes. Average divides once,
    at the end, by every rank's count."""
    *ici, dcn = _group_axes(ici_axes, dcn_axis)
    return _allreduce([x], ici, dcn, op)[0]


def staged_reducescatter(x, axes, op="sum", async_op=False):
    """Reduce-scatter ``x`` over the installed mesh's ``axes``, one stage
    per axis in their order: ``_reducescatter`` in its group form. With
    ``async_op`` the first stage is issued at once and the others run at
    ``wait()`` of the returned ``collective.Pending``."""
    _check_op("reducescatter", op)
    axes = [GroupAxis(a) for a in axes]
    first = collective.reducescatter(x, op=collective.Sum, async_op=True,
                                     axes=axes[0].axis)
    pending = collective.Pending((), lambda: _reducescatter(
        [first.wait()], axes[1:], op, scale=axes[0].n)[0])
    return pending if async_op else pending.wait()


def staged_allgather(x, axes):
    """Inverse of ``staged_reducescatter``."""
    return _allgather([x], [GroupAxis(a) for a in axes])[0]


def _reducescatter(xs, axes, op="sum", scale=1):
    """Reduce-scatter over the axis objects ``axes`` in their order,
    summing at each stage. Average divides once, at the end, by the ranks
    of every stage times ``scale`` (the ranks of a stage already run)."""
    _check_op("hierarchical_reducescatter", op)
    out, total = xs, scale
    for axis in axes:
        total *= axis.n
        out = axis.reduce_scatter(out)
    if op == "average":
        out = [o / total for o in out]
    return out


def _allgather(xs, axes):
    """Inverse of ``_reducescatter``: gather over ``axes`` last to
    first."""
    out = xs
    for axis in reversed(axes):
        out = axis.all_gather(out)
    return out


def _pad_flat(xs, ici):
    """Each shard flat and zero-padded to a multiple of the ICI size:
    ``(flats, n, ici_size)``."""
    n = xs[0].numel()
    ici_size = 1
    for axis in ici:
        ici_size *= axis.n
    pad = (-n) % ici_size
    flats = [x.reshape(-1) for x in xs]
    if pad:
        flats = [torch.cat([f, f.new_zeros(pad)]) for f in flats]
    return flats, n, ici_size


def _allreduce(xs, ici, dcn, op="average"):
    _check_op("hierarchical_allreduce", op)
    shape = xs[0].shape
    shard, n, ici_size = _pad_flat(xs, ici)
    shard = dcn.all_reduce(_reducescatter(shard, ici))
    out = [o[:n].reshape(shape) for o in _allgather(shard, ici)]
    if op == "average":
        total = ici_size * dcn.n
        out = [o / total for o in out]
    return out
