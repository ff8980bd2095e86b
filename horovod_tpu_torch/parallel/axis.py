"""Mesh axes as the algorithms over them see them: the shards this
process computes, and how they move between the ranks of one axis.

Ring attention, the two-level reduction and Adasum are each written once,
against an axis object:

* ``GroupAxis(name)`` is this rank's one shard on the axis ``name`` of the
  installed mesh (lists of one tensor), moved by the collectives of the
  axis's process group;
* ``LocalAxis(n)`` is every shard of an axis of ``n`` ranks, held in one
  process (lists of ``n`` tensors, shard ``j`` on rank ``j``) and moved by
  reindexing: the counterpart of the JAX tests' virtual CPU mesh. The
  tests and ``chip_smoke.py`` drive the algorithms through it.
  ``local_axes(shape, names)`` gives one per axis of a mesh whose every
  rank is held in one process, the shards in rank order.

Each operation takes and returns a list of shards, one entry per shard of
``indices`` (this shard's coordinate on the axis); outputs may share
storage. The sums run over the ranks of the axis in index order in the
local form and in the collective's order in the group form: over two
ranks both are one addition, so the two forms give the same bits.
"""

import torch

from horovod_tpu_torch.ops import collective
from horovod_tpu_torch.ops.reduction import Sum
from horovod_tpu_torch.parallel import mesh as mesh_lib


class GroupAxis:
    """This rank's shard on ``axis`` of the installed mesh: lists of one
    tensor, moved by the axis's process group."""

    def __init__(self, axis):
        mesh = mesh_lib.get_mesh()
        self.axis = axis
        self.n = mesh.axis_size(axis)
        self.indices = [mesh.axis_index(axis)]

    def shift(self, xs):
        """Each rank's tensor to the next rank of the ring."""
        if self.n == 1:
            return xs
        perm = [(j, (j + 1) % self.n) for j in range(self.n)]
        return [collective.ppermute(xs[0], self.axis, perm)]

    def exchange(self, xs, d):
        """Each rank's tensor to its partner at distance ``d``: the rank
        whose index is its own XOR ``d`` (``n`` a power of 2)."""
        perm = [(j, j ^ d) for j in range(self.n)]
        return [collective.ppermute(xs[0], self.axis, perm)]

    def all_to_all(self, xs, split_dim, concat_dim):
        return [collective.alltoall(xs[0], axes=self.axis,
                                    split_dim=split_dim,
                                    concat_dim=concat_dim)]

    def all_gather(self, xs, dim=0):
        x = xs[0].movedim(dim, 0)
        return [collective.allgather(x, axes=self.axis).movedim(0, dim)]

    def reduce_scatter(self, xs):
        """The sum over the axis, chunk ``i`` of dim 0 to index ``i``."""
        return [collective.reducescatter(xs[0], op=Sum, axes=self.axis)]

    def all_reduce(self, xs):
        """The sum over the axis, on every rank."""
        return [collective.allreduce_(xs[0].clone(), op=Sum,
                                      axes=self.axis)]


class LocalAxis:
    """Every shard of an axis in this process. ``LocalAxis(n)``: one axis
    of ``n`` ranks, shard ``j`` at index ``j``. ``groups`` (lists of shard
    positions, each in index order) lays out an axis of a larger mesh:
    every group is one set of ranks that share their other coordinates.
    A moved tensor is a view, so autograd sums its gradient in the order
    the group's backward does and the two give the same bits."""

    def __init__(self, n, groups=None):
        self.n = n
        self.groups = [list(range(n))] if groups is None else groups
        if any(len(g) != n for g in self.groups):
            raise ValueError(f"groups {self.groups} of an axis of {n}")
        width = sum(len(g) for g in self.groups)
        self.indices = [0] * width
        for g in self.groups:
            for i, pos in enumerate(g):
                self.indices[pos] = i

    def _each(self, fn):
        """``fn(group)`` gives each member's output in index order; the
        outputs in shard order."""
        out = [None] * len(self.indices)
        for g in self.groups:
            for pos, y in zip(g, fn(g)):
                out[pos] = y
        return out

    def shift(self, xs):
        return self._each(lambda g: [xs[g[(i - 1) % self.n]].view_as(
            xs[g[i]]) for i in range(self.n)])

    def exchange(self, xs, d):
        return self._each(lambda g: [xs[g[i ^ d]].view_as(xs[g[i]])
                                     for i in range(self.n)])

    def all_to_all(self, xs, split_dim, concat_dim):
        def one(g):
            parts = [xs[p].chunk(self.n, dim=split_dim) for p in g]
            return [torch.cat([q[j] for q in parts], dim=concat_dim)
                    for j in range(self.n)]
        return self._each(one)

    def all_gather(self, xs, dim=0):
        return self._each(lambda g: [torch.cat([xs[p] for p in g],
                                               dim=dim)] * self.n)

    def _sum(self, parts):
        out = parts[0]
        for p in parts[1:]:
            out = out + p
        return out

    def reduce_scatter(self, xs):
        def one(g):
            if xs[g[0]].shape[0] % self.n:
                raise ValueError(f"reducescatter: dim 0 "
                                 f"({xs[g[0]].shape[0]}) does not divide "
                                 f"by the group's size {self.n}")
            parts = [xs[p].chunk(self.n) for p in g]
            return [self._sum([q[i] for q in parts]) for i in range(self.n)]
        return self._each(one)

    def all_reduce(self, xs):
        return self._each(lambda g: [self._sum([xs[p] for p in g])] *
                          self.n)


def local_axes(shape, names):
    """``{name: LocalAxis}`` for every axis of a mesh of ``shape`` named
    ``names`` whose ranks are all held in this process, shard ``r`` the
    rank ``r`` (row-major, as ``mesh.build_mesh`` lays ranks out)."""
    groups = mesh_lib.mesh_groups(shape, names)
    return {name: LocalAxis(n, groups[(name,)])
            for name, n in zip(names, shape)}
