"""Mesh axes as the algorithms over them see them: the shards this
process computes, and how they move between the ranks of one axis.

Ring attention, the two-level reduction, Adasum, the tensor-parallel
transformer and the expert-parallel MoE are each written once, against
an axis object:

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
storage. ``shift`` and ``exchange`` move every shard; ``ppermute`` moves
those a partial permutation names and gives the others zeros, as
``collective.ppermute`` does. The sums run over the ranks of the axis in
index order in the local form and in the collective's order in the group
form: over two ranks both are one addition, so the two forms give the
same bits.

The moves above are plain functions of the shards. For a model whose
weights are sharded over an axis, both forms also give Megatron's
operators, each differentiable, with its conjugate as its backward:

* ``copy_to``: the identity forward, the sum over the axis backward (a
  replicated activation entering a sharded computation);
* ``reduce_from``: the sum over the axis forward, the identity backward
  (the partial results of a sharded computation, summed back into a
  replicated one);
* ``psum``: the sum both ways (a statistic of sharded data that every
  rank's replicated loss reads);
* ``gather_to``: the concatenation along dim 0 forward, this shard's
  chunk of the gradient backward (tokens sharded over the axis, gathered
  for a computation replicated over it);
* ``reduce_scatter_to``: the sum over the axis, chunk ``i`` of dim 0 to
  index ``i``, forward, and the concatenation backward (its conjugate).
"""

import torch

from horovod_tpu_torch.ops import collective
from horovod_tpu_torch.ops.reduction import Max, Sum
from horovod_tpu_torch.parallel import mesh as mesh_lib


class _Op(torch.autograd.Function):
    """``fwd`` on the shards forward and ``bwd`` on their gradients
    backward: each a function of a list of tensors to a list of tensors,
    run without autograd."""

    @staticmethod
    def forward(ctx, fwd, bwd, *xs):
        ctx.bwd = bwd
        outs, seen = [], set()
        for y in fwd(list(xs)):
            # every output its own tensor: autograd routes each one's
            # gradient to the shard that reads it
            if id(y) in seen or any(y is x for x in xs):
                y = y.clone()
            seen.add(id(y))
            outs.append(y)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        return (None, None) + tuple(ctx.bwd(list(gs)))


def _identity(xs):
    return xs


class _Operators:
    """The differentiable operators of an axis, over its moves
    (``all_reduce``, ``all_gather``, ``reduce_scatter``). On an axis of one
    rank each is the identity."""

    def _apply(self, fwd, bwd, xs):
        if self.n == 1:
            return list(xs)
        return list(_Op.apply(fwd, bwd, *xs))

    def copy_to(self, xs):
        return self._apply(_identity, self.all_reduce, xs)

    def reduce_from(self, xs):
        return self._apply(self.all_reduce, _identity, xs)

    def psum(self, xs):
        return self._apply(self.all_reduce, self.all_reduce, xs)

    def gather_to(self, xs):
        return self._apply(self.all_gather, self._own_chunks, xs)

    def reduce_scatter_to(self, xs):
        return self._apply(self.reduce_scatter, self.all_gather, xs)

    def _own_chunks(self, xs):
        return [x.chunk(self.n)[i] for x, i in zip(xs, self.indices)]


class GroupAxis(_Operators):
    """This rank's shard on ``axis`` of the installed mesh: lists of one
    tensor, moved by the axis's process group."""

    def __init__(self, axis):
        mesh = mesh_lib.get_mesh()
        self.axis = axis
        self.n = mesh.axis_size(axis)
        self.indices = [mesh.axis_index(axis)]

    def ppermute(self, xs, perm):
        """For each pair ``(i, j)`` of the partial permutation ``perm``,
        index ``i``'s tensor to index ``j``; an index that receives
        nothing gets zeros (a move that does not wrap)."""
        return [collective.ppermute(xs[0], self.axis, perm)]

    def shift(self, xs):
        """Each rank's tensor to the next rank of the ring."""
        if self.n == 1:
            return xs
        return self.ppermute(xs, [(j, (j + 1) % self.n)
                                  for j in range(self.n)])

    def exchange(self, xs, d):
        """Each rank's tensor to its partner at distance ``d``: the rank
        whose index is its own XOR ``d`` (``n`` a power of 2)."""
        return self.ppermute(xs, [(j, j ^ d) for j in range(self.n)])

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

    def all_max(self, xs):
        """The elementwise maximum over the axis, on every rank."""
        return [collective.allreduce_(xs[0].clone(), op=Max,
                                      axes=self.axis)]


class LocalAxis(_Operators):
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

    def ppermute(self, xs, perm):
        src = {j: i for i, j in perm}
        if len(src) != len(perm) or len(set(src.values())) != len(perm) \
                or not all(0 <= i < self.n for p in perm for i in p):
            raise ValueError(f"ppermute over an axis of {self.n}: {perm} is "
                             "not a partial permutation")
        return self._each(lambda g: [
            xs[g[src[i]]].view_as(xs[g[i]]) if i in src
            else torch.zeros_like(xs[g[i]]) for i in range(self.n)])

    def shift(self, xs):
        return self.ppermute(xs, [(j, (j + 1) % self.n)
                                  for j in range(self.n)])

    def exchange(self, xs, d):
        return self.ppermute(xs, [(j, j ^ d) for j in range(self.n)])

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

    def all_max(self, xs):
        def one(g):
            out = xs[g[0]]
            for p in g[1:]:
                out = torch.maximum(out, xs[p])
            return [out] * self.n
        return self._each(one)


def single_axis(width=1):
    """An axis of one rank over each of ``width`` shards: the axis a
    computation that is not sharded over it sees (every move and
    operator the identity)."""
    return LocalAxis(1, [[p] for p in range(width)])


def group_axis(axis):
    """``GroupAxis(axis)``, or the axis of one rank where ``axis`` is
    None."""
    return single_axis() if axis is None else GroupAxis(axis)


def local_axes(shape, names):
    """``{name: LocalAxis}`` for every axis of a mesh of ``shape`` named
    ``names`` whose ranks are all held in this process, shard ``r`` the
    rank ``r`` (row-major, as ``mesh.build_mesh`` lays ranks out)."""
    groups = mesh_lib.mesh_groups(shape, names)
    return {name: LocalAxis(n, groups[(name,)])
            for name, n in zip(names, shape)}
