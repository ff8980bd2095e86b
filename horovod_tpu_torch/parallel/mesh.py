"""The process mesh of the port: named axes over process groups, and this
process's device.

In the JAX package a mesh is a ``jax.sharding.Mesh`` of devices and a
collective binds to axis names. Here one process drives one device, so a
mesh is a grid of ranks: ``build_mesh((2, 2), ("data", "seq"))`` lays the
world out row-major, rank r at ``np.unravel_index(r, shape)`` (where
``jax.sharding.Mesh(np.arange(n).reshape(shape), names)`` holds device
r), and creates one process group for each set of axes a collective can
name: the ranks that share this rank's coordinates on the other axes,
in row-major order over the named ones.

``init()`` installs the 1-D mesh ``("data",)`` over the world;
``build_mesh`` installs the one it builds. ``group``, ``size`` and
``rank`` are always the whole mesh's (the world's): the default
reduction of the collectives, ``DistributedOptimizer``, the bucket
exchange, ZeRO-1 and the checkpoints read them.
"""

import dataclasses
import itertools
import threading

import numpy as np
import torch

DATA_AXIS = "data"
DCN_AXIS = "dcn"

_lock = threading.Lock()
_current = None


def mesh_groups(shape, axis_names):
    """The layout of a mesh of ``shape`` over ranks ``0..prod(shape)-1``:
    ``{axes: [ranks of each group]}`` for every non-empty tuple of axes
    in mesh order, each group's ranks in row-major order over ``axes``
    and the groups in row-major order over the other axes. Every rank
    creates every group in this order."""
    shape, axis_names = tuple(shape), tuple(axis_names)
    grid = np.arange(int(np.prod(shape))).reshape(shape)
    out = {}
    for k in range(1, len(shape) + 1):
        for idx in itertools.combinations(range(len(shape)), k):
            rest = [i for i in range(len(shape)) if i not in idx]
            rows = grid.transpose(rest + list(idx)).reshape(
                -1, int(np.prod([shape[i] for i in idx])))
            out[tuple(axis_names[i] for i in idx)] = [
                [int(r) for r in row] for row in rows]
    return out


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    group: object          # process group of the whole mesh (the world)
    device: torch.device   # the device this process computes on
    size: int
    rank: int
    axis_names: tuple = (DATA_AXIS,)
    shape: tuple = None    # ranks per axis; None: (size,)
    # axes (mesh order) -> (process group, its ranks) of this rank
    groups: dict = None

    def __post_init__(self):
        if self.shape is None:
            object.__setattr__(self, "shape", (self.size,))
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} for axes "
                             f"{self.axis_names}")
        if self.groups is None:
            object.__setattr__(self, "groups", {})

    @property
    def coords(self):
        """This rank's coordinate on each axis (row-major)."""
        return tuple(int(c) for c in np.unravel_index(self.rank, self.shape))

    def axis_size(self, axis):
        return self.shape[self._axis(axis)]

    def axis_index(self, axis):
        return self.coords[self._axis(axis)]

    def _axis(self, axis):
        try:
            return self.axis_names.index(axis)
        except ValueError:
            raise ValueError(f"no axis {axis!r} in the mesh "
                             f"{self.axis_names}") from None

    def resolve(self, axes):
        """``axes`` (None: every axis; a name; a tuple of names in mesh
        order) as a tuple in mesh order."""
        if axes is None:
            return self.axis_names
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        idx = [self._axis(a) for a in axes]
        if not idx or idx != sorted(set(idx)):
            raise ValueError(f"axes {axes} must name distinct axes of "
                             f"{self.axis_names} in mesh order")
        return axes

    def spans(self, axes):
        """True when ``axes`` reduce over the whole mesh (every axis of
        size above 1 is named)."""
        axes = self.resolve(axes)
        return all(n == 1 or a in axes
                   for a, n in zip(self.axis_names, self.shape))

    def group_of(self, axes):
        """``(group, ranks)`` of this rank over ``axes``: the process
        group and its global ranks, in row-major order over ``axes``."""
        axes = self.resolve(axes)
        if axes == self.axis_names:
            return self.group, list(range(self.size))
        return self.groups[axes]

    def peer(self, axis, index):
        """The global rank at this rank's coordinates with ``axis`` at
        ``index``."""
        coords = list(self.coords)
        coords[self._axis(axis)] = index
        return int(np.ravel_multi_index(coords, self.shape))

    def release(self):
        """Drop the process groups (after the world is destroyed): a step
        function's closure may keep the mesh, and its groups must not
        live on into interpreter exit, where destroying a gloo group can
        abort the process."""
        object.__setattr__(self, "group", None)
        object.__setattr__(self, "groups", {})


def build_mesh(shape, axis_names):
    """Lay the world out as a mesh of ``shape`` named ``axis_names``,
    create its process groups and install it (``get_mesh``). Every rank
    must call it, with the same arguments: creating a group is
    collective, member or not. ``init()`` must have run."""
    import torch.distributed as dist
    base = get_mesh()
    shape, axis_names = tuple(int(n) for n in shape), tuple(axis_names)
    if len(shape) != len(axis_names) or len(set(axis_names)) != len(shape):
        raise ValueError(f"mesh shape {shape} for axes {axis_names}")
    if int(np.prod(shape)) != base.size:
        raise ValueError(f"a mesh of {shape} needs {int(np.prod(shape))} "
                         f"ranks; the world has {base.size}")
    groups = {}
    for axes, rows in mesh_groups(shape, axis_names).items():
        if axes == axis_names:
            continue
        for ranks in rows:
            # a group that is the whole world is the world's own
            group = (base.group if len(ranks) == base.size
                     else dist.new_group(ranks))
            if base.rank in ranks:
                groups[axes] = (group, ranks)
    mesh = Mesh(group=base.group, device=base.device, size=base.size,
                rank=base.rank, axis_names=axis_names, shape=shape,
                groups=groups)
    set_mesh(mesh)
    return mesh


def set_mesh(mesh):
    global _current
    with _lock:
        _current = mesh


def get_mesh():
    """The installed mesh: ``init()``'s, or the last ``build_mesh``."""
    with _lock:
        if _current is None:
            raise RuntimeError("horovod_tpu_torch has not been initialized; "
                               "call horovod_tpu_torch.init()")
        return _current


def axis_size(axis, mesh=None):
    """Ranks on ``axis`` of the installed mesh."""
    return (mesh or get_mesh()).axis_size(axis)


def axis_index(axis, mesh=None):
    """This rank's coordinate on ``axis`` of the installed mesh."""
    return (mesh or get_mesh()).axis_index(axis)


def data_axis_names(mesh=None):
    """The mesh axes gradients are reduced over (data + dcn)."""
    mesh = mesh or get_mesh()
    return tuple(a for a in mesh.axis_names if a in (DCN_AXIS, DATA_AXIS))


def ici_axis_names(mesh=None):
    """Every axis except ``dcn``: the intra-host tier."""
    mesh = mesh or get_mesh()
    return tuple(a for a in mesh.axis_names if a != DCN_AXIS)
