"""The process mesh: one logical mesh over every rank of a job that spans
hosts. The port of ``horovod_tpu/cluster/procmesh.py``.

In the JAX package a row of the process mesh is one process holding K
devices, and ``jax.distributed.initialize`` joins the processes into one
runtime. Here one process drives one device, so a rank plays the part of
a JAX device, and a row is a group of K ranks: on a real job, one host's
ranks (the CPU stand-in sets K with ``HOROVOD_SPMD_LOCAL_DEVICES``).

* :func:`ensure_distributed` is the one call site of
  ``torch.distributed.init_process_group`` in the port (the twin of the
  JAX package's one ``jax.distributed.initialize``); ``basics.init()``
  joins the job through it.
* :func:`build_process_mesh` lays the world out as the 2-D ``(dcn, data)``
  mesh, ICI-first: the minor ``data`` axis is a row's ranks, the outer
  ``dcn`` axis the rows. Horovod's ranks are host-major, so row ``p``
  holds ranks ``p*K .. p*K + K-1``, and a batch sharded over ``(dcn,
  data)`` puts a contiguous block of global rows on each row, the
  contract ``ckpt.sharded`` and the loaders' ``rank/world`` sharding
  assume.
* :func:`shard_from_global` and :func:`place` make the DTensors of the
  GSPMD path (``parallel/gspmd.py``) from a host copy every rank holds,
  with no collective.

There is no device-count forcing here (the JAX package's
``--xla_force_host_platform_device_count``): one process drives one
device, so a row of K ranks is K processes.
"""

import logging
import os
import threading

import numpy as np

from horovod_tpu_torch.parallel.mesh import DATA_AXIS, DCN_AXIS

logger = logging.getLogger("horovod_tpu_torch")

_lock = threading.Lock()
_dist = {"joined": False, "spec": None}


def _env_int(env, name, default=0):
    v = env.get(name)
    if v in (None, ""):
        return default
    return int(v)


def coordinator_spec(cfg=None, env=None):
    """The ``(address, rows, rank)`` of a job over one process mesh, or
    None for a job without one. Read from the hvdrun env contract:
    ``HOROVOD_COORDINATOR_ADDR`` names the job's rendezvous,
    ``HOROVOD_SPMD_PROCS`` (default ``HOROVOD_SIZE``) the rows, and the
    rank is the launcher's (JAX ``procmesh.py:55``). A job of one row is
    None: its mesh is the 1-D ``(data,)`` one ``init()`` installs
    anyway."""
    env = os.environ if env is None else env
    coord = env.get("HOROVOD_COORDINATOR_ADDR")
    if not coord:
        return None
    if cfg is not None:
        rank, size = cfg.rank, cfg.size
        procs = getattr(cfg, "spmd_procs", 0) or size
    else:
        rank = _env_int(env, "HOROVOD_RANK", 0)
        size = _env_int(env, "HOROVOD_SIZE", 1)
        procs = _env_int(env, "HOROVOD_SPMD_PROCS", 0) or size
    if procs <= 1:
        return None
    return (coord, procs, rank)


def _foreign_distributed():
    """True when something other than :func:`ensure_distributed` has
    joined ``torch.distributed`` in this process (JAX
    ``procmesh.py:89``)."""
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def ensure_distributed(cfg=None, env=None, backend="gloo", store=None):
    """Join the job's world process group (idempotent): the one
    ``torch.distributed.init_process_group`` call site of the port.
    ``store`` is the rendezvous store, or a function that makes it (it is
    called only when this call joins). Returns True when the job runs
    over one process mesh across rows (:func:`coordinator_spec`), False
    otherwise (JAX ``procmesh.py:111``).

    A second call with the same spec returns at once; one that names
    another coordinator raises, as does a process whose
    ``torch.distributed`` something else joined first: the port's mesh,
    groups and checkpoints are keyed on the world it joins itself.
    ``leave()`` (``basics.shutdown()``) forgets the join."""
    import torch.distributed as dist

    env = os.environ if env is None else env
    spec = coordinator_spec(cfg, env)
    with _lock:
        if _dist["joined"]:
            if spec != _dist["spec"]:
                raise RuntimeError(
                    f"torch.distributed already joined as {_dist['spec']} "
                    f"but the environment now names {spec}; one process "
                    "cannot re-join a different coordinator")
            return spec is not None
        if _foreign_distributed():
            raise RuntimeError(
                "torch.distributed was initialized outside "
                "horovod_tpu_torch; call horovod_tpu_torch.init() before "
                "anything else joins the process group, or destroy it")
        if cfg is not None:
            rank, size = cfg.rank, cfg.size
        else:
            rank = _env_int(env, "HOROVOD_RANK", 0)
            size = _env_int(env, "HOROVOD_SIZE", 1)
        if callable(store):
            store = store()
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=size)
        _dist["joined"] = True
        _dist["spec"] = spec
        if spec is not None:
            logger.info("joined the process mesh: coordinator=%s rank %d, "
                        "%d rows", spec[0], rank, spec[1])
        return spec is not None


def leave():
    """Forget the join (after the world group is destroyed)."""
    with _lock:
        _dist["joined"] = False
        _dist["spec"] = None


def is_multiprocess():
    """True when this process joined a job over one process mesh across
    rows through :func:`ensure_distributed`."""
    with _lock:
        return _dist["joined"] and _dist["spec"] is not None


def row_owners(size=None, procs=None, local=None):
    """The row of every rank, ``[rank // K]`` for K = ``size // procs``
    ranks a row: the default of ``process_grid``. ``size``, ``procs`` and
    ``local`` (K, when it is stated) default to the installed mesh's
    world, ``HOROVOD_SPMD_PROCS`` (or one row) and
    ``HOROVOD_SPMD_LOCAL_DEVICES``."""
    if size is None:
        from horovod_tpu_torch.parallel import mesh as mesh_lib
        size = mesh_lib.get_mesh().size
    if procs is None:
        procs = _env_int(os.environ, "HOROVOD_SPMD_PROCS", 0) or 1
    if local is None:
        local = _env_int(os.environ, "HOROVOD_SPMD_LOCAL_DEVICES", 0)
    if procs < 1 or size % procs:
        raise ValueError(f"ragged process mesh: {size} ranks in {procs} "
                         "rows")
    k = size // procs
    if local and local != k:
        raise ValueError(f"{procs} rows of {local} ranks each are "
                         f"{procs * local} ranks; the world has {size}")
    return [r // k for r in range(size)]


def process_grid(owners=None):
    """The ranks as a ``(rows, K)`` array: row ``p`` holds the ranks whose
    row (``owners[rank]``, default ``row_owners()``) is ``p``, in rank
    order, the rows in row order (JAX ``procmesh.py:197``). Raises
    ``ValueError`` when rows hold unequal rank counts."""
    owners = row_owners() if owners is None else list(owners)
    by_row = {}
    for rank, row in enumerate(owners):
        by_row.setdefault(row, []).append(rank)
    counts = {p: len(rs) for p, rs in by_row.items()}
    if len(set(counts.values())) != 1:
        raise ValueError(f"ragged process mesh: ranks per row {counts}")
    return np.asarray([by_row[p] for p in sorted(by_row)], dtype=np.int64)


def build_process_mesh(owners=None, axis_names=(DCN_AXIS, DATA_AXIS)):
    """Build and install ONE mesh over every rank of the job: the ``(rows,
    K)`` grid of :func:`process_grid` as ``axis_names`` (``(dcn, data)``,
    ICI-first), or the 1-D ``(data,)`` mesh for one row (JAX
    ``procmesh.py:217``). The port's meshes lay ranks out row-major
    (``parallel.mesh.build_mesh``), so the grid must be rank-major, as
    Horovod's host-major ranks make it; every rank must call it (building
    groups is collective). ``init()`` must have run."""
    from horovod_tpu_torch.parallel import mesh as mesh_lib
    grid = process_grid(owners)
    if not np.array_equal(grid.reshape(-1), np.arange(grid.size)):
        raise ValueError(
            f"process mesh rows {grid.tolist()} are not rank-major: a row "
            "must hold consecutive ranks, in row order")
    mesh = mesh_lib.build_mesh(num_slices=grid.shape[0],
                               axis_names=tuple(axis_names))
    assert_process_contiguous(mesh, owners=row_owners(
        grid.size, grid.shape[0]) if owners is None else owners)
    return mesh


def _grid(mesh):
    """The ranks of ``mesh`` laid out on its shape: row-major for the
    port's meshes; a test stub may carry its own ``grid``."""
    grid = getattr(mesh, "grid", None)
    if grid is None:
        grid = np.arange(int(np.prod(mesh.shape))).reshape(mesh.shape)
    return np.asarray(grid)


def mesh_tiers(mesh):
    """The interconnect tier of every mesh axis, outer to inner:
    ``[{"axis", "size", "tier", "scope"}]`` (JAX ``procmesh.py:234``). The
    ``dcn`` axis is the tier across rows (hosts), every other axis a
    tier within a row."""
    shape = dict(zip(mesh.axis_names, mesh.shape))
    procs = shape.get(DCN_AXIS, 1)
    out = []
    for axis, size in zip(mesh.axis_names, mesh.shape):
        if axis == DCN_AXIS:
            out.append({"axis": axis, "size": int(size), "tier": "dcn",
                        "scope": f"inter-process ({procs} processes)"})
        else:
            out.append({"axis": axis, "size": int(size), "tier": "ici",
                        "scope": "intra-process"})
    return out


def assert_process_contiguous(mesh, owners=None):
    """Raise ``ValueError`` unless every outer-axis row of the mesh grid
    holds the ranks of exactly one row (``owners[rank]``, default
    ``row_owners()``) and the rows appear in row order: the checkpoint's
    and the loaders' row keying assume each row owns a contiguous block
    of global batch rows (JAX ``procmesh.py:251``)."""
    grid = _grid(mesh)
    grid = grid.reshape(1, -1) if grid.ndim == 1 else grid.reshape(
        grid.shape[0], -1)
    owners = row_owners(grid.size) if owners is None else list(owners)
    if len(set(owners)) == 1:
        return
    last = -1
    for r in range(grid.shape[0]):
        rows = {owners[int(rank)] for rank in grid[r]}
        if len(rows) != 1:
            raise ValueError(
                f"process mesh row {r} spans processes {sorted(rows)}; "
                "ckpt row ownership requires one process per dcn row")
        row = rows.pop()
        if row < last:
            raise ValueError(
                "process mesh rows out of process order; ckpt global row "
                "indices would not be contiguous per process")
        last = row


def local_row_block(global_rows, mesh=None, procs=None, row=None):
    """``(start, stop)`` of the contiguous global batch rows this rank's
    row feeds, for a batch sharded over every data axis of a
    process-contiguous mesh: block ``row`` of ``procs`` equal blocks
    (JAX ``procmesh.py:280``). ``procs`` and ``row`` default to the
    installed mesh's ``dcn`` size and this rank's coordinate on it."""
    from horovod_tpu_torch.parallel import mesh as mesh_lib
    if procs is None or row is None:
        m = mesh if mesh is not None else mesh_lib.get_mesh()
        has_dcn = DCN_AXIS in m.axis_names
        procs = m.axis_size(DCN_AXIS) if has_dcn else 1
        row = m.axis_index(DCN_AXIS) if has_dcn else 0
    if mesh is not None:
        assert_process_contiguous(mesh)
    if global_rows % procs != 0:
        raise ValueError(
            f"global batch {global_rows} not divisible by process count "
            f"{procs}")
    per = global_rows // procs
    return row * per, (row + 1) * per


def _local_slices(shape, device_mesh, placements):
    """This rank's block of a tensor of ``shape`` under ``placements``
    over ``device_mesh``: a ``Shard(d)`` placement cuts dim ``d`` into
    equal chunks over that mesh dim, mesh dims in order (DTensor's
    layout); an uneven cut raises."""
    from torch.distributed.tensor import Replicate, Shard
    coords = device_mesh.get_coordinate()
    starts, sizes = [0] * len(shape), list(shape)
    for mdim, p in enumerate(placements):
        if isinstance(p, Replicate):
            continue
        if not isinstance(p, Shard):
            raise ValueError(f"cannot cut a host value to {p}")
        n = device_mesh.size(mdim)
        if sizes[p.dim] % n:
            raise ValueError(
                f"dim {p.dim} of {tuple(shape)} ({sizes[p.dim]} at mesh "
                f"dim {mdim}) does not divide by {n} ranks")
        sizes[p.dim] //= n
        starts[p.dim] += coords[mdim] * sizes[p.dim]
    return tuple(slice(s, s + n) for s, n in zip(starts, sizes))


def shard_from_global(x, device_mesh, placements):
    """The DTensor of ``placements`` over ``device_mesh`` built from a
    full host copy of the global value that every rank holds, with NO
    collective: each rank cuts its own block and wraps it
    (``DTensor.from_local(..., run_check=False)``).

    Under SPMD every rank computes the same host values (batches, init
    parameters, zero buffers), so no rank needs another's. Placing the
    value through a collective instead (``distribute_tensor``, which
    scatters from rank 0, or ``from_local``'s ``run_check``) would put
    the whole value on the wire at every call and interleave with the
    step's own collectives (JAX ``procmesh.py:313-330``). The caller
    vouches that ``x`` is the same on every rank."""
    import torch
    from torch.distributed.tensor import DTensor
    x = torch.as_tensor(x)
    local = x[_local_slices(x.shape, device_mesh, placements)]
    local = local.to(device_mesh.device_type).contiguous()
    return DTensor.from_local(local, device_mesh, list(placements),
                              run_check=False, shape=x.shape,
                              stride=x.contiguous().stride())


def global_batch(x, device_mesh, placements, global_rows=None):
    """The DTensor of a batch whose dim 0 is sharded, from this rank's own
    rows ``x`` only: no rank holds the whole batch (JAX
    ``procmesh.py:298``). ``global_rows`` defaults to ``x``'s rows times
    the ranks dim 0 is cut over."""
    import torch
    from torch.distributed.tensor import DTensor, Shard
    n = 1
    for mdim, p in enumerate(placements):
        if isinstance(p, Shard):
            if p.dim != 0:
                raise ValueError("global_batch shards dim 0 only")
            n *= device_mesh.size(mdim)
    x = torch.as_tensor(x).to(device_mesh.device_type)
    shape = (global_rows or x.shape[0] * n,) + tuple(x.shape[1:])
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(x, device_mesh, list(placements),
                              run_check=False, shape=shape, stride=stride)


def place(x, device_mesh, placements):
    """The placement primitive of the GSPMD path (``gspmd.place_state``,
    the steps' batches; JAX ``procmesh.py:339``): a DTensor already
    under ``placements`` on ``device_mesh`` is returned as it is, another
    DTensor is redistributed (a true reshard), and a host or local tensor
    is cut by :func:`shard_from_global`, with no collective."""
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        if x.device_mesh == device_mesh and \
                tuple(x.placements) == tuple(placements):
            return x
        return x.redistribute(device_mesh, list(placements))
    return shard_from_global(x, device_mesh, placements)


def _reset_for_tests():
    """Forget the join record (the unit tests stub the process group)."""
    leave()
