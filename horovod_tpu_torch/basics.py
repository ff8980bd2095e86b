"""Process-level lifecycle and identity: init / shutdown / rank / size.

The port of ``horovod_tpu/basics.py``. ``init()`` reads the launcher's
env contract (``HOROVOD_RANK/SIZE/LOCAL_RANK/...``), picks this process's
device and joins the world process group that carries the data plane:

* on the card (the default): ``cuda:<local_rank>`` and NCCL;
* with ``device="cpu"``: the CPU and gloo (the tests run so).

A single-process job rendezvous through an in-process store, so it binds
no port. A multi-process job joins a torch TCP store:

* under the launcher, ``HOROVOD_GLOO_RENDEZVOUS_ADDR/PORT`` name its HTTP
  key-value store (``horovod_tpu/run/rendezvous.py``): rank 0 binds the
  TCP store on a free port and publishes ``host:port`` there, and the
  other ranks wait for it (``run/rendezvous.py``, signed with
  ``HOROVOD_SECRET_KEY``);
* otherwise the TCP store is at ``MASTER_ADDR/MASTER_PORT``, torch's own
  convention.
"""

import datetime
import os
import socket
import threading

import torch
import torch.distributed as dist

from horovod_tpu_torch.cluster import procmesh
from horovod_tpu_torch.config import Config
from horovod_tpu_torch.parallel import mesh as mesh_lib
from horovod_tpu_torch.runtime import services

_lock = threading.Lock()
_core_lock = threading.Lock()  # native_core()'s start of the core


class _State:
    def __init__(self):
        self.initialized = False
        self.config = None
        self.mesh = None
        self.init_mesh = None  # the mesh init() installed
        self.kv_inits = 0  # inits through the launcher's KV store
        # the run's telemetry and diagnosis services (runtime/services.py)
        self.ledger = None
        self.flight_recorder = None
        self.timeline = None
        self.metrics_server = None
        # the native host core (_core) of the classic adapters, the stall
        # inspector and the eviction handler
        self.controller = None
        self.core_starts = 0  # keys of the controller's port (services)
        self.stall_inspector = None
        self.preempt_handler = None


_state = _State()
_TIMEOUT = datetime.timedelta(seconds=300)


def _resolve_device(device, cfg):
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "horovod_tpu_torch.init(): CUDA is not available; pass "
                "device='cpu' to run on the CPU")
        return torch.device("cuda", cfg.local_rank)
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", cfg.local_rank)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


def _store(cfg):
    if cfg.size == 1:
        return dist.HashStore()
    if not cfg.rendezvous_addr or not cfg.rendezvous_port:
        raise RuntimeError(
            "a multi-process job needs a rendezvous address: set "
            "HOROVOD_GLOO_RENDEZVOUS_ADDR/PORT or MASTER_ADDR/MASTER_PORT")
    if cfg.kv_store:
        return _kv_store(cfg)
    return dist.TCPStore(cfg.rendezvous_addr, cfg.rendezvous_port,
                         world_size=cfg.size, is_master=cfg.rank == 0,
                         timeout=_TIMEOUT)


def _own_addr(peer):
    """This host's address on the route to ``peer`` (no packet is sent)."""
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.connect((peer, 9))
        return s.getsockname()[0]


def _kv_store(cfg):
    """The TCP store of a job under the launcher, found through its HTTP
    key-value store: rank 0 binds a free port and publishes it under this
    init's key, the others wait for it. The key carries the elastic epoch
    and the count of this process's inits, so a later init never reads
    an earlier one's address."""
    from horovod_tpu_torch.run import rendezvous
    _state.kv_inits += 1
    key = (f"torch_store/{os.environ.get('HOROVOD_ELASTIC_EPOCH', '0')}/"
           f"{_state.kv_inits}")
    addr, port = cfg.rendezvous_addr, cfg.rendezvous_port
    if cfg.rank == 0:
        host = _own_addr(addr)
        store = dist.TCPStore(host, 0, world_size=cfg.size, is_master=True,
                              timeout=_TIMEOUT, wait_for_workers=False)
        rendezvous.kv_put(addr, port, key, f"{host}:{store.port}".encode())
        return store
    value = rendezvous.kv_wait(addr, port, key,
                               timeout=_TIMEOUT.total_seconds())
    host, store_port = value.decode().rsplit(":", 1)
    return dist.TCPStore(host, int(store_port), world_size=cfg.size,
                         is_master=False, timeout=_TIMEOUT)


def _hosts_tile_world(cfg, dev):
    """Whether the world is ``cross_size`` hosts of ``local_size`` ranks
    each, the layout of the ``(dcn, data)`` mesh. Building that mesh is
    collective, so every rank must decide alike, and over hosts of
    unequal rank counts they see different values: the launcher gives
    each rank the number of hosts that have its local rank
    (``run/allocation.py``). One all-reduce of both values and their
    negations under MAX makes the decision the job's."""
    if cfg.size == 1:
        return False
    seen = torch.tensor([cfg.cross_size, -cfg.cross_size, cfg.local_size,
                         -cfg.local_size], dtype=torch.int64, device=dev)
    dist.all_reduce(seen, op=dist.ReduceOp.MAX)
    cross_max, cross_min, local_max, local_min = seen.tolist()
    return (cross_max == -cross_min > 1 and local_max == -local_min
            and cross_max * local_max == cfg.size)


def init(device=None, num_slices=None):
    """Initialize (idempotent). ``device`` is ``None`` for this process's
    card (raises when CUDA is absent), ``"cpu"``, or an explicit device.
    ``num_slices`` fixes the mesh's ``("dcn", "data")`` split, as the JAX
    ``init(num_slices=)`` does: ``(num_slices, size // num_slices)`` ranks
    (one axis ``("data",)`` for 1), refused before the rendezvous when it
    does not divide the world; None takes it from the job's hosts, below.
    Joins the world through ``cluster.procmesh.ensure_distributed`` and
    installs the mesh of ``parallel/mesh.py``, as the JAX ``init()`` does
    (``basics.py:97-106``):

    * under one process mesh across rows (``HOROVOD_COORDINATOR_ADDR``
      and ``HOROVOD_SPMD_PROCS`` N > 1: hvdrun's ``--spmd-procs``), the
      ``("dcn", "data")`` mesh of N rows of ``size // N`` ranks
      (``procmesh.build_process_mesh``, after its contiguity check);
    * otherwise ``("data",)`` over the world, or ``("dcn", "data")`` of
      ``(cross_size, local_size)`` when the job spans
      ``HOROVOD_CROSS_SIZE > 1`` hosts of equal rank counts. Over hosts
      of unequal rank counts the mesh stays 1-D and the job runs flat
      (there the JAX ``build_mesh`` raises, or builds a mesh that does
      not follow the hosts).

    Before the rendezvous it starts the run's host services
    (``runtime/services.py``): a fresh goodput ledger, the flight
    recorder, the host timeline and the metrics server, each as its
    ``HOROVOD_*`` variable asks. The native host core (``_core.py``) of
    the classic adapters starts at their first collective
    (``native_core``), not here."""
    with _lock:
        if _state.initialized:
            return
        cfg = Config.from_env()
        if num_slices is not None and cfg.size % num_slices:
            raise ValueError(f"device count {cfg.size} not divisible by "
                             f"num_slices {num_slices}")
        dev = _resolve_device(device, cfg)
        _state.config = cfg
        try:
            # the ledger, the flight recorder (armed before the
            # rendezvous it should explain), the timeline and the metrics
            # server
            services.start(_state)
            _join(cfg, dev, num_slices)
        except BaseException:
            # a retried init() starts the services afresh
            services.stop(_state, reason="init_failed")
            _state.config = None
            raise
        _state.initialized = True


def _join(cfg, dev, num_slices=None):
    """The rendezvous and the mesh of ``init()``."""
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    procmesh.ensure_distributed(cfg, backend=backend,
                                store=lambda: _store(cfg))
    _state.mesh = mesh_lib.Mesh(group=dist.group.WORLD, device=dev,
                                size=cfg.size, rank=cfg.rank)
    mesh_lib.set_mesh(_state.mesh)
    procs = cfg.spmd_procs or cfg.size
    if procmesh.coordinator_spec(cfg) is not None and \
            num_slices in (None, procs):
        procmesh.build_process_mesh(procmesh.row_owners(
            cfg.size, procs, cfg.spmd_local_devices))
    elif num_slices is not None:
        if num_slices > 1:
            mesh_lib.build_mesh(num_slices=num_slices)
    elif _hosts_tile_world(cfg, dev):
        mesh_lib.build_mesh(num_slices=cfg.cross_size)
    _state.init_mesh = mesh_lib.get_mesh()


def invalidate_meshes():
    """Drop the meshes built over the world after ``init()``
    (``parallel.mesh.build_mesh``) and install ``init()``'s again: the
    elastic reset's counterpart of the JAX package's
    ``collective.invalidate_proc_mesh()``. A re-rendezvous may change
    the world, and a mesh (with its process groups) built over the old
    one must not carry the next collective; the reset callbacks rebuild
    the steps over the installed mesh. A no-op before ``init()``."""
    with _lock:
        if _state.initialized and _state.init_mesh is not None:
            mesh_lib.set_mesh(_state.init_mesh)


def shutdown():
    """Destroy the process group and stop the run's services (the
    goodput dump, the server, the native core, the timeline, the
    recorder's final dump); a later ``init()`` starts afresh."""
    with _lock:
        if not _state.initialized:
            return
        services.stop(_state)
        installed = mesh_lib.get_mesh()
        dist.destroy_process_group()
        procmesh.leave()
        _state.mesh.release()
        installed.release()  # a mesh build_mesh installed over this world
        mesh_lib.set_mesh(None)
        _state.initialized = False
        _state.mesh = None
        _state.init_mesh = None
        _state.config = None


def is_initialized():
    return _state.initialized


def native_core():
    """The running native host core (``_core.py``) of the classic
    adapters (``torch/``, ``tensorflow/``, ``mxnet/``), started here at
    their first collective, which every rank makes: in a multi-process
    job under the launcher the job's core (``services.start_core``), in
    a one-rank job a core of size 1. ``shutdown()`` stops it. Raises
    before ``init()``, and in a job of more ranks that the launcher did
    not give a controller: a core of one rank there would return each
    rank's own tensor as the job's.

    The JAX package starts its core in ``init()``; the port starts it at
    first use, since its own collectives never use it (``_core.py``):
    a job that does not call a classic adapter builds and runs no core.
    As at the JAX ``init()``, every rank's first collective must come
    within the core's 120 s wait for its peers."""
    from horovod_tpu_torch import _core
    with _core_lock:
        if not _state.initialized:
            raise RuntimeError(
                "horovod_tpu_torch has not been initialized; call hvd.init()")
        if _core.is_initialized():
            return _core
        cfg = _state.config
        if cfg.size == 1:
            _core.init(rank=0, size=1)
            _state.controller = _core
        elif cfg.controller_addr:
            services.start_core(_state, cfg)
        else:
            raise RuntimeError(
                f"this job of {cfg.size} ranks runs no native core: "
                "launch it under hvdrun-torch (python -m "
                "horovod_tpu_torch.run), which names the core's controller "
                "(HOROVOD_CONTROLLER_ADDR)")
        return _core


def _cfg():
    if not _state.initialized:
        raise RuntimeError("horovod_tpu_torch has not been initialized; "
                           "call horovod_tpu_torch.init()")
    return _state.config


def rank():
    """Rank of this process among all launched processes."""
    return _cfg().rank


def size():
    """Number of launched processes."""
    return _cfg().size


def local_rank():
    return _cfg().local_rank


def local_size():
    return _cfg().local_size


def cross_rank():
    return _cfg().cross_rank


def cross_size():
    return _cfg().cross_size


def device():
    """The device this process computes on."""
    _cfg()
    return _state.mesh.device


def num_devices():
    """Ranks in the installed mesh: the data plane's world (one card a
    rank)."""
    _cfg()
    return mesh_lib.get_mesh().size


def mesh():
    """The installed mesh (``parallel/mesh.py``): ``init()``'s, or the
    last ``build_mesh``."""
    _cfg()
    return mesh_lib.get_mesh()


def data_axes():
    """The mesh axes gradients are reduced over, e.g. ``("data",)`` or
    ``("dcn", "data")``."""
    return mesh_lib.data_axis_names(mesh())


# Horovod's build probes, answered from torch.distributed: the backends
# this torch can run. The port joins its world over NCCL or gloo, never
# MPI, oneCCL or DDL.
def nccl_built():
    return dist.is_nccl_available()


def gloo_built():
    return dist.is_gloo_available()


def mpi_built():
    return dist.is_mpi_available()


def mpi_enabled():
    return False


def mpi_threads_supported():
    return False


def ccl_built():
    return False


def ddl_built():
    return False


def fusion_threshold():
    return _cfg().fusion_threshold


def wire_dtype():
    return _cfg().wire_dtype
