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

from horovod_tpu_torch.config import Config
from horovod_tpu_torch.parallel import mesh as mesh_lib

_lock = threading.Lock()


class _State:
    def __init__(self):
        self.initialized = False
        self.config = None
        self.mesh = None
        self.kv_inits = 0  # inits through the launcher's KV store


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


def init(device=None):
    """Initialize (idempotent). ``device`` is ``None`` for this process's
    card (raises when CUDA is absent), ``"cpu"``, or an explicit device.
    Installs the mesh of ``parallel/mesh.py``: ``("data",)`` over the
    world, or ``("dcn", "data")`` of ``(cross_size, local_size)`` when
    the job spans ``HOROVOD_CROSS_SIZE > 1`` hosts of equal rank counts,
    as the JAX ``init()`` does. Over hosts of unequal rank counts the
    mesh stays 1-D and the job runs flat (there the JAX ``build_mesh``
    raises, or builds a mesh that does not follow the hosts)."""
    with _lock:
        if _state.initialized:
            return
        cfg = Config.from_env()
        dev = _resolve_device(device, cfg)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        backend = "nccl" if dev.type == "cuda" else "gloo"
        dist.init_process_group(backend, store=_store(cfg), rank=cfg.rank,
                                world_size=cfg.size)
        _state.mesh = mesh_lib.Mesh(group=dist.group.WORLD, device=dev,
                                    size=cfg.size, rank=cfg.rank)
        mesh_lib.set_mesh(_state.mesh)
        if _hosts_tile_world(cfg, dev):
            mesh_lib.build_mesh(num_slices=cfg.cross_size)
        _state.config = cfg
        _state.initialized = True


def shutdown():
    """Destroy the process group; a later ``init()`` starts afresh."""
    with _lock:
        if not _state.initialized:
            return
        installed = mesh_lib.get_mesh()
        dist.destroy_process_group()
        _state.mesh.release()
        installed.release()  # a mesh build_mesh installed over this world
        mesh_lib.set_mesh(None)
        _state.initialized = False
        _state.mesh = None
        _state.config = None


def is_initialized():
    return _state.initialized


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
