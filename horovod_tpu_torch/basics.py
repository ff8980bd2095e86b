"""Process-level lifecycle and identity: init / shutdown / rank / size.

The port of ``horovod_tpu/basics.py``. ``init()`` reads the launcher's
env contract (``HOROVOD_RANK/SIZE/LOCAL_RANK/...``), picks this process's
device and joins the world process group that carries the data plane:

* on the card (the default): ``cuda:<local_rank>`` and NCCL;
* with ``device="cpu"``: the CPU and gloo (the tests run so).

A single-process job rendezvous through an in-process store, so it binds
no port; a multi-process job through a TCP store at the rendezvous
address of the env (``HOROVOD_GLOO_RENDEZVOUS_ADDR/PORT`` or
``MASTER_ADDR/PORT``).
"""

import datetime
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


_state = _State()


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
    return dist.TCPStore(cfg.rendezvous_addr, cfg.rendezvous_port,
                         world_size=cfg.size, is_master=cfg.rank == 0,
                         timeout=datetime.timedelta(seconds=300))


def init(device=None):
    """Initialize (idempotent). ``device`` is ``None`` for this process's
    card (raises when CUDA is absent), ``"cpu"``, or an explicit device."""
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
        _state.config = cfg
        _state.initialized = True


def shutdown():
    """Destroy the process group; a later ``init()`` starts afresh."""
    with _lock:
        if not _state.initialized:
            return
        dist.destroy_process_group()
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


def fusion_threshold():
    return _cfg().fusion_threshold


def wire_dtype():
    return _cfg().wire_dtype
