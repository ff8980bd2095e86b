"""The data-parallel "mesh" of the port: the world process group and this
process's device.

In the JAX package the data axis is a ``jax.sharding.Mesh`` axis and
collectives bind to its name. Here one process drives one device and the
data axis is the ``torch.distributed`` world group: a collective over the
data axis is a collective over that group.
"""

import dataclasses
import threading

import torch

_lock = threading.Lock()
_current = None


@dataclasses.dataclass(frozen=True)
class Mesh:
    group: object          # torch.distributed process group of the data axis
    device: torch.device   # the device this process computes on
    size: int
    rank: int


def set_mesh(mesh):
    global _current
    with _lock:
        _current = mesh


def get_mesh():
    """The mesh installed by ``horovod_tpu_torch.init()``."""
    with _lock:
        if _current is None:
            raise RuntimeError("horovod_tpu_torch has not been initialized; "
                               "call horovod_tpu_torch.init()")
        return _current
