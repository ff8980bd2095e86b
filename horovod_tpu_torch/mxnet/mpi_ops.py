"""Handle-based collective ops on MXNet NDArrays: the port of
``horovod_tpu/mxnet/mpi_ops.py``, over the port's ``_core``.

Rebuilds ``horovod/mxnet/mpi_ops.py`` + the engine-async push of
``mxnet/mpi_ops.cc:121-141`` over the native core: NDArrays bridge
through numpy into the name-negotiated queue; ``*_async`` returns a
handle backed by the core's background thread (our analogue of MXNet's
engine var-dependency callback), ``synchronize`` blocks and writes the
result back.

The adapter package import-gates on ``mxnet``; its logic is tested
against a numpy-backed stand-in (``tests/fake_mxnet.py``).
"""

import numpy as np

from horovod_tpu_torch import _core, basics
from horovod_tpu_torch.ops.reduction import Adasum, Average, Max, Min, Sum

_name_counter = {}


def _auto_name(kind, name):
    if name is not None:
        return name
    n = _name_counter.get(kind, 0)
    _name_counter[kind] = n + 1
    return f"{kind}.noname.{n}"


def _to_numpy(tensor):
    if hasattr(tensor, "asnumpy"):
        return np.ascontiguousarray(tensor.asnumpy())
    return np.ascontiguousarray(tensor)


def _write_back(tensor, arr):
    tensor[:] = arr


class MXHandle:
    """Wraps a core handle; optionally writes the result into an NDArray
    (reference: the engine callback completing the pushed op)."""

    def __init__(self, core_handle, out_tensor=None, make_output=None):
        self._h = core_handle
        self._out = out_tensor
        self._make_output = make_output

    def poll(self):
        return self._h.poll()

    def synchronize(self):
        arr = self._h.wait()
        if self._out is not None:
            _write_back(self._out, arr)
            return self._out
        if self._make_output is not None:
            return self._make_output(arr)
        return arr


def allreduce_async(tensor, average=True, name=None, op=None,
                    prescale_factor=1.0, postscale_factor=1.0):
    basics.native_core()
    op = op or (Average if average else Sum)
    arr = _to_numpy(tensor)
    h = _core.allreduce_async(arr, _auto_name("allreduce", name), op=op,
                              prescale=prescale_factor,
                              postscale=postscale_factor)
    return MXHandle(h, out_tensor=None,
                    make_output=lambda a: _like(tensor, a))


def allreduce_async_(tensor, average=True, name=None, op=None, **kw):
    basics.native_core()
    op = op or (Average if average else Sum)
    arr = _to_numpy(tensor)
    h = _core.allreduce_async(arr, _auto_name("allreduce", name), op=op,
                              **_scales(kw))
    return MXHandle(h, out_tensor=tensor)


def allreduce(tensor, average=True, name=None, op=None, **kw):
    return allreduce_async(tensor, average, name, op, **kw).synchronize()


def allreduce_(tensor, average=True, name=None, op=None, **kw):
    return allreduce_async_(tensor, average, name, op, **kw).synchronize()


def allgather_async(tensor, name=None):
    basics.native_core()
    arr = _to_numpy(tensor)
    h = _core.allgather_async(arr, _auto_name("allgather", name))
    return MXHandle(h, make_output=lambda a: _like(tensor, a))


def allgather(tensor, name=None):
    return allgather_async(tensor, name).synchronize()


def broadcast_async(tensor, root_rank, name=None):
    basics.native_core()
    arr = _to_numpy(tensor)
    h = _core.broadcast_async(arr, _auto_name("broadcast", name),
                              root_rank=root_rank)
    return MXHandle(h, make_output=lambda a: _like(tensor, a))


def broadcast_async_(tensor, root_rank, name=None):
    basics.native_core()
    arr = _to_numpy(tensor)
    h = _core.broadcast_async(arr, _auto_name("broadcast", name),
                              root_rank=root_rank)
    return MXHandle(h, out_tensor=tensor)


def broadcast(tensor, root_rank, name=None):
    return broadcast_async(tensor, root_rank, name).synchronize()


def broadcast_(tensor, root_rank, name=None):
    return broadcast_async_(tensor, root_rank, name).synchronize()


def _like(tensor, arr):
    """Build an output container matching `tensor`'s type (NDArray in,
    NDArray out), falling back to the numpy array."""
    if hasattr(tensor, "asnumpy"):
        try:
            import mxnet as mx
            return mx.nd.array(arr, dtype=arr.dtype)
        except ImportError:
            pass
        cls = type(tensor)
        if hasattr(cls, "from_numpy"):
            return cls.from_numpy(arr)
    return arr


def _scales(kw):
    return {"prescale": kw.get("prescale_factor", 1.0),
            "postscale": kw.get("postscale_factor", 1.0)}
