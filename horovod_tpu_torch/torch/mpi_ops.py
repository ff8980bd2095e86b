"""Handle-based collective ops on torch tensors over the native host core:
the port of ``horovod_tpu/torch/mpi_ops.py`` (Horovod's
``horovod/torch/mpi_ops.py``: ``allreduce_async``/``_``,
``allgather_async``, ``broadcast_async``/``_``, ``alltoall``, ``poll``,
``synchronize``).

``*_async`` returns a handle at once; the core's background thread
negotiates the tensor by name and runs the ring collective, and
``synchronize`` blocks and returns the result. The ``_`` variants write
the result back into their input.

A CPU tensor goes to the core as the JAX adapter's does: zero-copy for a
contiguous tensor in the in-place variants. A tensor on the card is
staged through host memory, as Horovod's torch ops reduce a GPU tensor
without GPU collectives: a synchronous copy into a pinned host buffer
(the copy has finished before the core reads the buffer), which the core
then borrows in place for allreduce and broadcast and which the borrow
registry keeps alive until the handle completes; the result returns to
the tensor's device (into the tensor itself for the ``_`` variants).
bfloat16 has no host dtype in the core and raises.
"""

import numpy as np
import torch

from horovod_tpu_torch import _core, basics
from horovod_tpu_torch.ops.reduction import Adasum, Average, Max, Min, Sum

_name_counter = {}


def _auto_name(kind, name):
    if name is not None:
        return name
    n = _name_counter.get(kind, 0)
    _name_counter[kind] = n + 1
    return f"{kind}.noname.{n}"


def _grad_name(name):
    """The backward collective's name, derived from the forward op's, so
    that a mismatch across ranks stalls on one named tensor."""
    return f"{name}.grad" if name is not None else None


class TorchHandle:
    """A core handle and what its result goes to: a new tensor on
    ``device`` (``None``: the CPU), ``out_tensor`` (copied into), or
    ``inplace_tensor``, where the core's in-place result already is (on
    the CPU). ``staged`` is the pinned host buffer a card tensor was
    copied into and the core worked in, in place: the result goes from
    it to the card. ``postprocess``, when given, maps the new result
    before it is returned or copied into ``out_tensor``."""

    def __init__(self, core_handle, out_tensor=None, inplace_tensor=None,
                 device=None, staged=None, postprocess=None):
        self._h = core_handle
        self._out = out_tensor
        self._inplace = inplace_tensor
        self._device = device
        self._staged = staged
        self._post = postprocess

    def poll(self):
        return self._h.poll()

    def synchronize(self):
        arr = self._h.wait()
        if self._inplace is not None:
            if self._staged is not None:
                self._inplace.copy_(self._staged)
            return self._inplace
        if self._staged is not None:
            t = self._staged.to(self._device)
        elif self._device is not None:
            t = torch.from_numpy(arr).to(self._device)
        else:
            t = torch.from_numpy(np.array(arr))
        if self._post is not None:
            t = self._post(t)
        if self._out is not None:
            if self._out.shape != t.shape:
                self._out.resize_(t.shape)
            self._out.copy_(t)
            return self._out
        return t


def _lent(t):
    """The numpy view of ``t``'s own memory that the core borrows in
    place: at least one dimension, since the core's contiguity check
    (``np.ascontiguousarray``) copies a 0-d array (an optimizer's
    ``step`` counter, say)."""
    return (t.view(1) if t.dim() == 0 else t).numpy()


def _stage(tensor):
    """``(array, device, staged)``: the host array the core reads, the
    card the result returns to (``None`` on the CPU) and the pinned host
    buffer a card tensor was copied into (``None`` on the CPU)."""
    basics.native_core()
    if tensor.dtype == torch.bfloat16:
        raise TypeError("the native core has no bfloat16 host dtype; cast "
                        "the tensor to float32 or float16 first")
    t = tensor.detach()
    if t.device.type == "cpu":
        return t.contiguous().numpy(), None, None
    if t.device.type != "cuda":
        raise ValueError(f"the torch adapter takes CPU and CUDA tensors, "
                         f"not {t.device}")
    staged = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    staged.copy_(t)  # synchronous: done before the core reads it
    return staged.numpy(), t.device, staged


def _enqueue(fn, tensor, name, borrow_on_card=False, **kw):
    """Enqueue ``tensor`` through ``fn`` (a ``_core.*_async``); a card
    tensor's staging buffer is lent to the core in place where ``fn``
    writes its result there (allreduce, broadcast)."""
    arr, device, staged = _stage(tensor)
    if staged is None or not borrow_on_card:
        return TorchHandle(fn(arr, name, **kw), device=device)
    return TorchHandle(fn(_lent(staged), name, inplace=True, **kw),
                       device=device, staged=staged)


def allreduce_async(tensor, average=True, name=None, op=None,
                    prescale_factor=1.0, postscale_factor=1.0):
    op = op or (Average if average else Sum)
    return _enqueue(_core.allreduce_async, tensor,
                    _auto_name("allreduce", name), borrow_on_card=True,
                    op=op, prescale=prescale_factor,
                    postscale=postscale_factor)


# ---- differentiable collectives (Horovod's torch/mpi_ops.py:158-385:
# the autograd Functions let a user backprop through an hvd op) ----------

class HorovodAllreduce(torch.autograd.Function):
    """The gradient of an allreduce is an allreduce of the gradient with
    the same op and scale factors (both are linear)."""

    @staticmethod
    def forward(ctx, tensor, average, name, op, prescale, postscale):
        ctx.average = average
        ctx.op = op
        ctx.name = name
        ctx.prescale = prescale
        ctx.postscale = postscale
        return allreduce_async(tensor, average, name, op,
                               prescale_factor=prescale,
                               postscale_factor=postscale).synchronize()

    @staticmethod
    def backward(ctx, grad_output):
        grad = HorovodAllreduce.apply(grad_output, ctx.average,
                                      _grad_name(ctx.name), ctx.op,
                                      ctx.prescale, ctx.postscale)
        return grad, None, None, None, None, None


class HorovodAllgather(torch.autograd.Function):
    """The backward sums the cotangent across ranks, and each rank takes
    the rows it contributed. The row counts are gathered in the forward
    (``{name}.dims``) and kept, so the backward adds no round trip;
    ``requires_grad`` must agree across ranks."""

    @staticmethod
    def forward(ctx, tensor, name):
        ctx.name = name
        dname = f"{name}.dims" if name is not None else None
        ctx.dims = allgather_async(
            torch.tensor([tensor.shape[0]]),
            name=dname).synchronize().tolist()
        return allgather_async(tensor, name).synchronize()

    @staticmethod
    def backward(ctx, grad_output):
        grad_reduced = allreduce_async(
            grad_output, average=False,
            name=_grad_name(ctx.name)).synchronize()
        r = _core.rank()
        start = int(sum(ctx.dims[:r]))
        return grad_reduced[start:start + ctx.dims[r]], None


class HorovodBroadcast(torch.autograd.Function):
    """The backward sums the cotangents onto the root; the other ranks
    get zero."""

    @staticmethod
    def forward(ctx, tensor, root_rank, name):
        ctx.root_rank = root_rank
        ctx.name = name
        return broadcast_async(tensor, root_rank, name).synchronize()

    @staticmethod
    def backward(ctx, grad_output):
        grad_reduced = allreduce_async(
            grad_output, average=False,
            name=_grad_name(ctx.name)).synchronize()
        if _core.rank() != ctx.root_rank:
            grad_reduced = grad_reduced * 0
        return grad_reduced, None, None


def allreduce(tensor, average=True, name=None, op=None, compression=None,
              prescale_factor=1.0, postscale_factor=1.0):
    from horovod_tpu_torch.torch.compression import Compression
    compression = compression or Compression.none
    wire, ctx = compression.compress(tensor)
    if wire.requires_grad:
        out = HorovodAllreduce.apply(wire, average,
                                     _auto_name("allreduce", name),
                                     op or (Average if average else Sum),
                                     prescale_factor, postscale_factor)
    else:
        out = allreduce_async(wire, average=average, name=name, op=op,
                              prescale_factor=prescale_factor,
                              postscale_factor=postscale_factor
                              ).synchronize()
    return compression.decompress(out, ctx)


def _inplace(fn, tensor, name, **kw):
    """An in-place op: a card tensor lends the core its pinned staging
    buffer, a contiguous CPU tensor its own memory (zero-copy), and any
    other tensor is reduced from a copy and copied back."""
    arr, _, staged = _stage(tensor)
    if staged is not None:
        return TorchHandle(fn(_lent(staged), name, inplace=True, **kw),
                           inplace_tensor=tensor, staged=staged)
    if tensor.is_contiguous():
        return TorchHandle(fn(_lent(tensor.detach()), name, inplace=True,
                              **kw), inplace_tensor=tensor)
    return TorchHandle(fn(arr, name, **kw), out_tensor=tensor)


def allreduce_async_(tensor, average=True, name=None, op=None,
                     prescale_factor=1.0, postscale_factor=1.0):
    """In place: the result is written back into ``tensor``."""
    return _inplace(_core.allreduce_async, tensor,
                    _auto_name("allreduce", name),
                    op=op or (Average if average else Sum),
                    prescale=prescale_factor, postscale=postscale_factor)


def allreduce_(tensor, average=True, name=None, op=None, **kw):
    return allreduce_async_(tensor, average=average, name=name, op=op,
                            **kw).synchronize()


def allgather_async(tensor, name=None):
    return _enqueue(_core.allgather_async, tensor,
                    _auto_name("allgather", name))


def allgather(tensor, name=None):
    if tensor.requires_grad:
        return HorovodAllgather.apply(tensor, _auto_name("allgather", name))
    return allgather_async(tensor, name).synchronize()


def broadcast_async(tensor, root_rank, name=None):
    return _enqueue(_core.broadcast_async, tensor,
                    _auto_name("broadcast", name), borrow_on_card=True,
                    root_rank=root_rank)


def broadcast(tensor, root_rank, name=None):
    if tensor.requires_grad:
        return HorovodBroadcast.apply(tensor, root_rank,
                                      _auto_name("broadcast", name))
    return broadcast_async(tensor, root_rank, name).synchronize()


def broadcast_async_(tensor, root_rank, name=None):
    """In-place broadcast; a contiguous CPU tensor goes zero-copy, which
    is what makes ``broadcast_parameters`` of a large model copy
    nothing on the CPU."""
    return _inplace(_core.broadcast_async, tensor,
                    _auto_name("broadcast", name), root_rank=root_rank)


def broadcast_(tensor, root_rank, name=None):
    return broadcast_async_(tensor, root_rank, name).synchronize()


def alltoall(tensor, name=None):
    return _enqueue(_core.alltoall_async, tensor,
                    _auto_name("alltoall", name)).synchronize()


def join(device=-1):
    """Announce that this rank's data is exhausted; blocks until every
    rank has joined and returns the rank that joined last. ``device`` is
    Horovod's signature's; the host plane stages no zero buffers."""
    del device
    return basics.native_core().join()


def poll(handle):
    return handle.poll()


def synchronize(handle):
    return handle.synchronize()


def broadcast_object(obj, root_rank=0, name=None):
    """Broadcast a picklable object: its length, then its bytes."""
    import pickle
    name = _auto_name("bcast_object", name)
    payload = pickle.dumps(obj)
    n = torch.tensor([len(payload)], dtype=torch.int64)
    n = broadcast(n, root_rank, name=f"{name}.len")
    buf = torch.zeros(int(n.item()), dtype=torch.uint8)
    if len(payload) == int(n.item()):
        buf[:] = torch.from_numpy(
            np.frombuffer(payload, dtype=np.uint8).copy())
    buf = broadcast(buf, root_rank, name=f"{name}.data")
    return pickle.loads(buf.numpy().tobytes())
