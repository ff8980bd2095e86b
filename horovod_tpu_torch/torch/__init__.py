"""The classic PyTorch adapter over the native host core: the port of
``horovod_tpu/torch/__init__.py`` (Horovod's ``horovod/torch/__init__.py``).

Horovod's torch contract: ``hvd.init()`` (the port's ``basics.init``;
``init(device="cpu")`` where there is no card), ``DistributedOptimizer``
whose gradient-ready hooks fire asynchronous allreduces that ``step()``
synchronizes, and ``broadcast_parameters`` /
``broadcast_optimizer_state`` at startup, over the core's TCP ring
collectives (``_core.py``). It takes CPU tensors, and tensors on the
card, which it stages through pinned host memory (``mpi_ops.py``). Run
it under ``hvdrun-torch -np N``, which names the core's controller; the
core starts at the first collective (``basics.native_core``). The
port's own ``DistributedOptimizer`` (``horovod_tpu_torch.hvd_torch``)
reduces over NCCL and is the main path on the card.
"""

import torch

from horovod_tpu_torch.basics import (cross_rank, cross_size, init,
                                      is_initialized, local_rank,
                                      local_size, mpi_threads_supported,
                                      rank, shutdown, size)
from horovod_tpu_torch.torch.compression import Compression
from horovod_tpu_torch.torch.mpi_ops import (Adasum, Average, Max, Min, Sum,
                                             allgather, allgather_async,
                                             allreduce, allreduce_,
                                             allreduce_async,
                                             allreduce_async_, alltoall,
                                             broadcast, broadcast_,
                                             broadcast_async,
                                             broadcast_async_,
                                             broadcast_object, join, poll,
                                             synchronize)

__all__ = [
    "init", "shutdown", "is_initialized", "rank", "size", "local_rank",
    "local_size", "cross_rank", "cross_size", "mpi_threads_supported",
    "Sum", "Average", "Adasum", "Min", "Max", "Compression",
    "allreduce", "allreduce_", "allreduce_async", "allreduce_async_",
    "allgather", "allgather_async", "broadcast", "broadcast_",
    "broadcast_async", "broadcast_async_", "broadcast_object", "alltoall",
    "join", "poll", "synchronize", "DistributedOptimizer",
    "broadcast_parameters", "broadcast_optimizer_state",
]


class _DistributedOptimizer(torch.optim.Optimizer):
    """Wraps a torch optimizer: gradient-ready hooks fire async allreduces,
    ``step()`` synchronizes them all, then runs the inner step (reference
    ``horovod/torch/__init__.py:57-212``).

    ``backward_passes_per_step=N`` follows the reference contract: grads
    accumulate locally over N backwards and the allreduce averages the
    accumulated SUM across ranks — no division by N (scale the learning
    rate if you want a micro-batch mean). The port's own
    ``DistributedOptimizer`` (``hvd_torch.py``) averages over micro-steps
    instead, as the JAX package's ``optax.MultiSteps`` path does.
    """

    def __init__(self, optimizer, named_parameters=None, compression=None,
                 backward_passes_per_step=1, op=Average):
        self._inner = optimizer
        self._compression = compression or Compression.none
        self._passes = backward_passes_per_step
        self._op = op
        self._handles = {}
        self._hook_registered = []

        if named_parameters is not None:
            named = list(named_parameters)
        else:
            named = []
            for gi, group in enumerate(optimizer.param_groups):
                for pi, p in enumerate(group["params"]):
                    named.append((f"allreduce.noname.{gi}.{pi}", p))
        dups = {n for n in [x for x, _ in named]
                if [x for x, _ in named].count(n) > 1}
        if dups:
            raise ValueError(f"duplicate parameter names: {sorted(dups)}")
        self._named = named
        self._name_of = {p: n for n, p in named}
        self._requires_update = {p for _, p in named if p.requires_grad}
        # per-param countdown: the hook fires the allreduce on the Nth
        # backward (reference torch/__init__.py:118-135 _allreduce_delay)
        self._delay = {p: self._passes for p in self._requires_update}
        self._register_hooks()

    # -- torch.optim.Optimizer surface delegates to the inner optimizer --
    @property
    def param_groups(self):
        return self._inner.param_groups

    @property
    def state(self):
        return self._inner.state

    def state_dict(self):
        return self._inner.state_dict()

    def load_state_dict(self, sd):
        return self._inner.load_state_dict(sd)

    def zero_grad(self, set_to_none=True):
        if self._handles:
            raise AssertionError(
                "optimizer.zero_grad() was called after loss.backward() but "
                "before optimizer.step() or optimizer.synchronize(); this "
                "would discard gradients with allreduces still in flight")
        return self._inner.zero_grad(set_to_none=set_to_none)

    def _register_hooks(self):
        for name, p in self._named:
            if not p.requires_grad:
                continue
            self._hook_registered.append(
                p.register_post_accumulate_grad_hook(self._make_hook(name)))

    def _fire_allreduce(self, p):
        wire, ctx = self._compression.compress(p.grad)
        from horovod_tpu_torch.torch import mpi_ops
        h = mpi_ops.allreduce_async(wire, name=self._name_of[p], op=self._op)
        return h, ctx

    def _make_hook(self, name):
        def hook(p):
            if p in self._handles and self._handles[p][0] is not None:
                raise AssertionError(
                    f"gradient for {name!r} was computed more than "
                    f"backward_passes_per_step={self._passes} times before "
                    "step()/synchronize(); call synchronize() between "
                    "extra backward passes")
            self._delay[p] -= 1
            handle, ctx = None, None
            if self._delay[p] == 0:
                handle, ctx = self._fire_allreduce(p)
            self._handles[p] = (handle, ctx)
        return hook

    def synchronize(self):
        # params whose countdown has not elapsed, or whose hook never
        # fired this step, are allreduced now so step() never consumes
        # unreduced gradients (reference torch/__init__.py:155-173)
        for p, (h, ctx) in list(self._handles.items()):
            if h is None:
                self._handles[p] = self._fire_allreduce(p)
        for p in self._requires_update - set(self._handles):
            if p.grad is not None:
                self._handles[p] = self._fire_allreduce(p)
        for p, (h, ctx) in self._handles.items():
            out = h.synchronize()
            self._delay[p] = self._passes
            p.grad.copy_(self._compression.decompress(out, ctx))
        self._handles.clear()

    def step(self, closure=None):
        # Always synchronize and run the inner step, like the reference:
        # gradient accumulation is expressed by the per-param delay
        # counters, not by skipping optimizer steps.
        self.synchronize()
        return self._inner.step(closure)


def DistributedOptimizer(optimizer, named_parameters=None, compression=None,
                         backward_passes_per_step=1, op=Average):
    return _DistributedOptimizer(
        optimizer, named_parameters=named_parameters,
        compression=compression,
        backward_passes_per_step=backward_passes_per_step, op=op)


def broadcast_parameters(params, root_rank=0):
    """Sync model state from root at startup (reference
    ``torch/__init__.py:440-470``). Accepts a ``state_dict()`` or an
    iterable of ``(name, tensor)``."""
    if isinstance(params, dict):
        items = sorted(params.items())
    else:
        items = list(params)
    handles = []
    from horovod_tpu_torch.torch import mpi_ops
    for name, t in items:
        if not torch.is_tensor(t):
            continue
        handles.append(mpi_ops.broadcast_async_(t.data, root_rank,
                                                name=f"bp.{name}"))
    for h in handles:
        h.synchronize()


def broadcast_optimizer_state(optimizer, root_rank=0):
    """Broadcast optimizer state dict from root
    (``torch/__init__.py:472-560``): tensors ride the data plane,
    non-tensor scalars ride broadcast_object."""
    if isinstance(optimizer, _DistributedOptimizer):
        optimizer = optimizer._inner
    sd = optimizer.state_dict()
    # Root drives the whole broadcast set: non-root ranks may have EMPTY
    # state (fresh process restoring from a rank-0 checkpoint), so the
    # list of (pid, key, shape, dtype) comes from root and missing
    # tensors are materialized locally before the tensor broadcasts —
    # otherwise ranks would enqueue mismatched sets and negotiation
    # would stall (reference torch/__init__.py:472-560 initializes
    # state on all ranks before broadcasting).
    meta = {
        "param_groups": sd["param_groups"],
        "scalars": {
            (pid, k): v
            for pid, st in sd["state"].items() for k, v in st.items()
            if not torch.is_tensor(v)
        },
        "tensors": [
            (pid, k, list(v.shape), str(v.dtype))
            for pid, st in sd["state"].items() for k, v in st.items()
            if torch.is_tensor(v)
        ],
    }
    meta = broadcast_object(meta, root_rank, name="bos.meta")
    sd["param_groups"] = meta["param_groups"]
    # Root's state set is authoritative: local entries root does not have
    # (e.g. this rank warmed momentum root never had) must not survive,
    # or ranks would step with divergent state after the "sync".
    root_keys = ({(pid, k) for (pid, k) in meta["scalars"]} |
                 {(pid, k) for pid, k, _, _ in meta["tensors"]})
    for pid, st in list(sd["state"].items()):
        for k in list(st):
            if (pid, k) not in root_keys:
                del st[k]
        if not st:
            del sd["state"][pid]
    for (pid, k), v in meta["scalars"].items():
        sd["state"].setdefault(pid, {})[k] = v
    tensors = []
    for pid, k, shape, dtype_s in meta["tensors"]:
        st = sd["state"].setdefault(pid, {})
        t = st.get(k)
        dtype = getattr(torch, dtype_s.replace("torch.", ""))
        if (not torch.is_tensor(t) or list(t.shape) != shape
                or t.dtype != dtype):
            t = torch.zeros(shape, dtype=dtype)
            st[k] = t
        tensors.append((f"bos.{pid}.{k}", t))
    broadcast_parameters(tensors, root_rank)
    optimizer.load_state_dict(sd)
