"""The classic MXNet adapter over the native host core: the port of
``horovod_tpu/mxnet/__init__.py`` (reference:
``horovod/mxnet/__init__.py:40-153``).

The Horovod MXNet contract over the native core's host data plane:
``DistributedOptimizer`` allreduces gradients inside ``update()``,
``DistributedTrainer`` (gluon) allreduces in ``_allreduce_grads``,
``broadcast_parameters`` syncs initial state from root.

The module import-gates on ``mxnet``: everything works when mxnet is
installed, and the adapter logic is tested against a numpy-backed
stand-in (``tests/fake_mxnet.py``).
"""

try:
    import mxnet as mx
except ImportError as e:  # pragma: no cover - mxnet absent in this image
    raise ImportError(
        "horovod_tpu_torch.mxnet requires mxnet, which is not installed. "
        "On the card, prefer the port's own API (import horovod_tpu_torch "
        "as hvd): its collectives run over NCCL.") from e

from horovod_tpu_torch.basics import (cross_rank, cross_size, init,
                                      is_initialized, local_rank,
                                      local_size, mpi_threads_supported,
                                      rank, shutdown, size)
from horovod_tpu_torch.mxnet.mpi_ops import (Adasum, Average, Max, Min, Sum,
                                             allgather, allgather_async,
                                             allreduce, allreduce_,
                                             allreduce_async,
                                             allreduce_async_, broadcast,
                                             broadcast_, broadcast_async,
                                             broadcast_async_)

__all__ = [
    "init", "shutdown", "is_initialized", "rank", "size", "local_rank",
    "local_size", "cross_rank", "cross_size", "mpi_threads_supported",
    "Sum", "Average", "Adasum", "Min", "Max",
    "allreduce", "allreduce_", "allreduce_async", "allreduce_async_",
    "allgather", "allgather_async", "broadcast", "broadcast_",
    "broadcast_async", "broadcast_async_",
    "DistributedOptimizer", "DistributedTrainer", "broadcast_parameters",
]


class DistributedOptimizer(mx.optimizer.Optimizer):
    """Wraps an ``mx.optimizer.Optimizer``: every ``update`` first
    averages the gradient across ranks (reference
    ``mxnet/__init__.py:40-77``)."""

    def __init__(self, optimizer):
        self._optimizer = optimizer

    def __getattr__(self, item):
        return getattr(self._optimizer, item)

    def _do_allreduce(self, index, grad):
        if size() == 1:
            return
        if isinstance(index, (tuple, list)):
            for i in range(len(index)):
                allreduce_(grad[i], average=True,
                           name=f"gradient.{index[i]}")
        else:
            allreduce_(grad, average=True, name=f"gradient.{index}")

    def update(self, index, weight, grad, state):
        self._do_allreduce(index, grad)
        self._optimizer.update(index, weight, grad, state)

    def update_multi_precision(self, index, weight, grad, state):
        self._do_allreduce(index, grad)
        self._optimizer.update_multi_precision(index, weight, grad, state)

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def set_lr_mult(self, args_lr_mult):
        self._optimizer.set_lr_mult(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self._optimizer.set_wd_mult(args_wd_mult)

    def create_state(self, index, weight):
        return self._optimizer.create_state(index, weight)

    def create_state_multi_precision(self, index, weight):
        return self._optimizer.create_state_multi_precision(index, weight)


def _make_distributed_trainer():
    """gluon Trainer subclass, defined lazily so environments exposing
    only the symbolic API still import."""
    if not hasattr(mx, "gluon"):
        return None

    class DistributedTrainer(mx.gluon.Trainer):
        """gluon Trainer whose gradient aggregation is a cross-rank
        allreduce (reference ``mxnet/__init__.py:85-108``)."""

        def __init__(self, params, optimizer, optimizer_params=None):
            if isinstance(optimizer, DistributedOptimizer):
                optimizer = optimizer._optimizer
            super().__init__(params, optimizer,
                             optimizer_params=optimizer_params,
                             kvstore=None)
            # Horovod contract: scale_ divides by local batch only; the
            # allreduce averages across ranks
            self._scale /= size()

        def _allreduce_grads(self):
            if size() == 1:
                return
            for i, param in enumerate(self._params):
                if param.grad_req != "null":
                    allreduce_(param.list_grad()[0], average=False,
                               name=f"gradient.{i}")

    return DistributedTrainer


DistributedTrainer = _make_distributed_trainer()


def _append_broadcast_init(param, root_rank, name):
    """Arm a deferred-init gluon parameter so that the moment the engine
    materializes it (first forward shapes it and calls ``_init_impl``),
    its freshly initialized value is broadcast from ``root_rank`` —
    without this, each rank keeps its own random init and the model
    silently diverges (reference ``mxnet/__init__.py:118-153``)."""
    import types as _types

    init_impl = param._init_impl  # bound method of this parameter

    def wrapped_init_impl(self, *args, **kwargs):
        init_impl(*args, **kwargs)
        broadcast_(self.data(), root_rank, name=f"bp.deferred.{name}")
        data = self.data()
        if hasattr(data, "wait_to_read"):
            # block until the broadcast write-back lands before the
            # engine's first use of the parameter
            data.wait_to_read()

    param._init_impl = _types.MethodType(wrapped_init_impl, param)


def broadcast_parameters(params, root_rank=0):
    """Sync model parameters from root at startup (reference
    ``mxnet/__init__.py:118-153``). Accepts a plain ``dict`` of NDArrays
    or a gluon ``ParameterDict``. Deferred-init parameters (shape not
    known yet) are armed to broadcast at materialization via
    ``_append_broadcast_init``."""
    deferred_exc = getattr(getattr(mx.gluon, "parameter", mx.gluon),
                           "DeferredInitializationError", None)
    tensors = []
    if isinstance(params, dict):
        tensors = sorted(params.items())
    elif hasattr(params, "items"):  # gluon ParameterDict
        for name, p in sorted(params.items()):
            if deferred_exc is not None:
                try:
                    tensors.append((name, p.data()))
                except deferred_exc:
                    _append_broadcast_init(p, root_rank, name)
            else:
                tensors.append((name, p.data()))
    else:
        raise ValueError("invalid params type: " + str(type(params)))
    handles = [broadcast_async_(t, root_rank, name=f"bp.{name}")
               for name, t in tensors]
    for h in handles:
        h.synchronize()
