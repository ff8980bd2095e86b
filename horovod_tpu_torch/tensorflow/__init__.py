"""The classic TensorFlow adapter over the native host core: the port of
``horovod_tpu/tensorflow/__init__.py`` (Horovod's
``horovod/tensorflow/__init__.py``), the same code over the port's
``_core`` and ``basics``. It imports ``tensorflow`` and ``torch`` (the
port's ``basics``), never ``jax``.

Eager-mode TF2 + TF1-style optimizer wrapping over the native core's host
data plane, mirroring the torch adapter: tensors bridge through numpy
into the name-negotiated queue (reference role: the custom
``HorovodAllreduceOp`` kernels, ``tensorflow/mpi_ops.cc:287-460``).

Covered contracts:

* ``allreduce`` with the **IndexedSlices → two-allgathers** fallback
  (reference ``__init__.py:43-118``: sparse gradients allgather values
  and indices instead of reducing dense zeros),
* fp16 wire compression on the dense path (reference Compression),
* **graph mode with registered gradients**: on a real TF, the dense
  collectives route through ``tf.numpy_function`` wrapped in
  ``tf.custom_gradient``, so they work inside ``tf.function`` (Keras 3
  traces ``model.fit``'s train step) and are differentiable — the role
  of the reference's ``AsyncOpKernel`` + gradient registrations
  (``tensorflow/mpi_ops.cc:287-460``, ``mpi_ops.py``):
  grad(allreduce) = allreduce(grad); grad(allgather) = allreduce(grad)
  sliced to the local rows; grad(broadcast) = summed grad on root,
  zeros elsewhere,
* ``DistributedOptimizer`` overriding ``compute_gradients`` (reference
  ``__init__.py:266-311``) with ``sparse_as_dense`` option,
* ``DistributedGradientTape`` for TF2 eager (``__init__.py:475-531``),
* ``broadcast_variables`` / ``broadcast_global_variables``
  (``__init__.py:139-188``),
* ``horovod_tpu.tensorflow.keras.load_model`` wrapping saved optimizers
  in DistributedOptimizer (reference ``keras/__init__.py:117-150``).

The adapter runs against real TF (eager, ``tf.function``, Keras 3
``model.fit``) when tensorflow is importable, and against the
numpy-backed stand-in of the tests (``tests/fake_tensorflow.py``)
otherwise.
"""

try:
    import tensorflow as tf
except ImportError as e:  # pragma: no cover - TF absent in this image
    raise ImportError(
        "horovod_tpu_torch.tensorflow requires tensorflow, which is not "
        "installed. On the card, prefer the port's own API (import "
        "horovod_tpu_torch as hvd): its collectives run over NCCL.") from e

import numpy as np

from horovod_tpu_torch import basics
from horovod_tpu_torch.basics import (cross_rank, cross_size, init,
                                      is_initialized, local_rank,
                                      local_size, rank, shutdown, size)
from horovod_tpu_torch.ops.reduction import Adasum, Average, Max, Min, Sum

__all__ = [
    "init", "shutdown", "is_initialized", "rank", "size", "local_rank",
    "local_size", "cross_rank", "cross_size",
    "Sum", "Average", "Adasum", "Min", "Max", "Compression",
    "allreduce", "allgather", "broadcast", "broadcast_variables",
    "broadcast_global_variables", "BroadcastGlobalVariablesHook",
    "DistributedGradientTape",
    "DistributedOptimizer",
]


class Compression:
    """fp16 wire compression (reference ``tensorflow/compression.py``)."""

    class none:
        @staticmethod
        def compress(arr):
            return arr, arr.dtype

        @staticmethod
        def decompress(arr, dtype):
            return arr

    class fp16:
        @staticmethod
        def compress(arr):
            if arr.dtype in (np.float32, np.float64):
                return arr.astype(np.float16), arr.dtype
            return arr, arr.dtype

        @staticmethod
        def decompress(arr, dtype):
            return arr.astype(dtype) if arr.dtype != dtype else arr


_counters = {}


def _auto_name(kind, name):
    if name is not None:
        return name
    n = _counters.get(kind, 0)
    _counters[kind] = n + 1
    return f"tf.{kind}.{n}"


def _to_numpy(tensor):
    if hasattr(tensor, "numpy"):
        return np.asarray(tensor.numpy())
    return np.asarray(tensor)


# Real TF exposes the three pieces the graph bridge needs; the test fake
# does not, and falls back to the plain eager numpy path below.
_GRAPH_OK = all(hasattr(tf, a) for a in
                ("numpy_function", "custom_gradient", "executing_eagerly"))


def _bridge(host_fn, x, out_shape, *extra):
    """Run ``host_fn(np.ndarray, ...) -> np.ndarray`` on ``x`` (plus any
    ``extra`` tensors) in either execution mode: direct in eager, via
    ``tf.numpy_function`` under ``tf.function`` (the host data plane is
    CPU-side either way, exactly like the reference's AsyncOpKernel
    handing the tensor to the background loop)."""
    if tf.executing_eagerly():
        return tf.convert_to_tensor(host_fn(
            np.asarray(x.numpy()),
            *(np.asarray(e.numpy()) for e in extra)))
    y = tf.numpy_function(host_fn, [x, *extra], x.dtype)
    y.set_shape(out_shape)
    return y


def _graph_allreduce(tensor, name, op, compression):
    """Differentiable allreduce (reference ``_allreduce_grad``,
    ``tensorflow/mpi_ops.py``: the gradient of an allreduce is an
    allreduce of the gradient with the same op)."""
    core = basics.native_core()

    def _host(arr, wire_name):
        arr = np.asarray(arr)
        c, dt = compression.compress(arr)
        out = core.allreduce(c, wire_name, op=op)
        # the host core flattens 0-d tensors to (1,); restore the shape
        return np.asarray(compression.decompress(np.asarray(out), dt),
                          dtype=arr.dtype).reshape(arr.shape)

    @tf.custom_gradient
    def _fn(x):
        y = _bridge(lambda a: _host(a, name), x, x.shape)

        def grad(dy):
            return _bridge(lambda a: _host(a, name + ".grad"), dy,
                           dy.shape)
        return y, grad

    return _fn(tf.convert_to_tensor(tensor))


def _graph_allgather(tensor, name):
    """Differentiable allgather. Backward is the reference's
    ``HorovodAllgatherGrad``: allreduce-sum the gathered-output gradient,
    then slice out the rows this rank contributed."""
    core = basics.native_core()

    def _host_fwd(arr):
        return np.asarray(core.allgather(np.asarray(arr), name))

    def _host_grad(dy, xshape):
        # shape metadata comes from the input's dynamic shape flowing
        # through THIS execution (a tiny int vector passed as a second
        # op input), never from trace-time closure state — concurrent
        # invocations of one traced function each see their own shapes,
        # and the full forward activation is never retained for it
        dy = np.asarray(dy)
        xshape = tuple(int(d) for d in np.asarray(xshape))
        nrows = xshape[0] if xshape else 1
        sizes = np.asarray(core.allgather(
            np.array([nrows], np.int64), name + ".grad.nrows"))
        g = np.asarray(core.allreduce(dy, name + ".grad", op=Sum))
        offset = int(sizes[:rank()].sum())
        return np.ascontiguousarray(
            g[offset:offset + nrows]).reshape(xshape)

    @tf.custom_gradient
    def _fn(x):
        y = _bridge(_host_fwd, x, [None] + list(x.shape[1:]))

        def grad(dy):
            return _bridge(_host_grad, dy, x.shape, tf.shape(x))
        return y, grad

    return _fn(tf.convert_to_tensor(tensor))


def _graph_broadcast(tensor, name, root_rank):
    """Differentiable broadcast: every rank allreduce-sums the upstream
    gradient, the root keeps it, the others zero it (reference
    ``_broadcast_grad``)."""
    core = basics.native_core()

    def _host_fwd(arr):
        arr = np.asarray(arr)
        out = np.asarray(core.broadcast(arr, name, root_rank=root_rank))
        return out.reshape(arr.shape)  # 0-d safety, as in allreduce

    def _host_grad(dy):
        dy = np.asarray(dy)
        g = np.asarray(core.allreduce(dy, name + ".grad",
                                      op=Sum)).reshape(dy.shape)
        return g if rank() == root_rank else np.zeros_like(g)

    @tf.custom_gradient
    def _fn(x):
        y = _bridge(_host_fwd, x, x.shape)

        def grad(dy):
            return _bridge(_host_grad, dy, dy.shape)
        return y, grad

    return _fn(tf.convert_to_tensor(tensor))


def allreduce(tensor, average=None, name=None, op=None,
              compression=Compression.none):
    """Allreduce a tf.Tensor — or allgather an ``tf.IndexedSlices``
    (sparse gradients reduce as gathered (values, indices) pairs, the
    reference's bandwidth answer for embeddings,
    ``tensorflow/__init__.py:74-89``)."""
    if op is None:
        op = Average if (average is None or average) else Sum
    if isinstance(tensor, tf.IndexedSlices):
        if op not in (Sum, Average):
            # the gathered (values, indices) pairs ARE the sum/average of
            # the represented tensor; no other reduction holds
            raise NotImplementedError(
                f"{op} does not support sparse tensors; pass "
                "sparse_as_dense=True to DistributedOptimizer")
        # distinct wire names per component: one tensor name must map to
        # one (shape, dtype) stream or the response cache re-negotiates
        # every step (cxx/src/response_cache.cc:9-14)
        values = allgather(tensor.values,
                           name=None if name is None else name + ".values")
        indices = allgather(tensor.indices,
                            name=None if name is None else name + ".indices")
        if op == Average:
            values = values / float(size())
        return tf.IndexedSlices(values, indices,
                                dense_shape=tensor.dense_shape)
    wire = _auto_name("allreduce", name)
    if _GRAPH_OK:
        return _graph_allreduce(tensor, wire, op, compression)
    core = basics.native_core()
    arr = _to_numpy(tensor)
    compressed, dtype = compression.compress(arr)
    out = core.allreduce(compressed, wire, op=op)
    return tf.convert_to_tensor(compression.decompress(np.asarray(out),
                                                       dtype))


def allgather(tensor, name=None):
    wire = _auto_name("allgather", name)
    if _GRAPH_OK:
        return _graph_allgather(tensor, wire)
    core = basics.native_core()
    out = core.allgather(_to_numpy(tensor), wire)
    return tf.convert_to_tensor(np.asarray(out))


def broadcast(tensor, root_rank=0, name=None):
    wire = _auto_name("broadcast", name)
    if _GRAPH_OK:
        return _graph_broadcast(tensor, wire, root_rank)
    core = basics.native_core()
    out = core.broadcast(_to_numpy(tensor), wire, root_rank=root_rank)
    return tf.convert_to_tensor(np.asarray(out))


def broadcast_variables(variables, root_rank=0):
    """Assign every variable rank ``root_rank``'s value (reference
    ``broadcast_variables``, ``tensorflow/__init__.py:139``)."""
    # convert_to_tensor (not v.value()) so Keras-3 variables — where
    # .value is a property, not a method — work alongside tf.Variable
    for i, v in enumerate(variables):
        v.assign(broadcast(tf.convert_to_tensor(v), root_rank,
                           name=f"bv.{i}"))


def broadcast_global_variables(root_rank=0):
    """TF1-compat alias over every trainable variable TF tracks
    (reference ``tensorflow/__init__.py:157-170``); in TF2 eager there
    is no global collection, so this requires an explicit registry."""
    coll = getattr(tf.compat.v1, "global_variables", None) \
        if hasattr(tf, "compat") else None
    variables = coll() if coll is not None else []
    if not variables:
        # TF2 eager populates no global collections — a silent no-op here
        # would leave ranks unsynchronized, which is worse than an error
        raise NotImplementedError(
            "broadcast_global_variables needs TF1 global collections "
            "(none found); in TF2 call "
            "broadcast_variables(model.variables) instead")
    broadcast_variables(variables, root_rank)


_SessionRunHook = object
if hasattr(tf, "compat") and hasattr(tf.compat.v1, "train"):
    _SessionRunHook = tf.compat.v1.train.SessionRunHook


class BroadcastGlobalVariablesHook(_SessionRunHook):
    """``tf.compat.v1`` SessionRunHook that broadcasts all global
    variables from ``root_rank`` right after session creation — the
    TF1/estimator-era startup sync (reference
    ``tensorflow/__init__.py:194-227``). Keras/TF2 flows use
    ``callbacks.BroadcastGlobalVariablesCallback`` instead.
    """

    def __init__(self, root_rank=0, device=""):
        super().__init__()
        self.root_rank = root_rank
        self.device = device
        self.bcast_op = None

    def begin(self):
        graph = tf.compat.v1.get_default_graph()
        if self.bcast_op is None or self.bcast_op.graph is not graph:
            import contextlib
            dev = tf.device(self.device) if self.device \
                else contextlib.nullcontext()
            with dev:
                assigns = [
                    tf.compat.v1.assign(
                        v, broadcast(v.read_value(), self.root_rank,
                                     name=f"bgvh.{i}"))
                    for i, v in enumerate(
                        tf.compat.v1.global_variables())]
                self.bcast_op = tf.group(*assigns)

    def after_create_session(self, session, coord):
        session.run(self.bcast_op)


def _sparse_to_dense(tensor):
    if not isinstance(tensor, tf.IndexedSlices):
        return tensor
    if _GRAPH_OK:
        # real TF scatter-adds IndexedSlices in its converter, and this
        # stays symbolic-safe inside tf.function
        return tf.convert_to_tensor(tensor)
    values = _to_numpy(tensor.values)
    indices = _to_numpy(tensor.indices).astype(np.int64)
    shape = tensor.dense_shape
    if shape is None:
        raise ValueError("sparse_as_dense needs a dense_shape")
    dense = np.zeros(tuple(int(d) for d in _to_numpy(shape)),
                     dtype=values.dtype)
    np.add.at(dense, indices, values)
    return tf.convert_to_tensor(dense)


def _allreduce_grads(grads, op, compression, sparse_as_dense, prefix):
    out = []
    for i, g in enumerate(grads):
        if g is None:
            out.append(None)
            continue
        if sparse_as_dense:
            g = _sparse_to_dense(g)
        out.append(allreduce(g, op=op, name=f"{prefix}.{i}",
                             compression=compression))
    return out


class DistributedOptimizer:
    """TF1-style optimizer wrapper: ``compute_gradients`` allreduces
    before returning (reference ``_DistributedOptimizer``,
    ``tensorflow/__init__.py:266-311``); everything else delegates."""

    def __init__(self, optimizer, name=None, op=Average,
                 compression=Compression.none, sparse_as_dense=False):
        self._optimizer = optimizer
        # deterministic default prefix: stable across steps AND ranks so
        # the response cache hits and negotiation never diverges. When
        # wrapping optimizers for several models in one job, pass a
        # distinct name= per model or their gradient names collide.
        self._name = name or f"Distributed{type(optimizer).__name__}"
        self._op = op
        self._compression = compression
        self._sparse_as_dense = sparse_as_dense

    def compute_gradients(self, *args, **kwargs):
        gradients = self._optimizer.compute_gradients(*args, **kwargs)
        if size() <= 1 or not gradients:
            return gradients
        grads, variables = zip(*gradients)
        avg = _allreduce_grads(grads, self._op, self._compression,
                               self._sparse_as_dense, self._name)
        return list(zip(avg, variables))

    def apply_gradients(self, *args, **kwargs):
        return self._optimizer.apply_gradients(*args, **kwargs)

    def minimize(self, loss, global_step=None, var_list=None, **kwargs):
        """TF1 minimize contract: split the arguments between
        compute_gradients and apply_gradients (global_step belongs to
        the latter)."""
        grads_and_vars = self.compute_gradients(loss, var_list=var_list,
                                                **kwargs)
        if global_step is None:
            return self.apply_gradients(grads_and_vars)
        return self.apply_gradients(grads_and_vars,
                                    global_step=global_step)

    def get_slot(self, *args, **kwargs):
        return self._optimizer.get_slot(*args, **kwargs)

    def get_slot_names(self, *args, **kwargs):
        return self._optimizer.get_slot_names(*args, **kwargs)

    def variables(self, *args, **kwargs):
        return self._optimizer.variables(*args, **kwargs)

    def get_config(self):
        return self._optimizer.get_config()


class DistributedGradientTape:
    """``tf.GradientTape`` wrapper whose ``gradient()`` allreduces,
    with the same sparse handling as DistributedOptimizer (reference
    ``tensorflow/__init__.py:475-531``)."""

    def __init__(self, tape, op=Average, compression=Compression.none,
                 sparse_as_dense=False, name="tape"):
        self._tape = tape
        self._op = op
        self._compression = compression
        self._sparse_as_dense = sparse_as_dense
        # stable default: the TF2 idiom re-wraps the tape every step, so
        # the prefix must repeat or the response cache misses every step
        # and rank-dependent tape counts would desynchronize names. For
        # several models in one job pass a distinct name per model.
        self._name = name

    def __enter__(self):
        self._tape.__enter__()
        return self

    def __exit__(self, *exc):
        return self._tape.__exit__(*exc)

    def watch(self, t):
        self._tape.watch(t)

    def gradient(self, target, sources, output_gradients=None):
        grads = self._tape.gradient(target, sources, output_gradients)
        if size() <= 1:
            return grads
        return _allreduce_grads(grads, self._op, self._compression,
                                self._sparse_as_dense, self._name)
