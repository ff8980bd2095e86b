"""Keras-on-TF helpers: the port of ``horovod_tpu/tensorflow/keras.py``
(reference: ``horovod/keras/__init__.py``).

``DistributedOptimizer`` wraps a keras optimizer so its gradients are
allreduced before the update (reference ``_impl.create_distributed_
optimizer``, ``horovod/_keras/__init__.py:23-55``), and ``load_model``
restores a saved model while transparently re-wrapping whatever
optimizer it was trained with (reference ``keras/__init__.py:117-150``)
— that is what makes rank-0-restore + broadcast resume work for Keras
models, since the optimizer slot weights come back with the model.

Keras 3 removed ``get_gradients`` from optimizers; the update hook is
``apply(grads, trainable_variables)`` (``apply_gradients`` delegates to
it, and ``model.fit``'s traced train step calls ``apply_gradients``), so
on Keras 3 the distributed subclass overrides ``apply``. Legacy Keras 2
optimizers (and the test fake) still expose ``get_gradients``, which is
overridden when present. Wrapping mutates the optimizer's class in
place (``__class__`` swap to a dynamic subclass) instead of rebuilding
it via ``from_config``, so slot variables and iteration counters of an
already-live optimizer survive wrapping.

The gradient allreduce itself rides ``horovod_tpu_torch.tensorflow.allreduce``
which is graph-capable on real TF (``tf.numpy_function`` +
``tf.custom_gradient``), so wrapped optimizers work inside the
``tf.function``-compiled ``model.fit`` path.
"""

import tensorflow as tf

from horovod_tpu_torch.ops.reduction import Average
# allgather/allreduce/broadcast/broadcast_global_variables are re-exported
# here the way the reference's keras namespace does (keras/__init__.py),
# so pure-Keras scripts never import horovod.tensorflow directly
from horovod_tpu_torch.tensorflow import (  # noqa: F401
    Compression, _allreduce_grads, allgather, allreduce, broadcast,
    broadcast_global_variables, size)

from horovod_tpu_torch.tensorflow import callbacks  # noqa: F401  (re-export)


def _make_distributed_class(cls, op=Average, compression=Compression.none,
                            sparse_as_dense=False, name=None):
    """Build a ``Distributed<Opt>`` subclass of ``cls`` whose gradient
    hook allreduces before delegating. Also used as the deserialization
    target in ``load_model`` (a real class, so Keras 3's
    ``deserialize_keras_object`` can call ``from_config`` on it)."""
    prefix = name or f"Distributed{cls.__name__}"
    ns = {"_hvd_wrapped": cls}

    def _reduce(grads):
        return _allreduce_grads(list(grads), op, compression,
                                sparse_as_dense, prefix)

    if hasattr(cls, "apply"):  # Keras 3
        def apply(self, grads, trainable_variables=None):
            if size() <= 1:
                return super(dist_cls, self).apply(grads,
                                                   trainable_variables)
            return super(dist_cls, self).apply(_reduce(grads),
                                               trainable_variables)
        ns["apply"] = apply

    if hasattr(cls, "get_gradients"):  # Keras 2 / legacy
        def get_gradients(self, loss, params):
            grads = super(dist_cls, self).get_gradients(loss, params)
            if size() <= 1:
                return grads
            return _reduce(grads)
        ns["get_gradients"] = get_gradients

    dist_cls = type(prefix, (cls,), ns)
    return dist_cls


def DistributedOptimizer(optimizer, name=None, op=Average,
                         compression=Compression.none,
                         sparse_as_dense=False):
    """Wrap a keras optimizer in place: its class becomes a dynamic
    ``Distributed*`` subclass whose update hook allreduces gradients.
    All existing state (slot variables, iterations) is preserved —
    unlike a ``from_config`` rebuild, this is safe on an optimizer that
    has already taken steps."""
    if getattr(type(optimizer), "_hvd_wrapped", None) is not None:
        return optimizer  # already wrapped
    optimizer.__class__ = _make_distributed_class(
        type(optimizer), op=op, compression=compression,
        sparse_as_dense=sparse_as_dense, name=name)
    return optimizer


def load_model(filepath, custom_optimizers=None, custom_objects=None,
               compression=Compression.none):
    """``tf.keras.models.load_model`` with every known optimizer class
    mapped to its Distributed subclass (reference
    ``keras/__init__.py:146-150`` ``wrap_optimizer``). Both the bare
    name (``SGD``) and the wrapped name (``DistributedSGD``) resolve, so
    models saved before or after wrapping round-trip."""
    objects = {}

    def add(cls):
        dist = _make_distributed_class(cls, compression=compression)
        objects[cls.__name__] = dist
        objects[dist.__name__] = dist

    opt_mod = tf.keras.optimizers
    for attr in dir(opt_mod):
        cls = getattr(opt_mod, attr)
        if isinstance(cls, type) and not attr.startswith("_"):
            add(cls)
    for cls in (custom_optimizers or []):
        add(cls)
    objects.update(custom_objects or {})
    return tf.keras.models.load_model(filepath, custom_objects=objects)
