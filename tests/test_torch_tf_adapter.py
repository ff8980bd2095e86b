"""The port's classic TensorFlow adapter (horovod_tpu_torch/tensorflow/)
against the JAX package's (horovod_tpu/tensorflow/), each on 2 ranks of
its own launcher's ``run()`` over the numpy-backed stand-in
``fake_tensorflow.py``, with the same seeded inputs: the collectives
(fp16 wire included), the IndexedSlices allgather, ``DistributedOptimizer``
(dense and ``sparse_as_dense``), ``DistributedGradientTape``,
``broadcast_variables``, the callbacks (startup broadcast, metric
average, the learning-rate warmup at world 2) and ``keras``'s optimizer
wrapping and ``load_model``: the two adapters' results equal, value for
value. The spawns run side by side. One case runs the port's adapter on
a real TensorFlow, gated as ``test_tf_real.py`` is."""

import importlib.machinery
import os
import sys

import numpy as np
import pytest

import adapter_pair


def _body(package, init_kw):
    """One rank's checks of ``package``'s TF adapter; plain values."""
    import importlib
    import tempfile

    import numpy as np

    import fake_tensorflow
    tf = fake_tensorflow.install()
    hvd = importlib.import_module(f"{package}.tensorflow")
    cb = importlib.import_module(f"{package}.tensorflow.callbacks")
    keras = importlib.import_module(f"{package}.tensorflow.keras")
    hvd.init(**init_kw)
    r = hvd.rank()
    out = {"size": hvd.size()}

    def val(t):
        return np.asarray(t.numpy() if hasattr(t, "numpy") else t).tolist()

    x = tf.convert_to_tensor(np.random.default_rng(10 + r).standard_normal(
        (3, 4)).astype(np.float32))
    out["ar.avg"] = val(hvd.allreduce(x, name="ar.avg"))
    out["ar.sum"] = val(hvd.allreduce(x, op=hvd.Sum, name="ar.sum"))
    out["ar.max"] = val(hvd.allreduce(x, op=hvd.Max, name="ar.max"))
    out["ar.fp16"] = val(hvd.allreduce(x, name="ar.fp16",
                                       compression=hvd.Compression.fp16))
    out["ag"] = val(hvd.allgather(tf.convert_to_tensor(
        np.full((r + 1, 2), r + 0.5, np.float32)), name="ag"))
    out["bc"] = val(hvd.broadcast(x, root_rank=1, name="bc"))
    s = hvd.allreduce(tf.IndexedSlices(
        np.full((1, 2), r + 1.0, np.float32), np.array([r]),
        dense_shape=(4, 2)), op=hvd.Average, name="slices")
    out["slices"] = [val(s.values), val(s.indices)]
    v = tf.Variable(np.ones(4, np.float32))
    inner = tf.train.Optimizer(lr=0.1)
    inner._test_grads = [tf.convert_to_tensor(
        np.full(4, r + 1.0, np.float32))]
    hvd.DistributedOptimizer(inner).minimize(None, var_list=[v])
    out["opt"] = val(v)
    v = tf.Variable(np.zeros((2, 2), np.float32))
    inner = tf.train.Optimizer(lr=1.0)
    inner._test_grads = [tf.IndexedSlices(
        np.full((1, 2), r + 1.0, np.float32), np.array([r]),
        dense_shape=(2, 2))]
    hvd.DistributedOptimizer(inner, sparse_as_dense=True,
                             name="dense").minimize(None, var_list=[v])
    out["sparse_as_dense"] = val(v)
    tape = hvd.DistributedGradientTape(tf.GradientTape(grads=[
        tf.convert_to_tensor(np.full(2, 4.0 * (r + 1), np.float32))]))
    with tape:
        pass
    out["tape"] = [val(g) for g in tape.gradient(None, [v])]
    v = tf.Variable(np.full(3, r + 1.0, np.float32))
    hvd.broadcast_variables([v], root_rank=1)
    out["bv"] = val(v)

    class Model:
        def __init__(self, optimizer, variables=()):
            self.optimizer = optimizer
            self.variables = list(variables)

    v = tf.Variable(np.full(2, 3.0 + r, np.float32))
    c = cb.BroadcastGlobalVariablesCallback(0)
    c.set_model(Model(tf.train.Optimizer(lr=0.2), [v]))
    c.on_train_batch_end(0)
    c.on_train_batch_end(1)  # once only
    out["callback.bcast"] = val(v)
    logs = {"loss": 2.0 + r, "acc": 0.25 * r, "name": "kept"}
    cb.MetricAverageCallback().on_epoch_end(0, logs)
    out["callback.metrics"] = logs
    opt = tf.train.Optimizer(lr=0.2)
    c = cb.LearningRateWarmupCallback(warmup_epochs=2, steps_per_epoch=2)
    c.set_model(Model(opt))
    c.on_train_begin()
    lrs = []
    for epoch in range(3):
        c.on_epoch_begin(epoch)
        for b in range(2):
            c.on_batch_begin(b)
            lrs.append(opt.lr)
            c.on_batch_end(b)
    out["callback.warmup"] = lrs
    wrapped = keras.DistributedOptimizer(tf.keras.optimizers.SGD(lr=0.5))
    out["keras.class"] = type(wrapped).__name__
    path = os.path.join(tempfile.mkdtemp(), "model.bin")
    tf.keras.models.save_model(tf.keras.Model(
        {"w": np.full(3, r + 1.0, np.float32)},
        tf.keras.optimizers.SGD(lr=0.25)), path)
    loaded = keras.load_model(path)
    out["keras.load"] = [type(loaded.optimizer).__name__,
                         loaded.optimizer.get_config(),
                         val(loaded.weights["w"])]
    hvd.shutdown()
    return out


def _adapters_agree(ranks):
    jax, port = ranks
    assert [o["size"] for o in port] == [2, 2]
    assert port == jax


def _results_hold_against_numpy(ranks):
    _, port = ranks
    xs = [np.random.default_rng(10 + r).standard_normal((3, 4)).astype(
        np.float32) for r in range(2)]
    for r, out in enumerate(port):
        assert out["ar.sum"] == (xs[0] + xs[1]).tolist()
        assert out["ar.avg"] == ((xs[0] + xs[1]) * np.float32(0.5)).tolist()
        assert out["ar.max"] == np.maximum(*xs).tolist()
        assert out["bc"] == xs[1].tolist()
        assert out["ag"] == [[0.5, 0.5], [1.5, 1.5], [1.5, 1.5]]
        assert out["slices"] == [[[0.5, 0.5], [1.0, 1.0]], [0, 1]]
        np.testing.assert_allclose(out["opt"], np.full(4, 0.85), rtol=1e-6)
        assert out["sparse_as_dense"] == [[-0.5, -0.5], [-1.0, -1.0]]
        assert out["tape"] == [[6.0, 6.0]]
        assert out["bv"] == [2.0, 2.0, 2.0]
        assert out["callback.bcast"] == [3.0, 3.0]
        assert out["callback.metrics"] == {"loss": 2.5, "acc": 0.125,
                                           "name": "kept"}
        # the ramp from lr / size to lr over the 2 warmup epochs
        assert out["callback.warmup"][0] < out["callback.warmup"][3] \
            < 0.2 + 1e-9
        assert out["keras.class"] == "DistributedSGD"
        assert out["keras.load"] == ["DistributedSGD", {"lr": 0.25},
                                     [r + 1.0] * 3]


def test_adapters_on_two_ranks():
    """Both adapters' 2 ranks, spawned side by side once, held by every
    check above."""
    ranks = adapter_pair.run_both(sys.modules[__name__], _body)
    _adapters_agree(ranks)
    _results_hold_against_numpy(ranks)


def test_public_names_equal_the_jax_adapter():
    import fake_tensorflow
    fake_tensorflow.install()
    import horovod_tpu.tensorflow as jax_adapter

    import horovod_tpu_torch.tensorflow as port_adapter
    assert port_adapter.__all__ == jax_adapter.__all__
    for name in port_adapter.__all__:
        assert hasattr(port_adapter, name), name


def _tf_available():
    # PathFinder bypasses sys.modules, so the fake installed above is not
    # taken for a real installation
    try:
        return importlib.machinery.PathFinder.find_spec(
            "tensorflow") is not None
    except (ImportError, ValueError):
        return False


@pytest.mark.skipif(not _tf_available(), reason="tensorflow not installed")
def test_real_tensorflow_graph_allreduce_on_two_ranks():
    """On a real TensorFlow the port's adapter routes through
    ``tf.numpy_function`` inside ``tf.function`` and differentiates."""
    def fn():
        import numpy as np
        import tensorflow as tf

        import horovod_tpu_torch.tensorflow as hvd
        hvd.init(device="cpu")
        x = tf.Variable(np.full(3, hvd.rank() + 1.0, np.float32))

        @tf.function
        def step():
            with tf.GradientTape() as tape:
                y = tf.reduce_sum(hvd.allreduce(x * 2.0, name="g"))
            return y, tape.gradient(y, x)

        y, g = step()
        hvd.shutdown()
        return float(y), g.numpy().tolist()

    from horovod_tpu_torch.run import api
    for y, g in api.run(fn, np=2):
        assert y == 9.0 and g == [2.0, 2.0, 2.0]
