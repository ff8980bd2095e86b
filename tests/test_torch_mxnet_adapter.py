"""The port's classic MXNet adapter (horovod_tpu_torch/mxnet/) against the
JAX package's (horovod_tpu/mxnet/), each on 2 ranks of its own
launcher's ``run()`` over the numpy-backed stand-in ``fake_mxnet.py``,
with the same seeded inputs: the collectives and their in-place forms,
``DistributedOptimizer``, ``DistributedTrainer``, ``broadcast_parameters``
(a dict, and a deferred gluon parameter broadcast when it materializes):
the two adapters' results equal, value for value. The spawns run side by
side. Then the port's Spark shim: its import gate and ``run``'s
signature, equal to the JAX package's."""

import inspect
import sys

import numpy as np
import pytest

import adapter_pair


def _body(package, init_kw):
    """One rank's checks of ``package``'s MXNet adapter; plain values."""
    import importlib

    import numpy as np

    import fake_mxnet
    mx = fake_mxnet.install()
    hvd = importlib.import_module(f"{package}.mxnet")
    hvd.init(**init_kw)
    r = hvd.rank()
    out = {"size": hvd.size()}
    x = np.random.default_rng(20 + r).standard_normal((3, 2)).astype(
        np.float32)
    out["ar.avg"] = hvd.allreduce(mx.nd.array(x), name="ar.avg") \
        .asnumpy().tolist()
    out["ar.sum"] = hvd.allreduce(mx.nd.array(x), average=False,
                                  name="ar.sum").asnumpy().tolist()
    out["ar.scaled"] = hvd.allreduce(
        mx.nd.array(x), average=False, name="ar.scaled",
        prescale_factor=0.5, postscale_factor=4.0).asnumpy().tolist()
    y = mx.nd.array(x)
    hvd.allreduce_(y, name="ip.ar")
    out["ip.ar"] = y.asnumpy().tolist()
    out["ag"] = hvd.allgather(mx.nd.array(
        np.full((r + 1, 2), r + 0.5, np.float32)), name="ag") \
        .asnumpy().tolist()
    out["bc"] = hvd.broadcast(mx.nd.array(x), 1, name="bc") \
        .asnumpy().tolist()
    z = mx.nd.array(x)
    hvd.broadcast_async_(z, 1, name="ip.bc").synchronize()
    out["ip.bc"] = z.asnumpy().tolist()
    opt = hvd.DistributedOptimizer(mx.optimizer.Optimizer(0.1))
    w = mx.nd.array(np.ones(4, dtype=np.float32))
    opt.update(0, w, mx.nd.array(np.full(4, r + 1.0, np.float32)), None)
    out["opt"] = w.asnumpy().tolist()
    p = mx.gluon.Parameter("w", np.full(3, float(r), dtype=np.float32))
    hvd.broadcast_parameters({"w": p.data()}, root_rank=0)
    trainer = hvd.DistributedTrainer(
        [p], mx.optimizer.Optimizer(learning_rate=1.0))
    p.list_grad()[0][:] = np.full(3, r + 1.0, dtype=np.float32)
    trainer.step(batch_size=1)
    out["trainer"] = p.data().asnumpy().tolist()

    class ParamDict:  # gluon's ParameterDict is not a dict
        def __init__(self, **kw):
            self._p = kw

        def items(self):
            return self._p.items()

    ready = mx.gluon.Parameter("ready", np.full(2, r + 7.0, np.float32))
    deferred = mx.gluon.Parameter("emb", data=None)
    hvd.broadcast_parameters(ParamDict(ready=ready, emb=deferred),
                             root_rank=0)
    deferred._finish_deferred_init(np.full((2, 3), 10.0 + r, np.float32))
    out["deferred"] = [ready.data().asnumpy().tolist(),
                       deferred.data().asnumpy().tolist()]
    hvd.shutdown()
    return out


def _adapters_agree(ranks):
    jax, port = ranks
    assert [o["size"] for o in port] == [2, 2]
    assert port == jax


def _results_hold_against_numpy(ranks):
    _, port = ranks
    xs = [np.random.default_rng(20 + r).standard_normal((3, 2)).astype(
        np.float32) for r in range(2)]
    total = xs[0] + xs[1]
    for out in port:
        assert out["ar.sum"] == total.tolist()
        assert out["ar.avg"] == (total * np.float32(0.5)).tolist()
        assert out["ip.ar"] == out["ar.avg"]
        assert out["ar.scaled"] == ((xs[0] * np.float32(0.5) + xs[1]
                                     * np.float32(0.5)) * 4).tolist()
        assert out["ag"] == [[0.5, 0.5], [1.5, 1.5], [1.5, 1.5]]
        assert out["bc"] == out["ip.bc"] == xs[1].tolist()
        np.testing.assert_allclose(out["opt"], np.full(4, 0.85), rtol=1e-6)
        # broadcast w = 0; the summed gradient 3 scaled by 1 / size
        assert out["trainer"] == [-1.5] * 3
        assert out["deferred"] == [[7.0, 7.0], [[10.0] * 3] * 2]


def test_adapters_on_two_ranks():
    """Both adapters' 2 ranks, spawned side by side once, held by every
    check above."""
    ranks = adapter_pair.run_both(sys.modules[__name__], _body)
    _adapters_agree(ranks)
    _results_hold_against_numpy(ranks)


def test_public_names_equal_the_jax_adapter():
    import fake_mxnet
    fake_mxnet.install()
    import horovod_tpu.mxnet as jax_adapter

    import horovod_tpu_torch.mxnet as port_adapter
    assert port_adapter.__all__ == jax_adapter.__all__
    for name in port_adapter.__all__:
        assert hasattr(port_adapter, name), name


def test_spark_shim_gates_and_matches_the_jax_signature(monkeypatch):
    """``run`` imports pyspark only when called, refuses without an
    active SparkContext, and takes the JAX package's arguments."""
    import horovod_tpu.spark as jax_spark

    import horovod_tpu_torch.spark as port_spark
    from horovod_tpu_torch.run import cluster
    assert inspect.signature(port_spark.run) == \
        inspect.signature(jax_spark.run)
    assert port_spark.SparkBackend is cluster.SparkBackend
    assert port_spark.run_on_cluster is cluster.run_on_cluster
    monkeypatch.setitem(sys.modules, "pyspark", None)
    with pytest.raises(ImportError):
        port_spark.run(lambda: 0, num_proc=1)
    fake = type(sys)("pyspark")
    fake.SparkContext = type("SparkContext", (), {
        "_active_spark_context": None})
    monkeypatch.setitem(sys.modules, "pyspark", fake)
    with pytest.raises(RuntimeError, match="active SparkContext"):
        port_spark.run(lambda: 0, num_proc=1)
