"""The port's cluster integration and NIC discovery
(horovod_tpu_torch/run/cluster.py, discovery.py, task_exec.py) against
the JAX package's tests of the same behaviour: a job through the cluster
callback protocol on a cluster of local subprocesses, rank grouping by
host hash, the publish-then-reraise policy, the Spark backend against a
stub SparkContext, and discovery on loopback, with tasks of both
packages in one ring."""

import json
import os
import pickle
import sys
import threading

import numpy as np
import pytest

from horovod_tpu.run import discovery as jdiscovery
from horovod_tpu_torch.run import cluster, secret
from horovod_tpu_torch.run.cluster import (LocalProcessBackend, SparkBackend,
                                           run_on_cluster)
from horovod_tpu_torch.run.discovery import (DriverService, PingServer,
                                             TaskAgent, discover, host_hash,
                                             local_interfaces, probe)
from horovod_tpu_torch.run.rendezvous import KVStoreServer
from horovod_tpu_torch.run.task_exec import exec_and_publish


@pytest.fixture(autouse=True)
def _isolate_environ():
    """``cluster_task`` sets the rank's env in its process, and the stub
    SparkContext runs it in this process's threads."""
    snapshot = os.environ.copy()
    yield
    os.environ.clear()
    os.environ.update(snapshot)


def _make_train(scale):
    # a closure, so that cloudpickle ships it by value
    def train():
        import torch

        import horovod_tpu_torch as hvd
        hvd.init(device="cpu")
        x = torch.full((4,), (hvd.rank() + 1) * scale)
        out = hvd.allreduce(x, op=hvd.Average)
        result = (float(out[0]), hvd.rank(), hvd.size(), hvd.local_rank(),
                  hvd.cross_rank())
        hvd.shutdown()
        return result
    return train


def test_cluster_run_groups_ranks_by_host():
    """Indices 0 and 2 fake host A, 1 host B: ranks are contiguous per
    host with index 0 as rank 0; the port's ``init()`` finds its store
    through the run's signed key-value store and averages 1, 2, 3."""
    salts = {0: "hostA", 1: "hostB", 2: "hostA"}
    results = run_on_cluster(_make_train(1.0), num_proc=3,
                             backend=LocalProcessBackend(host_salts=salts),
                             start_timeout=120)
    by_rank = {r: (s, lr, cr) for _, r, s, lr, cr in results}
    assert by_rank == {0: (3, 0, 0), 1: (3, 1, 0), 2: (3, 0, 1)}
    np.testing.assert_allclose([v for v, *_ in results], [2.0] * 3)


def test_exec_and_publish_publishes_and_reraises_control_flow():
    published = []
    assert exec_and_publish(lambda: 41 + 1, (), {}, published.append)
    assert pickle.loads(published[-1]) == (True, 42)

    def boom():
        raise ValueError("executor boom")

    assert not exec_and_publish(boom, (), {}, published.append)
    ok, tb = pickle.loads(published[-1])
    assert not ok and "executor boom" in tb

    def interrupted():
        raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        exec_and_publish(interrupted, (), {}, published.append)
    ok, tb = pickle.loads(published[-1])
    assert not ok and "KeyboardInterrupt" in tb

    with pytest.raises(SystemExit):
        exec_and_publish(lambda: sys.exit(3), (), {}, published.append)
    ok, tb = pickle.loads(published[-1])
    assert not ok and "SystemExit" in tb


def _boom():
    raise SystemExit(3)


def test_cluster_task_control_flow_scoping(monkeypatch):
    """Control flow that was published is swallowed only under the Spark
    policy; an interrupt before anything was published propagates."""
    puts = {}

    class _StubAgent:
        def __init__(self, *a, **k):
            pass

        def register(self):
            pass

        def run_ring_probe(self, timeout=None):
            pass

        def common_interfaces(self, timeout=None):
            pass

        def shutdown(self):
            pass

    def fake_kv_wait(addr, port, key, timeout=None, auth_key=None):
        if key.startswith("cluster/assign/"):
            return b'{"HOROVOD_RANK": "0"}'
        if key == "runfunc/func":
            return pickle.dumps((_boom, (), {}))
        raise AssertionError(key)

    monkeypatch.setattr(cluster, "TaskAgent", _StubAgent)
    monkeypatch.setattr(cluster, "kv_wait", fake_kv_wait)
    monkeypatch.setattr(
        cluster, "kv_put",
        lambda addr, port, key, payload, auth_key=None:
        puts.__setitem__(key, payload))
    ctx = {"key": "00", "kv_addr": "127.0.0.1", "kv_port": 1}

    with pytest.raises(SystemExit):
        cluster.cluster_task(0, 1, ctx)
    ok, tb = pickle.loads(puts.pop("runfunc/result/0"))
    assert not ok and "SystemExit" in tb
    assert cluster.cluster_task(0, 1, ctx, reraise_control_flow=False) == 0
    ok, _ = pickle.loads(puts.pop("runfunc/result/0"))
    assert not ok

    monkeypatch.setattr(
        _StubAgent, "register",
        lambda self: (_ for _ in ()).throw(KeyboardInterrupt()))
    with pytest.raises(KeyboardInterrupt):
        cluster.cluster_task(0, 1, ctx, reraise_control_flow=False)
    assert "runfunc/result/0" not in puts


class _FakeRDD:
    """The part of a pyspark RDD that SparkBackend calls."""

    def __init__(self, sc, n):
        self._sc = sc
        self._n = n
        self._mapper = None

    def mapPartitionsWithIndex(self, f):
        self._mapper = f
        return self

    def collect(self):
        if self._sc.fail_with is not None:
            raise self._sc.fail_with
        results = [None] * self._n
        errors = []

        def part(i):
            try:
                results[i] = list(self._mapper(i, iter(())))
            except BaseException as e:  # noqa: BLE001 - raised below
                errors.append(e)

        threads = [threading.Thread(target=part, args=(i,))
                   for i in range(self._n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        return [x for r in results for x in (r or [])]


class _FakeSparkContext:
    """range / mapPartitionsWithIndex / collect / cancelAllJobs, the
    partitions on threads."""

    def __init__(self, fail_with=None):
        self.fail_with = fail_with
        self.cancelled = 0

    def range(self, start, end, numSlices=None):
        return _FakeRDD(self, end - start)

    def cancelAllJobs(self):
        self.cancelled += 1


def _spark_run(fn, backend, timeout=120):
    return run_on_cluster(fn, num_proc=2, backend=backend,
                          kv_host="127.0.0.1", kv_addr="127.0.0.1",
                          start_timeout=timeout)


def test_spark_backend_with_a_stub_context():
    """End to end through the partitions; a ``SystemExit`` in the user's
    fn reaches the driver as the published failure and does not escape a
    partition (Spark would retry it); a failed Spark job fails the run
    and surfaces through ``alive()`` and ``wait()``; ``cancel`` cancels
    every job; no active context is an error."""
    assert _spark_run(lambda: "partition-ok",
                      SparkBackend(_FakeSparkContext())) == \
        ["partition-ok"] * 2

    backend = SparkBackend(_FakeSparkContext())
    with pytest.raises(RuntimeError, match="SystemExit"):
        _spark_run(lambda: sys.exit(3), backend)
    backend.wait()
    assert backend.alive()

    sc = _FakeSparkContext(fail_with=RuntimeError("stage lost"))
    backend = SparkBackend(sc)
    with pytest.raises(RuntimeError):
        _spark_run(lambda: 0, backend, timeout=30)
    assert not backend.alive() and sc.cancelled == 1
    with pytest.raises(RuntimeError, match="stage lost"):
        backend.wait()

    with pytest.raises((RuntimeError, ImportError)):
        SparkBackend(None)


# ---- discovery on loopback -------------------------------------------------

def test_ping_server_and_probe():
    key = secret.make_secret_key()
    srv = PingServer("task-0", key, host="127.0.0.1")
    try:
        addrs = {"lo": [("127.0.0.1", srv.port)]}
        got = probe(addrs, key, "task-0", match_intf=True,
                    local_addrs=addrs, timeout=2.0)
        assert got == {"lo": [("127.0.0.1", srv.port)]}
        assert probe(addrs, key, "task-9", local_addrs=addrs,
                     timeout=2.0) == {}
        assert probe(addrs, secret.make_secret_key(), "task-0",
                     local_addrs=addrs, timeout=1.0, retries=1) == {}
        # reached through another interface than the one named: NAT
        assert probe({"fakenic": [("127.0.0.1", srv.port)]}, key, "task-0",
                     match_intf=True,
                     local_addrs={"fakenic": [("192.0.2.1", 0)]},
                     timeout=2.0) == {}
        # the JAX package's prober speaks the same frames
        assert jdiscovery.probe(addrs, key, "task-0", match_intf=True,
                                local_addrs=addrs, timeout=2.0) == got
    finally:
        srv.shutdown()


def test_local_interfaces_and_host_hash_match_jax():
    ifs = local_interfaces(port=1234)
    assert ("127.0.0.1", 1234) in ifs["lo"]
    assert ifs == jdiscovery.local_interfaces(port=1234)
    with pytest.raises(RuntimeError):
        local_interfaces(nic="does-not-exist-0")
    for salt in (None, "hostA", "hostB"):
        assert host_hash(salt) == jdiscovery.host_hash(salt)
    assert host_hash("hostA") != host_hash("hostB")


def test_discovery_ring_across_both_packages():
    """3 fake hosts on loopback, each with an ``eth0``, host 1 also with
    an ``ib0`` that its predecessor has not; tasks 0 and 2 are the
    port's, task 1 the JAX package's, the driver the port's: the ring
    elects exactly eth0 and the host hashes group the tasks."""
    key = secret.make_secret_key()
    kv = KVStoreServer(auth_key=key)
    port = kv.start()
    try:
        fakes = [{"eth0": [("127.0.0.1", 0)]},
                 {"eth0": [("127.0.0.1", 0)], "ib0": [("127.0.0.1", 0)]},
                 {"eth0": [("127.0.0.1", 0)]}]
        kinds = (TaskAgent, jdiscovery.TaskAgent, TaskAgent)
        agents = [kind(i, 3, "127.0.0.1", port, key, addresses=fakes[i],
                       host_salt="hostA" if i < 2 else "hostB")
                  for i, kind in enumerate(kinds)]
        try:
            for a in agents:
                a.register()
            driver = DriverService(3, "127.0.0.1", port, key)
            regs = driver.wait_for_registrations(timeout=20)
            assert set(regs) == {0, 1, 2}
            threads = [threading.Thread(target=a.run_ring_probe,
                                        kwargs={"timeout": 20})
                       for a in agents]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert driver.wait_for_probes(timeout=20) == ["eth0"]
            assert sorted(driver.host_hash_indices(regs).values()) == \
                [[0, 1], [2]]
            assert agents[1].common_interfaces(timeout=5) == ["eth0"]
            assert json.loads(kv.get("disc/common")) == ["eth0"]
        finally:
            for a in agents:
                a.shutdown()
    finally:
        kv.stop()


def test_discover_helper_and_dead_task():
    key = secret.make_secret_key()
    kv = KVStoreServer(auth_key=key)
    port = kv.start()
    try:
        common, groups = discover(2, "127.0.0.1", port, key,
                                  host_salts={0: "h0", 1: "h1"})
        assert "lo" in common
        assert sorted(groups.values()) == [[0], [1]]
        driver = DriverService(5, "127.0.0.1", port, key,
                               liveness=lambda: False)
        with pytest.raises(RuntimeError, match="discovery task exited"):
            driver.wait_for_registrations(timeout=30)
    finally:
        kv.stop()
