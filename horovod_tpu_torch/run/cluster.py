"""Running ``fn`` on a cluster's existing executors: the port of
``horovod_tpu/run/cluster.py`` (the role of Horovod's Spark integration).

The cluster (Spark, or any scheduler) owns N placed task slots, so the
launcher cannot start processes where it likes; each cluster task calls
back instead:

1. the driver makes a per-run secret and a signed key-value store and
   puts the pickled ``fn`` there;
2. a :class:`ClusterBackend` starts ``cluster_task`` in each executor
   (Spark: one per partition; ``LocalProcessBackend``: subprocesses);
3. each task registers its NIC map and host hash and ring-probes its
   successor (``discovery.py``);
4. the driver groups the task indices by host hash, rotates so that
   index 0's host comes first, and gives each host contiguous ranks;
5. each task takes its env assignment (ranks, rendezvous, secret), runs
   ``fn`` and puts the result back; the driver returns the results in
   rank order.

Inside ``fn`` the port runs as under the launcher: ``init()`` finds its
TCP store through the same key-value store.
"""

import json
import os
import pickle
import subprocess
import sys
import threading
import time

from horovod_tpu_torch.run import allocation, launcher
from horovod_tpu_torch.run import secret as _secret
from horovod_tpu_torch.run import task_exec
from horovod_tpu_torch.run.discovery import DriverService, TaskAgent
from horovod_tpu_torch.run.rendezvous import (KVStoreServer, kv_get, kv_put,
                                              kv_wait)

try:
    import cloudpickle as _pickler
except ImportError:
    _pickler = pickle

HOST_SALT_ENV = "HOROVOD_HOSTHASH_SALT"  # tests: fake distinct hosts
TASK = "horovod_tpu_torch.run.cluster_task"


class ClusterBackend:
    """Something that starts ``num_tasks`` callbacks on a cluster.

    ``start_tasks(num_tasks, ctx)`` arranges for
    ``cluster_task(index, num_tasks, ctx)`` to run in ``num_tasks``
    processes, one per executor slot. ``ctx`` is a small JSON-safe dict
    (the store's address and port, the hex key)."""

    def start_tasks(self, num_tasks, ctx):
        raise NotImplementedError

    def alive(self):
        """False once a task died abnormally (fails the run fast)."""
        return True

    def wait(self):
        pass

    def cancel(self):
        pass


class LocalProcessBackend(ClusterBackend):
    """A cluster on this machine: each executor is a subprocess;
    ``host_salts`` makes indices look like distinct hosts to the host-hash
    grouping."""

    def __init__(self, host_salts=None, env=None):
        self._salts = host_salts or {}
        self._env = env or {}
        self._procs = []

    def start_tasks(self, num_tasks, ctx):
        for i in range(num_tasks):
            env = dict(os.environ)
            env.update(self._env)
            env[_secret.SECRET_ENV] = ctx["key"]
            if i in self._salts:
                env[HOST_SALT_ENV] = self._salts[i]
            env["PYTHONPATH"] = launcher.repo_pythonpath(env)
            self._procs.append(subprocess.Popen(
                [sys.executable, "-m", TASK, str(i), str(num_tasks),
                 ctx["kv_addr"], str(ctx["kv_port"])], env=env))

    def alive(self):
        return not any(p.poll() not in (None, 0) for p in self._procs)

    def wait(self):
        for p in self._procs:
            p.wait()

    def cancel(self):
        for p in self._procs:
            if p.poll() is None:
                p.kill()


class SparkBackend(ClusterBackend):
    """One task per Spark partition through ``mapPartitionsWithIndex``.
    Needs an active SparkContext (pyspark is imported only when none is
    given); the Spark job runs on a thread, and Spark's RPC encryption
    protects the key in transit."""

    def __init__(self, spark_context=None):
        if spark_context is None:
            import pyspark
            spark_context = pyspark.SparkContext._active_spark_context
        if spark_context is None:
            raise RuntimeError("no active SparkContext; start a PySpark "
                               "session before running on Spark")
        self._sc = spark_context
        self._thread = None
        self._error = []

    def start_tasks(self, num_tasks, ctx):
        def _mapper(index, _it):
            # a failed Spark task is retried, which would run the user's
            # fn again against a finished rendezvous: control flow that
            # was published is not raised again in a partition
            yield cluster_task(index, num_tasks, ctx,
                               reraise_control_flow=False)

        def _run():
            try:
                self._sc.range(0, num_tasks, numSlices=num_tasks) \
                    .mapPartitionsWithIndex(_mapper).collect()
            except Exception as e:  # surfaces through alive() and wait()
                self._error.append(e)

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()

    def alive(self):
        return not self._error

    def wait(self):
        if self._thread:
            self._thread.join()
        if self._error:
            raise self._error[0]

    def cancel(self):
        self._sc.cancelAllJobs()


def cluster_task(index, num_tasks, ctx, reraise_control_flow=True):
    """The task's side, run inside a cluster executor. Returns its rank.

    ``reraise_control_flow``: whether an interrupt or ``SystemExit`` out
    of the user's fn is raised again after its failure was published.
    True for subprocess backends; False where a task exception means a
    retry (Spark). Control flow before anything was published always
    propagates."""
    key = _secret.decode_key(ctx["key"])
    os.environ[_secret.SECRET_ENV] = ctx["key"]
    kv_addr, kv_port = ctx["kv_addr"], int(ctx["kv_port"])
    timeout = ctx.get("timeout", 600)
    agent = TaskAgent(index, num_tasks, kv_addr, kv_port, key,
                      host_salt=os.environ.get(HOST_SALT_ENV))
    try:
        agent.register()
        agent.run_ring_probe(timeout=timeout)
        agent.common_interfaces(timeout=timeout)
        assign = json.loads(kv_wait(kv_addr, kv_port,
                                    f"cluster/assign/{index}",
                                    timeout=timeout, auth_key=key))
    finally:
        agent.shutdown()
    os.environ.update({k: str(v) for k, v in assign.items()})
    rank = int(assign["HOROVOD_RANK"])
    fn, args, kwargs = _pickler.loads(
        kv_wait(kv_addr, kv_port, "runfunc/func", auth_key=key))
    try:
        task_exec.exec_and_publish(
            fn, args, kwargs,
            lambda payload: kv_put(kv_addr, kv_port,
                                   f"runfunc/result/{rank}", payload,
                                   auth_key=key))
    except BaseException:
        # only control flow that exec_and_publish has published gets here
        if reraise_control_flow:
            raise
    return rank


def _assignments(groups, regs, common, num_proc, kv_addr, kv_port,
                 extra_env):
    """``{task index: env}``: contiguous ranks per host (``groups``, the
    task indices by host hash, rotated so that index 0 is rank 0), each
    task's own address on the first common interface, the store of this
    run."""
    hashes = sorted(groups)
    while 0 not in groups[hashes[0]]:
        hashes = hashes[1:] + hashes[:1]
    ranks_to_indices = [i for h in hashes for i in groups[h]]
    hosts = [allocation.HostSlots(h, len(groups[h])) for h in hashes]
    slots = allocation.allocate(hosts, num_proc)
    controller_ip = regs[ranks_to_indices[0]]["addresses"][common[0]][0][0]
    out = {}
    for rank, index in enumerate(ranks_to_indices):
        s = slots[rank]
        assign = {
            "HOROVOD_RANK": s.rank, "HOROVOD_SIZE": s.size,
            "HOROVOD_LOCAL_RANK": s.local_rank,
            "HOROVOD_LOCAL_SIZE": s.local_size,
            "HOROVOD_CROSS_RANK": s.cross_rank,
            "HOROVOD_CROSS_SIZE": s.cross_size,
            "HOROVOD_CONTROLLER_ADDR": controller_ip,
            "HOROVOD_CONTROLLER_PORT": 0,
            "HOROVOD_HOSTNAME": regs[index]["addresses"][common[0]][0][0],
            "HOROVOD_GLOO_RENDEZVOUS_ADDR": kv_addr,
            "HOROVOD_GLOO_RENDEZVOUS_PORT": kv_port,
            "HOROVOD_COMMON_INTERFACES": ",".join(common),
        }
        if extra_env:
            assign.update(extra_env)
        out[index] = assign
    return out


def run_on_cluster(fn, args=(), kwargs=None, num_proc=2, backend=None,
                   start_timeout=600, kv_host="0.0.0.0", kv_addr=None,
                   extra_env=None):
    """Run ``fn`` across ``num_proc`` cluster executors; returns the
    results in rank order."""
    kwargs = kwargs or {}
    backend = backend or LocalProcessBackend()
    key = _secret.make_secret_key()
    kv = KVStoreServer(host=kv_host, auth_key=key)
    kv_port = kv.start()
    if kv_addr is None:
        kv_addr = ("127.0.0.1" if isinstance(backend, LocalProcessBackend)
                   else launcher.this_host_addr())
    try:
        kv.put("runfunc/func", _pickler.dumps((fn, args, kwargs)))
        ctx = {"kv_addr": kv_addr, "kv_port": kv_port,
               "key": _secret.encode_key(key), "timeout": start_timeout}
        backend.start_tasks(num_proc, ctx)

        driver = DriverService(num_proc, kv_addr, kv_port, key,
                               liveness=backend.alive)
        regs = driver.wait_for_registrations(timeout=start_timeout)
        common = driver.wait_for_probes(timeout=start_timeout)
        if not common:
            raise RuntimeError(
                "no common task-to-task interface across executors: "
                + str({i: list(r["addresses"]) for i, r in regs.items()}))
        groups = driver.host_hash_indices(regs)
        for index, assign in _assignments(groups, regs, common, num_proc,
                                          kv_addr, kv_port,
                                          extra_env).items():
            kv.put(f"cluster/assign/{index}", json.dumps(assign).encode())

        results = []
        for rank in range(num_proc):
            # a dead executor fails the run now, not after start_timeout
            deadline = time.time() + start_timeout
            payload = None
            while time.time() < deadline:
                payload = kv_get(kv_addr, kv_port,
                                 f"runfunc/result/{rank}", auth_key=key)
                if payload is not None:
                    break
                if not backend.alive():
                    raise RuntimeError(
                        f"a cluster executor died before rank {rank} "
                        f"reported its result")
                time.sleep(0.2)
            if payload is None:
                raise TimeoutError(
                    f"rank {rank} result not published within "
                    f"{start_timeout}s")
            ok, value = pickle.loads(payload)
            if not ok:
                raise RuntimeError(f"rank {rank} raised:\n{value}")
            results.append(value)
        backend.wait()
        return results
    except BaseException:
        backend.cancel()
        raise
    finally:
        kv.stop()
