"""The programmatic launcher, ``run(fn, args=(), np=N)``: the port of
``horovod_tpu/run/api.py``. The function is pickled into the launcher's
key-value store, N fresh worker processes run it under the env contract,
and their return values come back in rank order.
"""

import pickle
import sys

from horovod_tpu_torch.run import allocation, launcher
from horovod_tpu_torch.run import secret as _secret
from horovod_tpu_torch.run.rendezvous import KVStoreServer, kv_wait

try:  # cloudpickle ships closures and lambdas by value
    import cloudpickle as _pickler
except ImportError:
    _pickler = pickle

TASK = "horovod_tpu_torch.run.run_task"


def run(fn, args=(), kwargs=None, np=1, hosts=None, extra_env=None,
        timeout=300, use_jax_coordinator=False):
    """Run ``fn(*args, **kwargs)`` in ``np`` processes and return the
    list of their return values, in rank order. ``hosts`` is ``-H``'s
    ``"h1:2,h2:2"`` (default: ``np`` slots on this machine). Raises
    ``RuntimeError`` with the traceback of a rank whose ``fn`` raised.
    Without ``cloudpickle``, ``fn`` must be importable by the workers.
    ``use_jax_coordinator`` names the run's rendezvous in
    ``HOROVOD_COORDINATOR_ADDR``, so that ``init()`` installs one process
    mesh over the ranks (``cluster/procmesh.py``; the rows are
    ``HOROVOD_SPMD_PROCS`` of ``extra_env``, else one a rank)."""
    kwargs = kwargs or {}
    host_list = (allocation.parse_hosts(hosts) if hosts
                 else [allocation.HostSlots("localhost", np)])
    slots = allocation.allocate(host_list, np)

    controller_addr = slots[0].hostname
    if controller_addr in launcher.LOCAL_HOSTS:
        controller_addr = "127.0.0.1"

    all_local = all(s.hostname in launcher.LOCAL_HOSTS for s in slots)
    # a job across hosts gets a per-run key, so that no unauthenticated
    # peer can feed pickles into the store
    auth_key = None if all_local else _secret.make_secret_key()
    kv = KVStoreServer(host="127.0.0.1" if all_local else "0.0.0.0",
                       auth_key=auth_key)
    rendezvous_port = kv.start()
    kv.put("runfunc/func", _pickler.dumps((fn, args, kwargs)))

    env = dict(extra_env or {})
    if auth_key is not None:
        env[_secret.SECRET_ENV] = _secret.encode_key(auth_key)
    env["PYTHONPATH"] = launcher.repo_pythonpath(
        env if "PYTHONPATH" in env else None)
    if use_jax_coordinator:
        env["HOROVOD_COORDINATOR_ADDR"] = \
            f"{controller_addr}:{rendezvous_port}"

    job = launcher.launch(slots, [sys.executable, "-m", TASK],
                          controller_addr, 0,
                          rendezvous_port=rendezvous_port, extra_env=env)
    try:
        try:
            job.wait()
        except RuntimeError as e:
            # the failed rank's traceback, where it got as far as sending it
            for r in range(np):
                payload = kv.get(f"runfunc/result/{r}")
                if payload is None:
                    continue
                ok, value = pickle.loads(payload)
                if not ok:
                    raise RuntimeError(
                        f"rank {r} raised:\n{value}") from e
            raise
        results = []
        for r in range(np):
            payload = kv_wait("127.0.0.1", rendezvous_port,
                              f"runfunc/result/{r}", timeout=timeout,
                              auth_key=auth_key)
            ok, value = pickle.loads(payload)
            if not ok:
                raise RuntimeError(f"rank {r} raised:\n{value}")
            results.append(value)
        return results
    finally:
        kv.stop()
