"""Spark integration: ``horovod_tpu_torch.spark.run(fn, args=...,
num_proc=N)``, the port of ``horovod_tpu/spark/__init__.py``.

Rebuilds ``horovod/spark/__init__.py:101-236`` as a thin shim over the
port's pluggable cluster backend (``run/cluster.py``): Spark owns task placement;
each Spark partition calls back into the driver's signed KV, registers
its NICs + host hash, ring-probes, receives a rank with contiguous
per-host grouping, and runs ``fn``. Results return in rank order.

``run`` imports ``pyspark`` when it is called; the protocol underneath
it (registration, probing, host-hash rank grouping, rank assignment,
result collection) is tested through ``LocalProcessBackend``, as the
reference fakes clusters in ``test/test_spark.py``.
"""

import os

from horovod_tpu_torch.run.cluster import SparkBackend, run_on_cluster


def run(fn, args=(), kwargs=None, num_proc=None, start_timeout=None,
        env=None, verbose=1, nic=None):
    """Run ``fn`` in ``num_proc`` Spark tasks; returns per-rank results
    (reference contract, ``spark/__init__.py:101-130``).

    ``num_proc`` defaults to ``spark.default.parallelism``."""
    import pyspark
    sc = pyspark.SparkContext._active_spark_context
    if sc is None:
        raise RuntimeError("horovod_tpu_torch.spark.run() needs an active "
                           "SparkContext (run inside a PySpark session)")
    if num_proc is None:
        num_proc = sc.defaultParallelism
        if verbose >= 1:
            print(f"Running {num_proc} processes "
                  f"(from spark.default.parallelism)...")
    if start_timeout is None:
        start_timeout = int(os.getenv("HOROVOD_SPARK_START_TIMEOUT", "600"))
    extra = dict(env or {})
    if nic:
        extra["HOROVOD_COMMON_INTERFACES"] = nic
    return run_on_cluster(fn, args=args, kwargs=kwargs, num_proc=num_proc,
                          backend=SparkBackend(sc),
                          start_timeout=start_timeout,
                          extra_env=extra or None)
