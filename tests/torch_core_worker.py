"""One rank of the port's native-core tests (spawned by
``test_torch_native_core.py``): ``native_worker.py``'s scenarios and the
parity scenario below, through one shim of the core.

    python torch_core_worker.py <port|jax> <scenario,...> <rank> <size> \
        <controller port> <out dir>

``port`` binds ``horovod_tpu_torch._core`` (which builds the port's own
library); ``jax`` loads the JAX package's ``horovod_tpu/_core.py`` by its
path, so that the process imports no JAX. ``native_worker.py`` reads its
shim as ``horovod_tpu._core``: the chosen one is registered under that
name before it is imported. Each process loads one shim's library only.
The parity scenario writes every result to ``<shim>.rank<r>.npz``, and
each rank writes ``<shim>.rank<r>.json`` (the libraries it mapped, the
join's last rank, the error messages).
"""

import importlib.util
import json
import os
import sys
import time
import types

import numpy as np

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
sys.path.insert(0, REPO)
sys.path.insert(0, TESTS)

# the core's host dtypes, by name, and the ops each takes part in
INT_DTYPES = ("uint8", "int8", "uint16", "int16", "int32", "int64")
FLOAT_DTYPES = ("float16", "float32", "float64")
OPS = ("sum", "average", "min", "max")


def load_shim(which):
    if which == "port":
        from horovod_tpu_torch import _core
        return _core
    spec = importlib.util.spec_from_file_location(
        "horovod_tpu._core", os.path.join(REPO, "horovod_tpu", "_core.py"))
    core = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(core)
    return core


def install(core):
    pkg = types.ModuleType("horovod_tpu")
    pkg.__path__ = []
    pkg._core = core
    sys.modules["horovod_tpu"] = pkg
    sys.modules["horovod_tpu._core"] = core


def ints(rank, dtype, shape, seed=0):
    """Small whole numbers of ``dtype``: every sum, scale and average of
    them is exact in any order, so numpy gives the core's bits."""
    rng = np.random.default_rng([seed, rank, len(dtype)])
    hi = 2 if dtype == "bool" else 4
    return rng.integers(0, hi, size=shape).astype(dtype)


def normals(rank, dtype, shape, seed=1):
    rng = np.random.default_rng([seed, rank])
    return rng.standard_normal(shape).astype(dtype)


def parity(core, rank, size, which, out):
    """Every op on every dtype, on seeded inputs; the results go to
    ``<which>.rank<r>.npz`` for the parent to hold against the other shim
    and numpy."""
    res = {}
    for d in INT_DTYPES + FLOAT_DTYPES:
        x = ints(rank, d, (5, 3))
        for op in OPS:
            res[f"ar.{op}.{d}"] = core.allreduce(x, f"ar.{op}.{d}", op=op)
        res[f"ag.{d}"] = core.allgather(ints(rank, d, (rank + 1, 3)),
                                        f"ag.{d}")
        res[f"bc.{d}"] = core.broadcast(x, f"bc.{d}", root_rank=1)
        res[f"a2a.{d}"] = core.alltoall(ints(rank, d, (2 * size, 2)),
                                        f"a2a.{d}")
        for op in ("sum", "average"):
            res[f"rs.{op}.{d}"] = core.reducescatter(
                ints(rank, d, (size + 1, 3)), f"rs.{op}.{d}", op=op)
    b = ints(rank, "bool", (4, 2))
    res["ag.bool"] = core.allgather(b, "ag.bool")
    res["bc.bool"] = core.broadcast(b, "bc.bool", root_rank=1)
    # prescale and postscale: exact on whole numbers by powers of two
    res["ar.scaled"] = core.allreduce(ints(rank, "float32", (7,)),
                                      "ar.scaled", op="sum", prescale=2.0,
                                      postscale=0.5)
    # random values: the shims bit for bit (the order of the ring's sums
    # is the core's own)
    for d in FLOAT_DTYPES:
        y = normals(rank, d, (33,))
        for op in ("sum", "average"):
            res[f"rand.{op}.{d}"] = core.allreduce(y, f"rand.{op}.{d}",
                                                   op=op)
        res[f"rand.scaled.{d}"] = core.allreduce(
            y, f"rand.scaled.{d}", op="sum", prescale=0.3, postscale=1.7)
    if size & (size - 1) == 0:
        for d in ("float32", "float64"):
            res[f"adasum.{d}"] = core.allreduce(normals(rank, d, (33,)),
                                                f"adasum.{d}", op="adasum")
    # in place: the core works in the caller's buffer
    z = normals(rank, "float32", (1000,))
    got = core.allreduce_async(z, "ip.ar", op="sum", inplace=True).wait()
    assert got is z
    res["ip.ar"] = z
    w = ints(rank, "int32", (64,))
    assert core.broadcast_async(w, "ip.bc", root_rank=1,
                                inplace=True).wait() is w
    res["ip.bc"] = w
    info = {}
    # an uneven join: rank 0 runs out first, the others reduce once more
    # (averaged over the ranks still active) and then join
    x = ints(rank, "float32", (4,))
    res["jn.0"] = core.allreduce(x, "jn.0", op="average")
    if rank == 0:
        info["last"] = core.join()
    else:
        res["jn.1"] = core.allreduce(x, "jn.1", op="average")
        info["last"] = core.join()
    core.barrier()
    # a negotiated error: the same name at two shapes
    try:
        core.allreduce(np.ones(3 + rank, np.float32), "err.shape")
        info["error"] = None
    except RuntimeError as e:
        info["error"] = str(e)
    core.barrier()
    info["control_bytes"] = core.control_bytes()
    info["autotune"] = core.autotune_state()
    np.savez(os.path.join(out, f"{which}.rank{rank}.npz"), **res)
    return info


def mapped_cores():
    with open("/proc/self/maps") as f:
        return sorted({line.split()[-1] for line in f
                       if "libhvdcore" in line})


def main():
    which, scenarios, rank, size, port, out = sys.argv[1:7]
    rank, size, port = int(rank), int(size), int(port)
    core = load_shim(which)
    install(core)
    import native_worker
    info = {}
    core.init(rank=rank, size=size, coord_host="127.0.0.1", coord_port=port)
    try:
        for s in scenarios.split(","):
            t0 = time.perf_counter()
            if s == "parity":
                info.update(parity(core, rank, size, which, out))
            else:
                getattr(native_worker, f"scenario_{s}")(rank, size)
            info[f"seconds.{s}"] = time.perf_counter() - t0
        info["libraries"] = mapped_cores()
    finally:
        core.shutdown()
    timeline = os.environ.get("HOROVOD_TIMELINE")
    if timeline and rank == 0:
        with open(timeline) as f:
            events = json.load(f)
        info["timeline_negotiations"] = sum(
            e.get("name", "").startswith("NEGOTIATE") for e in events)
    with open(os.path.join(out, f"{which}.rank{rank}.json"), "w") as f:
        json.dump(info, f)


if __name__ == "__main__":
    main()
