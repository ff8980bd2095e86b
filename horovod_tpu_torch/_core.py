"""ctypes binding to the native host core: the port of
``horovod_tpu/_core.py``.

The core is the C++ under ``cxx/`` (Horovod's ``common/``): a TCP
controller that negotiates tensors by name, the ring collectives
(allreduce, allgatherv, broadcast, alltoall, reduce-scatter, Adasum),
Join, the barrier, the response cache, the autotuner and the timeline,
all run by one background thread a process on host memory. This module
compiles those sources as they are, one ``g++`` a ``.cc`` file with
``cxx/Makefile``'s flags, all started together, into
``_build/libhvdcore-<hash>.so`` (the hash of every source, header and
flag), under a file lock, and binds it with the JAX shim's ctypes
surface: the argument types, the dtype map (no bfloat16), the reduce
ops, the handles with their borrow registry and orphan sweep, and the
in-place contract. It never loads the JAX package's build of the core.
The sources are read from ``cxx/`` beside the package in a source
checkout, and from the package's ``_cxx/`` in an installed one
(``setup.py`` ships them there).

The classic adapters start the core at their first collective
(``basics.native_core``; in a multi-process job under the launcher
``runtime/services.start_core``), so that a job that never calls them
builds and runs no core. It carries the classic framework adapters
(``horovod_tpu_torch.torch``, ``.tensorflow``, ``.mxnet``), Join and the
barrier. The port's own eager collectives (``ops/collective.py``), the
fused bucket exchange and the autotuner's joint decisions stay on
``torch.distributed``, NCCL on the card: the JAX package routes its
eager host collectives through the core when it runs because JAX has no
eager multi-process plane of its own, and the port has one.
"""

import ctypes
import fcntl
import hashlib
import os
import shutil
from pathlib import Path

import numpy as np

from horovod_tpu_torch import _build

# Request::Type (cxx/include/hvd/message.h)
ALLREDUCE, ALLGATHER, BROADCAST, JOIN, ADASUM, ALLTOALL = 0, 1, 2, 3, 4, 5
REDUCESCATTER, BARRIER = 6, 7
# ReduceOp (cxx/include/hvd/cpu_ops.h)
OP_SUM, OP_AVERAGE, OP_MIN, OP_MAX, OP_ADASUM = 0, 1, 2, 3, 4

_DTYPE_MAP = {
    np.dtype(np.uint8): 0, np.dtype(np.int8): 1,
    np.dtype(np.uint16): 2, np.dtype(np.int16): 3,
    np.dtype(np.int32): 4, np.dtype(np.int64): 5,
    np.dtype(np.float16): 6, np.dtype(np.float32): 7,
    np.dtype(np.float64): 8, np.dtype(np.bool_): 9,
}

_OP_MAP = {"sum": OP_SUM, "average": OP_AVERAGE, "min": OP_MIN,
           "max": OP_MAX, "adasum": OP_ADASUM}

# the installed package's copy of cxx/'s sources, else the checkout's
_SHIPPED = _build.PACKAGE_DIR / "_cxx"
CXX_DIR = (_SHIPPED if (_SHIPPED / "src").is_dir()
           else _build.PACKAGE_DIR.parent / "cxx")
# cxx/Makefile's CXXFLAGS and LDFLAGS
CXX_FLAGS = ("-O2", "-g", "-std=c++17", "-fPIC", "-Wall", "-Wextra")
LINK_FLAGS = ("-shared", "-pthread")

_lib = None


def cxx_path():
    """The C++ compiler: ``g++`` on ``PATH``."""
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError(
            "g++ not found: the native host core of horovod_tpu_torch is "
            "built from cxx/ at first use")
    return found


def sources(cxx=CXX_DIR):
    """Every file the build reads, in sorted order: the ``.cc`` files it
    compiles and the headers they include."""
    cxx = Path(cxx)
    return sorted([*(cxx / "src").glob("*.cc"),
                   *(cxx / "include" / "hvd").glob("*.h")])


def library_path(cxx=CXX_DIR):
    """Where the build of these sources and flags lives: a change to any
    source, header or flag gives another path."""
    h = hashlib.sha256()
    for src in sources(cxx):
        h.update(src.name.encode() + b"\0")
        h.update(src.read_bytes())
    h.update(" ".join(CXX_FLAGS + LINK_FLAGS).encode())
    return _build.BUILD_DIR / f"libhvdcore-{h.hexdigest()[:16]}.so"


def build(force=False):
    """Compile the core unless this exact build exists (``force``: compile
    it again all the same); returns the library's path. Concurrent processes (the ranks of one job) build it
    once: the others wait on the lock and load what it built. The
    compilers run at the lowest CPU priority, so that a build beside
    running jobs on this host (a test suite, a training job) does not
    slow them; on an idle host it is as fast."""
    lib = library_path()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(_build.BUILD_DIR / ".core.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if lib.exists() and not force:
                return lib
            if not (CXX_DIR / "src").is_dir():
                raise RuntimeError(f"the native core's sources are missing: "
                                   f"{CXX_DIR / 'src'}")
            cxx = cxx_path()
            objdir = _build.BUILD_DIR / f"core-obj{os.getpid()}"
            objdir.mkdir(exist_ok=True)
            try:
                units = [s for s in sources() if s.suffix == ".cc"]
                objs = [objdir / (s.stem + ".o") for s in units]
                include = f"-I{CXX_DIR / 'include'}"
                nice = ([shutil.which("nice"), "-n", "19"]
                        if shutil.which("nice") else [])
                _build._run_all([[*nice, cxx, *CXX_FLAGS, include, "-c",
                                  str(s), "-o", str(o)]
                                 for s, o in zip(units, objs)])
                tmp = lib.with_suffix(f".tmp{os.getpid()}")
                _build._run_all([[*nice, cxx, *map(str, objs), *LINK_FLAGS,
                                  "-o", str(tmp)]])
            finally:
                shutil.rmtree(objdir, ignore_errors=True)
            os.replace(tmp, lib)
            return lib
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    lib.hvdc_init.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_char_p,
                              ctypes.c_int, ctypes.c_char_p]
    lib.hvdc_enqueue.argtypes = [
        ctypes.c_int, ctypes.c_char_p, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_double]
    lib.hvdc_enqueue_borrow.argtypes = lib.hvdc_enqueue.argtypes
    lib.hvdc_copy_bytes.restype = ctypes.c_int64
    lib.hvdc_error_message.restype = ctypes.c_char_p
    lib.hvdc_last_error.restype = ctypes.c_char_p
    lib.hvdc_output_size.restype = ctypes.c_int64
    lib.hvdc_copy_output.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.hvdc_autotune_state.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.hvdc_control_bytes.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64)]
    lib.hvdc_data_bytes.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64)]
    _lib = lib
    return lib


def core_available():
    try:
        _load()
        return True
    # hvd-lint: disable=HVD-EXCEPT -- availability probe: any failure means the core is absent
    except Exception:
        return False


def init(rank=0, size=1, coord_host="127.0.0.1", coord_port=0,
         advertise_host="127.0.0.1"):
    """Start the native core (its background negotiation loop and TCP
    planes); blocks until every rank has joined the controller."""
    lib = _load()
    rv = lib.hvdc_init(rank, size, coord_host.encode(), coord_port,
                       advertise_host.encode())
    if rv != 0:
        raise RuntimeError("native core init failed: " +
                           lib.hvdc_last_error().decode())


def shutdown():
    if _lib is not None and _lib.hvdc_is_initialized():
        _sweep_orphans()  # drain completed fire-and-forget handles
        _lib.hvdc_shutdown()


def is_initialized():
    return _lib is not None and bool(_lib.hvdc_is_initialized())


def rank():
    return _lib.hvdc_rank() if _lib is not None else -1


def size():
    return _lib.hvdc_size() if _lib is not None else -1


# Buffers the core is borrowing, keyed by handle: the registry (not only
# the Handle object) pins each array until the op completes, so a caller
# that fires and forgets an in-place op never leaves the background loop
# holding a pointer into freed memory.
_borrowed_refs = {}
# C handles whose Python Handle was collected before completion: their
# borrow stays pinned until the loop is done with the pointer, and they
# are swept (released and unpinned) from _enqueue once hvdc_poll reports
# completion.
_orphaned = set()


def _finalize_completed(h):
    """If handle ``h`` is done, unpin its borrow and release the C
    handle. Returns True when finalized (``Handle.__del__`` and the
    orphan sweep both go through it)."""
    if _lib is None or _lib.hvdc_poll(h) == 0:
        return False
    _borrowed_refs.pop(h, None)
    _lib.hvdc_release(h)
    return True


def _sweep_orphans():
    for h in list(_orphaned):
        if _finalize_completed(h):
            _orphaned.discard(h)


class Handle:
    """An asynchronous op's handle. With ``borrowed`` set, the core
    worked zero-copy in that array's buffer: the handle keeps it alive
    until completion and ``wait`` returns it (the result is in place)."""

    def __init__(self, h, out_dtype, out_shape_hint=None, borrowed=None):
        self._h = h
        self._dtype = out_dtype
        self._shape_hint = out_shape_hint
        self._borrowed = borrowed
        if borrowed is not None:
            _borrowed_refs[h] = borrowed
        self._released = False

    def poll(self):
        """True when the op has completed."""
        done = _lib.hvdc_poll(self._h) != 0
        if done:
            # the core dropped the raw pointer: the registry's pin can go
            # (self._borrowed keeps the array for wait()'s return)
            _borrowed_refs.pop(self._h, None)
        return done

    def __del__(self):
        if getattr(self, "_released", True):
            return
        try:
            if _lib is not None and not _finalize_completed(self._h):
                # still in flight: the loop may hold the buffer's
                # pointer, so the pin stays until the sweep
                _orphaned.add(self._h)
        # hvd-lint: disable=HVD-EXCEPT -- interpreter shutdown: globals may already be gone
        except Exception:
            pass

    def wait(self):
        """Block until done; return the result array."""
        if self._released:
            raise RuntimeError("handle already synchronized")
        rv = _lib.hvdc_wait(self._h)
        _borrowed_refs.pop(self._h, None)  # op done: the core dropped it
        if rv != 1:
            msg = _lib.hvdc_error_message(self._h).decode()
            _lib.hvdc_release(self._h)
            self._released = True
            raise RuntimeError(msg)
        nbytes = _lib.hvdc_output_size(self._h)
        if self._borrowed is not None and nbytes == 0:
            # in place on the borrowed buffer: nothing to copy out
            _lib.hvdc_release(self._h)
            self._released = True
            return self._borrowed
        out = np.empty(nbytes, dtype=np.uint8)
        _lib.hvdc_copy_output(self._h, out.ctypes.data_as(ctypes.c_void_p))
        _lib.hvdc_release(self._h)
        self._released = True
        arr = out.view(self._dtype)
        if self._shape_hint is not None:
            arr = arr.reshape(self._shape_hint)
        return arr


def _enqueue(req_type, name, array, op=OP_SUM, root_rank=-1, prescale=1.0,
             postscale=1.0, out_shape=None, inplace=False):
    lib = _load()
    _sweep_orphans()
    arr = np.ascontiguousarray(array)
    if arr.dtype not in _DTYPE_MAP:
        raise ValueError(f"unsupported dtype {arr.dtype}")
    # zero-copy borrow: the core reads (and for allreduce and broadcast
    # writes) the caller's buffer. The in-place promise holds only for a
    # C-contiguous writable array; anything else would reduce into a
    # hidden copy while the caller reads a stale original.
    if inplace and (arr is not array or not arr.flags.writeable):
        raise ValueError(
            "inplace=True requires a C-contiguous writable ndarray "
            "(got a copy or read-only view); drop inplace or pass "
            "np.ascontiguousarray(x) yourself and read the result there")
    # if the collective fails, an in-place buffer is undefined (see
    # hvdc_enqueue_borrow in cxx/include/hvd/operations.h)
    shape = (ctypes.c_int64 * arr.ndim)(*arr.shape)
    fn = lib.hvdc_enqueue_borrow if inplace else lib.hvdc_enqueue
    h = fn(req_type, name.encode(), arr.ctypes.data_as(ctypes.c_void_p),
           shape, arr.ndim, _DTYPE_MAP[arr.dtype], op, root_rank, prescale,
           postscale)
    if h < 0:
        raise RuntimeError(lib.hvdc_last_error().decode())
    return Handle(h, arr.dtype, out_shape, borrowed=arr if inplace else None)


def allreduce_async(array, name, op="average", prescale=1.0, postscale=1.0,
                    inplace=False):
    req = ADASUM if op == "adasum" else ALLREDUCE
    # the caller's array goes to _enqueue as it is: its one
    # ascontiguousarray is what the in-place contract checks against
    return _enqueue(req, name, array, _OP_MAP[op],
                    out_shape=np.shape(array), prescale=prescale,
                    postscale=postscale, inplace=inplace)


def allreduce(array, name, op="average", **kw):
    return allreduce_async(array, name, op, **kw).wait()


def allgather_async(array, name):
    arr = np.ascontiguousarray(array)
    out_shape = (-1,) + arr.shape[1:] if arr.ndim > 0 else (-1,)
    return _enqueue(ALLGATHER, name, arr, out_shape=out_shape)


def allgather(array, name):
    return allgather_async(array, name).wait()


def broadcast_async(array, name, root_rank=0, inplace=False):
    return _enqueue(BROADCAST, name, array, root_rank=root_rank,
                    out_shape=np.shape(array), inplace=inplace)


def broadcast(array, name, root_rank=0, **kw):
    return broadcast_async(array, name, root_rank, **kw).wait()


def copy_bytes():
    """Host memcpy bytes the core has made so far (copy-in at enqueue,
    fusion staging, copy-out); the in-place paths keep it flat."""
    return int(_load().hvdc_copy_bytes())


def reducescatter_async(array, name, op="sum", prescale=1.0, postscale=1.0):
    """Reduce across ranks and scatter along dim 0: this rank receives
    rows ``[rank * base + min(rank, rem), ...)`` of the reduction (the
    remainder rows go to the first ranks)."""
    arr = np.ascontiguousarray(array)
    d0 = arr.shape[0] if arr.ndim > 0 else 1
    n = _lib.hvdc_size() if _lib is not None and _lib.hvdc_size() > 0 else 1
    base, rem = divmod(d0, n)
    r = _lib.hvdc_rank() if _lib is not None else 0
    rows = base + (1 if r < rem else 0)
    out_shape = (rows,) + arr.shape[1:]
    return _enqueue(REDUCESCATTER, name, arr, _OP_MAP[op],
                    out_shape=out_shape, prescale=prescale,
                    postscale=postscale)


def reducescatter(array, name, op="sum", **kw):
    return reducescatter_async(array, name, op, **kw).wait()


def alltoall_async(array, name):
    arr = np.ascontiguousarray(array)
    return _enqueue(ALLTOALL, name, arr, out_shape=arr.shape)


def alltoall(array, name):
    return alltoall_async(array, name).wait()


def join():
    """Announce that this rank's data is exhausted; once every rank has
    joined, return the rank that joined last."""
    lib = _load()
    h = lib.hvdc_enqueue_join()
    if h < 0:
        raise RuntimeError("join: core not initialized")
    rv = lib.hvdc_wait(h)
    msg = lib.hvdc_error_message(h).decode()
    last = -1
    if rv == 1 and lib.hvdc_output_size(h) == 4:
        out = np.zeros(1, dtype=np.int32)
        lib.hvdc_copy_output(h, out.ctypes.data_as(ctypes.c_void_p))
        last = int(out[0])
    lib.hvdc_release(h)
    if rv != 1:
        raise RuntimeError(f"join failed: {msg}")
    return last


def barrier():
    lib = _load()
    if lib.hvdc_barrier() != 0:
        raise RuntimeError("barrier failed")
    # a barrier proves every op enqueued before it completed: sweep, so
    # that fire-and-forget callers do not pin orphaned buffers
    _sweep_orphans()


def control_bytes():
    """Control-plane bytes (sent, received) of the negotiation rounds so
    far; the response cache's bit vectors shrink them in steady state."""
    lib = _load()
    sent = ctypes.c_int64(0)
    recvd = ctypes.c_int64(0)
    if lib.hvdc_control_bytes(ctypes.byref(sent), ctypes.byref(recvd)) != 0:
        raise RuntimeError("native core is not initialized")
    return sent.value, recvd.value


def data_bytes():
    """Data-plane payload bytes (intra-host, cross-host) this rank has
    sent so far, split by the ``HOROVOD_LOCAL_*``/``CROSS_*`` topology."""
    lib = _load()
    local = ctypes.c_int64(0)
    cross = ctypes.c_int64(0)
    if lib.hvdc_data_bytes(ctypes.byref(local), ctypes.byref(cross)) != 0:
        raise RuntimeError("native core is not initialized")
    return local.value, cross.value


def autotune_state():
    """The autotuner's state: ``enabled``, the current
    ``fusion_threshold`` and ``cycle_time_ms``, the categorical
    ``hierarchical`` and ``cache`` gates, the coordinator's ``samples``
    (-1 on the other ranks) and ``done``."""
    lib = _load()
    fusion = ctypes.c_int64(0)
    cycle = ctypes.c_double(0.0)
    samples = ctypes.c_int(0)
    done = ctypes.c_int(0)
    hier = ctypes.c_int(0)
    cache = ctypes.c_int(0)
    rv = lib.hvdc_autotune_state(ctypes.byref(fusion), ctypes.byref(cycle),
                                 ctypes.byref(samples), ctypes.byref(done),
                                 ctypes.byref(hier), ctypes.byref(cache))
    if rv < 0:
        raise RuntimeError("native core is not initialized")
    return {"enabled": bool(rv), "fusion_threshold": fusion.value,
            "cycle_time_ms": cycle.value, "samples": samples.value,
            "done": bool(done.value), "hierarchical": bool(hier.value),
            "cache": bool(cache.value)}
