"""Build and load the package's CUDA kernels.

The sources under ``csrc/`` are compiled by ``nvcc`` for Hopper
(``sm_90a``), one ``nvcc`` per ``.cu`` file, all started together, and
linked into one shared library with a plain C interface, bound with
``ctypes``: no PyTorch headers enter the build, so it takes seconds, not
minutes. TMA's tensor-map encoder (``cuTensorMapEncodeTiled``) lives
in ``libcuda``; the launchers look it up at run time through the CUDA
runtime (``cudaGetDriverEntryPointByVersion``), so nothing beyond the
static runtime is linked. The build runs at first use, is cached under
``_build/`` by a hash of every source and header under ``csrc/`` and of
the flags, and is guarded by a file lock so that concurrent processes
build once. A failed build raises with the compiler's output.

The build (or the load of a cached one) is the port's compile time: its
seconds go to ``hvd_compile_seconds_total`` and the goodput ledger's
``compile`` phase (``telemetry/instruments.record_compile``), a cached
library counting a cache hit.
"""

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
LINK_FLAGS = ("-shared", *ARCH)
SOURCE_SUFFIXES = (".cu", ".cuh", ".h")

_lib = None


def nvcc_path():
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, then
    ``/usr/local/cuda/bin/nvcc``, then ``nvcc`` on ``PATH``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels of "
            "horovod_tpu_torch are built from csrc/ at first use")
    return found


def sources(csrc=CSRC_DIR):
    """Every file the build reads, in sorted order: the ``.cu`` files it
    compiles and the headers they include."""
    return sorted(p for p in Path(csrc).iterdir()
                  if p.is_file() and p.suffix in SOURCE_SUFFIXES)


def library_path(csrc=CSRC_DIR):
    """Where the build of these sources and flags lives: a change to any
    source or header under ``csrc`` gives another path, so a stale
    library is never loaded."""
    h = hashlib.sha256()
    for src in sources(csrc):
        h.update(src.name.encode() + b"\0")
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    return BUILD_DIR / f"libhvd_kernels-{h.hexdigest()[:16]}.so"


def _run_all(cmds):
    """Start every command at once, then wait for each; raise with the
    compiler's output if one failed. Returns their joined output."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    outs, failed = [], []
    for cmd, proc in procs:
        out = proc.communicate()[0]
        outs.append(out)
        if proc.returncode != 0:
            failed.append(f"build step failed ({proc.returncode}): "
                          f"{' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return "".join(outs)


def build():
    """Compile the kernels unless this exact build exists; returns the
    library's path. The compiler's report (registers, shared memory,
    spills from ``-Xptxas -v``) is kept beside it as ``.log``."""
    lib = library_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if lib.exists():
                return lib
            nvcc = nvcc_path()
            objdir = BUILD_DIR / f"obj{os.getpid()}"
            objdir.mkdir(exist_ok=True)
            try:
                units = [s for s in sources() if s.suffix == ".cu"]
                objs = [objdir / (s.stem + ".o") for s in units]
                log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)]
                                for s, o in zip(units, objs)])
                tmp = lib.with_suffix(f".tmp{os.getpid()}")
                log += _run_all([[nvcc, *LINK_FLAGS, "-o", str(tmp),
                                  *map(str, objs)]])
            finally:
                shutil.rmtree(objdir, ignore_errors=True)
            lib.with_suffix(".log").write_text(log)
            os.replace(tmp, lib)
            return lib
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# Every C entry point of the library: its argument types and result type.
# ctypes passes whatever it is given, so a missing or wrong entry is a
# silent memory fault on the card; tests/test_torch_build.py holds this
# table to the declarations in csrc/.
ENTRY_POINTS = {
    # q k v o lse | bh sq skv d q_off kv_off causal | scale | dtype | stream
    "hvd_flash_fwd": ([_P] * 5 + [_I] * 7 + [_F, _I, _P], ctypes.c_int),
    # q k v g lse delta dq | out_f32 bh sq skv d q_off kv_off causal | ...
    "hvd_flash_dq": ([_P] * 7 + [_I] * 8 + [_F, _I, _P], ctypes.c_int),
    # q k v g lse delta dk dv | out_f32 bh sq skv d q_off kv_off causal | ...
    "hvd_flash_dkv": ([_P] * 8 + [_I] * 8 + [_F, _I, _P], ctypes.c_int),
    # the bf16 Hopper kernels with their tile choice in place of dtype:
    # K1 ... | bn stages | stream
    "hvd_flash_fwd_sm90": ([_P] * 5 + [_I] * 7 + [_F, _I, _I, _P],
                           ctypes.c_int),
    # K2 ... | bn stages | stream
    "hvd_flash_dq_sm90": ([_P] * 7 + [_I] * 8 + [_F, _I, _I, _P],
                          ctypes.c_int),
    # K3 ... | stages | stream
    "hvd_flash_dkv_sm90": ([_P] * 8 + [_I] * 8 + [_F, _I, _P], ctypes.c_int),
    "hvd_cuda_error_string": ([_I], ctypes.c_char_p),
}


def load():
    """The loaded kernel library (built first if needed), with every C
    entry point's ``argtypes``/``restype`` declared from
    ``ENTRY_POINTS``."""
    global _lib
    if _lib is not None:
        return _lib
    t0 = time.perf_counter()
    cached = library_path().exists()
    lib = ctypes.CDLL(str(build()))
    for name, (argtypes, restype) in ENTRY_POINTS.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    _lib = lib
    from horovod_tpu_torch.telemetry import instruments
    instruments.record_compile(time.perf_counter() - t0, cache_hit=cached)
    return lib


def check(lib, code, what):
    """Raise when a launcher returned a CUDA error."""
    if code != 0:
        msg = lib.hvd_cuda_error_string(code).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error "
                           f"{code} ({msg})")
