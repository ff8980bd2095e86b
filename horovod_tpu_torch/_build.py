"""Build and load the package's CUDA kernels.

The sources under ``csrc/`` are compiled by ``nvcc`` for Hopper
(``sm_90a``) into one shared library with a plain C interface, bound
with ``ctypes``: no PyTorch headers enter the build, so it takes seconds,
not minutes. The build runs at first use, is cached under ``_build/`` by
a hash of the sources and flags, and is guarded by a file lock so that
concurrent processes build once. A failed build raises with the
compiler's output.
"""

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent
SOURCES = (PACKAGE_DIR / "csrc" / "flash_attention.cu",)
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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


def library_path():
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libhvd_kernels-{h.hexdigest()[:16]}.so"


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
            tmp = lib.with_suffix(f".tmp{os.getpid()}")
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                   *map(str, SOURCES)]
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n"
                    f"{res.stdout}\n{res.stderr}")
            lib.with_suffix(".log").write_text(res.stdout + res.stderr)
            os.replace(tmp, lib)
            return lib
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def load():
    """The loaded kernel library (built first if needed), with every C
    entry point's ``argtypes``/``restype`` declared."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # q k v o lse | bh sq skv d q_off kv_off causal | scale | dtype | stream
    lib.hvd_flash_fwd.argtypes = [p] * 5 + [i] * 7 + [f, i, p]
    # q k v g lse delta dq | out_f32 bh sq skv d q_off kv_off causal | ...
    lib.hvd_flash_dq.argtypes = [p] * 7 + [i] * 8 + [f, i, p]
    # q k v g lse delta dk dv | out_f32 bh sq skv d q_off kv_off causal | ...
    lib.hvd_flash_dkv.argtypes = [p] * 8 + [i] * 8 + [f, i, p]
    for fn in (lib.hvd_flash_fwd, lib.hvd_flash_dq, lib.hvd_flash_dkv):
        fn.restype = ctypes.c_int
    lib.hvd_cuda_error_string.argtypes = [i]
    lib.hvd_cuda_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def check(lib, code, what):
    """Raise when a launcher returned a CUDA error."""
    if code != 0:
        msg = lib.hvd_cuda_error_string(code).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error "
                           f"{code} ({msg})")
