"""The kernel build of horovod_tpu_torch, on the CPU and with no nvcc: the
cache key covers every source and header, the flags target Hopper, a
missing compiler is named, and the ctypes table of the C entry points
matches their declarations."""

import ctypes
import re
import shutil

import pytest

from horovod_tpu_torch import _build


@pytest.fixture
def csrc(tmp_path):
    """A copy of the package's kernel sources."""
    dst = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, dst)
    return dst


def test_sources_are_every_unit_and_header(csrc):
    names = [p.name for p in _build.sources(csrc)]
    assert names == sorted(names)
    assert "flash_attention.cu" in names and "hopper.cuh" in names
    assert {"flash_fwd_sm90.cu", "flash_dq_sm90.cu",
            "flash_dkv_sm90.cu"} <= set(names)
    (csrc / "notes.txt").write_text("not a source")
    assert "notes.txt" not in [p.name for p in _build.sources(csrc)]


@pytest.mark.parametrize("name", ["hopper.cuh", "flash_fwd_sm90.cu",
                                  "flash_dq_sm90.cu", "extra.h"])
def test_a_changed_source_or_header_changes_the_library_path(csrc, name):
    before = _build.library_path(csrc)
    assert before == _build.library_path(csrc)  # deterministic
    path = csrc / name
    text = path.read_text() if path.exists() else ""
    path.write_text(text + "\n// changed\n")
    after = _build.library_path(csrc)
    assert after != before
    assert after.parent == _build.BUILD_DIR and after.suffix == ".so"


def test_the_path_follows_the_flags(csrc, monkeypatch):
    before = _build.library_path(csrc)
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build.library_path(csrc) != before


def test_flags_target_hopper_sm90a():
    for flags in (_build.NVCC_FLAGS, _build.LINK_FLAGS):
        i = flags.index("-gencode")
        assert flags[i + 1] == "arch=compute_90a,code=sm_90a"
    assert "-shared" in _build.LINK_FLAGS
    assert "-Xptxas" in _build.NVCC_FLAGS  # the register and spill report


def test_nvcc_path_names_cuda_home_when_no_compiler(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    real_is_file = _build.Path.is_file
    monkeypatch.setattr(_build.Path, "is_file",
                        lambda self: False if self.name == "nvcc"
                        else real_is_file(self))
    with pytest.raises(RuntimeError, match="CUDA_HOME"):
        _build.nvcc_path()


def test_nvcc_path_prefers_cuda_home(tmp_path, monkeypatch):
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text("")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    assert _build.nvcc_path() == str(nvcc)


# a declaration or definition of a C entry point: result type, name, params
_DECL = re.compile(r"\b(int|const\s+char\s*\*)\s+(hvd_\w+)\s*\(([^)]*)\)")
_RESULT = {"int": ctypes.c_int, "const char*": ctypes.c_char_p}


def _ctype(param):
    """The ctypes type that carries one C parameter."""
    if "*" in param or param.startswith("cudaStream_t"):
        return ctypes.c_void_p
    if param.startswith("float "):
        return ctypes.c_float
    if param.startswith("int "):
        return ctypes.c_int
    raise AssertionError(f"no ctypes rule for the parameter {param!r}")


def _c_entry_points():
    """Every declaration and definition of an ``hvd_*`` function under
    csrc/, by name: [(result type, [parameter, ...]), ...]."""
    found = {}
    for src in _build.sources():
        text = re.sub(r"//[^\n]*", "", src.read_text())
        for ret, name, params in _DECL.findall(text):
            ret = re.sub(r"\s+", " ", ret).replace(" *", "*")
            params = [" ".join(x.split()) for x in params.split(",")]
            found.setdefault(name, []).append((ret, params))
    return found


def test_entry_point_table_matches_the_c_declarations():
    """ctypes passes whatever it is given: an entry point missing from the
    table, or one argument too few or of the wrong kind, is a silent
    memory fault on the card. Each declaration and definition of every
    ``hvd_*`` function must agree with ``ENTRY_POINTS`` argument by
    argument."""
    found = _c_entry_points()
    assert set(found) == set(_build.ENTRY_POINTS)
    assert {"hvd_flash_dq", "hvd_flash_dq_sm90"} <= set(found)
    for name, decls in found.items():
        argtypes, restype = _build.ENTRY_POINTS[name]
        for ret, params in decls:
            assert len(params) == len(argtypes), (name, params)
            assert [_ctype(x) for x in params] == argtypes, (name, params)
            assert _RESULT[ret] is restype, name
    # the launcher of each Hopper kernel is declared once and defined once
    for name in ("hvd_flash_fwd_sm90", "hvd_flash_dq_sm90",
                 "hvd_flash_dkv_sm90"):
        assert len(found[name]) == 2, name


def test_load_declares_every_entry_point(tmp_path, monkeypatch):
    class Fn:
        argtypes = restype = None

    class Lib:
        def __init__(self, path):
            self.path = path

        def __getattr__(self, name):
            if not name.startswith("hvd_"):
                raise AttributeError(name)
            fn = Fn()
            setattr(self, name, fn)
            return fn

    built = tmp_path / "libhvd_kernels.so"
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "build", lambda: built)
    monkeypatch.setattr(_build.ctypes, "CDLL", Lib)
    lib = _build.load()
    assert lib.path == str(built)
    for name, (argtypes, restype) in _build.ENTRY_POINTS.items():
        fn = getattr(lib, name)
        assert fn.argtypes == argtypes and fn.restype is restype, name
    assert _build.load() is lib  # loaded once


_FAKE_NVCC = """#!/bin/sh
# writes each -o target after a pause, and logs its call
echo "$@" >> "$(dirname "$0")/calls.log"
sleep 0.5
while [ $# -gt 0 ]; do
    if [ "$1" = "-o" ]; then echo fake > "$2"; fi
    shift
done
"""

_BUILD_ONCE = """
import sys
from pathlib import Path
from horovod_tpu_torch import _build
_build.BUILD_DIR = Path(sys.argv[1])
print(_build.build())
"""


def test_concurrent_builds_compile_once(tmp_path):
    """Processes of one host that load the kernels at once (the ranks of a
    job, or a worker started while another builds) build them once under
    the file lock, and all take the one library."""
    import os
    import subprocess
    import sys

    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text(_FAKE_NVCC)
    nvcc.chmod(0o755)
    repo = _build.PACKAGE_DIR.parent
    env = dict(os.environ, CUDA_HOME=str(tmp_path / "cuda"),
               PYTHONPATH=str(repo))
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_ONCE,
                               str(tmp_path / "build")], env=env,
                              stdout=subprocess.PIPE, text=True)
             for _ in range(3)]
    outs = [p.communicate(timeout=120)[0].strip() for p in procs]
    assert [p.returncode for p in procs] == [0, 0, 0]
    want = str(tmp_path / "build" / _build.library_path().name)
    assert outs == [want] * 3
    units = [s for s in _build.sources() if s.suffix == ".cu"]
    calls = (nvcc.parent / "calls.log").read_text().splitlines()
    assert len(calls) == len(units) + 1  # one compile each, one link


def test_setup_names_every_package_of_the_port():
    """An installed port imports only what ``setup.py`` lists: every
    directory of ``horovod_tpu_torch`` with an ``__init__.py`` must be
    there, and the launcher's console script."""
    import ast

    repo = _build.PACKAGE_DIR.parent
    setup = next(node for node in ast.walk(ast.parse(
        (repo / "setup.py").read_text()))
        if isinstance(node, ast.Call) and getattr(node.func, "id", "") ==
        "setup")
    kw = {k.arg: ast.literal_eval(k.value) for k in setup.keywords
          if k.arg in ("packages", "entry_points")}
    want = {".".join(p.parent.relative_to(repo).parts)
            for p in _build.PACKAGE_DIR.rglob("__init__.py")}
    assert {"horovod_tpu_torch.run", "horovod_tpu_torch.ckpt"} <= want
    assert want <= set(kw["packages"])
    assert ("hvdrun-torch = horovod_tpu_torch.run.run:main"
            in kw["entry_points"]["console_scripts"])
