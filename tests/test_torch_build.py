"""The kernel build of horovod_tpu_torch, on the CPU and with no nvcc: the
cache key covers every source and header, the flags target Hopper, and a
missing compiler is named."""

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
    assert {"flash_fwd_sm90.cu", "flash_dkv_sm90.cu"} <= set(names)
    (csrc / "notes.txt").write_text("not a source")
    assert "notes.txt" not in [p.name for p in _build.sources(csrc)]


@pytest.mark.parametrize("name", ["hopper.cuh", "flash_fwd_sm90.cu",
                                  "extra.h"])
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
