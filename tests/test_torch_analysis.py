"""The port's hvd-lint (``horovod_tpu_torch/analysis``) against the JAX
package's (``horovod_tpu/analysis``), on the CPU.

* Every fixture of ``tests/test_analysis.py`` for the five rules the two
  packages share (HVD-DESYNC, HVD-LOCKORDER, HVD-SIGSAFE, HVD-EXCEPT,
  HVD-METRIC) and for the engine's mechanics (suppressions, the dated
  shrink-only baseline, the walk) runs twice, by running that file's own
  test functions: once with its ``run_lint`` linting through both
  engines, whose findings (rule, file, line, message, fingerprint),
  suppressions, baselined and stale entries must be equal; once with its
  ``engine``, ``run_lint`` and ``LintError`` the port's, so the JAX
  test's own assertions hold for the port.
* The CLIs: exit codes 0, 1 and 2 and ``--format json`` equal, step for
  step, on the same fixture; the port's default targets and baseline
  name; ``python -m horovod_tpu_torch.analysis.cli`` with neither torch
  nor JAX importable.
* The torch twins of HVD-HOSTSYNC, HVD-MESH and HVD-DISTINIT on positive
  and negative fixtures in torch idiom (JAX's ``test_hostsync_*``,
  ``test_mesh_*``, ``test_distinit_*``).
* The port's tree is clean under ``.hvd-lint-torch-baseline.json``.
"""

import ast
import importlib.util
import json
import os
import subprocess
import sys
import textwrap

import pytest

from horovod_tpu.analysis import cli as jcli
from horovod_tpu.analysis import engine as jengine
from horovod_tpu_torch import analysis as panalysis
from horovod_tpu_torch.analysis import cli as pcli
from horovod_tpu_torch.analysis import engine as pengine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TESTS = os.path.join(REPO, "tests", "test_analysis.py")
BASELINE = os.path.join(REPO, ".hvd-lint-torch-baseline.json")

# the shared rules' fixtures and the engine's mechanics in test_analysis.py
_SHARED = ("test_desync_", "test_lockorder_", "test_sigsafe_",
           "test_except_", "test_metric_", "test_positional_",
           "test_suppression_", "test_baseline_", "test_overlapping_",
           "test_parallel_walk_", "test_unparseable_")


def _jax_fixture_tests():
    tree = ast.parse(open(JAX_TESTS).read())
    return [n.name for n in tree.body if isinstance(n, ast.FunctionDef)
            and n.name.startswith(_SHARED)]


def _load_jax_tests():
    """A private copy of tests/test_analysis.py, so patching its globals
    touches nothing else."""
    spec = importlib.util.spec_from_file_location("_jax_test_analysis",
                                                  JAX_TESTS)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _view(result):
    key = (lambda f: (f.rule, f.file, f.line, f.col, f.message,
                      f.fingerprint))
    return dict(findings=[key(f) for f in result.findings],
                all_findings=sorted(key(f) for f in result.all_findings),
                suppressed=sorted(key(f) for f in result.suppressed),
                baselined=sorted(key(f) for f in result.baselined),
                stale=result.stale_baseline, files=result.files,
                walked=result.walked, clean=result.clean)


def _lint_both(*args, **kw):
    """``run_lint`` through both engines: the views must be equal (or
    both raise ``LintError`` with the same text); returns JAX's."""
    try:
        got = pengine.run_lint(*args, **kw)
    except pengine.LintError as e:
        with pytest.raises(jengine.LintError) as want:
            jengine.run_lint(*args, **kw)
        assert str(e) == str(want.value)
        raise want.value
    want = jengine.run_lint(*args, **kw)
    assert _view(got) == _view(want)
    return want


@pytest.mark.parametrize("mode", ["both_engines", "port_engine"])
@pytest.mark.parametrize("name", _jax_fixture_tests())
def test_jax_fixture_through_the_port(tmp_path, name, mode):
    mod = _load_jax_tests()
    if mode == "both_engines":
        mod.run_lint = _lint_both
    else:
        mod.run_lint = pengine.run_lint
        mod.engine = pengine
        mod.LintError = pengine.LintError
    getattr(mod, name)(tmp_path)


# ---- the CLIs ------------------------------------------------------------

_EXCEPT_SRC = """
    def a():
        try:
            return 1
        except Exception:
            return 0
"""

_CLEAN_SRC = _EXCEPT_SRC.replace("except Exception", "except ValueError")


def _cli(main, root, *argv, capsys):
    rc = main(["--root", str(root)] + list(argv))
    out, err = capsys.readouterr()
    return rc, out, err


def test_cli_exit_codes_and_json_match_jax(tmp_path, capsys):
    """The steps of JAX's ``test_cli_exit_codes_and_json`` through both
    CLIs on the same fixture (``pkg/m.py``): the same exit codes, the
    same ``--format json`` documents, a baseline written then failing as
    stale, engine errors as 2."""
    roots = {}
    for name in ("jax", "port"):
        root = tmp_path / name
        (root / "pkg").mkdir(parents=True)
        (root / "pkg" / "m.py").write_text(textwrap.dedent(_EXCEPT_SRC))
        roots[name] = root
    mains = {"jax": jcli.main, "port": pcli.main}

    def both(*argv, edit=None):
        out = {}
        for name, root in roots.items():
            if edit is not None:
                (root / "pkg" / "m.py").write_text(edit)
            out[name] = _cli(mains[name], root,
                             *[str(root / a) if a == "pkg" else a
                               for a in argv], capsys=capsys)
        return out

    runs = both("pkg")
    assert runs["port"][0] == runs["jax"][0] == 1
    assert "HVD-EXCEPT" in runs["port"][1] and "m.py:5" in runs["port"][1]
    runs = both("pkg", "--format", "json")
    assert json.loads(runs["port"][1]) == json.loads(runs["jax"][1])
    assert json.loads(runs["port"][1])["findings"][0]["rule"] == \
        "HVD-EXCEPT"
    runs = both("pkg", "--baseline", "write")
    assert runs["port"][0] == runs["jax"][0] == 0
    assert (roots["port"] / ".hvd-lint-torch-baseline.json").exists()
    assert not (roots["port"] / ".hvd-lint-baseline.json").exists()
    runs = both("pkg", "--format", "json")
    assert runs["port"][0] == runs["jax"][0] == 0
    assert json.loads(runs["port"][1]) == json.loads(runs["jax"][1])
    runs = both("pkg", "--format", "json",
                edit=textwrap.dedent(_CLEAN_SRC))
    assert runs["port"][0] == runs["jax"][0] == 1
    assert json.loads(runs["port"][1]) == json.loads(runs["jax"][1])
    assert json.loads(runs["port"][1])["stale_baseline"]
    assert "STALE-BASELINE" in both("pkg")["port"][1]
    runs = both("pkg", edit="def broken(:\n")
    assert runs["port"][0] == runs["jax"][0] == 2
    assert "cannot parse" in runs["port"][2]
    runs = both("pkg", "--rules", "NOT-A-RULE")
    assert runs["port"][0] == runs["jax"][0] == 2
    runs = both("pkg", "--baseline", "write", "--baseline-file",
                str(tmp_path / "nodir" / "base.json"))
    assert runs["port"][0] == runs["jax"][0] == 2
    assert "hvd-lint-torch: error:" in runs["port"][2]
    assert _cli(pcli.main, tmp_path / "missing-root", capsys=capsys)[0] == 2


def test_cli_module_runs_without_torch_or_jax(tmp_path):
    """``python -m horovod_tpu_torch.analysis.cli`` lints the port's
    default targets (``horovod_tpu_torch/`` and ``chip_smoke.py``) where
    neither torch nor JAX imports, and ``horovod_tpu_torch.analysis``
    imports neither them nor ``horovod_tpu``."""
    shadow = tmp_path / "shadow"
    shadow.mkdir()
    for mod in ("jax", "torch"):
        (shadow / f"{mod}.py").write_text(
            f"raise ImportError('no {mod} on this machine')\n")
    root = tmp_path / "root"
    (root / "horovod_tpu_torch").mkdir(parents=True)
    (root / "horovod_tpu_torch" / "m.py").write_text(
        textwrap.dedent(_EXCEPT_SRC))
    (root / "chip_smoke.py").write_text(textwrap.dedent(_EXCEPT_SRC))
    (root / "elsewhere.py").write_text(textwrap.dedent(_EXCEPT_SRC))
    env = dict(os.environ, PYTHONPATH=f"{shadow}{os.pathsep}{REPO}")
    out = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.analysis.cli", "--root",
         str(root), "--format", "json"],
        capture_output=True, text=True, env=env, cwd=str(tmp_path))
    assert out.returncode == 1, (out.stdout, out.stderr)
    files = {f["file"] for f in json.loads(out.stdout)["findings"]}
    assert files == {"horovod_tpu_torch/m.py", "chip_smoke.py"}
    probe = subprocess.run(
        [sys.executable, "-c",
         "import sys, horovod_tpu_torch.analysis\n"
         "bad = [m for m in sys.modules if m.split('.')[0] in "
         "('jax', 'torch', 'horovod_tpu')]\n"
         "assert not bad, bad\n"],
        capture_output=True, text=True, env=env, cwd=str(tmp_path))
    assert probe.returncode == 0, probe.stderr
    assert pcli.BASELINE_NAME == ".hvd-lint-torch-baseline.json"
    assert {os.path.relpath(t, REPO)
            for t in pengine.default_targets(REPO)} == {
        "horovod_tpu_torch", "chip_smoke.py"}


# ---- the torch twins -----------------------------------------------------

def lint_src(tmp_path, src, name="mod.py", rules=None):
    p = tmp_path / name
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(src))
    return panalysis.run_lint([str(tmp_path)], root=str(tmp_path),
                              rules=rules)


def rules_of(result):
    return sorted({f.rule for f in result.findings})


def test_hostsync_flags_syncs_in_compiled_fn(tmp_path):
    r = lint_src(tmp_path, """
        import time
        import numpy as np
        import torch
        def loss(model, batch):
            v = model(batch).mean()
            print("dbg", v)
            host = np.asarray(v)
            torch.cuda.synchronize()
            time.sleep(0.1)
            return float(v) + int(v) + v.item() + v.cpu() + host
        step = torch.compile(loss)
    """)
    assert rules_of(r) == ["HVD-HOSTSYNC"]
    kinds = " ".join(f.message for f in r.findings)
    for marker in ("print", "np.asarray", "torch.cuda.synchronize",
                   "`float()`", "`int()`", ".item()", ".cpu()",
                   "time.sleep"):
        assert marker in kinds, marker
    assert all("inside a compiled or train-step function" in f.message
               for f in r.findings)


def test_hostsync_decorator_and_step_builder_entries(tmp_path):
    r = lint_src(tmp_path, """
        import functools
        import torch
        from horovod_tpu_torch import training

        @torch.compile
        def a(x):
            return float(x)

        @torch.compile(mode="reduce-overhead")
        def b(x):
            return x.item()

        @functools.partial(torch.compile, fullgraph=True)
        def c(x):
            return x.cpu()

        def loss_fn(logits, targets):
            return logits.tolist()
        step = training.make_train_step(model, opt, loss_fn=loss_fn)
        lm_step = training.make_lm_train_step(model, opt, loss=loss_fn)
    """)
    assert len(r.findings) == 4
    assert rules_of(r) == ["HVD-HOSTSYNC"]


def test_hostsync_negative_outside_the_step_and_host_metadata(tmp_path):
    r = lint_src(tmp_path, """
        import numpy as np
        import torch
        def logger_hook(loss):
            return float(np.asarray(loss.cpu()).item())
        def traced(x):
            n = float(x.numel()) + int(x.shape[0]) + int(len(x))
            return x * 2 / n + x.size(0)
        step = torch.compile(traced)
        hook = compile("1 + 1", "<s>", "eval")
    """)
    assert r.findings == []


def test_hostsync_suppression_is_justified_as_in_jax(tmp_path):
    r = lint_src(tmp_path, """
        import torch
        def f(x):
            return x.item()  # hvd-lint: disable=HVD-HOSTSYNC -- read once at the end of a run
        g = torch.compile(f)
    """)
    assert r.findings == [] and len(r.suppressed) == 1


def test_mesh_flags_raw_groups_but_not_the_mesh_layer(tmp_path):
    pkg = tmp_path / "horovod_tpu_torch"
    (pkg / "parallel").mkdir(parents=True)
    (pkg / "hot.py").write_text(
        "import torch.distributed as dist\n"
        "from torch.distributed.device_mesh import DeviceMesh, "
        "init_device_mesh\n"
        "g = dist.new_group([0, 1])\n"
        "m = DeviceMesh('cuda', [0, 1])\n"
        "n = init_device_mesh('cuda', (2,))\n")
    for layer in ("mesh.py", "axis.py", "gspmd.py"):
        (pkg / "parallel" / layer).write_text(
            "import torch.distributed as dist\n"
            "from torch.distributed.device_mesh import DeviceMesh\n"
            "g = dist.new_group([0, 1])\n"
            "m = DeviceMesh('cuda', [0, 1])\n")
    r = panalysis.run_lint([str(pkg)], root=str(tmp_path))
    hits = [f for f in r.findings if f.rule == "HVD-MESH"]
    assert [(f.file, f.line) for f in hits] == [
        ("horovod_tpu_torch/hot.py", 3), ("horovod_tpu_torch/hot.py", 4),
        ("horovod_tpu_torch/hot.py", 5)]
    assert hits[0].message == ("explicit `new_group(` call site off the "
                               "logical mesh")


def test_mesh_negative_other_groups(tmp_path):
    r = lint_src(tmp_path, """
        import itertools
        from horovod_tpu_torch.parallel import mesh
        m = mesh.build_mesh((2, 2), ("data", "seq"))
        g, ranks = m.group_of(("data",))
        pairs = itertools.groupby([1, 1, 2])
    """)
    assert [f for f in r.findings if f.rule == "HVD-MESH"] == []


def test_distinit_flags_rogue_init_but_not_the_entry_point(tmp_path):
    pkg = tmp_path / "horovod_tpu_torch"
    cluster = pkg / "cluster"
    cluster.mkdir(parents=True)
    (pkg / "rogue.py").write_text(
        "import torch.distributed as dist\n"
        "dist.init_process_group('gloo', init_method='tcp://h:1',\n"
        "                        world_size=2, rank=0)\n")
    (pkg / "sneaky.py").write_text(
        "from torch.distributed import init_process_group\n"
        "init_process_group('nccl')\n")
    (cluster / "procmesh.py").write_text(
        "import torch.distributed as dist\n"
        "def ensure_distributed():\n"
        "    dist.init_process_group('gloo')\n")
    r = panalysis.run_lint([str(pkg)], root=str(tmp_path))
    hits = [f for f in r.findings if f.rule == "HVD-DISTINIT"]
    assert [f.file for f in hits] == ["horovod_tpu_torch/rogue.py",
                                      "horovod_tpu_torch/sneaky.py"]
    assert "ensure_distributed" in hits[0].hint
    assert hits[0].message == ("torch.distributed.init_process_group "
                               "outside the sanctioned cluster entry point")


def test_distinit_negative_other_initializers(tmp_path):
    r = lint_src(tmp_path, """
        import torch.distributed as dist
        from horovod_tpu_torch.cluster import procmesh
        def setup(app):
            procmesh.ensure_distributed()
            dist.is_initialized()
            app.init_process()
            dist.new_subgroups()
    """)
    assert [f for f in r.findings if f.rule == "HVD-DISTINIT"] == []


def test_desync_knows_torch_distributed_names(tmp_path):
    """``dist.get_rank()`` is rank-dependent and ``dist.all_reduce``,
    ``broadcast_object_list`` and the port's in-place forms are
    collectives."""
    r = lint_src(tmp_path, """
        import torch.distributed as dist
        from horovod_tpu_torch.ops import collective, fusion
        def save(x, objs, ts):
            if dist.get_rank() == 0:
                dist.all_reduce(x)
                dist.broadcast_object_list(objs, src=0)
                collective.broadcast_(x, root_rank=0)
                fusion.fused_allreduce_(ts)
            dist.all_gather_into_tensor(x, x)
    """)
    assert [(f.rule, f.line) for f in r.findings] == [
        ("HVD-DESYNC", 6), ("HVD-DESYNC", 7), ("HVD-DESYNC", 8),
        ("HVD-DESYNC", 9)]


# ---- the port's tree -----------------------------------------------------

def test_port_tree_is_clean_under_its_baseline():
    """No unbaselined finding and no stale entry over
    ``horovod_tpu_torch/`` and ``chip_smoke.py``; every entry dated."""
    result = panalysis.run_lint(panalysis.default_targets(REPO), root=REPO,
                                baseline_path=BASELINE)
    assert result.clean, (
        "\n".join(f.format() for f in result.findings)
        + "".join(f"\nstale baseline: {e}" for e in result.stale_baseline))
    entries = panalysis.load_baseline(BASELINE)
    assert entries and all(
        len(e["date"]) == 10 and e["date"].count("-") == 2 for e in entries)
    assert result.files > 100
    assert set(panalysis.all_rules()) == set(jengine.all_rules())
