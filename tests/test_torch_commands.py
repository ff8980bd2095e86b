"""The port's commands against the JAX package's: every installed
console script of ``setup.py`` and every script of ``bin/`` has a
``-torch`` twin that runs the port's entry point, from a checkout with
nothing installed and with ``jax`` and ``horovod_tpu`` unimportable (and
torch too, for the launcher, the lint and the doctor's hang, perf and
serve reports); ``bin/hvd-doctor-torch`` gives JAX's ``doctor_cli`` exit
code and ``--json`` report on the same dumps, for each subcommand; and
the launcher's multi-host hint names the port's own launcher.

The scripts run as files (``chip_smoke.start_script``: ``runpy`` in a
process whose ``sys.modules`` holds ``None`` for each blocked name, so
that importing one raises ``ImportError``). The dumps are written by the
writers of the port's doctor tests: the flight recorder's scenarios
(``test_torch_diag.py``), both packages' goodput ledgers
(``test_torch_goodput.py``), a serving trace and X-ray summaries
(``test_torch_xray.py``)."""

import ast
import contextlib
import io
import json
import os
import subprocess
import sys
import textwrap
import types

import pytest

from horovod_tpu.diag import recorder as jrec
from horovod_tpu.diag.doctor import doctor_cli as jax_doctor_cli
from horovod_tpu.telemetry import ledger as jled
from horovod_tpu.telemetry import registry as jreg
from horovod_tpu_torch.diag import recorder as trec
from horovod_tpu_torch.telemetry import ledger as tled
from horovod_tpu_torch.telemetry import registry as treg
from test_torch_diag import SCENARIOS, _write
from test_torch_goodput import _synth_dump
from test_torch_xray import _exposed, _overlapped

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke as cs  # noqa: E402

NO_TORCH = cs.NO_JAX + ("torch",)
# the JAX package's bin/ scripts; each has a twin named <name>-torch
JAX_SCRIPTS = sorted(n for n in os.listdir(os.path.join(REPO, "bin"))
                     if os.path.isfile(os.path.join(REPO, "bin", n))
                     and not n.endswith("-torch"))


def _console_scripts():
    setup = next(node for node in ast.walk(ast.parse(
        open(os.path.join(REPO, "setup.py")).read()))
        if isinstance(node, ast.Call) and getattr(node.func, "id", "") ==
        "setup")
    kw = {k.arg: ast.literal_eval(k.value) for k in setup.keywords
          if k.arg == "entry_points"}
    return dict(tuple(s.strip() for s in line.split("=", 1))
                for line in kw["entry_points"]["console_scripts"])


# -- (a) the installed console scripts ----------------------------------------

@pytest.mark.parametrize("name", ["hvd-doctor", "hvd-lint", "hvd-serve",
                                  "hvdrun"])
def test_every_console_script_has_a_torch_twin(name):
    """``<name>-torch`` runs the port's module of the same path and the
    same function as JAX's ``<name>``, and that callable imports."""
    import importlib
    scripts = _console_scripts()
    assert {n for n in scripts if not n.endswith("-torch")} == {
        "hvd-doctor", "hvd-lint", "hvd-serve", "hvdrun"}
    target = scripts[name]
    assert target.startswith("horovod_tpu.")
    twin = scripts[f"{name}-torch"]
    assert twin == "horovod_tpu_torch." + target[len("horovod_tpu."):]
    module, func = twin.split(":")
    assert callable(getattr(importlib.import_module(module), func))


# -- (b) the checkout's scripts -----------------------------------------------

@pytest.mark.parametrize("name", JAX_SCRIPTS)
def test_every_bin_script_has_a_torch_twin(name):
    """``bin/<name>-torch`` exists, is executable, imports nothing of JAX
    or the JAX package, and its ``--help`` exits 0 naming the port's
    command with ``jax`` and ``horovod_tpu`` unimportable (torch too,
    but for the server)."""
    assert JAX_SCRIPTS == ["hvd-doctor", "hvd-lint", "hvd-serve", "hvdrun"]
    twin = f"{name}-torch"
    path = os.path.join(REPO, "bin", twin)
    assert os.access(path, os.X_OK)
    imported = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            imported |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            imported.add(node.module.split(".")[0])
    assert imported == {"os", "sys", "horovod_tpu_torch"}
    blocked = cs.NO_JAX if name == "hvd-serve" else NO_TORCH
    p = cs.start_script(twin, ["--help"], blocked=blocked)
    out, err = p.communicate(timeout=240)
    assert p.returncode == 0, err[-3000:]
    assert out.startswith(f"usage: {twin}"), out[:200]


# -- (c) the twin of tests/test_analysis.py's bin/hvd-lint check --------------

def test_bin_hvd_lint_torch_runs_without_jax(tmp_path):
    """The analysis package is pure stdlib and ``import
    horovod_tpu_torch`` loads no torch, so a lint-only CI job on a
    machine WITHOUT jax or torch still lints (``jax`` and ``torch``
    shadowed by modules that raise, as the JAX package's test shadows
    ``jax``)."""
    shadow = tmp_path / "shadow"
    shadow.mkdir()
    for mod in ("jax", "torch"):
        (shadow / f"{mod}.py").write_text(
            f"raise ImportError('no {mod} on this machine')\n")
    (tmp_path / "horovod_tpu_torch").mkdir()
    (tmp_path / "horovod_tpu_torch" / "m.py").write_text(textwrap.dedent("""
        def a():
            try:
                return 1
            except Exception:
                return 0
    """))
    env = dict(os.environ, PYTHONPATH=str(shadow))
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "bin", "hvd-lint-torch"),
         "--root", str(tmp_path)],
        capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 1, (out.stdout, out.stderr)
    assert "HVD-EXCEPT" in out.stdout
    assert "no jax" not in out.stderr and "no torch" not in out.stderr


# -- (d) bin/hvd-doctor-torch against JAX's doctor_cli -------------------------

def _hang_dumps(d):
    scripts, size, _ = SCENARIOS["dead rank"]
    _write(trec, d / "port", scripts, size)
    _write(jrec, d / "jax", scripts, size)


def _perf_dumps(d):
    (d / "e1").mkdir(parents=True)
    _synth_dump(tled, treg, d, 0, {"data_wait": 3.0, "ckpt_stall": 0.5})
    _synth_dump(jled, jreg, d, 1, {"data_wait": 2.0, "compile": 1.0})
    _synth_dump(tled, treg, d / "e1", 2, {"compile": 0.5})


def _serve_dumps(d):
    from horovod_tpu_torch.serve.tracing import RequestTrace, ServeTracer
    tracer = ServeTracer(sample=1.0, out_dir=str(d))
    for i, (start, end) in enumerate([(0.5, 1.0), (0.2, 3.0)]):
        tr = RequestTrace(f"r-{i}", clock=lambda: 0.0)
        tr.phase(0.0, "queued")
        tr.span("prefill", start, end, actor="default")
        tr.phase(end, "decoding")
        tracer.finish(tr, end=end + 1.0)
    tracer.close()


def _xray_dumps(d):
    from horovod_tpu.telemetry import xprof as jxprof
    from horovod_tpu_torch.telemetry import xprof
    xprof.write_summary(xprof.attribute(_overlapped()), str(d), rank=0)
    jxprof.write_summary(jxprof.attribute(_exposed()), str(d), rank=1)


DOCTOR_DUMPS = {"hang": _hang_dumps, "perf": _perf_dumps,
                "serve": _serve_dumps, "xray": _xray_dumps}


def _jax_doctor(argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = jax_doctor_cli(list(argv))
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("sub", sorted(DOCTOR_DUMPS))
def test_bin_hvd_doctor_torch_is_jax_doctor_cli(sub, tmp_path):
    """``bin/hvd-doctor-torch <sub> <dir>`` with and without ``--json``
    (and the bare ``<dir>`` form for ``hang``) on dumps of both packages
    gives the exit code, report and ``--json`` output of JAX's
    ``doctor_cli`` in this process on the same directory; an empty
    directory exits 2 in both. The X-ray needs torch; the others run
    without it."""
    dumps = tmp_path / "dumps"
    dumps.mkdir()
    DOCTOR_DUMPS[sub](dumps)
    (tmp_path / "empty").mkdir()
    calls = [[sub, str(dumps), "--json"], [sub, str(dumps)],
             [sub, str(tmp_path / "empty")]]
    if sub == "hang":
        calls += [[str(dumps), "--json"]]
    blocked = cs.NO_JAX if sub == "xray" else NO_TORCH
    procs = [cs.start_script("hvd-doctor-torch", argv, blocked=blocked)
             for argv in calls]
    try:
        want = [_jax_doctor(argv) for argv in calls]
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    got = [(p.returncode, out, err) for p, (out, err) in zip(procs, outs)]
    for argv, (rc, out, err), (jrc, jout, _) in zip(calls, got, want):
        assert rc == jrc, (argv, err[-3000:])
        if "--json" in argv:
            assert json.loads(out) == json.loads(jout), argv
        else:
            assert out == jout, argv
    assert [rc for rc, _, _ in got] == [0, 0, 2] + [0] * (len(calls) - 3)


# -- (e) the launcher's multi-host hint ---------------------------------------

def test_multi_host_hint_names_the_ports_launcher(tmp_path):
    """After a failed job across hosts the launcher tells the user to
    rerun ``hvdrun-torch --doctor`` over the collected dumps, never JAX's
    ``hvdrun``; the report follows."""
    import importlib
    run_mod = importlib.import_module("horovod_tpu_torch.run.run")
    scripts, size, _ = SCENARIOS["dead rank"]
    _write(trec, tmp_path, scripts, size)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        run_mod._maybe_doctor(types.SimpleNamespace(no_doctor=False,
                                                    num_proc=size),
                              str(tmp_path), multi_host=True)
    text = err.getvalue()
    assert "MULTI-HOST job" in text
    assert "rerun `hvdrun-torch --doctor <dir>`" in text
    assert "`hvdrun --doctor" not in text
    assert "dead rank" in text.lower()
