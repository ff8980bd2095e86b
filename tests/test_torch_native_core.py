"""The port's binding to the native host core (horovod_tpu_torch/_core.py),
held against the JAX package's shim (horovod_tpu/_core.py) and numpy.

Each shim runs in its own worker processes (``torch_core_worker.py``),
one process a rank, so no process loads both libraries. At world 2 and 3
the port's shim runs ``native_worker.py``'s scenarios (every collective,
Adasum at world 2, the negotiated errors, uneven Join, the response cache's control
bytes, cache invalidation, the zero-copy borrow) with the core's
timeline on; both shims run the parity scenario, whose results must
agree bit for bit, and with numpy where the inputs are whole numbers.
A third spawn runs the autotuner to convergence through the port's shim.
The start rule of ``basics.native_core`` and the config run in-process
and load no core; ``--check-build``, the library a fresh process maps
and an installed package's build of the core from the sources it ships
run in subprocesses."""

import json
import os
import socket
import subprocess
import sys
import types

import numpy as np
import pytest

import torch_core_worker as w

from horovod_tpu_torch import _core

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
WORKER = os.path.join(TESTS, "torch_core_worker.py")
SCENARIOS = ("collectives", "adasum", "errors", "join", "join_cached",
             "join_allgather", "timeline", "cache_bytes",
             "cache_invalidation", "zerocopy")


@pytest.fixture(scope="module")
def built():
    """The checkout's builds of the core, the port's (one g++ a source,
    about 15 s on 8 idle cores) and the JAX package's (``make``; this
    process loads neither), made before the spawns, whose limit counts
    only their run."""
    from horovod_tpu import _core as jax_core
    jax_core.build()
    return _core.build()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(extra=None):
    # no HOROVOD_* of the pytest process reaches a worker
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("HOROVOD_")}
    env["PYTHONPATH"] = REPO
    env.update(extra or {})
    return env


def _spawn(runs, out, timeout=120):
    """Start every ``(shim, scenarios, size, env)`` run at once, one
    process a rank, and wait for all; returns each run's per-rank info
    dicts."""
    procs = []
    for shim, scenarios, size, env in runs:
        port = _free_port()
        for r in range(size):
            log = open(os.path.join(out, f"{shim}.rank{r}.log"), "w")
            procs.append((shim, r, log, subprocess.Popen(
                [sys.executable, WORKER, shim, ",".join(scenarios), str(r),
                 str(size), str(port), out], env=env, stdout=log,
                stderr=subprocess.STDOUT, cwd=REPO)))
    try:
        for shim, r, log, p in procs:
            rc = p.wait(timeout=timeout)
            log.close()
            assert rc == 0, (shim, r, open(log.name).read()[-4000:])
    finally:
        for *_, log, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    infos = {}
    for shim, scenarios, size, _ in runs:
        infos[shim] = []
        for r in range(size):
            with open(os.path.join(out, f"{shim}.rank{r}.json")) as f:
                infos[shim].append(json.load(f))
    return infos


def _world(size, out):
    """One spawn a world size: the port's shim through every scenario and
    the parity scenario, the JAX shim through the parity scenario."""
    out = str(out)
    timeline = os.path.join(out, "timeline.json")
    # Adasum's tree needs a power-of-two world
    scenarios = tuple(s for s in SCENARIOS if s != "adasum" or size == 2)
    infos = _spawn([
        ("port", scenarios + ("parity",), size,
         _env({"HOROVOD_TIMELINE": timeline})),
        ("jax", ("parity",), size, _env()),
    ], out)
    results = {shim: [dict(np.load(os.path.join(out, f"{shim}.rank{r}.npz")))
                      for r in range(size)] for shim in ("port", "jax")}
    return types.SimpleNamespace(size=size, out=out, infos=infos,
                                 results=results, scenarios=scenarios)


def _scenarios_and_timeline_through_the_port(world):
    """``native_worker.py``'s scenarios passed through the port's shim on
    every rank (their asserts ran in the workers), and rank 0's core
    wrote its timeline of negotiations."""
    port = world.infos["port"]
    for info in port:
        assert all(f"seconds.{s}" in info for s in world.scenarios)
    assert port[0]["timeline_negotiations"] > 0


def _parity_bit_for_bit_with_the_jax_shim(world):
    port, jax = world.results["port"], world.results["jax"]
    for r in range(world.size):
        assert sorted(port[r]) == sorted(jax[r])
        for name in port[r]:
            a, b = port[r][name], jax[r][name]
            assert a.dtype == b.dtype and a.shape == b.shape, name
            assert a.tobytes() == b.tobytes(), (r, name)
    # Adasum runs at a power-of-two world
    assert ("adasum.float32" in port[0]) == (world.size == 2)
    # the negotiated error's message, but for which two shapes it names:
    # the first request to arrive is the core's reference
    shapes = {f"[{3 + r}]" for r in range(world.size)}
    for info in world.infos["port"] + world.infos["jax"]:
        head, _, pair = info["error"].partition(" (")
        assert head == "tensor err.shape: mismatched shapes across ranks", \
            info["error"]
        a, _, b = pair.rstrip(")").partition(" vs ")
        assert a != b and {a, b} <= shapes, info["error"]


def _numpy_allreduce(xs, op, size):
    if op == "min":
        return np.minimum.reduce(xs)
    if op == "max":
        return np.maximum.reduce(xs)
    total = np.sum(xs, axis=0, dtype=xs[0].dtype)
    if op == "sum":
        return total
    # the core scales in double and stores through float (cpu_ops.cc)
    scaled = total.astype(np.float64) * (1.0 / size)
    if xs[0].dtype == np.float16:
        scaled = scaled.astype(np.float32)
    return scaled.astype(xs[0].dtype)


def _parity_against_numpy(world):
    """Every op on whole numbers, which every order of the ring's sums
    gives exactly: the port's results equal numpy's bit for bit."""
    n, res = world.size, world.results["port"]
    rows = [(n + 1) // n + (1 if r < (n + 1) % n else 0) for r in range(n)]
    starts = np.concatenate([[0], np.cumsum(rows)])
    for d in w.INT_DTYPES + w.FLOAT_DTYPES:
        xs = [w.ints(r, d, (5, 3)) for r in range(n)]
        gathered = np.concatenate([w.ints(r, d, (r + 1, 3))
                                   for r in range(n)])
        a2a = [w.ints(r, d, (2 * n, 2)) for r in range(n)]
        rs = [w.ints(r, d, (n + 1, 3)) for r in range(n)]
        for r in range(n):
            got = res[r]
            for op in w.OPS:
                want = _numpy_allreduce(xs, op, n)
                assert got[f"ar.{op}.{d}"].tobytes() == want.tobytes(), \
                    (r, op, d)
            assert got[f"ag.{d}"].tobytes() == gathered.tobytes(), d
            assert got[f"bc.{d}"].tobytes() == xs[1].tobytes(), d
            want = np.concatenate([x[2 * r:2 * r + 2] for x in a2a])
            assert got[f"a2a.{d}"].tobytes() == want.tobytes(), d
            for op in ("sum", "average"):
                full = _numpy_allreduce(rs, op, n)
                want = full[starts[r]:starts[r + 1]]
                assert got[f"rs.{op}.{d}"].shape == want.shape
                assert got[f"rs.{op}.{d}"].tobytes() == want.tobytes(), \
                    (r, op, d)
    bools = [w.ints(r, "bool", (4, 2)) for r in range(n)]
    scaled = np.sum([w.ints(r, "float32", (7,)) * np.float32(2.0)
                     for r in range(n)], axis=0, dtype=np.float32) * 0.5
    for r in range(n):
        assert res[r]["ag.bool"].tobytes() == np.concatenate(bools).tobytes()
        assert res[r]["bc.bool"].tobytes() == bools[1].tobytes()
        assert res[r]["ar.scaled"].tobytes() == \
            scaled.astype(np.float32).tobytes()
        assert res[r]["ip.bc"].tobytes() == \
            w.ints(1, "int32", (64,)).tobytes()
    # the uneven join: rank 0 joined first, the others averaged over the
    # ranks still active; the last to join is one of them, on every rank
    late = [w.ints(r, "float32", (4,)) for r in range(1, n)]
    want = _numpy_allreduce(late, "average", n - 1) if n > 2 else late[0]
    for r in range(1, n):
        assert res[r]["jn.1"].tobytes() == want.tobytes()
    infos = world.infos["port"]
    assert len({i["last"] for i in infos}) == 1 and infos[0]["last"] >= 1
    if n == 2:
        assert infos[0]["last"] == 1
    assert all("mismatched shapes" in i["error"] for i in infos)
    assert all(min(i["control_bytes"]) > 0 for i in infos)
    assert all(not i["autotune"]["enabled"] for i in infos)


def _each_worker_maps_only_its_own_library(world):
    for shim, infos in world.infos.items():
        for info in infos:
            libs = info["libraries"]
            assert len(libs) == 1, libs
            if shim == "port":
                assert "/horovod_tpu_torch/_build/libhvdcore-" in libs[0]
            else:
                assert libs[0].endswith("/horovod_tpu/lib/libhvdcore.so")


@pytest.mark.parametrize("size", [2, 3], ids=["world2", "world3"])
def test_port_shim_against_the_jax_shim_and_numpy(size, tmp_path, built):
    """One spawn a world size (each shim in its own workers), held by
    every check below."""
    world = _world(size, tmp_path)
    _scenarios_and_timeline_through_the_port(world)
    _parity_bit_for_bit_with_the_jax_shim(world)
    _parity_against_numpy(world)
    _each_worker_maps_only_its_own_library(world)


def test_autotune_converges_through_the_port(tmp_path, built):
    """The autotuner's loop converges within its sample budget, and both
    ranks end on the coordinator's parameters (``autotune_state``)."""
    log = tmp_path / "autotune.csv"
    _spawn([("port", ("autotune",), 2, _env({
        "HOROVOD_AUTOTUNE": "1", "HOROVOD_AUTOTUNE_LOG": str(log),
        "HOROVOD_AUTOTUNE_WARMUP_SAMPLES": "1",
        "HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE": "2",
        "HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES": "6"}))], str(tmp_path))
    tuned = []
    for r in range(2):
        text = (tmp_path / f"port.rank{r}.log").read_text()
        tuned.append([line for line in text.splitlines()
                      if line.startswith("TUNED ")][0])
    assert tuned[0] == tuned[1]
    assert any(line.startswith("converged,")
               for line in log.read_text().splitlines())


def test_the_core_starts_at_first_use_by_the_launchers_rule(monkeypatch):
    """``init()``'s services start no core; ``basics.native_core`` starts
    one at first use: of size 1 in a one-rank job, the job's through
    ``services.start_core`` where the launcher named a controller, and
    none (it raises) in a job of more ranks without one. The config
    reads the launcher's controller variables as the JAX package's
    does."""
    from horovod_tpu.config import Config as JConfig

    from horovod_tpu_torch import basics
    from horovod_tpu_torch.config import Config
    from horovod_tpu_torch.runtime import services

    calls = []
    monkeypatch.setattr(_core, "is_initialized", lambda: False)
    monkeypatch.setattr(_core, "build", lambda: calls.append("build"))
    monkeypatch.setattr(_core, "init", lambda **kw: calls.append(kw))
    monkeypatch.setattr(services, "start_core",
                        lambda state, cfg: calls.append(("job", cfg.size)))
    state = basics._State()
    state.config = Config(size=2, rank=0, controller_addr="127.0.0.1",
                          flightrec=False)
    services.start(state)
    services.stop(state)
    assert calls == [] and state.controller is None
    monkeypatch.setattr(basics, "_state", state)
    state.initialized = True
    for cfg, want in ((Config(size=1), [{"rank": 0, "size": 1}]),
                      (Config(size=2, controller_addr="127.0.0.1"),
                       [("job", 2)])):
        calls.clear()
        state.config = cfg
        assert basics.native_core() is _core
        assert calls == want
    calls.clear()
    state.config = Config(size=2)
    with pytest.raises(RuntimeError, match="runs no native core"):
        basics.native_core()
    assert calls == []
    env = {"HOROVOD_CONTROLLER_ADDR": "10.1.2.3",
           "HOROVOD_CONTROLLER_PORT": "4567"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    mine, ref = Config.from_env(), JConfig.from_env()
    assert (mine.controller_addr, mine.controller_port) == \
        (ref.controller_addr, ref.controller_port) == ("10.1.2.3", 4567)


_PROBE = """
import json, sys
from horovod_tpu_torch.run.run import check_build
check_build()
with open("/proc/self/maps") as f:
    libs = sorted({l.split()[-1] for l in f if "libhvdcore" in l})
print("MAPS", json.dumps(libs))
print("JAX" if any(m.startswith(("jax", "horovod_tpu."))
                   or m == "horovod_tpu" for m in sys.modules) else "NOJAX")
"""


def test_check_build_lists_the_core_and_a_process_loads_the_port_library():
    rv = subprocess.run([sys.executable, "-c", _PROBE], env=_env(),
                        cwd=REPO, capture_output=True, text=True,
                        timeout=300)
    assert rv.returncode == 0, rv.stderr
    out = rv.stdout
    assert "[X] TCP (native host core)" in out
    assert ("[X] host ring collectives (allreduce/allgatherv/broadcast/"
            "alltoall/reducescatter/Adasum)") in out
    maps = [line for line in out.splitlines() if line.startswith("MAPS")]
    libs = json.loads(maps[0][len("MAPS "):])
    assert len(libs) == 1 and "/horovod_tpu_torch/_build/libhvdcore-" in \
        libs[0], libs
    assert "horovod_tpu/lib" not in out
    assert out.strip().endswith("NOJAX")


_SETUP = """
import runpy, subprocess, sys
# setup.py's build_py first makes the JAX package's core (cxx/Makefile);
# that step builds nothing of the port and is left out here
subprocess.check_call = lambda *a, **k: 0
sys.argv = ["setup.py", "-q", "egg_info", "--egg-base", sys.argv[1],
            "build_py", "--build-lib", sys.argv[2]]
runpy.run_path("setup.py", run_name="__main__")
"""

_INSTALLED = """
import json
import numpy as np
from horovod_tpu_torch import _core
lib = _core.build()
_core.init(rank=0, size=1)
out = _core.allreduce(np.arange(4, dtype=np.float32), "one", op="sum")
_core.shutdown()
print("INSTALLED", json.dumps(dict(cxx=str(_core.CXX_DIR), lib=str(lib),
                                   out=out.tolist())))
"""


def test_an_installed_port_builds_its_core_from_the_shipped_sources(
        tmp_path):
    """``setup.py``'s ``build_py`` (the files an install copies) ships
    ``cxx/``'s sources and headers in the package's ``_cxx/``; a process
    that imports the port from that layout alone builds the core from
    them into the installed package's ``_build/``, under the checkout's
    hash, and runs it."""
    lib_dir = tmp_path / "lib"
    rv = subprocess.run([sys.executable, "-c", _SETUP, str(tmp_path),
                         str(lib_dir)], env=_env(), cwd=REPO,
                        capture_output=True, text=True, timeout=120)
    assert rv.returncode == 0, rv.stderr[-4000:]
    pkg = lib_dir / "horovod_tpu_torch"
    shipped = sorted(p.relative_to(pkg / "_cxx").as_posix()
                     for p in (pkg / "_cxx").rglob("*") if p.is_file())
    assert shipped == sorted(
        p.relative_to(_core.CXX_DIR).as_posix() for p in _core.sources())
    env = _env()
    env["PYTHONPATH"] = str(lib_dir)
    rv = subprocess.run([sys.executable, "-c", _INSTALLED], env=env,
                        cwd=tmp_path, capture_output=True, text=True,
                        timeout=600)
    assert rv.returncode == 0, rv.stderr[-4000:]
    line = [x for x in rv.stdout.splitlines() if x.startswith("INSTALLED")]
    got = json.loads(line[0][len("INSTALLED "):])
    assert got["cxx"] == str(pkg / "_cxx")
    assert got["lib"] == str(pkg / "_build" / _core.library_path().name)
    assert got["out"] == [0.0, 1.0, 2.0, 3.0]
