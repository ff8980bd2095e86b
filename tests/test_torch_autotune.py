"""The port's slope-window timer (``utils/benchmarks.py``: ``WindowTime``,
``slope_window``, ``repeat_step_windows`` and its throughput views
``repeat_throughput`` and ``timed_throughput``) and fusion autotuner
(``ops/fusion.py``: ``AutotuneTimings``, ``autotune_fusion_threshold``)
against the JAX package's, on the CPU.

* The timers run on one scripted clock (``time.perf_counter``) with
  scripted per-iteration and per-sync costs: a clean slope, an inverted
  set then a clean one, two inverted sets (the upper bound), and a fixed
  cost on the mid windows only (asymmetric). Values, flags, calls and
  warnings equal JAX's exactly; so do they under the port's ``agree``
  hook at the identity, and a joint slope that inverts reruns the set.
  The throughput views run on the clock at dyadic costs: rates and
  windows equal JAX's exactly.
* The tuner's twins of ``tests/test_fusion.py``'s autotune tests run in
  this process on a mesh whose data axis counts 2 over this one rank (the
  trials' collectives reduce over one rank; the tuner sees a world of 2),
  each beside the JAX test on its 8-device mesh with the same fake
  windows; the world-1 abstention beside JAX's on a one-device mesh.
* One spawn of 2 gloo ranks: each rank injects its own slope windows,
  and the winner, timings, ``retried``, ``slope_window_escalations`` and
  ``abstain_reason`` equal JAX's run on windows that are the two ranks'
  sums, also where only one rank's window is a bound; both ranks install
  the same config; an unfaked run where only rank 1's window inverts
  keeps both ranks' collectives paired; a ``DistributedOptimizer``
  built before the tuner takes the installed wire on its next exchange;
  unfaked runs (trials 2) on both axes; every wire of a chunked-only grid
  is ranked (the port's departure: JAX's eager fallback drops them).
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys
import textwrap
import time
import types
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd_t
from horovod_tpu.ops import fusion as jfusion
from horovod_tpu.parallel import mesh as jmesh
from horovod_tpu.utils import benchmarks as jbench
from horovod_tpu_torch import basics
from horovod_tpu_torch.ops import fusion as pfusion
from horovod_tpu_torch.parallel import mesh as pmesh
from horovod_tpu_torch.utils import benchmarks as pbench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRIALS = 2


# ---- slope_window on a scripted clock ------------------------------------

class _Clock:
    """``perf_counter`` of a fake clock: each step adds ``step_cost``,
    each sync pops its cost from ``sync_costs`` (then 0)."""

    def __init__(self, step_cost, sync_costs):
        self.t, self.step_cost = 0.0, step_cost
        self.sync_costs = list(sync_costs)
        self.steps = 0

    def perf_counter(self):
        return self.t

    def step_once(self, st):
        self.t += self.step_cost
        self.steps += 1
        return st + 1, st

    def sync(self, *_):
        self.t += self.sync_costs.pop(0) if self.sync_costs else 0.0


def _rounds(*per_window):
    """Sync costs of 3 rounds of (base, mid, full) windows."""
    return list(per_window) * 3


# iters 4: windows of 2, 4, 6 iterations; the flush window costs nothing
_CLEAN = [0.0] + _rounds(0.1, 0.1, 0.1)
_INVERTED = _rounds(1.0, 0.5, 0.0)
SCRIPTS = {
    "clean": (0.01, _CLEAN),
    "inverted_then_clean": (0.01, [0.0] + _INVERTED + _rounds(0.1, 0.1,
                                                              0.1)),
    "inverted_twice": (0.01, [0.0] + _INVERTED + _INVERTED),
    "asymmetric": (0.01, [0.0] + _rounds(0.0, 0.05, 0.0)),
}


def _timed(bench, monkeypatch, script, fn):
    step_cost, sync_costs = script
    clock = _Clock(step_cost, sync_costs)
    monkeypatch.setattr(time, "perf_counter", clock.perf_counter)
    monkeypatch.setattr(bench, "sync", clock.sync)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = fn(bench, clock)
    return out, clock.steps, [(w.category, str(w.message)) for w in caught]


def _window(dt):
    return (float(dt), dt.upper_bound, dt.asymmetric, type(dt).__name__)


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_slope_window_matches_jax(monkeypatch, script):
    def run(bench, clock):
        dt, st = bench.slope_window(clock.step_once, 0, 4)
        return _window(dt), st

    got = _timed(pbench, monkeypatch, SCRIPTS[script], run)
    want = _timed(jbench, monkeypatch, SCRIPTS[script], run)
    assert got == want
    (value, upper, asym, _), _ = got[0]
    assert upper == (script == "inverted_twice")
    assert asym == (script == "asymmetric")
    if script in ("clean", "inverted_then_clean"):
        assert value == pytest.approx(0.04)
    assert bool(got[2]) == (script in ("inverted_twice", "asymmetric"))


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_slope_window_agree(monkeypatch, script):
    """``agree``: the identity (one process) equals JAX on every script;
    a world whose least slope is this rank's but inverted once reruns
    the set and keeps this rank's slope; one inverted throughout makes
    the result an upper bound, as a second inversion here would."""
    def run(agree):
        def go(bench, clock):
            kw = {} if agree is None else dict(agree=agree)
            dt, st = bench.slope_window(clock.step_once, 0, 4, **kw)
            return _window(dt), st
        return go

    got = _timed(pbench, monkeypatch, SCRIPTS[script], run(lambda s: s))
    assert got == _timed(jbench, monkeypatch, SCRIPTS[script], run(None))
    if script != "clean":
        return
    asked = []

    def once(slope):
        asked.append(slope)
        return -1.0 if len(asked) == 1 else slope

    (window, _), steps, caught = _timed(pbench, monkeypatch,
                                        SCRIPTS[script], run(once))
    assert window[:3] == (pytest.approx(0.04), False, False)
    assert steps == 1 + 2 * 36 and len(asked) == 2 and not caught
    (window, _), steps, caught = _timed(pbench, monkeypatch,
                                        SCRIPTS[script], run(lambda s: 0.0))
    assert window[:3] == (pytest.approx(0.06), True, False)
    assert steps == 1 + 2 * 36 and "inverted twice" in caught[0][1]


def test_repeat_step_windows_matches_jax(monkeypatch):
    """2 warm-up steps and 2 windows (the second inverted once, then
    clean): the windows, flags, step count and state equal JAX's."""
    script = (0.01, [0.0, 0.0] + _CLEAN + [0.0] + _INVERTED
              + _rounds(0.2, 0.2, 0.2))

    def run(bench, clock):
        runs, st = bench.repeat_step_windows(clock.step_once, 0, warmup=2,
                                             iters=4, repeats=2)
        return [_window(r) for r in runs], st

    got = _timed(pbench, monkeypatch, script, run)
    want = _timed(jbench, monkeypatch, script, run)
    assert got == want
    assert len(got[0][0]) == 2 and got[1] == 2 + 2 * (1 + 36) + 36


def test_repeat_throughput_propagates_window_times():
    """The twin of ``tests/test_benchmarks_util.py``'s test: each of the
    repeats is a positive rate beside its ``WindowTime``."""
    def step(state, images, labels):
        return state, torch.zeros(())

    imgs = np.zeros((4, 1))
    runs = pbench.repeat_throughput(step, 0, imgs, None, warmup=0, iters=3,
                                    repeats=2)
    assert len(runs) == 2
    for rate, dt in runs:
        assert isinstance(dt, pbench.WindowTime)
        assert rate > 0


def test_every_benchmarks_helper_has_a_port_twin():
    """Each public function and class of JAX's ``utils/benchmarks.py``
    has its twin in the port's but ``cost_analysis_dict``, which only
    normalizes XLA's ``cost_analysis()`` and has no torch form."""
    def public(mod):
        return {n for n, v in vars(mod).items() if not n.startswith("_")
                and getattr(v, "__module__", None) == mod.__name__}

    assert public(jbench) - public(pbench) == {"cost_analysis_dict"}


# dyadic costs, so that every window, slope and rate is exact
_DYADIC_STEP = 2.0 ** -7
_DYADIC_CLEAN = _rounds(0.125, 0.125, 0.125)
_DYADIC_ASYMMETRIC = _rounds(0.0, 0.0625, 0.0)


@pytest.mark.parametrize("view", ["repeat", "timed"])
def test_throughput_views_match_jax(monkeypatch, view):
    """``repeat_throughput`` (2 warm-up steps, then a clean window, one
    inverted twice and an asymmetric one) and ``timed_throughput`` (one
    clean window) on one scripted clock: rates, ``WindowTime`` values,
    ``upper_bound``, ``asymmetric``, warnings and steps equal JAX's
    exactly; a clean window of 4 steps of 2^-7 s over 4 images reads
    512 img/s."""
    images, labels = np.zeros((4, 3, 8, 8), np.float32), np.zeros(4)
    if view == "repeat":
        script = (_DYADIC_STEP, [0.0, 0.0, 0.0] + _DYADIC_CLEAN + [0.0]
                  + _INVERTED + _INVERTED + [0.0] + _DYADIC_ASYMMETRIC)
    else:
        script = (_DYADIC_STEP, [0.0, 0.0] + _DYADIC_CLEAN)

    def run(bench, clock):
        def step(st, x, y):
            assert x is images and y is labels
            return clock.step_once(st)

        if view == "repeat":
            runs = bench.repeat_throughput(step, 0, images, labels,
                                           warmup=2, iters=4, repeats=3)
        else:
            runs = [bench.timed_throughput(step, 0, images, labels,
                                           warmup=1, iters=4)]
        return [(rate, _window(dt)) for rate, dt in runs]

    got = _timed(pbench, monkeypatch, script, run)
    want = _timed(jbench, monkeypatch, script, run)
    for (rate, _), (jrate, _) in zip(got[0], want[0]):
        assert type(rate) is type(jrate) is float
    assert got[0][0] == (512.0, (0.03125, False, False, "WindowTime"))
    flags = [w[1:3] for _, w in got[0]]
    if view == "repeat":
        assert flags == [(False, False), (True, False), (False, True)]
        assert got[1] == 2 + 3 + 36 + 2 * 36 + 36
    else:
        assert flags == [(False, False)] and got[1] == 1 + 1 + 36
    assert got == want


# ---- the tuner in this process -------------------------------------------

@pytest.fixture()
def port():
    hvd_t.shutdown()
    hvd_t.init(device="cpu")
    yield
    hvd_t.shutdown()


@pytest.fixture()
def world2(port):
    """A mesh whose data axis counts 2 over this one rank: the tuner sees
    a world of 2, the trials' collectives reduce over the one rank."""
    mesh = pmesh.get_mesh()
    pmesh.set_mesh(dataclasses.replace(mesh, shape=(2,)))
    yield
    pmesh.set_mesh(mesh)


def _result(best, timings):
    return (best, {k: (float(v), getattr(v, "upper_bound", False))
                   for k, v in timings.items()},
            timings.retried, timings.slope_window_escalations,
            timings.abstain_reason)


def _both(monkeypatch, make_fake, kw):
    """The port's tuner and JAX's with the same fake window (each
    package's ``WindowTime``); returns both results and both fakes'
    records."""
    out = []
    for bench, fusion, tensors in (
            (pbench, pfusion, [torch.ones(64)]),
            (jbench, jfusion, {"a": jnp.ones((64,))})):
        seen = []
        monkeypatch.setattr(bench, "slope_window", make_fake(bench, seen))
        best, timings = fusion.autotune_fusion_threshold(tensors, **kw)
        out.append((_result(best, timings), seen))
    return out


def test_autotune_uses_shared_timing_primitive(hvd, world2, monkeypatch):
    """Every trial goes through ``utils.benchmarks.slope_window`` and each
    call of a window sees a fresh salt."""
    def spying(bench, seen):
        real = bench.slope_window

        def spy(step_once, state, iters, base_iters=2, agree=None):
            salts = []
            seen.append(salts)

            def spy_step(st):
                salts.append(float(st[1]))
                return step_once(st)
            kw = {} if agree is None else dict(agree=agree)
            return real(spy_step, state, iters, base_iters=base_iters, **kw)
        return spy

    (_, p_seen), (_, j_seen) = _both(
        monkeypatch, spying,
        dict(candidates=[1 << 10, 1 << 20], trials=TRIALS, apply=False))
    for seen in (p_seen, j_seen):
        assert len(seen) >= 2
        for salts in seen:
            assert len(set(salts)) == len(salts)
    assert p_seen[0][:3] == j_seen[0][:3] == [1.0, 2.0, 3.0]


def test_autotune_retries_inverted_windows(hvd, world2, monkeypatch):
    def fake(bench, seen):
        def window(step_once, state, iters, base_iters=2, agree=None):
            seen.append(iters)
            return bench.WindowTime(0.1 * iters,
                                    upper_bound=(iters == 2)), state
        return window

    (got, p_iters), (want, j_iters) = _both(
        monkeypatch, fake,
        dict(candidates=[1 << 10, 1 << 20], trials=TRIALS, apply=False))
    assert got == want and p_iters == j_iters == [2, 8, 2, 8]
    best, values, retried, escalations, reason = got
    assert retried == 2 and escalations == 2 and reason is None
    for value, upper in values.values():
        assert not upper and value == pytest.approx(0.1 * 2)


def test_autotune_escalation_is_bounded_and_counted(hvd, world2,
                                                    monkeypatch):
    def bounded(bench, seen):
        def window(step_once, state, iters, base_iters=2, agree=None):
            seen.append(iters)
            return bench.WindowTime(0.1 * iters, upper_bound=True), state
        return window

    def clean(bench, seen):
        def window(step_once, state, iters, base_iters=2, agree=None):
            seen.append(iters)
            return bench.WindowTime(0.1 * iters), state
        return window

    kw = dict(candidates=[1 << 10], trials=TRIALS, apply=False)
    (got, p_iters), (want, j_iters) = _both(monkeypatch, bounded, kw)
    assert got == want and p_iters == j_iters == [2, 8, 32]
    assert got[0] is None and got[3] == 2
    (got, p_iters), (want, j_iters) = _both(monkeypatch, clean, kw)
    assert got == want and p_iters == j_iters == [2]
    assert got[2] == got[3] == 0


def test_autotune_abstains_on_unresolved_bounds(hvd, world2, monkeypatch):
    def bounded(bench, seen):
        def window(step_once, state, iters, base_iters=2, agree=None):
            return bench.WindowTime(0.1 * iters, upper_bound=True), state
        return window

    before = (basics._state.config.fusion_threshold,
              basics._state.config.wire_dtype)
    (got, _), (want, _) = _both(
        monkeypatch, bounded,
        dict(candidates=[1 << 10, 1 << 20], trials=TRIALS))
    assert got == want and got[0] is None
    assert "upper bounds" in got[4]
    assert all(upper for _, upper in got[1].values())
    assert (basics._state.config.fusion_threshold,
            basics._state.config.wire_dtype) == before


def test_autotune_abstains_at_world_one(port):
    """One rank over the axes: ``(None, {})`` with JAX's reason, word for
    word, and the config as it was."""
    old = jmesh._current_mesh
    import jax
    jmesh.set_mesh(jmesh.build_mesh(devices=[jax.devices()[0]]))
    try:
        want = jfusion.autotune_fusion_threshold(
            {"a": jnp.ones((64,))}, candidates=[1 << 10, 1 << 20],
            trials=TRIALS)
    finally:
        jmesh.set_mesh(old)
    cfg = basics._state.config
    before = (cfg.fusion_threshold, cfg.wire_dtype)
    got = pfusion.autotune_fusion_threshold(
        [torch.ones(64)], candidates=[1 << 10, 1 << 20], trials=TRIALS,
        wire_candidates=["none", "bf16", "int8"])
    assert got[0] is None and got[1] == {} == want[1]
    assert got[1].abstain_reason == want[1].abstain_reason
    assert "world size 1" in got[1].abstain_reason
    assert (cfg.fusion_threshold, cfg.wire_dtype) == before
    assert hvd_t.autotune_fusion_threshold is pfusion.autotune_fusion_threshold


def test_autotune_before_init_raises():
    """Without ``init()`` the port has no mesh and no world: the tuner
    raises as the port's other entry points do (JAX's falls back to its
    native core's world, which the port does not have)."""
    hvd_t.shutdown()
    with pytest.raises(RuntimeError, match="not been initialized"):
        pfusion.autotune_fusion_threshold([torch.ones(8)], trials=1)


def test_autotune_wire_axis_rejects_typo(port):
    with pytest.raises(ValueError, match="unknown wire dtype"):
        pfusion.autotune_fusion_threshold(
            [torch.ones(8)], candidates=[1 << 20], trials=1,
            wire_candidates=["int9"])


# ---- 2 gloo ranks: each rank its own windows, JAX on their sums ----------

MB = 1 << 20
# per key, the windows of its successive calls: ((rank 0, rank 1), bound),
# the bound for both ranks or (rank 0, rank 1). Dyadic values, so a sum of
# rank-normalized times and a normalized sum are the same float.
SCENARIOS = {
    "clean": dict(
        candidates=[MB, 4 * MB, 16 * MB], wires=None,
        windows=[[((0.5, 0.25), False)], [((0.25, 0.125), False)],
                 [((0.5, 0.5), False)]]),
    "escalation_clears": dict(
        candidates=[MB, 4 * MB], wires=None,
        windows=[[((0.5, 0.5), True), ((1.0, 0.5), False)],
                 [((0.25, 0.5), False)]]),
    "one_rank_inverts": dict(
        candidates=[MB, 4 * MB], wires=None,
        windows=[[((0.5, 0.5), (False, True)), ((1.0, 0.5), False)],
                 [((0.25, 0.5), False)]]),
    "unresolved_near_best": dict(
        candidates=[MB, 4 * MB], wires=None,
        windows=[[((0.25, 0.25), True)],
                 [((0.015625, 0.015625), False)]]),
    "wire_axis": dict(
        candidates=[MB, 4 * MB], wires=["none", "bf16", "int8"],
        windows=[[((0.5, 0.5), False)], [((0.375, 0.25), False)],
                 [((0.25, 0.25), False)], [((0.5, 0.25), False)],
                 [((0.25, 0.125), False)], [((0.125, 0.0625), False)]]),
}


def injected_window(bench, windows, rank, seen):
    """A ``slope_window`` that returns, for the key whose trials it is
    timing, its next scripted window: this rank's value and bound, or
    with ``rank=None`` the ranks' sum, a bound where either rank's is."""
    at = {"key": -1, "call": 0}

    def window(step_once, state, iters, base_iters=2, agree=None):
        if iters == TRIALS:  # a key's first window
            at["key"] += 1
            at["call"] = 0
        calls = windows[at["key"]]
        values, bound = calls[min(at["call"], len(calls) - 1)]
        at["call"] += 1
        seen.append((at["key"], iters))
        bounds = bound if isinstance(bound, tuple) else (bound, bound)
        if rank is None:
            value, bound = sum(values), any(bounds)
        else:
            value, bound = values[rank], bounds[rank]
        return bench.WindowTime(value, upper_bound=bound), state
    return window


def _jsonable(best, timings):
    return dict(best=list(best) if isinstance(best, tuple) else best,
                timings=[[list(k) if isinstance(k, tuple) else k,
                          float(v), bool(getattr(v, "upper_bound", False))]
                         for k, v in timings.items()],
                retried=timings.retried,
                escalations=timings.slope_window_escalations,
                reason=timings.abstain_reason)


def rank_checks(out_dir):
    """One gloo rank of the spawn (``HOROVOD_RANK``, ``HOROVOD_SIZE`` 2):
    each scenario of ``SCENARIOS`` on injected windows, the optimizer's
    wire, the unfaked runs, a chunked-only grid. Writes rank<r>.json."""
    from horovod_tpu_torch.ops import collective

    hvd_t.init(device="cpu")
    r = hvd_t.rank()
    cfg = basics._state.config
    default = (cfg.fusion_threshold, cfg.wire_dtype)
    res = {"default": list(default)}
    real_window = pbench.slope_window

    gen = torch.Generator().manual_seed(7)
    params = [torch.nn.Parameter(torch.randn(300, generator=gen)),
              torch.nn.Parameter(torch.randn(20, 10, generator=gen))]
    # built before the tuner installs its wire
    opt = hvd_t.DistributedOptimizer(torch.optim.SGD(params, lr=0.1))

    for name, sc in SCENARIOS.items():
        cfg.fusion_threshold, cfg.wire_dtype = default
        seen = []
        pbench.slope_window = injected_window(pbench, sc["windows"], r,
                                              seen)
        best, timings = pfusion.autotune_fusion_threshold(
            [torch.ones(64)], candidates=sc["candidates"], trials=TRIALS,
            wire_candidates=sc["wires"])
        res[name] = dict(_jsonable(best, timings), seen=seen,
                         config=[cfg.fusion_threshold, cfg.wire_dtype])
    pbench.slope_window = real_window

    # the wire installed by "wire_axis" on the optimizer built before it
    grads = [torch.randn(p.shape, generator=torch.Generator().manual_seed(
        11 + r)) for p in params]
    for p, g in zip(params, grads):
        p.grad = g.clone()
    opt.synchronize()
    want = pfusion.fused_allreduce(grads, compression="int8")
    exact = pfusion.fused_allreduce(grads)
    res["opt"] = dict(
        wire=opt.compression.name if opt.compression else None,
        equal_int8=all(torch.equal(p.grad, w)
                       for p, w in zip(params, want)),
        equal_exact=all(torch.equal(p.grad, w)
                        for p, w in zip(params, exact)))

    # unfaked: the threshold axis, then the joint axis
    cfg.fusion_threshold, cfg.wire_dtype = default
    tensors = [torch.ones(512), torch.ones(256), torch.ones(64, 8)]
    best, timings = pfusion.autotune_fusion_threshold(
        tensors, candidates=[1 << 10, 1 << 20], trials=TRIALS)
    res["real"] = dict(_jsonable(best, timings),
                       config=[cfg.fusion_threshold, cfg.wire_dtype],
                       summed=[t.tolist() for t in pfusion.fused_allreduce(
                           tensors, op=collective.Sum)])
    cfg.fusion_threshold, cfg.wire_dtype = default
    best, timings = pfusion.autotune_fusion_threshold(
        [torch.ones(512), torch.ones(64, 8)], candidates=[1 << 10, 1 << 20],
        trials=TRIALS, wire_candidates=["none", "int8"])
    res["real_joint"] = dict(_jsonable(best, timings),
                             config=[cfg.fusion_threshold, cfg.wire_dtype])

    # unfaked, but rank 1's clock stands still through both sets of the
    # first trial's window (reads 3 to 38): only its slope inverts, and
    # both ranks rerun, escalate and go on together
    reads = {"n": 0}

    def clock():
        reads["n"] += 1
        return (0.0 if r == 1 and 2 < reads["n"] <= 38
                else time.perf_counter())

    pbench.time = types.SimpleNamespace(perf_counter=clock)
    try:
        best, timings = pfusion.autotune_fusion_threshold(
            tensors, candidates=[1 << 10, 1 << 20], trials=TRIALS,
            apply=False)
    finally:
        pbench.time = time
    res["one_rank_real"] = _jsonable(best, timings)

    # a grid of chunked quantizers only: ranked, none dropped
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        best, timings = pfusion.autotune_fusion_threshold(
            [torch.ones(64)], candidates=[1 << 20], trials=TRIALS,
            apply=False, wire_candidates=["int8", "fp8_e4m3"])
    res["chunked"] = dict(_jsonable(best, timings),
                          warnings=[str(w.message) for w in caught])
    res["calls"] = pfusion._AUTOTUNE_CALLS.get("n", 0)
    with open(os.path.join(out_dir, f"rank{r}.json"), "w") as f:
        json.dump(res, f)
    hvd_t.shutdown()


_WORKER = textwrap.dedent("""
    import sys
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, {tests!r})
    from test_torch_autotune import rank_checks
    rank_checks({out!r})
""")


def _run_two_ranks(src, timeout=120):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for r in range(2):
        env = dict(os.environ, HOROVOD_RANK=str(r), HOROVOD_SIZE="2",
                   HOROVOD_LOCAL_RANK=str(r), HOROVOD_LOCAL_SIZE="2",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   PYTHONPATH=REPO, OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", src], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        for p in procs:
            _, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, err[-4000:]
    finally:
        for p in procs:
            p.kill()
            p.wait()


def _jax_on_sums(monkeypatch, sc):
    seen = []
    monkeypatch.setattr(jbench, "slope_window",
                        injected_window(jbench, sc["windows"], None, seen))
    best, timings = jfusion.autotune_fusion_threshold(
        {"a": jnp.ones((64,))}, candidates=sc["candidates"], trials=TRIALS,
        apply=False, wire_candidates=sc["wires"])
    return dict(_jsonable(best, timings), seen=seen)


def test_two_gloo_ranks_match_jax_on_summed_timings(hvd, tmp_path,
                                                    monkeypatch):
    """On 2 gloo ranks (one spawn):

    * each scenario of ``SCENARIOS`` (a clean winner, an inverted window
      that one escalation clears, an unresolved bound near the best, the
      wire axis none/bf16/int8; a window that only rank 1's inverts, which
      both escalate): the winner, timings and flags,
      ``retried``, ``slope_window_escalations``, ``abstain_reason`` and
      the windows asked for equal JAX's on the ranks' summed windows;
      both ranks install the same ``fusion_threshold`` and ``wire_dtype``
      (nothing where they abstain); one cross-rank sum a call;
    * the ``DistributedOptimizer`` built before the wire axis installed
      int8 exchanges at int8 on its next ``synchronize()``;
    * unfaked runs at trials 2 on both axes return a candidate or abstain
      with a reason, alike on both ranks, and install it;
    * an unfaked run whose first window inverts on rank 1 alone (its
      clock stands still): both ranks rerun the set and escalate
      together, so their collectives pair up, and they end with the same
      timings, ``retried`` and ``slope_window_escalations``;
    * a grid of chunked wires only is ranked whole, with no warning."""
    _run_two_ranks(_WORKER.format(tests=os.path.join(REPO, "tests"),
                                  out=str(tmp_path)))
    ranks = [json.loads((tmp_path / f"rank{r}.json").read_text())
             for r in range(2)]
    default = ranks[0]["default"]
    for name, sc in SCENARIOS.items():
        want = _jax_on_sums(monkeypatch, sc)
        got = [dict(ranks[r][name]) for r in range(2)]
        configs = [g.pop("config") for g in got]
        for g in got:
            g["seen"] = [tuple(s) for s in g["seen"]]
            assert g == want, name
        assert configs[0] == configs[1], name
        best = want["best"]
        if best is None:
            assert configs[0] == default
        elif sc["wires"] is None:
            assert configs[0] == [best, default[1]]
        else:
            assert configs[0] == [best[0], None if best[1] == "none"
                                  else best[1]]
    assert ranks[0]["escalation_clears"]["retried"] == 1
    assert ranks[0]["one_rank_inverts"]["escalations"] == 1
    assert ranks[0]["unresolved_near_best"]["best"] is None
    assert ranks[0]["wire_axis"]["best"] == [4 * MB, "int8"]
    assert all(r["calls"] == len(SCENARIOS) + 4 for r in ranks)

    for r in ranks:
        assert r["opt"] == dict(wire="int8", equal_int8=True,
                                equal_exact=False)

    for key, wires in (("real", None), ("real_joint", ["none", "int8"])):
        got = [r[key] for r in ranks]
        assert got[0]["best"] == got[1]["best"]
        assert got[0]["reason"] == got[1]["reason"]
        assert got[0]["config"] == got[1]["config"]
        keys = [k if wires is None else tuple(k)
                for k, _, _ in got[0]["timings"]]
        want_keys = ([1 << 10, 1 << 20] if wires is None else
                     [(t, w) for t in (1 << 10, 1 << 20) for w in wires])
        assert keys == want_keys
        assert all(v > 0 for _, v, _ in got[0]["timings"])
        if got[0]["best"] is None:
            assert got[0]["reason"]
            assert any(b for _, _, b in got[0]["timings"])
        elif wires is None:
            assert got[0]["config"][0] == got[0]["best"]
        else:
            assert got[0]["config"] == [
                got[0]["best"][0],
                None if got[0]["best"][1] == "none" else got[0]["best"][1]]
    assert ranks[0]["real"]["summed"] == [[2.0] * 512, [2.0] * 256,
                                          [[2.0] * 8] * 64]

    real = [r["one_rank_real"] for r in ranks]
    assert real[0] == real[1]
    assert real[0]["retried"] >= 1 and real[0]["escalations"] >= 1
    assert [k for k, _, _ in real[0]["timings"]] == [1 << 10, 1 << 20]

    for r in ranks:
        chunked = r["chunked"]
        assert [tuple(k) for k, _, _ in chunked["timings"]] == [
            (1 << 20, "int8"), (1 << 20, "fp8_e4m3")]
        assert not any("dropping chunked" in w for w in chunked["warnings"])
