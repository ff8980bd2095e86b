"""The port's ``runtime/stall.py`` against the JAX package's
``runtime/stall.py`` on fake clocks (``tests/test_stall.py``'s cases,
each on both packages), and its wiring into ``init()``'s services under
``HOROVOD_ELASTIC=1`` (the inspector, the elastic worker's heartbeat
reporter, the eviction handler; all gone after ``shutdown()``)."""

import time

import pytest

from horovod_tpu.runtime import stall as jstall
from horovod_tpu.telemetry import get_registry as jregistry
from horovod_tpu.telemetry import instruments as jinst
from horovod_tpu_torch.runtime import stall as tstall
from horovod_tpu_torch.telemetry import get_registry as tregistry
from horovod_tpu_torch.telemetry import instruments as tinst

PACKAGES = {
    "jax": (jstall.StallInspector, lambda: jregistry().get(
        jinst.STALLED_RANKS).value, "horovod_tpu"),
    "port": (tstall.StallInspector, lambda: tregistry().get(
        tinst.STALLED_RANKS).value, "horovod_tpu_torch"),
}


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _warnings(caplog, logger):
    return [r for r in caplog.records
            if r.name == logger and "stalled" in r.message]


def _script(pkg, caplog, script, **kw):
    """Run ``script`` (a list of ("advance", dt) / ("progress", step) /
    ("check",) ops) on a fresh inspector of ``pkg``; returns, per check,
    ``(stalled, gauge, shutdown_requested, warnings so far)``."""
    cls, gauge, logger = PACKAGES[pkg]
    caplog.clear()
    clk = FakeClock(kw.pop("t0", 0.0))
    fired = []
    insp = cls(clock=clk, on_shutdown=lambda: fired.append(1), **kw)
    out = []
    with caplog.at_level("WARNING", logger=logger):
        for op, *arg in script:
            if op == "advance":
                clk.advance(arg[0])
            elif op == "progress":
                insp.record_progress(step=arg[0])
            else:
                stalled = insp.check_once()
                out.append((sorted(stalled), gauge(),
                            insp.shutdown_requested,
                            len(_warnings(caplog, logger)), len(fired)))
    return out


SCRIPTS = {
    # no warning before the threshold
    "below": (dict(warning_time=60.0),
              [("advance", 59.0), ("check",)]),
    # once per episode
    "once": (dict(warning_time=60.0),
             [("advance", 61.0), ("check",), ("check",)]),
    # progress resets the episode; a second stall warns again
    "episodes": (dict(warning_time=60.0),
                 [("advance", 61.0), ("check",), ("progress", 1),
                  ("check",), ("advance", 61.0), ("check",)]),
    # the shutdown threshold, its hook once
    "shutdown": (dict(warning_time=10.0, shutdown_time=30.0),
                 [("advance", 15.0), ("check",), ("advance", 16.0),
                  ("check",), ("check",)]),
    # no shutdown without a threshold
    "no_shutdown": (dict(warning_time=10.0),
                    [("advance", 1e6), ("check",)]),
    # the cluster view names the stalled ranks
    "heartbeats": (dict(warning_time=60.0, t0=100.0,
                        heartbeat_fn=lambda: {0: 95.0, 1: 20.0, 2: 10.0}),
                   [("check",)]),
    # the loop's cadence is check_interval: a shutdown below the warning
    "interval": (dict(warning_time=600.0, shutdown_time=5.0,
                      check_interval=0.01),
                 [("advance", 6.0), ("check",)]),
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_check_once_matches_jax_at_every_tick(caplog, name):
    """The same fake-clock script on both inspectors: the stalled ranks,
    the ``hvd_stalled_ranks`` gauge, the shutdown flag, the warnings and
    the hook's calls agree at every check."""
    kw, script = SCRIPTS[name]
    got = _script("port", caplog, script, **dict(kw))
    want = _script("jax", caplog, script, **dict(kw))
    assert got == want


def test_the_cases_of_the_jax_tests(caplog):
    """``tests/test_stall.py``'s expectations, on the port."""
    run = {name: _script("port", caplog, script, **dict(kw))
           for name, (kw, script) in SCRIPTS.items()}
    assert run["below"] == [([], 0, False, 0, 0)]
    assert run["once"] == [([-1], 1, False, 1, 0)] * 2
    assert run["episodes"] == [([-1], 1, False, 1, 0),
                               ([], 0, False, 1, 0),
                               ([-1], 1, False, 2, 0)]
    assert [c[2] for c in run["shutdown"]] == [False, True, True]
    assert run["shutdown"][-1][4] == 1  # the hook fired once
    assert run["no_shutdown"] == [([-1], 1, False, 1, 0)]
    assert run["heartbeats"][0][:2] == ([1, 2], 2)
    assert run["interval"][0][1:3] == (0, True)


def test_loop_runs_with_real_clock():
    insp = tstall.StallInspector(warning_time=0.01, shutdown_time=0.02,
                                 check_interval=0.01)
    assert insp._check_interval == 0.01  # not derived from warning_time
    insp.start()
    deadline = time.monotonic() + 5.0
    while not insp.shutdown_requested and time.monotonic() < deadline:
        time.sleep(0.01)
    insp.stop()
    assert insp.shutdown_requested


def test_progress_listeners_feed_the_heartbeat():
    steps = []
    insp = tstall.StallInspector(warning_time=60.0)
    insp.add_progress_listener(steps.append)
    insp.add_progress_listener(lambda s: 1 / 0)  # a bad listener is logged
    insp.record_progress(3)
    insp.record_progress(4)
    assert steps == [3, 4]


def test_elastic_init_starts_the_inspector_and_the_eviction_handler(
        monkeypatch):
    """``init()`` under ``HOROVOD_ELASTIC=1`` (no native core needed):
    the stall inspector with the worker's heartbeat reporter attached,
    the eviction handler (after the recorder); ``shutdown()`` takes them
    down. ``HOROVOD_STALL_CHECK_DISABLE`` leaves the inspector out."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import basics
    from horovod_tpu_torch.elastic import preempt, worker

    hvd.shutdown()
    monkeypatch.setenv("HOROVOD_ELASTIC", "1")
    monkeypatch.setenv("HOROVOD_STALL_CHECK_TIME_SECONDS", "30")
    hvd.init(device="cpu")
    try:
        insp = basics._state.stall_inspector
        assert insp is not None and insp._warning_time == 30.0
        ctx = worker.get_worker_context()
        assert ctx is not None and ctx.attached_to_inspector
        assert ctx.report_progress in insp._progress_listeners
        assert preempt.get_handler() is basics._state.preempt_handler
        assert preempt.get_handler().installed
    finally:
        hvd.shutdown()
    assert basics._state.stall_inspector is None
    assert worker.get_worker_context() is None
    assert preempt.get_handler() is None
    monkeypatch.setenv("HOROVOD_STALL_CHECK_DISABLE", "1")
    hvd.init(device="cpu")
    try:
        assert basics._state.stall_inspector is None
        assert preempt.get_handler() is not None
    finally:
        hvd.shutdown()
    monkeypatch.delenv("HOROVOD_ELASTIC")
    monkeypatch.delenv("HOROVOD_STALL_CHECK_DISABLE")
    hvd.init(device="cpu")
    try:
        assert basics._state.stall_inspector is None
        assert preempt.get_handler() is None  # no opt-in, no handler
    finally:
        hvd.shutdown()
