"""Graceful eviction in the port (``horovod_tpu_torch/elastic/
preempt.py``), the doomed-host plane through its elastic driver, blame
(drained against crashed) and the blacklist's decay: every case of
``tests/test_preempt.py`` on the port, the blacklist's decisions against
the JAX package's under one fake clock, and the port's departure from
the JAX driver: a survivor's eviction caused by the launcher's fan-out
after a crash drains no host."""

import json
import os
import time

import pytest

from horovod_tpu.elastic.driver import Blacklist as JBlacklist
from horovod_tpu_torch.elastic import preempt
from horovod_tpu_torch.elastic.discovery import FixedHosts
from horovod_tpu_torch.elastic.driver import (DOOMED_TTL_S, EXIT_RENDEZVOUS,
                                              Blacklist, ElasticDriver)
from horovod_tpu_torch.elastic.preempt import (DOOMED_KEY_PREFIX,
                                               DOOMED_MARKER_KEY,
                                               GracefulEvictionHandler)
from horovod_tpu_torch.run.rendezvous import KVStoreServer

WIDTHS = ["--device", "cpu", "--layers", "1", "--d-model", "32", "--heads",
          "2", "--vocab", "64", "--seq-len", "16", "--batch", "2"]


# -- env knobs -----------------------------------------------------------

def test_grace_seconds_env_parsing():
    assert preempt.grace_seconds({}) == preempt.DEFAULT_GRACE_SECONDS
    assert preempt.grace_seconds({"HOROVOD_GRACE_SECONDS": "12.5"}) == 12.5
    assert preempt.grace_seconds({"HOROVOD_GRACE_SECONDS": "-3"}) == 0.0
    assert preempt.grace_seconds({"HOROVOD_GRACE_SECONDS": "nope"}) == \
        preempt.DEFAULT_GRACE_SECONDS


def test_configured_requires_an_explicit_opt_in():
    assert not preempt.configured({})
    assert preempt.configured({"HOROVOD_GRACE_SECONDS": "10"})
    assert preempt.configured({"HOROVOD_PREEMPT_NOTICE_FILE": "/p"})
    assert preempt.configured({"HOROVOD_PREEMPT_NOTICE_URL": "http://x"})


# -- the eviction, on a fake state, clock and exit ------------------------

class FakeState:
    def __init__(self, error=None):
        self.flush_timeouts = []
        self._error = error

    def flush(self, timeout=None):
        self.flush_timeouts.append(timeout)
        if self._error is not None:
            raise self._error


def _run_eviction(kind="sigterm", state="default", env=None, grace=5.0):
    codes = []
    handler = GracefulEvictionHandler(
        state=FakeState() if state == "default" else state,
        grace=grace, env=env if env is not None else {},
        exit_fn=codes.append)
    t = handler.trigger(kind)
    assert t is not None
    t.join(10.0)
    assert handler.finished.is_set()
    return handler, codes


def test_eviction_commits_within_grace_and_exits_clean():
    handler, codes = _run_eviction()
    assert handler.last["kind"] == "sigterm"
    assert handler.last["outcome"] == "committed"
    assert 0 < handler._state.flush_timeouts[0] <= 5.0
    assert codes == [0]


def test_eviction_exit_code_is_rendezvous_under_a_driver():
    _handler, codes = _run_eviction(env={"HOROVOD_ELASTIC_EPOCH": "2"})
    assert codes == [EXIT_RENDEZVOUS]


def test_eviction_timeout_and_error_outcomes():
    handler, codes = _run_eviction(state=FakeState(error=TimeoutError()))
    assert handler.last["outcome"] == "timeout"
    assert codes == [0]
    handler, _ = _run_eviction(state=FakeState(error=RuntimeError("disk")))
    assert handler.last["outcome"] == "error"
    handler, _ = _run_eviction(state=None)
    assert handler.last["outcome"] == "no-state"


def test_eviction_is_idempotent():
    codes = []
    handler = GracefulEvictionHandler(state=FakeState(), grace=1.0, env={},
                                      exit_fn=codes.append)
    first = handler.trigger("sigterm")
    assert handler.trigger("sigterm") is None
    first.join(10.0)
    assert codes == [0]
    assert len(handler._state.flush_timeouts) == 1


@pytest.fixture()
def kv():
    server = KVStoreServer()
    port = server.start()
    yield server, port
    server.stop()


def test_eviction_announces_doomed_host_on_kv(kv):
    server, port = kv
    env = {"HOROVOD_HOSTNAME": "spot-a", "HOROVOD_RANK": "1",
           "HOROVOD_GLOO_RENDEZVOUS_ADDR": "127.0.0.1",
           "HOROVOD_GLOO_RENDEZVOUS_PORT": str(port)}
    handler, _ = _run_eviction(env=env)
    assert handler.last["announced"]
    info = json.loads(server.get(DOOMED_KEY_PREFIX + "spot-a"))
    assert info["host"] == "spot-a" and info["kind"] == "sigterm"
    assert info["rank"] == 1 and info["time"] > 0
    assert json.loads(server.get(DOOMED_MARKER_KEY))["host"] == "spot-a"


def test_teardown_fanout_suppresses_second_announcement(kv):
    server, port = kv
    server.put(DOOMED_MARKER_KEY, json.dumps(
        {"host": "spot-b", "time": time.time()}).encode())
    env = {"HOROVOD_HOSTNAME": "spot-a",
           "HOROVOD_GLOO_RENDEZVOUS_ADDR": "127.0.0.1",
           "HOROVOD_GLOO_RENDEZVOUS_PORT": str(port),
           "HOROVOD_ELASTIC_EPOCH": "3"}
    handler, codes = _run_eviction(env=env)
    assert handler.last["kind"] == "teardown"
    assert not handler.last["announced"]
    assert handler.last["outcome"] == "committed"
    assert server.get(DOOMED_KEY_PREFIX + "spot-a") is None
    assert codes == [EXIT_RENDEZVOUS]


def test_stale_marker_from_other_host_does_not_suppress(kv):
    server, port = kv
    server.put(DOOMED_MARKER_KEY, json.dumps(
        {"host": "spot-b",
         "time": time.time() - 2 * preempt.TEARDOWN_WINDOW_S}).encode())
    env = {"HOROVOD_HOSTNAME": "spot-a",
           "HOROVOD_GLOO_RENDEZVOUS_ADDR": "127.0.0.1",
           "HOROVOD_GLOO_RENDEZVOUS_PORT": str(port)}
    handler, _ = _run_eviction(env=env)
    assert handler.last["kind"] == "sigterm" and handler.last["announced"]


def test_notice_file_polling_triggers_eviction(tmp_path):
    notice = tmp_path / "preempted"
    codes = []
    handler = GracefulEvictionHandler(
        state=FakeState(), grace=2.0, notice_file=str(notice),
        poll_interval=0.02, env={}, exit_fn=codes.append)
    handler.install()
    try:
        time.sleep(0.1)
        assert not handler.finished.is_set()
        notice.write_text("TRUE")
        assert handler.finished.wait(10.0)
        assert handler.last["kind"] == "notice:file"
        assert codes == [0]
    finally:
        handler.uninstall()


def test_install_idempotent_and_module_singleton():
    codes = []
    try:
        h1 = preempt.install(state=FakeState(), grace=1.0, env={},
                             exit_fn=codes.append)
        h2 = preempt.install()
        assert h1 is h2 is preempt.get_handler()
        fresh = FakeState()
        preempt.attach_state(fresh)
        assert h1._state is fresh
    finally:
        preempt.uninstall()
    assert preempt.get_handler() is None


def test_sigterm_rides_the_recorders_watcher(tmp_path):
    """With the flight recorder armed, SIGTERM reaches the handler on the
    recorder's watcher thread (a rank parked in native code still
    evicts); the recorder's own dump runs first."""
    import signal

    from horovod_tpu_torch.diag import recorder
    recorder.install(dump_dir=str(tmp_path))
    codes = []
    try:
        handler = GracefulEvictionHandler(state=FakeState(), grace=1.0,
                                          env={}, exit_fn=codes.append)
        handler.install()
        assert handler._via_recorder
        os.kill(os.getpid(), signal.SIGTERM)
        assert handler.finished.wait(10.0)
        assert codes == [0] and handler.last["kind"] == "sigterm"
        handler.uninstall()
    finally:
        recorder.uninstall(dump=False)


# -- the blacklist: drained is not crashed; decay on sustained health -----

# (op, host, t): record_failure / record_drain / observe(hosts) at t
BLACKLIST_SCRIPTS = {
    "backoff": (dict(threshold=3, base_delay=10.0, max_delay=1000.0), [
        ("fail", "h", 0.0), ("probe", "h", 0.0), ("probe", "h", 11.0),
        ("fail", "h", 11.0), ("probe", "h", 25.0), ("probe", "h", 35.0),
        ("fail", "h", 35.0), ("probe", "h", 1e9),
        ("probe", "other", 1e9)]),
    "drain": (dict(threshold=3, base_delay=10.0), [
        ("drain", "h", 0.0), ("drain", "h", 0.0), ("probe", "h", 0.0),
        ("fail", "h", 0.0), ("probe", "h", 0.0)]),
    "decay": (dict(threshold=3, base_delay=1.0, decay_window=100.0), [
        ("fail", "h", 0.0), ("fail", "h", 0.0), ("observe", "h", 0.0),
        ("observe", "h", 99.0), ("probe", "h", 99.0),
        ("observe", "h", 100.0), ("probe", "h", 100.0),
        ("observe", "h", 200.0), ("probe", "h", 200.0)]),
    "streak": (dict(threshold=3, base_delay=1.0, decay_window=100.0), [
        ("fail", "h", 0.0), ("observe", "h", 0.0), ("observe", "", 90.0),
        ("observe", "h", 110.0), ("probe", "h", 110.0),
        ("observe", "h", 209.0), ("probe", "h", 209.0),
        ("observe", "h", 215.0), ("probe", "h", 215.0),
        ("fail", "h", 215.0), ("observe", "h", 215.0),
        ("fail", "h", 250.0), ("observe", "h", 320.0),
        ("observe", "h", 400.0), ("probe", "h", 400.0)]),
    "permanent": (dict(threshold=2, base_delay=1.0, decay_window=10.0), [
        ("fail", "h", 0.0), ("fail", "h", 0.0), ("observe", "h", 100.0),
        ("observe", "h", 1000.0), ("observe", "h", 1e6),
        ("probe", "h", 1e6)]),
    "no_window": (dict(threshold=3, base_delay=1.0), [
        ("fail", "h", 0.0), ("observe", "h", 1e6), ("probe", "h", 1e6)]),
}


def _blacklist_run(cls, kw, script):
    now = {"t": 0.0}
    bl = cls(clock=lambda: now["t"], **kw)
    out = []
    for op, host, t in script:
        now["t"] = t
        if op == "fail":
            out.append(bl.record_failure(host))
        elif op == "drain":
            out.append(bl.record_drain(host))
        elif op == "observe":
            bl.observe_health({host} if host else set())
        else:
            out.append((bl.count(host), bl.drains(host), bl.excluded(host),
                        bl.blacklisted(host), sorted(bl.hosts)))
    return out


@pytest.mark.parametrize("name", sorted(BLACKLIST_SCRIPTS))
def test_blacklist_decisions_equal_jax(name):
    """One fake clock, one script of failures, drains and health
    observations: the port's blacklist decides as the JAX package's at
    every probe (counts, drains, excluded, blacklisted)."""
    kw, script = BLACKLIST_SCRIPTS[name]
    assert _blacklist_run(Blacklist, kw, script) == \
        _blacklist_run(JBlacklist, kw, script)


def test_blacklist_cases_of_the_jax_tests():
    run = {n: _blacklist_run(Blacklist, kw, s)
           for n, (kw, s) in BLACKLIST_SCRIPTS.items()}
    # backoff: 10 s, cooled, 20 s, permanent at the third
    assert [p[2] for p in run["backoff"] if isinstance(p, tuple)] == \
        [True, False, True, False, True, False]
    assert run["backoff"][-2][3] and run["backoff"][-2][4] == ["h"]
    assert run["drain"][2] == (0, 2, False, False, [])
    assert run["drain"][-1][2]  # the crash path backs off
    assert [p[0] for p in run["decay"] if isinstance(p, tuple)] == \
        [2, 1, 0]
    assert [p[0] for p in run["streak"] if isinstance(p, tuple)] == \
        [1, 1, 0, 2]
    assert run["permanent"][-1][:4] == (2, 0, True, True)
    assert run["no_window"][-1][0] == 1


# -- the driver's doomed-host plane ---------------------------------------

def _put_doomed(server, host, kind="sigterm", ts=None):
    payload = json.dumps({"host": host, "rank": 0, "kind": kind,
                          "time": time.time() if ts is None else ts,
                          "grace": 5.0}).encode()
    server.put(DOOMED_KEY_PREFIX + host, payload)
    server.put(DOOMED_MARKER_KEY, payload)


def test_rendezvous_drains_announced_doomed_host(kv):
    server, _ = kv
    driver = ElasticDriver(FixedHosts({"hostA": 1, "hostB": 1}), min_np=1,
                           kv=server, poll_interval=0.05)
    _put_doomed(server, "hostA")
    assert {s.hostname for s in driver.rendezvous()} == {"hostB"}
    assert server.get(DOOMED_KEY_PREFIX + "hostA") is None
    assert server.get(DOOMED_MARKER_KEY) is None
    assert "hostA" in {s.hostname for s in driver.rendezvous()}
    driver.stop()


def test_rendezvous_reuses_doomed_host_below_min_np(kv):
    server, _ = kv
    driver = ElasticDriver(FixedHosts({"hostA": 1}), min_np=1, kv=server,
                           poll_interval=0.05)
    _put_doomed(server, "hostA")
    assert {s.hostname for s in driver.rendezvous()} == {"hostA"}
    assert server.get(DOOMED_KEY_PREFIX + "hostA") is None
    driver.stop()


def test_stale_doomed_announcement_is_dropped(kv):
    server, _ = kv
    driver = ElasticDriver(FixedHosts({"hostA": 1, "hostB": 1}), min_np=1,
                           kv=server, poll_interval=0.05)
    _put_doomed(server, "hostA", ts=time.time() - DOOMED_TTL_S - 60)
    assert "hostA" in {s.hostname for s in driver.rendezvous()}
    assert server.get(DOOMED_KEY_PREFIX + "hostA") is None
    driver.stop()


class FakeJob:
    def __init__(self, rcs, failed_at=None):
        self.rcs = rcs
        self.first_failure = next(
            ((r, c) for r, c in sorted(rcs.items()) if c != 0), None)
        self.failed_at = failed_at

    def join(self):
        return dict(self.rcs)


def test_run_job_drain_blame_on_graceful_eviction(kv):
    server, _ = kv
    driver = ElasticDriver(FixedHosts({"hostA": 1}), min_np=1, kv=server,
                           poll_interval=0.05)

    def launch(slots, epoch, env):
        assert env["HOROVOD_ELASTIC"] == "1"
        if epoch == 1:
            _put_doomed(server, "hostA")
            return FakeJob({0: EXIT_RENDEZVOUS})
        return FakeJob({0: 0})

    assert driver.run_job(launch, max_epochs=4) == 2
    assert driver.blacklist.drains("hostA") == 1
    assert driver.blacklist.count("hostA") == 0
    assert not driver.blacklist.excluded("hostA")


def test_run_job_drain_blame_when_sigkill_beats_the_grace_window(kv):
    server, _ = kv
    driver = ElasticDriver(FixedHosts({"hostA": 1}), min_np=1, kv=server,
                           poll_interval=0.05)

    def launch(slots, epoch, env):
        if epoch == 1:
            _put_doomed(server, "hostA")
            return FakeJob({0: -9}, failed_at=time.time())
        return FakeJob({0: 0})

    assert driver.run_job(launch, max_epochs=4) == 2
    assert driver.blacklist.drains("hostA") == 1
    assert driver.blacklist.count("hostA") == 0


def test_run_job_crash_without_announcement_still_blames(kv):
    server, _ = kv
    driver = ElasticDriver(FixedHosts({"hostA": 1}), min_np=1, kv=server,
                           poll_interval=0.05,
                           blacklist=Blacklist(threshold=3, base_delay=0.0))

    def launch(slots, epoch, env):
        return FakeJob({0: 1} if epoch == 1 else {0: 0})

    assert driver.run_job(launch, max_epochs=4) == 2
    assert driver.blacklist.count("hostA") == 1
    assert driver.blacklist.drains("hostA") == 0


def test_crash_fanout_evictions_drain_no_host(kv):
    """hostA's rank crashes; the launcher's fan-out SIGTERMs hostB's rank,
    whose handler (no other host announced) announces hostB after the
    failure. The port blames hostA and keeps hostB in the next
    rendezvous; an announcement made before the failure still drains."""
    server, _ = kv
    driver = ElasticDriver(FixedHosts({"hostA": 1, "hostB": 1}), min_np=1,
                           max_np=2, kv=server, poll_interval=0.05,
                           blacklist=Blacklist(threshold=3, base_delay=0.0))
    seen = []

    def launch(slots, epoch, env):
        seen.append(sorted(s.hostname for s in slots))
        if epoch == 1:
            failed = time.time()
            _put_doomed(server, "hostB", ts=failed + 0.5)  # the fan-out
            return FakeJob({0: -9, 1: EXIT_RENDEZVOUS}, failed_at=failed)
        return FakeJob({0: 0, 1: 0})

    assert driver.run_job(launch, max_epochs=4) == 2
    assert seen == [["hostA", "hostB"], ["hostA", "hostB"]]
    assert driver.blacklist.count("hostA") == 1
    assert driver.blacklist.drains("hostB") == 0
    assert server.get(DOOMED_KEY_PREFIX + "hostB") is None
    assert server.get(DOOMED_MARKER_KEY) is None


# -- drained recovery against SIGKILL recovery, real workers ------------------

@pytest.mark.slow
def test_drained_recovery_cheaper_than_sigkill(tmp_path):
    """The same death as a graceful eviction (SIGTERM, announce, commit,
    exit 75) and as a SIGKILL: the drain recovers without blame or
    backoff, so it beats the crash, whose host sits out a 4 s backoff."""
    from horovod_tpu_torch.examples.elastic_train import local_launch
    results = {}
    for mode in ("evict", "kill"):
        log = tmp_path / mode / "losses.jsonl"
        log.parent.mkdir(parents=True)
        server = KVStoreServer()
        port = server.start()
        try:
            driver = ElasticDriver(
                FixedHosts({"hostA": 1}), min_np=1, kv=server,
                poll_interval=0.1,
                blacklist=Blacklist(threshold=3, base_delay=4.0))
            launch = local_launch(port, [
                *WIDTHS, "--steps", "6", "--ckpt-dir",
                tmp_path / mode / "ckpt", "--log", log, "--die", mode,
                "--die-host", "hostA", "--die-until-epoch", "2",
                "--die-after", "2"], {"HOROVOD_GRACE_SECONDS": "10"})
            t0 = time.monotonic()
            assert driver.run_job(launch, max_epochs=4) == 2
            results[mode] = (time.monotonic() - t0, driver.blacklist)
        finally:
            server.stop()
        records = [json.loads(x) for x in log.read_text().splitlines()]
        done = [r for r in records if "done" in r]
        assert done and done[0]["done"] == 6
        assert done[0]["resumed_from"] >= 1
    (wall_evict, bl_evict), (wall_kill, bl_kill) = (results["evict"],
                                                    results["kill"])
    assert bl_evict.drains("hostA") == 1 and bl_evict.count("hostA") == 0
    assert bl_kill.count("hostA") == 1 and bl_kill.drains("hostA") == 0
    assert wall_evict < wall_kill


@pytest.mark.parametrize("env,want", [
    ({}, 5.0), ({"HOROVOD_ELASTIC": "1"}, 31.0),
    ({"HOROVOD_GRACE_SECONDS": "12"}, 13.0),
    ({"HOROVOD_GRACE_SECONDS": "1"}, 5.0),
    ({"HOROVOD_ELASTIC": "1", "HOROVOD_GRACE_SECONDS": "bad"}, 31.0)])
def test_middleman_grace_covers_the_eviction(env, want):
    """The launcher's middleman SIGKILLs its command a while after the
    SIGTERM it forwards: for an elastic worker (or a run with a grace
    budget) the eviction's budget and a second, not a fixed 5 s that
    would cut the force-commit short."""
    from horovod_tpu_torch.run.safe_exec import term_grace
    assert term_grace(env) == want
