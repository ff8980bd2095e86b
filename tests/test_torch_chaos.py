"""The port's chaos harness (``horovod_tpu_torch/chaos/``): every case of
``tests/test_chaos.py`` on the port, the seeded schedules equal to the
JAX package's for the same specs, the repaired ``ChaosMonkey.done()`` (a
host injection counts once: the JAX injector counts its per-rank
entries), and the soak: ``hvdrun-torch --chaos`` SIGTERMs a rank of a
live 2-rank elastic job of ``examples/elastic_train.py`` on gloo; the
eviction drains the epoch, and the job finishes with every step's loss
an unbroken run's, bit for bit."""

import json
import os
import signal
import sys
import time

import pytest

from horovod_tpu.chaos import ChaosMonkey as JChaosMonkey
from horovod_tpu.chaos import parse_spec as jparse_spec
from horovod_tpu_torch.chaos import ChaosMonkey, ChaosPlan, Injection, parse_spec
from horovod_tpu_torch.chaos.plan import KINDS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# -- plans: seeded determinism and the spec grammar ----------------------

SPECS = [
    "seed=7,interval=2.5,kinds=sigterm+sigkill,count=6",
    "seed=0,kinds=sigterm,count=1,interval=3,jitter=0",
    "seed=5,interval=18,jitter=0,kinds=sigterm,count=1",
    "seed=1,kinds=" + "+".join(KINDS) + ",count=40,duration=3",
    "count=8",
    "seed=42,interval=0.5,jitter=1,kinds=host_sigterm+stall,count=12",
]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_spec_schedules_equal_jax(spec):
    """The same spec gives the same schedule in both packages, element
    for element (``Injection.as_dict``), and the same description."""
    got, want = parse_spec(spec), jparse_spec(spec)
    assert [i.as_dict() for i in got.injections] == \
        [i.as_dict() for i in want.injections]
    assert got.describe() == want.describe()
    assert got.as_dict() == want.as_dict()


def test_json_spec_forms_equal_jax(tmp_path):
    knobs = tmp_path / "knobs.json"
    knobs.write_text(json.dumps({"seed": 3, "interval": 1.0, "count": 4,
                                 "kinds": ["sigkill"]}))
    expanded = tmp_path / "plan.json"
    expanded.write_text(json.dumps({"injections": [
        {"at": 2.0, "kind": "stall", "rank": 5, "duration": 1.5},
        {"at": 1.0, "kind": "sigterm"}]}))
    for path in (knobs, expanded):
        assert parse_spec(str(path)).as_dict() == \
            jparse_spec(str(path)).as_dict()


def test_plan_generation_deterministic():
    a = ChaosPlan.generate(seed=7, interval=2.5, jitter=0.5,
                           kinds=("sigterm", "sigkill"), count=6)
    b = ChaosPlan.generate(seed=7, interval=2.5, jitter=0.5,
                           kinds=("sigterm", "sigkill"), count=6)
    assert [i.as_dict() for i in a.injections] == \
        [i.as_dict() for i in b.injections]
    assert len(a.injections) == 6
    ats = [i.at for i in a.injections]
    assert ats == sorted(ats) and ats[0] > 0
    c = ChaosPlan.generate(seed=8, interval=2.5, jitter=0.5,
                           kinds=("sigterm", "sigkill"), count=6)
    assert [i.as_dict() for i in a.injections] != \
        [i.as_dict() for i in c.injections]


def test_plan_durations_only_for_pausing_kinds():
    plan = ChaosPlan.generate(seed=1, kinds=KINDS, count=40, duration=3.0)
    for inj in plan.injections:
        want = 3.0 if inj.kind in ("stall", "slow_disk") else 0.0
        assert inj.duration == want


def test_plan_validation():
    with pytest.raises(ValueError, match="unknown kind"):
        ChaosPlan.generate(kinds=("sigterm", "meteor"))
    with pytest.raises(ValueError, match="interval"):
        ChaosPlan.generate(interval=0.0)
    with pytest.raises(ValueError, match="jitter"):
        ChaosPlan.generate(jitter=1.5)
    with pytest.raises(ValueError, match="unknown injection kind"):
        ChaosPlan([Injection(at=1.0, kind="meteor", rank=0)])


def test_parse_spec_inline_is_generate():
    plan = parse_spec("seed=7,interval=2.5,kinds=sigterm+sigkill,count=6")
    ref = ChaosPlan.generate(seed=7, interval=2.5,
                             kinds=("sigterm", "sigkill"), count=6)
    assert [i.as_dict() for i in plan.injections] == \
        [i.as_dict() for i in ref.injections]


def test_parse_spec_json_file_forms(tmp_path):
    knobs = tmp_path / "knobs.json"
    knobs.write_text(json.dumps({"seed": 3, "interval": 1.0, "count": 4,
                                 "kinds": ["sigkill"]}))
    plan = parse_spec(str(knobs))
    assert len(plan.injections) == 4
    assert all(i.kind == "sigkill" for i in plan.injections)
    expanded = tmp_path / "plan.json"
    expanded.write_text(json.dumps({"injections": [
        {"at": 2.0, "kind": "stall", "rank": 5, "duration": 1.5},
        {"at": 1.0, "kind": "sigterm"}]}))
    plan = parse_spec(str(expanded))
    assert [i.kind for i in plan.injections] == ["sigterm", "stall"]
    assert plan.injections[1].duration == 1.5


@pytest.mark.parametrize("bad", ["", "   ", "seed", "seed=x", "volume=11",
                                 "kinds=sigterm+meteor", "interval=0",
                                 "jitter=2"])
def test_parse_spec_rejects_malformed(bad):
    with pytest.raises(ValueError):
        parse_spec(bad)
    with pytest.raises(ValueError):
        jparse_spec(bad)


def test_parse_spec_rejects_malformed_files(tmp_path):
    notjson = tmp_path / "broken.json"
    notjson.write_text("{nope")
    with pytest.raises(ValueError, match="not valid JSON"):
        parse_spec(str(notjson))
    listjson = tmp_path / "list.json"
    listjson.write_text("[1, 2]")
    with pytest.raises(ValueError, match="JSON object"):
        parse_spec(str(listjson))
    badkey = tmp_path / "badkey.json"
    badkey.write_text(json.dumps({"volume": 11}))
    with pytest.raises(ValueError, match="unknown spec key"):
        parse_spec(str(badkey))


def test_cli_rejects_malformed_chaos_spec(capsys):
    """hvdrun-torch takes a well-formed ``--chaos`` and rejects a
    malformed one before launching, with the parser's exit 2 and the
    spec's own error."""
    from horovod_tpu_torch.run.run import parse_args
    ok = parse_args(["-np", "2", "--chaos", "seed=1,count=2",
                     "python", "t.py"])
    assert ok.chaos == "seed=1,count=2"
    for bad in ("volume=11", "kinds=meteor", ""):
        with pytest.raises(SystemExit) as ei:
            parse_args(["-np", "2", "--chaos", bad, "python", "t.py"])
        assert ei.value.code == 2
        assert "chaos:" in capsys.readouterr().err


# -- the monkey on fake clocks and fake processes -------------------------

class FakeProc:
    def __init__(self, pid):
        self.pid = pid
        self.signals = []
        self.rc = None

    def poll(self):
        return self.rc

    def send_signal(self, sig):
        self.signals.append(sig)

    def kill(self):
        self.signals.append(signal.SIGKILL)
        self.rc = -9


class FakeJob:
    def __init__(self, n, pid0=100):
        self.procs = [FakeProc(pid0 + i) for i in range(n)]


class FakeSlot:
    def __init__(self, hostname):
        self.hostname = hostname


class FakeHostJob(FakeJob):
    def __init__(self, hostnames, pid0=100):
        super().__init__(len(hostnames), pid0=pid0)
        self.slots = [FakeSlot(h) for h in hostnames]


def _wait_until(fn, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if fn():
            return True
        time.sleep(0.005)
    return False


def _fake_clock():
    now = {"t": 0.0}
    return now, (lambda: now["t"]), (lambda dt: now.__setitem__(
        "t", now["t"] + dt))


def _unit_monkey(job, cls=ChaosMonkey, plan=None):
    monkey = cls(plan or ChaosPlan([]), clock=lambda: 0.0,
                 sleep=lambda dt: None)
    monkey._job = job  # targeting only: no scheduler thread
    return monkey


def test_monkey_fake_clock_schedule():
    _, clock, sleep = _fake_clock()
    plan = ChaosPlan([Injection(at=10.0, kind="sigterm", rank=1),
                      Injection(at=20.0, kind="sigkill", rank=5)])
    job = FakeJob(3)
    monkey = ChaosMonkey(plan, clock=clock, sleep=sleep)
    monkey.attach(job)
    assert _wait_until(monkey.done)
    monkey.stop()
    done = [(inj.kind, rank) for inj, rank, _pid in monkey.injections_done]
    assert done == [("sigterm", 1), ("sigkill", 2)]
    assert job.procs[1].signals == [signal.SIGTERM]
    assert job.procs[2].signals == [signal.SIGKILL]
    assert job.procs[0].signals == []


def test_monkey_targets_only_live_procs():
    job = FakeJob(3)
    job.procs[0].rc = -9
    _unit_monkey(job)._apply(Injection(at=0.0, kind="sigterm", rank=0))
    assert job.procs[1].signals == [signal.SIGTERM]
    assert job.procs[0].signals == []


def test_monkey_no_live_procs_skips():
    job = FakeJob(2)
    for p in job.procs:
        p.rc = 0
    monkey = _unit_monkey(job)
    monkey._apply(Injection(at=0.0, kind="sigkill", rank=0))
    assert monkey.injections_done == []


def test_monkey_stall_freezes_then_unfreezes():
    now, clock, sleep = _fake_clock()
    monkey = ChaosMonkey(ChaosPlan([]), clock=clock, sleep=sleep)
    job = FakeJob(1)
    monkey._job = job
    monkey._apply(Injection(at=0.0, kind="stall", rank=0, duration=2.0))
    assert job.procs[0].signals == [signal.SIGSTOP, signal.SIGCONT]
    assert now["t"] >= 2.0


def test_monkey_slow_disk_pulses():
    now, clock, sleep = _fake_clock()
    monkey = ChaosMonkey(ChaosPlan([]), clock=clock, sleep=sleep)
    job = FakeJob(1)
    monkey._job = job
    monkey._apply(Injection(at=0.0, kind="slow_disk", rank=0, duration=1.0))
    sigs = job.procs[0].signals
    assert sigs and sigs == [signal.SIGSTOP, signal.SIGCONT] * (
        len(sigs) // 2)
    assert now["t"] >= 1.0


def test_monkey_retargets_on_reattach():
    plan = ChaosPlan([Injection(at=10_000.0, kind="sigterm", rank=0)])
    monkey = ChaosMonkey(plan)  # the real clock: it never fires
    job1, job2 = FakeJob(2), FakeJob(2, pid0=200)
    try:
        monkey.attach(job1)
        monkey.attach(job2)
        monkey._apply(Injection(at=0.0, kind="sigterm", rank=0))
        assert job2.procs[0].signals == [signal.SIGTERM]
        assert all(p.signals == [] for p in job1.procs)
    finally:
        monkey.stop()


def test_monkey_stop_aborts_pending_injections():
    plan = ChaosPlan([Injection(at=10_000.0, kind="sigkill", rank=0)])
    monkey = ChaosMonkey(plan)
    job = FakeJob(1)
    monkey.attach(job)
    monkey.stop()
    assert monkey.done()
    assert job.procs[0].signals == []


def test_monkey_host_sigterm_fells_whole_host_and_only_that_host():
    job = FakeHostJob(["node-a", "node-a", "node-b", "node-b"])
    monkey = _unit_monkey(job)
    monkey._apply(Injection(at=0.0, kind="host_sigterm", rank=0))
    assert job.procs[0].signals == [signal.SIGTERM]
    assert job.procs[1].signals == [signal.SIGTERM]
    assert job.procs[2].signals == [] and job.procs[3].signals == []
    assert [(r, p) for _i, r, p in monkey.injections_done] == \
        [(0, 100), (1, 101)]


def test_monkey_host_sigkill_uses_kill():
    job = FakeHostJob(["node-a", "node-a", "node-b", "node-b"])
    _unit_monkey(job)._apply(Injection(at=0.0, kind="host_sigkill", rank=1))
    assert job.procs[2].signals == [signal.SIGKILL]
    assert job.procs[3].signals == [signal.SIGKILL]
    assert job.procs[2].rc == -9 and job.procs[3].rc == -9
    assert job.procs[0].signals == [] and job.procs[1].signals == []


def test_monkey_host_kind_skips_already_dead_ranks():
    job = FakeHostJob(["node-a", "node-a"])
    job.procs[0].rc = -9
    monkey = _unit_monkey(job)
    monkey._apply(Injection(at=0.0, kind="host_sigterm", rank=0))
    assert job.procs[0].signals == []
    assert job.procs[1].signals == [signal.SIGTERM]
    assert [r for _i, r, _p in monkey.injections_done] == [1]


def test_monkey_host_kind_without_slots_is_one_local_host():
    job = FakeJob(3)
    monkey = _unit_monkey(job)
    monkey._apply(Injection(at=0.0, kind="host_sigterm", rank=0))
    assert all(p.signals == [signal.SIGTERM] for p in job.procs)
    assert [r for _i, r, _p in monkey.injections_done] == [0, 1, 2]


def test_monkey_host_injection_counts_once_toward_done():
    """The JAX test's schedule on the port: both host injections land,
    one done-entry per felled rank."""
    _, clock, sleep = _fake_clock()
    plan = ChaosPlan([
        Injection(at=10.0, kind="host_sigterm", rank=0),
        Injection(at=20.0, kind="host_sigkill", rank=1)])
    job = FakeHostJob(["node-a", "node-a", "node-b", "node-b"])
    monkey = ChaosMonkey(plan, clock=clock, sleep=sleep)
    monkey.attach(job)
    assert _wait_until(monkey.done)
    monkey.stop()
    kinds = [(inj.kind, rank) for inj, rank, _pid in monkey.injections_done]
    assert kinds == [("host_sigterm", 0), ("host_sigterm", 1),
                     ("host_sigkill", 2), ("host_sigkill", 3)]


@pytest.mark.parametrize("cls,done_early", [(ChaosMonkey, False),
                                            (JChaosMonkey, True)],
                         ids=["port", "jax"])
def test_done_counts_a_host_injection_once(cls, done_early):
    """The repaired ``done()``: after the first of two plan items, a host
    injection that felled 2 ranks, the plan is not done. The JAX
    injector counts ``max(attempted, done-entries)`` and says done."""
    plan = ChaosPlan([
        Injection(at=10.0, kind="host_sigterm", rank=0),
        Injection(at=20.0, kind="host_sigkill", rank=1)])
    job = FakeHostJob(["node-a", "node-a", "node-b", "node-b"])
    monkey = _unit_monkey(job, cls=cls, plan=plan)
    monkey._apply(plan.injections[0])
    monkey._attempted += 1  # as the scheduler counts the item it applied
    assert len(monkey.injections_done) == 2
    assert monkey.done() is done_early
    monkey._apply(plan.injections[1])
    monkey._attempted += 1
    assert monkey.done()


def test_blacklist_host_drain_is_not_a_crash():
    from horovod_tpu_torch.elastic.driver import Blacklist
    now = {"t": 0.0}
    bl = Blacklist(threshold=3, base_delay=5.0, clock=lambda: now["t"])
    for _ in range(5):
        bl.record_drain("node-a")
    assert bl.drains("node-a") == 5 and bl.count("node-a") == 0
    assert not bl.excluded("node-a")
    bl.record_failure("node-b")
    assert bl.excluded("node-b") and not bl.blacklisted("node-b")
    bl.record_failure("node-b")
    bl.record_failure("node-b")
    assert bl.blacklisted("node-b")
    now["t"] = 10_000.0
    assert bl.excluded("node-b") and not bl.excluded("node-a")


# -- the soak: hvdrun-torch --chaos against a live 2-rank elastic job -----

WIDTHS = ["--layers", "1", "--d-model", "32", "--heads", "2", "--vocab",
          "64", "--seq-len", "16", "--batch", "2"]


def _unbroken_losses(steps):
    """The example's losses of an unbroken run at world 1, in this
    process."""
    import numpy as np
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.utils.benchmarks import make_lm_bench
    hvd.shutdown()
    hvd.init(device="cpu")
    try:
        step, _, _, _ = make_lm_bench(batch=2, seq_len=16, layers=1,
                                      d_model=32, heads=2, vocab=64,
                                      flash=True, dtype=torch.float32)
        tokens = torch.from_numpy(np.random.default_rng(0).integers(
            0, 64, size=(2, 16)).astype(np.int64))
        return [float(step(tokens)) for _ in range(steps)]
    finally:
        hvd.shutdown()


def test_chaos_soak_two_ranks_sigterm_resumes_bit_identical(tmp_path):
    """A seeded ``--chaos`` plan SIGTERMs a rank of a live 2-rank elastic
    job (gloo) mid-training: the evicted worker grace-commits, announces
    its drain and exits ``EXIT_RENDEZVOUS``, its peer leaves as the
    fan-out's teardown, the driver re-rendezvouses, and the job finishes
    with every logged loss equal to the unbroken run's, bit for bit (a
    step replayed from the last complete commit repeats its loss). The
    final flight-recorder dumps carry no hang verdict."""
    import subprocess

    from horovod_tpu_torch.diag import doctor
    from horovod_tpu_torch.run import launcher

    steps = 150
    log = tmp_path / "losses.jsonl"
    dumps = tmp_path / "flightrec"
    dumps.mkdir()
    env = dict(os.environ, PYTHONPATH=launcher.repo_pythonpath(),
               HOROVOD_GRACE_SECONDS="20", HOROVOD_FLIGHTREC_DIR=str(dumps),
               OMP_NUM_THREADS="1")
    # one SIGTERM at t+10 s: past the workers' cold start, inside the
    # ~9 s of training (jitter 0 pins the time, the seed the target)
    rv = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.run", "-np", "2",
         "--min-np", "2", "--chaos",
         "seed=5,interval=10,jitter=0,kinds=sigterm,count=1", "--",
         sys.executable, "-m", "horovod_tpu_torch.examples.elastic_train",
         "--device", "cpu", *WIDTHS, "--steps", str(steps),
         "--step-sleep", "0.05", "--ckpt-dir", str(tmp_path / "ckpt"),
         "--log", str(log)], env=env, cwd=REPO, capture_output=True,
        text=True, timeout=180)
    assert rv.returncode == 0, rv.stderr[-4000:]
    assert "hvd-chaos: t+10.0s sigterm -> rank" in rv.stderr
    records = [json.loads(line) for line in log.read_text().splitlines()]
    done = [r for r in records if "done" in r]
    losses = [r for r in records if "loss" in r]
    assert done and done[-1]["done"] == steps
    assert {r["epoch"] for r in losses} >= {1, 2}, "no re-rendezvous"
    assert done[-1]["resumed_from"] > 0
    want = _unbroken_losses(steps)
    for r in losses:
        assert r["loss"] == want[r["step"] - 1], r
    assert {r["step"] for r in losses} == set(range(1, steps + 1))
    found, _ = doctor.load_dumps(str(dumps))
    if found:
        report = doctor.diagnose(found)
        assert report["classification"] in ("healthy",
                                            "graceful eviction"), \
            doctor.format_report(report)
