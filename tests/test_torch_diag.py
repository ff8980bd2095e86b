"""The port's flight recorder and doctor against the JAX package's: the
ring, dumps under a double signal, install/uninstall; the desync digest
of an eager schedule (bf16 included) equal to JAX's for the same
schedule; every doctor classification, with dumps written by either
package read by both doctors (``--json`` reports agree); and one 2-rank
gloo job whose rank 1 dies inside an allreduce."""

import json
import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd_t
from horovod_tpu.diag import doctor as jdoctor
from horovod_tpu.diag import recorder as jrec
from horovod_tpu_torch.diag import doctor as tdoctor
from horovod_tpu_torch.diag import recorder as trec

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt
        return self.t


def make_recorder(mod, directory, rank=0, size=2, capacity=64, t0=50.0,
                  config=None):
    clk = FakeClock(t0)
    rec = mod.FlightRecorder(capacity=capacity, rank=rank, size=size,
                             dump_dir=str(directory), clock=clk,
                             wall_clock=lambda: clk.t + 1.7e9,
                             config=config)
    return rec, clk


def drive(rec, clk, ops, complete=True, dtype="float32"):
    for op, shape in ops:
        clk.advance(0.01)
        seq = rec.collective_enter(op, name=None, shape=shape, dtype=dtype,
                                   nbytes=int(np.prod(shape)) * 4)
        if complete:
            clk.advance(0.01)
            rec.collective_exit(op, seq)


# -- the ring and its dumps ----------------------------------------------------

def test_ring_wraparound_and_digest_history(tmp_path):
    rec, clk = make_recorder(trec, tmp_path, capacity=8)
    drive(rec, clk, [("allreduce", (4,))] * 20)
    snap = rec.snapshot()
    assert len(snap["events"]) == 8
    assert rec.collective_seq == rec.last_completed_seq == 20
    assert snap["events_total"] == 1 + 40
    assert max(e["seq"] for e in snap["events"] if e["k"] == "coll") == 20
    drive(rec, clk, [("allreduce", (4,))] * 300)
    d = rec.digest()
    assert d["seq"] == 320 and len(d["hist"]) <= trec.DIGEST_PUBLISH
    assert d["hist"][-1][0] == 320


def test_dump_idempotent_under_double_signal(tmp_path):
    rec, clk = make_recorder(trec, tmp_path, rank=3, size=4)
    drive(rec, clk, [("allreduce", (8,))] * 3, complete=False)
    p1 = rec.dump(reason="signal:15")
    first = json.loads(open(p1).read())
    p2 = rec.dump(reason="signal:15")
    assert p1 == p2 == rec.dump_path()
    second = json.loads(open(p2).read())
    assert first["rank"] == second["rank"] == 3
    assert second["dump_reasons"] == ["signal:15", "signal:15"]
    assert not [f for f in os.listdir(tmp_path) if ".tmp." in f]
    rec._dump_lock.acquire()
    try:
        assert rec.dump(reason="signal:15") is None
    finally:
        rec._dump_lock.release()


def test_install_uninstall_restores_hooks(tmp_path):
    prev_hook = sys.excepthook
    prev_term = signal.getsignal(signal.SIGTERM)
    rec = trec.install(dump_dir=str(tmp_path), rank=0, size=1)
    try:
        assert trec.get_recorder() is rec
        assert trec.install() is rec  # idempotent
        assert sys.excepthook is not prev_hook
        assert signal.getsignal(signal.SIGTERM) is not prev_term
        assert trec.signal_watcher_active()
        assert trec.dump_now(reason="endpoint")
    finally:
        trec.uninstall(dump=True, reason="shutdown")
    assert trec.get_recorder() is None
    assert sys.excepthook is prev_hook
    assert signal.getsignal(signal.SIGTERM) is prev_term
    d = json.loads((tmp_path / "flightrec.rank0.json").read_text())
    assert d["dump_reasons"] == ["endpoint", "shutdown"]
    assert trec.dump_now() is None


def test_failed_init_stops_the_services(tmp_path, monkeypatch):
    """An ``init()`` that fails after starting the run's services stops
    them: the metrics port is free again, the recorder is uninstalled
    with a dump that does not read as a clean exit, and a retried
    ``init()`` starts them afresh."""
    import socket
    import urllib.request
    from horovod_tpu_torch import basics
    from horovod_tpu_torch.cluster import procmesh
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    monkeypatch.setenv("HOROVOD_FLIGHTREC", "1")
    monkeypatch.setenv("HOROVOD_FLIGHTREC_DIR", str(tmp_path))
    monkeypatch.setenv("HOROVOD_METRICS_PORT", str(port))
    real = procmesh.ensure_distributed

    def refuse(*a, **k):
        raise RuntimeError("rendezvous refused")

    hvd_t.shutdown()
    monkeypatch.setattr(procmesh, "ensure_distributed", refuse)
    with pytest.raises(RuntimeError, match="refused"):
        hvd_t.init(device="cpu")
    assert not basics._state.initialized and basics._state.config is None
    assert basics._state.metrics_server is None
    assert trec.get_recorder() is None
    d = json.loads((tmp_path / "flightrec.rank0.json").read_text())
    assert d["dump_reasons"] == ["init_failed"]
    monkeypatch.setattr(procmesh, "ensure_distributed", real)
    hvd_t.init(device="cpu")
    try:
        assert trec.get_recorder() is not None
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/healthz", timeout=30) as r:
            assert r.status == 200
    finally:
        hvd_t.shutdown()


# -- the digest of an eager schedule -----------------------------------------

@pytest.fixture()
def cpu_world(tmp_path, monkeypatch):
    monkeypatch.setenv("HOROVOD_FLIGHTREC", "1")
    monkeypatch.setenv("HOROVOD_FLIGHTREC_DIR", str(tmp_path / "fr"))
    hvd_t.shutdown()
    hvd_t.init(device="cpu")
    yield hvd_t
    hvd_t.shutdown()


def test_eager_schedule_digest_equals_the_jax_recorders(cpu_world,
                                                        tmp_path):
    """Real port collectives at world 1 (gloo) against the JAX recorder
    fed what the JAX eager collectives record for the same operands:
    op, shape and numpy's dtype name (bf16 included; allgather's shape
    left out of the digest in both)."""
    import ml_dtypes
    rec = trec.get_recorder()
    assert rec is not None and rec is cpu_world.basics._state.flight_recorder
    ref, _ = make_recorder(jrec, tmp_path / "j", rank=0, size=1)
    schedule = [
        ("allreduce", (4, 3), torch.float32, np.float32),
        ("allreduce", (5,), torch.bfloat16, ml_dtypes.bfloat16),
        ("allgather", (2, 2), torch.bfloat16, ml_dtypes.bfloat16),
        ("broadcast", (3,), torch.int64, np.int64),
        ("reducescatter", (4, 2), torch.float32, np.float32),
        ("alltoall", (2,), torch.float16, np.float16),
    ]
    start = rec.collective_seq
    for op, shape, tdt, ndt in schedule:
        x = torch.ones(shape, dtype=tdt)
        if op == "allreduce":
            hvd_t.allreduce(x, op=hvd_t.Sum)
        elif op == "allgather":
            hvd_t.allgather(x)
        elif op == "broadcast":
            hvd_t.broadcast(x, 0)
        elif op == "reducescatter":
            hvd_t.reducescatter(x)
        else:
            hvd_t.alltoall(x)
        arr = np.ones(shape, dtype=ndt)
        ref.collective_enter(op, name=None, shape=np.shape(arr),
                             dtype=arr.dtype, nbytes=arr.nbytes,
                             hash_shape=op != "allgather")
    assert rec.collective_seq - start == len(schedule)
    ours = {s: h for s, h in rec.digest()["hist"]}
    theirs = {s: h for s, h in ref.digest()["hist"]}
    # the chains agree once both hashed the same ops (the port's
    # recorder started with init's own history, none here at world 1)
    assert start == 0 and ours == theirs
    ev = [e for e in rec.snapshot()["events"] if e.get("op") == "allgather"]
    assert ev[0]["dtype"] == "bfloat16" and ev[0]["shape"] == [2, 2]
    assert trec.dtype_name(torch.float8_e4m3fn) == "float8_e4m3fn"
    assert not rec.snapshot()["open_collectives"]


# -- the doctor, across packages ----------------------------------------------

def _parked(rec, clk):
    drive(rec, clk, [("allreduce", (4,))] * 4)
    drive(rec, clk, [("allreduce", (4,))], complete=False)
    rec.dump(reason="signal:15")


def _majority(rec, clk):
    drive(rec, clk, [("allreduce", (4,)), ("allreduce", (8,))])
    rec.dump(reason="stall")


def _minority(rec, clk):
    drive(rec, clk, [("allreduce", (4,)), ("allgather", (8,))])
    rec.dump(reason="stall")


def _starved(rec, clk):
    drive(rec, clk, [("allreduce", (4,))] * 4)
    rec.step_begin(3)
    rec.step_end(3)
    rec.record("data_wait", ph="B", source="ArraySource", epoch=0, batch=9)
    rec.dump(reason="stall")


def _compiling(rec, clk):
    drive(rec, clk, [("allreduce", (4,))] * 4)
    rec.step_begin(7)
    rec.dump(reason="stall")


def _evicted(rec, clk):
    drive(rec, clk, [("allreduce", (4,))] * 4)
    rec.record("preempt", kind="sigterm", signum=15, host="spot-a",
               grace=5.0)
    rec.record("preempt", kind="sigterm", outcome="committed",
               announced=True, commit_seconds=0.4)
    rec.dump(reason="preempt")


def _clean(rec, clk):
    drive(rec, clk, [("allreduce", (4,))] * 2)
    rec.step_begin(1)
    rec.step_end(1)
    rec.dump(reason="exit")


def _quiet(rec, clk):
    drive(rec, clk, [("allreduce", (4,))] * 2)
    rec.dump(reason="stall")


# scenario -> ({rank: script}, expected size, classification)
SCENARIOS = {
    "dead rank": ({0: _parked, 2: _parked}, 3, "dead rank"),
    "desync": ({0: _majority, 1: _minority, 2: _majority}, 3, "desync"),
    "data stall": ({0: _parked, 1: _starved}, 2, "data stall"),
    "compile stall": ({0: _parked, 1: _compiling}, 2, "compile stall"),
    "graceful eviction": ({0: _evicted, 1: _parked}, 2,
                          "graceful eviction"),
    "healthy": ({0: _clean, 1: _clean}, 2, "healthy"),
    "collective hang": ({0: _parked, 1: _parked}, 2, "collective hang"),
    "unknown": ({0: _quiet, 1: _quiet}, 2, "unknown"),
}


def _write(mod, directory, scripts, size, configs=None):
    for r, fn in scripts.items():
        rec, clk = make_recorder(mod, directory, rank=r, size=size,
                                 config=(configs or {}).get(r))
        fn(rec, clk)


def _agreed(report):
    return {"classification": report["classification"],
            "dead": report["dead_ranks"],
            "last_common_seq": report["last_common_seq"],
            "parked": {int(r): (list(i["parked"]) if i["parked"] else None)
                       for r, i in report["per_rank"].items()},
            "desynced": report["desync"]["desynced"],
            "evicted": report["evicted_ranks"],
            "config_mismatch": report["config_mismatch"]}


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_doctors_agree_on_either_packages_dumps(tmp_path, scenario, writer):
    scripts, size, want = SCENARIOS[scenario]
    _write(trec if writer == "port" else jrec, tmp_path, scripts, size)
    reports = []
    for doc in (tdoctor, jdoctor):
        dumps, skipped = doc.load_dumps(str(tmp_path))
        assert sorted(dumps) == sorted(scripts) and not skipped
        reports.append(doc.diagnose(dumps, expected_size=size))
    assert reports[0]["classification"] == want
    assert _agreed(reports[0]) == _agreed(reports[1])
    assert tdoctor.format_report(reports[0]) == \
        jdoctor.format_report(reports[1])


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_json_reports_agree_across_packages(tmp_path, capsys, writer):
    scripts, size, _ = SCENARIOS["dead rank"]
    _write(trec if writer == "port" else jrec, tmp_path, scripts, size)
    args = [str(tmp_path), "--expected-size", str(size), "--json"]
    ours = _json_report(tdoctor, args, capsys)
    theirs = _json_report(jdoctor, args, capsys)
    assert ours == theirs
    assert ours["per_rank"]["0"]["parked"] == [5, "allreduce"]


def test_config_mismatch_flagged_by_both(tmp_path):
    from horovod_tpu_torch.config import Config
    cfgs = {0: Config(rank=0, size=2, fusion_threshold=1 << 20),
            1: Config(rank=1, size=2, fusion_threshold=1 << 21)}
    _write(trec, tmp_path, {0: _clean, 1: _clean}, 2, configs=cfgs)
    reports = [doc.diagnose(doc.load_dumps(str(tmp_path))[0])
               for doc in (tdoctor, jdoctor)]
    assert reports[0]["config_mismatch"] and \
        _agreed(reports[0]) == _agreed(reports[1])
    assert trec.config_fingerprint(Config(rank=0, size=2)) == \
        trec.config_fingerprint(Config(rank=1, size=2, metrics_port=9))
    assert "CONFIG MISMATCH" in tdoctor.format_report(reports[0])


def _json_report(doc, args, capsys):
    """A doctor's ``--json`` report, in this process (both doctors are
    free of JAX; the prose goes to stderr)."""
    capsys.readouterr()
    assert doc.doctor_cli(list(args)) == 0
    return json.loads(capsys.readouterr().out)


# -- one 2-rank job whose rank 1 dies inside an allreduce ----------------------

_WORKER = r"""
import os, sys, time
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.ops import collective
hvd.init(device="cpu")
for _ in range(3):
    hvd.allreduce(torch.ones(4))
marker = sys.argv[1]
if hvd.rank() == 1:
    def stuck(*a, **k):  # entered the recorder's allreduce, never returns
        open(marker + ".1", "w").close()
        time.sleep(600)
    collective.dist.all_reduce = stuck
else:
    open(marker + ".0", "w").close()
hvd.allreduce(torch.ones(4))
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait_for(path, procs, deadline):
    while not os.path.exists(path):
        if time.monotonic() > deadline or any(p.poll() is not None
                                              for p in procs):
            raise AssertionError(f"{path} never appeared: " + "; ".join(
                p.communicate()[1][-2000:] for p in procs
                if p.poll() is not None))
        time.sleep(0.05)


def test_two_rank_dead_rank_inside_an_allreduce(tmp_path, capsys):
    """Rank 1 is SIGKILLed inside its fourth allreduce (no dump); rank 0,
    parked in its own, dumps on SIGTERM through the recorder's watcher.
    Both doctors, on the port's dumps, name rank 1 dead and rank 0 parked
    in allreduce at seq 4, last common seq 3; their ``--json`` reports
    agree."""
    dump_dir = tmp_path / "dumps"
    port = _free_port()
    procs = []
    for r in range(2):
        env = dict(os.environ, HOROVOD_RANK=str(r), HOROVOD_SIZE="2",
                   HOROVOD_LOCAL_RANK=str(r), HOROVOD_LOCAL_SIZE="2",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   HOROVOD_FLIGHTREC_DIR=str(dump_dir), PYTHONPATH=REPO)
        env.pop("HOROVOD_GLOO_RENDEZVOUS_ADDR", None)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _WORKER, str(tmp_path / "in")], env=env,
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    try:
        deadline = time.monotonic() + 120
        for r in range(2):
            _wait_for(str(tmp_path / f"in.{r}"), procs, deadline)
        time.sleep(0.5)  # rank 0 is inside its gloo wait
        procs[0].send_signal(signal.SIGTERM)
        _wait_for(str(dump_dir / "flightrec.rank0.json"), procs[:1],
                  deadline)
        procs[1].kill()
        for p in procs:
            p.communicate(timeout=60)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert not (dump_dir / "flightrec.rank1.json").exists()
    reports = [_json_report(doc, [str(dump_dir), "--expected-size", "2",
                                  "--json"], capsys)
               for doc in (tdoctor, jdoctor)]
    for rep in reports:
        assert rep["classification"] == "dead rank"
        assert rep["dead_ranks"] == [1]
        assert rep["last_common_seq"] == 3
        assert rep["per_rank"]["0"]["parked"] == [4, "allreduce"]
    assert reports[0]["explanation"] == reports[1]["explanation"]
