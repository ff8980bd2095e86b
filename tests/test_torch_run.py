"""The port's launcher (horovod_tpu_torch/run/) against the JAX package's
(horovod_tpu/run/): the pure launch functions on the same inputs, exact;
signing and the key-value store both ways; hvdrun of the port on the CPU
over gloo, port against port and across the two packages; the
programmatic ``run()``; the orphan-reaping middleman."""

import json
import os
import signal
import subprocess
import sys
import textwrap
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from horovod_tpu.run import allocation as jallocation
from horovod_tpu.run import cache as jcache
from horovod_tpu.run import config_parser as jconfig_parser
from horovod_tpu.run import launcher as jlauncher
from horovod_tpu.run import rendezvous as jrdv
from horovod_tpu.run import secret as jsecret
from horovod_tpu.run.run import parse_args as jparse_args
from horovod_tpu_torch.run import (allocation, api, cache, config_parser,
                                   launcher, rendezvous, secret)
from horovod_tpu_torch.run import run as trun
from horovod_tpu_torch.run.run import main, parse_args
from horovod_tpu_torch.run.safe_exec import descendants

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    env.update(extra)
    return env


def _hvdrun(package, argv, timeout=120, **env):
    return subprocess.run([sys.executable, "-m", f"{package}.run", *argv],
                          env=_env(**env), capture_output=True, text=True,
                          timeout=timeout, cwd=REPO)


def _outcome(fn, *args):
    """``fn(*args)``'s value, or its exception's type and message."""
    try:
        return fn(*args)
    except (ValueError, OSError) as e:
        return type(e).__name__, str(e)


def _slots(slots):
    return [vars(s) for s in slots]


# ---- pure launch functions: the port against the JAX package -----------

HOSTS = ["h1:4,h2:2,h3", " a:1 , b ,", "", "solo", "x:0,y:3", "[::1]:2",
         "h1:two"]


@pytest.mark.parametrize("spec", HOSTS)
def test_parse_hosts_matches_jax(spec):
    def parse(mod):
        out = _outcome(mod.parse_hosts, spec)
        return out if isinstance(out, tuple) else [vars(h) for h in out]

    assert parse(allocation) == parse(jallocation)


HOSTFILES = ["h1 slots=4\n# comment\nh2 slots=2\nh3\n",
             "a slots = 3  # trailing\n\n   \nb\n", "h1 slots=x\n",
             "h1 h2\n"]


@pytest.mark.parametrize("text", HOSTFILES)
def test_parse_hostfile_matches_jax(tmp_path, text):
    path = tmp_path / "hosts"
    path.write_text(text)

    def parse(mod):
        out = _outcome(mod.parse_hostfile, str(path))
        return out if isinstance(out, tuple) else [vars(h) for h in out]

    assert parse(allocation) == parse(jallocation)


ALLOCS = [("h1:2,h2:2", 4), ("h1:3,h2:1", 4), ("h1:2", 3), ("h1:4,h2:4", 5),
          ("h1:1,h2:3,h3:2", 6), ("h1:8", 1), ("a:2,b:2,c:2", 4)]


@pytest.mark.parametrize("spec,np_", ALLOCS)
def test_allocate_matches_jax(spec, np_):
    def alloc(mod):
        out = _outcome(mod.allocate, mod.parse_hosts(spec), np_)
        return out if isinstance(out, tuple) else _slots(out)

    mine = alloc(allocation)
    assert mine == alloc(jallocation)
    if spec == "h1:2":
        assert mine == ("ValueError",
                        "requested 3 processes but hosts provide only 2 "
                        "slots")


SLOT_ENVS = [
    (dict(rank=3, hostname="h2", local_rank=1, local_size=2, cross_rank=1,
          cross_size=2, size=4), ("10.0.0.1", 9999),
     dict(rendezvous_addr="10.0.0.1", rendezvous_port=8888)),
    (dict(rank=0, hostname="localhost", local_rank=0, local_size=1,
          cross_rank=0, cross_size=1, size=1), ("127.0.0.1", 0), {}),
    (dict(rank=5, hostname="h3", local_rank=2, local_size=3, cross_rank=1,
          cross_size=2, size=6), ("h1", 0),
     dict(rendezvous_addr="h1", rendezvous_port=1,
          extra_env={"HOROVOD_METRICS_PORT": "9100", "X": "y"})),
    (dict(rank=1, hostname="h", local_rank=1, local_size=2, cross_rank=0,
          cross_size=1, size=2), ("h", 0),
     dict(extra_env={"HOROVOD_METRICS_PORT": "0"})),
]


@pytest.mark.parametrize("slot,controller,kw", SLOT_ENVS)
def test_slot_env_matches_jax(slot, controller, kw):
    mine = launcher.slot_env(allocation.Slot(**slot), *controller, **kw)
    assert mine == jlauncher.slot_env(jallocation.Slot(**slot), *controller,
                                      **kw)
    assert mine["HOROVOD_RANK"] == str(slot["rank"])


KEY_HEX = "ab" * 32
COMMANDS = [
    ("localhost", {"HOROVOD_RANK": "0", secret.SECRET_ENV: KEY_HEX}, {}),
    ("127.0.0.1", {"HOROVOD_RANK": "1"}, {"ssh_port": 22}),
    ("remotehost", {"HOROVOD_RANK": "2"}, {"ssh_port": 2222}),
    ("remotehost", {"HOROVOD_RANK": "2", "A": "x y",
                    secret.SECRET_ENV: KEY_HEX}, {}),
    ("remotehost", {"HOROVOD_RANK": "3", secret.SECRET_ENV: KEY_HEX},
     {"remote_middleman": True, "cwd": "/work dir"}),
    ("h9", {}, {"remote_middleman": True, "ssh_port": 7}),
]


@pytest.mark.parametrize("host,env,kw", COMMANDS)
def test_build_command_matches_jax_but_the_package(host, env, kw):
    command = ["python", "train.py", "--x", "a b"]
    mine = launcher.build_command(host, command, env, **kw)
    ref = jlauncher.build_command(host, command, env, **kw)
    swap = json.loads(json.dumps(ref[:2]).replace(
        "horovod_tpu.run.safe_exec", "horovod_tpu_torch.run.safe_exec"))
    assert [list(mine[0]), mine[1]] == swap and mine[2] == ref[2]
    if host not in launcher.LOCAL_HOSTS:
        assert KEY_HEX not in " ".join(mine[0])  # the secret rides stdin
        if secret.SECRET_ENV in env:
            assert mine[2] == (KEY_HEX + "\n").encode()
    if kw.get("remote_middleman"):
        assert "horovod_tpu_torch.run.safe_exec" in mine[0][-1]


@pytest.mark.parametrize("env", [{}, {"HOROVOD_GRACE_SECONDS": "7"},
                                 {"HOROVOD_GRACE_SECONDS": "bad"},
                                 {"HOROVOD_GRACE_SECONDS": "-3"},
                                 {"HOROVOD_GRACE_SECONDS": ""}])
def test_grace_seconds_matches_jax(env):
    assert launcher.grace_seconds(env) == jlauncher.grace_seconds(env)


class _FakeProc:
    def __init__(self):
        self.rc = None
        self.killed = False

    def poll(self):
        return self.rc

    def kill(self):
        self.killed = True
        self.rc = -9


def test_escalate_after_grace_kills_only_survivors():
    """Fake clock: one process drains inside the grace window, one
    ignores the SIGTERM; only the survivor is SIGKILLed, after the whole
    grace, and a job whose processes all exit returns at once."""
    now = {"t": 0.0}
    drains, stubborn = _FakeProc(), _FakeProc()

    def sleep(dt):
        now["t"] += dt
        if now["t"] >= 2.0 and drains.rc is None:
            drains.rc = 75

    job = launcher.Job()
    job.procs = [drains, stubborn]
    assert job.escalate_after_grace(grace=10.0, clock=lambda: now["t"],
                                    sleep=sleep) == [1]
    assert stubborn.killed and not drains.killed and now["t"] >= 10.0

    now["t"] = 0.0
    a, b = _FakeProc(), _FakeProc()

    def sleep_exit(dt):
        now["t"] += dt
        a.rc = b.rc = 0

    job.procs = [a, b]
    assert job.escalate_after_grace(grace=30.0, clock=lambda: now["t"],
                                    sleep=sleep_exit) == []
    assert now["t"] < 30.0 and not a.killed


def test_cache_reads_the_jax_cache_and_expires(tmp_path):
    """The same file and keys as the JAX package's: either reads what the
    other wrote; expired entries miss; a corrupt file is a miss and is
    written over."""
    mine = cache.Cache(folder=str(tmp_path), ttl=3600)
    ref = jcache.Cache(folder=str(tmp_path), ttl=3600)
    assert mine.get("nics:a,b") is None
    ref.put("nics:a,b", ["eth0", "ib0"])
    assert mine.get("nics:a,b") == ["eth0", "ib0"]
    mine.put("nics:c", ["lo"])
    assert ref.get("nics:c") == ["lo"] and ref.get("nics:a,b")
    assert cache.Cache(folder=str(tmp_path), ttl=0).get("nics:c") is None
    (tmp_path / "cache.json").write_text("{not json")
    assert mine.get("nics:c") is None
    mine.put("nics:c", ["eth0"])
    assert mine.get("nics:c") == ref.get("nics:c") == ["eth0"]


ARGVS = [
    ["-np", "2", "python", "train.py"],
    ["-np", "2", "--fusion-threshold-mb", "32", "--cycle-time-ms", "2.5",
     "--autotune", "--timeline-filename", "/tmp/t.json", "python", "t.py"],
    ["-np", "2", "--disable-cache", "--", "python", "train.py"],
    ["-np", "4", "-H", "h1:2,h2:2", "-p", "2222", "--start-timeout", "30",
     "--verbose", "--nic", "eth0", "--no-interface-discovery", "x"],
    ["-np", "1", "--fusion-threshold-mb", "0", "--cache-capacity", "0",
     "--hierarchical-allreduce", "--hierarchical-allgather",
     "--no-stall-check", "--stall-warning-time-seconds", "30",
     "--stall-shutdown-time-seconds", "60", "--log-level", "debug", "y"],
    ["-np", "3", "--autotune-log-file", "a.csv", "--autotune-warmup-samples",
     "2", "--autotune-steps-per-sample", "5", "--autotune-sample-repeats",
     "1", "--autotune-bayes-opt-max-samples", "9",
     "--autotune-gaussian-process-noise", "0.5", "--timeline-mark-cycles",
     "--metrics-port", "9100", "--metrics-addr", "0.0.0.0", "--no-doctor",
     "--output-dir", "/tmp/o", "--hostfile", "hf", "z"],
    ["--check-build"],
]


@pytest.mark.parametrize("argv", ARGVS)
def test_parse_args_and_env_match_jax(argv):
    mine, ref = parse_args(argv), jparse_args(argv)
    assert vars(mine) == vars(ref)
    assert config_parser.args_to_env(mine) == \
        jconfig_parser.args_to_env(ref)
    assert config_parser.ARG_TO_ENV == jconfig_parser.ARG_TO_ENV


def test_config_file_matches_jax(tmp_path):
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(textwrap.dedent("""
        num-proc: 3
        fusion-threshold-mb: 16
        autotune: true
        stall-warning-time-seconds: 30
        timeline:
          filename: /tmp/tl.json
    """))
    argv = ["--config-file", str(cfg), "--fusion-threshold-mb", "8",
            "python", "x.py"]
    mine, ref = parse_args(argv), jparse_args(argv)
    assert vars(mine) == vars(ref)
    env = config_parser.args_to_env(mine)
    assert env == jconfig_parser.args_to_env(ref)
    assert env["HOROVOD_FUSION_THRESHOLD"] == str(8 << 20)  # CLI wins
    assert env["HOROVOD_TIMELINE"] == "/tmp/tl.json" and mine.num_proc == 3


# ---- signing and the key-value store, both ways ------------------------

def test_secret_matches_jax():
    key = secret.make_secret_key()
    assert len(key) == jsecret.SECRET_LENGTH == secret.SECRET_LENGTH
    assert secret.encode_key(key) == jsecret.encode_key(key)
    assert secret.decode_key(jsecret.encode_key(key)) == key
    sig = secret.sign(key, "PUT", "/a/b", b"payload")
    assert sig == jsecret.sign(key, "PUT", "/a/b", b"payload")
    assert jsecret.verify(key, "PUT", "/a/b", b"payload", sig)
    for args in (("PUT", "/a/b", b"tampered"), ("GET", "/a/b", b"payload"),
                 ("PUT", "/a/c", b"payload")):
        assert not secret.verify(key, *args, sig)
        assert not jsecret.verify(key, *args, sig)
    assert not secret.verify(key, "PUT", "/a/b", b"payload", None)
    assert not secret.verify(key, "PUT", "/a/b", b"payload", "é" * 64)
    assert secret.key_from_env({secret.SECRET_ENV: secret.encode_key(key)}) \
        == key and secret.key_from_env({}) is None


@pytest.mark.parametrize("keyed", [False, True])
def test_jax_clients_against_the_ports_store(keyed):
    """The JAX package's client (the native core of a JAX worker under the
    port's launcher publishes its controller port so) against the port's
    server: PUT, GET, 404 while missing, DELETE; with a key, unsigned
    and wrongly signed requests are refused with 403 and leave the store
    as it was."""
    key = secret.make_secret_key() if keyed else None
    kv = rendezvous.KVStoreServer(auth_key=key)
    port = kv.start()
    try:
        assert jrdv.kv_get("127.0.0.1", port, "scope/k", auth_key=key) \
            is None
        jrdv.kv_put("127.0.0.1", port, "scope/k", b"v1", auth_key=key)
        assert kv.get("scope/k") == b"v1"
        assert rendezvous.kv_get("127.0.0.1", port, "scope/k",
                                 auth_key=key) == b"v1"
        rendezvous.kv_put("127.0.0.1", port, "scope/k", b"v2", auth_key=key)
        assert jrdv.kv_wait("127.0.0.1", port, "scope/k", timeout=5,
                            auth_key=key) == b"v2"
        headers = ({} if key is None else {rendezvous.AUTH_HEADER:
                   secret.sign(key, "DELETE", "/scope/k")})
        urllib.request.urlopen(urllib.request.Request(
            f"http://127.0.0.1:{port}/scope/k", method="DELETE",
            headers=headers), timeout=5).read()
        assert kv.get("scope/k") is None
        if keyed:
            kv.put("x", b"good")
            unsigned_put = urllib.request.Request(
                f"http://127.0.0.1:{port}/x", data=b"evil", method="PUT")
            refused = [
                lambda: urllib.request.urlopen(unsigned_put, timeout=5),
                lambda: urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/x", timeout=5),
                lambda: jrdv.kv_put("127.0.0.1", port, "x", b"evil",
                                    auth_key=secret.make_secret_key())]
            for request in refused:
                with pytest.raises(urllib.error.HTTPError) as ei:
                    request()
                assert ei.value.code == 403
            assert kv.get("x") == b"good"
    finally:
        kv.stop()


# ---- the CLI, port against port ----------------------------------------

_MLP_WORKER = """
import json
import pathlib
import sys
import numpy as np
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch import basics, convert, training
from horovod_tpu_torch.models.simple import MLP


def train():
    hvd.init(device="cpu")
    model = MLP(6, (10, 7, 3))
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
        named_parameters=convert.flax_named_parameters(model))
    rng = np.random.default_rng(0)  # the same batch on every rank
    x = torch.from_numpy(rng.standard_normal((8, 6)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 3, size=(8,)))
    losses = []
    for _ in range(3):
        opt.zero_grad()
        loss = training.softmax_cross_entropy(model(x), y)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    out = {"rank": hvd.rank(), "size": hvd.size(),
           "fusion": basics.fusion_threshold(),
           "hierarchical": opt.hierarchical_resolved(), "losses": losses,
           "params": [p.detach().numpy().ravel().tolist()
                      for p in model.parameters()]}
    hvd.shutdown()
    return out


if __name__ == "__main__":
    out = train()
    pathlib.Path(sys.argv[1], f"result.{out['rank']}.json").write_text(
        json.dumps(out))
"""


def _results(out_dir):
    """Each rank's result, from its own file: the ranks share hvdrun's
    stdout, where two lines longer than the pipe's atomic write size
    (4 KiB) can interleave."""
    return sorted((json.loads(f.read_text())
                   for f in out_dir.glob("result.*.json")),
                  key=lambda r: r["rank"])


def test_hvdrun_two_ranks_equal_one_bit_for_bit(tmp_path):
    """``hvdrun -np 2`` of the port trains the MLP 3 steps through
    ``DistributedOptimizer`` on gloo with the same batch on each rank:
    the mean of two equal gradients is that gradient, so both ranks end
    bit for bit where one rank alone does. ``--fusion-threshold-mb``
    reaches the workers' ``fusion_threshold()`` and
    ``--hierarchical-allreduce`` their optimizers (both acted on, so not
    named; on one host the mesh has no dcn axis and the reduction stays
    flat); ``--cycle-time-ms``, which the port does not read, is named
    on stderr."""
    import runpy
    script = tmp_path / "mlp.py"
    script.write_text(_MLP_WORKER)
    rv = _hvdrun("horovod_tpu_torch",
                 ["-np", "2", "--fusion-threshold-mb", "1",
                  "--hierarchical-allreduce",
                  "--cycle-time-ms", "5", sys.executable, str(script),
                  str(tmp_path)])
    assert rv.returncode == 0, rv.stdout + rv.stderr
    assert ("hvdrun: horovod_tpu_torch does not act on HOROVOD_CYCLE_TIME "
            "yet") in rv.stderr
    assert "HOROVOD_FUSION_THRESHOLD" not in rv.stderr
    assert "HOROVOD_HIERARCHICAL_ALLREDUCE" not in rv.stderr
    two = _results(tmp_path)
    assert [(r["rank"], r["size"], r["fusion"], r["hierarchical"])
            for r in two] == [(0, 2, 1 << 20, True), (1, 2, 1 << 20, True)]
    one = runpy.run_path(str(script))["train"]()
    assert one["size"] == 1 and not one["hierarchical"]
    for r in two:
        assert r["losses"] == one["losses"]
        assert r["params"] == one["params"]
    assert one["losses"][-1] < one["losses"][0]


def test_hvdrun_failing_rank_kills_the_job(tmp_path):
    """Rank 1 exits 3 while rank 0 would sleep a minute: the fan-out
    terminates rank 0 and hvdrun exits 1, naming the rank, well before
    the minute. ``--output-dir`` holds each rank's output."""
    script = tmp_path / "crash.py"
    script.write_text(textwrap.dedent("""
        import os, sys, time
        print("rank", os.environ["HOROVOD_RANK"], flush=True)
        if os.environ["HOROVOD_RANK"] == "1":
            sys.exit(3)
        time.sleep(60)
    """))
    t = time.monotonic()
    rv = _hvdrun("horovod_tpu_torch",
                 ["-np", "2", "--output-dir", str(tmp_path / "logs"),
                  sys.executable, str(script)], timeout=90)
    assert rv.returncode == 1
    assert "process with rank 1 exited with code 3" in rv.stderr
    assert "remaining processes were terminated" in rv.stderr
    assert time.monotonic() - t < 45
    # rank 0 may be terminated before it prints
    assert (tmp_path / "logs" / "rank.0.log").exists()
    assert (tmp_path / "logs" / "rank.1.log").read_text() == "rank 1\n"


_DIAG_JOB = textwrap.dedent("""
    import sys
    import torch
    import horovod_tpu_torch as hvd
    hvd.init(device="cpu")
    for _ in range(3):
        hvd.allreduce(torch.ones(4))
    if hvd.size() > 1 and hvd.rank() == 1:
        sys.exit(3)  # leaves rank 0 parked in its next allreduce
    hvd.allreduce(torch.ones(4))
    hvd.shutdown()
""")


@pytest.fixture(scope="module")
def one_rank_job(tmp_path_factory):
    """One 1-rank CPU job under hvdrun with the flight recorder and the
    timeline on: its output dir holds ``flightrec.rank0.json``,
    ``goodput.rank0.json`` and the host trace."""
    out = tmp_path_factory.mktemp("diagjob")
    script = out / "job.py"
    script.write_text(_DIAG_JOB)
    rv = _hvdrun("horovod_tpu_torch",
                 ["-np", "1", "--output-dir", str(out / "logs"),
                  "--timeline-filename", str(out / "trace.json"),
                  sys.executable, str(script)],
                 HOROVOD_FLIGHTREC="1")
    assert rv.returncode == 0, rv.stdout + rv.stderr
    return out


@pytest.mark.parametrize("flag", ["--doctor", "--goodput-report",
                                  "--merge-timeline"])
def test_diagnosis_flags_on_a_one_rank_job(one_rank_job, flag, capsys):
    """hvdrun's diagnosis flags run their tool over the job's outputs
    and exit: the hang report (healthy), the goodput report, the merged
    trace."""
    logs = str(one_rank_job / "logs")
    if flag == "--doctor":
        assert main([flag, logs, "-np", "1"]) == 0
        out = capsys.readouterr().out
        assert "probable cause: healthy" in out
    elif flag == "--goodput-report":
        assert main([flag, logs]) == 0
        out = capsys.readouterr().out
        assert "goodput report" in out and "rank 0: wall" in out
        empty = one_rank_job / "empty"
        empty.mkdir(exist_ok=True)
        assert main([flag, str(empty)]) == 2
    else:
        merged = one_rank_job / "merged.json"
        assert main([flag, str(merged),
                     str(one_rank_job / "trace.json")]) == 0
        events = json.loads(merged.read_text())
        assert any(e.get("name") == "hvd_clock_sync" for e in events)
        assert main([flag, str(merged)]) == 1  # no traces given


def test_failed_job_prints_the_doctors_report(tmp_path):
    """Rank 1 exits 3 after three allreduces while rank 0 waits in its
    fourth: hvdrun ends the job and prints the doctor's report over the
    ranks' dumps, which names the collective rank 0 was in."""
    script = tmp_path / "job.py"
    script.write_text(_DIAG_JOB)
    rv = _hvdrun("horovod_tpu_torch",
                 ["-np", "2", "--output-dir", str(tmp_path / "logs"),
                  sys.executable, str(script)], timeout=120)
    assert rv.returncode == 1, rv.stdout + rv.stderr
    assert "process with rank 1 exited with code 3" in rv.stderr
    assert "doctor report (suppress with --no-doctor)" in rv.stderr
    assert "==== horovod_tpu doctor report" in rv.stderr
    # gloo raises in rank 0 when rank 1's socket closes (FAILED), unless
    # the launcher's SIGTERM reaches it first (PARKED, dumped by the
    # recorder's watcher)
    assert any(f"rank 0: seq entered 4, completed 3; {state} in allreduce "
               "(seq 4)" in rv.stderr for state in ("FAILED", "PARKED"))
    assert "rank 1: seq entered 3, completed 3" in rv.stderr
    assert "probable cause:" in rv.stderr


# the rejections of the JAX package's test_cli_elastic_flag_validation
# (tests/test_elastic.py:349-390); {script} is an executable discovery
# script, {plain} a file that is not executable
ELASTIC_REJECTS = [
    ["--min-np", "4", "--max-np", "2"],
    ["--min-np", "0"],
    ["--min-np", "2", "-np", "1"],
    ["--min-np", "1", "--max-np", "2", "-np", "3"],
    ["--max-np", "2"],
    ["--host-discovery-script", "/nonexistent-script", "--min-np", "1"],
    ["--host-discovery-script", "{script}", "-H", "h1:2", "--min-np", "1"],
    ["--host-discovery-script", "{plain}", "--min-np", "1"],
    ["--spmd-procs", "2", "--min-np", "1"],
]


def _discovery_files(tmp_path):
    script = tmp_path / "d.sh"
    script.write_text("#!/bin/sh\necho localhost:2\n")
    script.chmod(0o755)
    plain = tmp_path / "plain.txt"
    plain.write_text("not a script")
    return {"script": str(script), "plain": str(plain)}


def _parse_error(parse, argv, capsys):
    with pytest.raises(SystemExit) as ei:
        parse(argv)
    assert ei.value.code == 2
    return capsys.readouterr().err.strip().splitlines()[-1].split(
        "error: ", 1)[1]


@pytest.mark.parametrize("flags", ELASTIC_REJECTS,
                         ids=lambda f: " ".join(f))
def test_elastic_flag_rejections_carry_the_jax_messages(capsys, tmp_path,
                                                        flags):
    """``_validate_elastic_args``: each bad combination exits 2 with the
    JAX launcher's message, word for word (``--spmd-procs`` with the
    elastic flags is refused by both, each naming its own mesh)."""
    files = _discovery_files(tmp_path)
    argv = [f.format(**files) for f in flags] + ["python", "t.py"]
    got = _parse_error(parse_args, argv, capsys)
    want = _parse_error(jparse_args, argv, capsys)
    if flags[0] == "--spmd-procs":
        assert got.startswith("--spmd-procs is fixed-size") and \
            want.startswith("--spmd-procs is fixed-size")
        assert got.endswith("drop the elastic flags")
    else:
        assert got == want


def test_elastic_flags_accepted_as_jax_does(tmp_path):
    files = _discovery_files(tmp_path)
    for argv in (["--min-np", "1", "--max-np", "4", "-np", "2"],
                 ["--min-np", "3"],
                 ["--host-discovery-script", files["script"], "--min-np",
                  "2"],
                 ["-np", "2"]):
        got = parse_args(argv + ["python", "t.py"])
        want = jparse_args(argv + ["python", "t.py"])
        assert (got.elastic, got.min_np, got.max_np, got.num_proc) == \
            (want.elastic, want.min_np, want.max_np, want.num_proc), argv
    ok = parse_args(["--min-np", "1", "--max-np", "4", "-np", "2",
                     "python", "t.py"])
    assert ok.elastic and (ok.min_np, ok.max_np, ok.num_proc) == (1, 4, 2)


@pytest.mark.parametrize("spec", ["volume=11", "kinds=meteor", "",
                                  "interval=0"])
def test_malformed_chaos_spec_is_rejected_before_launch(capsys, spec):
    assert _parse_error(parse_args, ["-np", "2", "--chaos", spec, "python",
                                     "t.py"], capsys) == \
        _parse_error(jparse_args, ["-np", "2", "--chaos", spec, "python",
                                   "t.py"], capsys)


def test_cli_elastic_smoke_local():
    """hvdrun-torch with the elastic flags: one local worker, one epoch,
    a clean exit."""
    assert main(["--min-np", "1", "-np", "1", "--", sys.executable, "-c",
                 "print('elastic-ok')"]) == 0


def test_hvdrun_elastic_two_gloo_ranks(tmp_path):
    """``hvdrun-torch --min-np 1 --max-np 2 -H localhost:2`` runs
    ``examples/elastic_train.py`` on 2 gloo ranks under the elastic
    driver: one epoch, world 2, every step's loss the one-rank unbroken
    run's, bit for bit."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from test_torch_chaos import WIDTHS, _unbroken_losses
    log = tmp_path / "losses.jsonl"
    rv = _hvdrun("horovod_tpu_torch", [
        "--min-np", "1", "--max-np", "2", "-H", "localhost:2", "--",
        sys.executable, "-m", "horovod_tpu_torch.examples.elastic_train",
        "--device", "cpu", *WIDTHS, "--steps", "3", "--ckpt-dir",
        str(tmp_path / "ckpt"), "--log", str(log)], timeout=180,
        OMP_NUM_THREADS="1")
    assert rv.returncode == 0, rv.stdout + rv.stderr
    records = [json.loads(x) for x in log.read_text().splitlines()]
    done = [r for r in records if "done" in r]
    assert done == [dict(done[0], done=3, resumed_from=0, world=2,
                         epoch=1)]
    assert [r["loss"] for r in records if "loss" in r] == \
        _unbroken_losses(3)


# (flags, -np the launch takes, the workers' process-mesh env): the JAX
# launcher's N processes of K devices are N x K ranks of the port
SPMD_FLAGS = [
    (["--spmd-procs", "2", "--spmd-local-devices", "2"], 4,
     {"HOROVOD_SPMD_PROCS": "2", "HOROVOD_SPMD_LOCAL_DEVICES": "2"}),
    (["-np", "6", "--spmd-procs", "3", "--spmd-local-devices", "2"], 6,
     {"HOROVOD_SPMD_PROCS": "3", "HOROVOD_SPMD_LOCAL_DEVICES": "2"}),
    (["--spmd-procs", "2"], 2, {"HOROVOD_SPMD_PROCS": "2"}),
    (["-np", "2", "--jax-coordinator"], 2, {}),
]


@pytest.mark.parametrize("flags,np_,env", SPMD_FLAGS)
def test_spmd_flags_set_the_ranks_and_the_process_mesh_env(flags, np_, env):
    """``--spmd-procs N --spmd-local-devices K`` (and ``--jax-coordinator``)
    launch N x K ranks and name the job's rendezvous (the launcher's
    key-value store) as ``HOROVOD_COORDINATOR_ADDR``."""
    from horovod_tpu_torch.run.run import spmd_env
    args = parse_args([*flags, "python", "x.py"])
    assert args.num_proc == np_ and args.jax_coordinator
    got = spmd_env(args, "10.0.0.1", 4321)
    assert got == {"HOROVOD_COORDINATOR_ADDR": "10.0.0.1:4321", **env}


@pytest.mark.parametrize("flags,message", [
    (["-np", "3", "--spmd-procs", "2", "--spmd-local-devices", "2"],
     "must equal -np"),
    (["-np", "2", "--spmd-local-devices", "2"], "requires --spmd-procs"),
    (["--spmd-procs", "0"], "must be >= 1"),
])
def test_spmd_flags_refuse_a_mismatch(capsys, flags, message):
    with pytest.raises(SystemExit) as ei:
        main([*flags, "python", "x.py"])
    assert ei.value.code == 2 and message in capsys.readouterr().err


def test_num_proc_is_required_and_check_build_lists_the_planes(capsys):
    with pytest.raises(SystemExit) as ei:
        main(["python", "x.py"])
    assert ei.value.code == 2 and "-np" in capsys.readouterr().err
    assert main(["--check-build"]) == 0
    out = capsys.readouterr().out
    assert f"[X] PyTorch {torch.__version__}" in out
    cuda = "X" if torch.cuda.is_available() else " "
    assert f"[{cuda}] CUDA" in out
    assert "[X] gloo" in out and "NCCL" in out and "nvcc" in out


# ---- the CLI, across the two packages ----------------------------------

_JAX_WORKER = """
import numpy as np
import horovod_tpu as hvd
hvd.init()
x = np.ones(3, dtype=np.float32) * (hvd.rank() + 1)
out = hvd.allreduce(x, op=hvd.Sum)
assert np.allclose(np.asarray(out), 3.0), out  # 1+2
g = hvd.allgather(np.array([hvd.rank()], dtype=np.int32))
assert list(np.asarray(g)) == [0, 1], g
print(f"rank {hvd.rank()} OK")
"""

_PORT_WORKER = """
import torch
import horovod_tpu_torch as hvd
hvd.init(device="cpu")
out = hvd.allreduce(torch.full((3,), float(hvd.rank() + 1)), op=hvd.Sum)
assert out.tolist() == [3.0] * 3, out
print(f"rank {hvd.rank()} of {hvd.size()} OK", flush=True)
hvd.shutdown()
"""


@pytest.mark.parametrize("launcher_pkg,worker", [
    ("horovod_tpu_torch", _JAX_WORKER), ("horovod_tpu", _PORT_WORKER)],
    ids=["jax_worker_under_the_port", "port_worker_under_jax"])
def test_each_launcher_runs_the_other_packages_workers(tmp_path,
                                                       launcher_pkg, worker):
    """The JAX package's end-to-end CLI script (its native core publishes
    its controller port through the key-value store) under the port's
    hvdrun, and a port worker under the JAX package's hvdrun."""
    script = tmp_path / "train.py"
    script.write_text(worker)
    rv = _hvdrun(launcher_pkg, ["-np", "2", sys.executable, str(script)],
                 timeout=150)
    assert rv.returncode == 0, rv.stdout + rv.stderr
    assert "rank 0" in rv.stdout and "rank 1" in rv.stdout


# ---- the programmatic launcher ------------------------------------------

def test_programmatic_run_averages_on_every_rank():
    """``run(probe, np=3)``: each rank averages (rank + 1) * 2 over the
    three, 4.0; ``horovod_tpu_torch.run.run`` is the function."""
    from horovod_tpu_torch.examples.probe import probe
    assert trun is api.run
    results = api.run(probe, kwargs={"device": "cpu", "scale": 2.0}, np=3)
    assert [r[:3] for r in results] == [(0, 3, "cpu"), (1, 3, "cpu"),
                                        (2, 3, "cpu")]
    for r in results:
        np.testing.assert_array_equal(r[3], [4.0] * 4)


def test_programmatic_run_failure_raises():
    def bad(_):
        raise ValueError("boom on purpose")

    with pytest.raises(RuntimeError, match="boom on purpose"):
        api.run(bad, args=(1,), np=2)


# ---- the orphan-reaping middleman ---------------------------------------

MIDDLEMAN = "horovod_tpu_torch.run.safe_exec"


def _alive(pid):
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False


def _wait_dead(pid, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if not _alive(pid):
            return True
        time.sleep(0.2)
    return False


def _wait_pid(pidfile, timeout=30):
    deadline = time.time() + timeout
    while time.time() < deadline and not os.path.exists(pidfile):
        time.sleep(0.1)
    assert os.path.exists(pidfile), "the worker never started"
    time.sleep(0.2)
    return int(open(pidfile).read())


def test_middleman_propagates_exit_code_and_env():
    proc = subprocess.Popen(
        [sys.executable, "-m", MIDDLEMAN, "--watch-stdin", "--",
         sys.executable, "-c", "raise SystemExit(7)"],
        env=_env(), stdin=subprocess.PIPE)
    assert proc.wait(timeout=60) == 7
    proc = launcher.spawn(
        "localhost", [sys.executable, "-c",
                      "import os,sys; sys.exit(int(os.environ['WANT_RC']))"],
        {"WANT_RC": "5", "PYTHONPATH": launcher.repo_pythonpath()},
        middleman=True)
    assert proc.wait(timeout=60) == 5


def test_descendants_walks_proc():
    proc = subprocess.Popen(
        [sys.executable, "-c",
         "import subprocess,sys,time;"
         "p=subprocess.Popen([sys.executable,'-c','import time;"
         "time.sleep(60)']);time.sleep(60)"])
    try:
        deadline = time.time() + 10
        while time.time() < deadline and not descendants(proc.pid):
            time.sleep(0.1)
        assert len(descendants(proc.pid)) >= 1
    finally:
        for p in descendants(proc.pid):
            os.kill(p, signal.SIGKILL)
        proc.kill()
        proc.wait()


def test_launcher_sigkill_reaps_a_grandchild_that_left_the_group(tmp_path):
    """launcher -> middleman -> worker -> grandchild in its own session:
    the launcher's SIGKILL closes the death pipe and the middleman reaps
    the whole tree."""
    pidfile = str(tmp_path / "gc.pid")
    worker = textwrap.dedent(f"""
        import subprocess, sys, time
        gc = subprocess.Popen([sys.executable, '-c',
                               'import time; time.sleep(300)'],
                              start_new_session=True)
        open({pidfile!r}, 'w').write(str(gc.pid))
        time.sleep(300)
    """)
    parent = textwrap.dedent(f"""
        import os, subprocess, sys, time
        r, w = os.pipe()
        subprocess.Popen([sys.executable, '-m', {MIDDLEMAN!r}, str(r),
                          '--', sys.executable, '-c', {worker!r}],
                         pass_fds=(r,))
        os.close(r)
        time.sleep(300)
    """)
    proc = subprocess.Popen([sys.executable, "-c", parent], env=_env())
    gc_pid = _wait_pid(pidfile)
    assert _alive(gc_pid)
    proc.send_signal(signal.SIGKILL)
    proc.wait()
    assert _wait_dead(gc_pid), "the grandchild survived the launcher"


def test_sigterm_to_middleman_reaps(tmp_path):
    pidfile = str(tmp_path / "gc.pid")
    worker = textwrap.dedent(f"""
        import subprocess, sys, time
        gc = subprocess.Popen([sys.executable, '-c',
                               'import time; time.sleep(300)'])
        open({pidfile!r}, 'w').write(str(gc.pid))
        time.sleep(300)
    """)
    mid = subprocess.Popen(
        [sys.executable, "-m", MIDDLEMAN, "--watch-stdin", "--",
         sys.executable, "-c", worker], env=_env(), stdin=subprocess.PIPE)
    gc_pid = _wait_pid(pidfile)
    mid.send_signal(signal.SIGTERM)
    assert _wait_dead(gc_pid), "the grandchild survived the middleman"
    mid.wait(timeout=30)


def test_reparented_escapee_reaped(tmp_path):
    """A grandchild whose parent exited was reparented, out of a /proc
    walk's reach; the middleman's tracker saw it and still reaps it."""
    pidfile = str(tmp_path / "esc.pid")
    intermediate = textwrap.dedent(f"""
        import subprocess, sys, time
        gc = subprocess.Popen([sys.executable, '-c',
                               'import time; time.sleep(300)'],
                              start_new_session=True)
        open({pidfile!r}, 'w').write(str(gc.pid))
        time.sleep(3)  # alive across the tracker's 1 s poll
    """)
    worker = textwrap.dedent(f"""
        import subprocess, sys, time
        subprocess.run([sys.executable, '-c', {intermediate!r}])
        time.sleep(300)
    """)
    parent = textwrap.dedent(f"""
        import os, subprocess, sys, time
        r, w = os.pipe()
        subprocess.Popen([sys.executable, '-m', {MIDDLEMAN!r}, str(r),
                          '--', sys.executable, '-c', {worker!r}],
                         pass_fds=(r,))
        os.close(r)
        time.sleep(300)
    """)
    proc = subprocess.Popen([sys.executable, "-c", parent], env=_env())
    gc_pid = _wait_pid(pidfile)
    time.sleep(5)  # the intermediate has exited; the tracker polled
    assert _alive(gc_pid)
    proc.send_signal(signal.SIGKILL)
    proc.wait()
    assert _wait_dead(gc_pid), "the reparented escapee survived"
