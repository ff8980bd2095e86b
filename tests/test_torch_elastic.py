"""The port's elastic plane (``horovod_tpu_torch/elastic/``) against the
JAX package's (``horovod_tpu/elastic/``): every case of
``tests/test_elastic.py`` on the port; where the behaviour is
deterministic, both packages on the same inputs (``diff_hosts``, the
driver's bounds, notification frames across the packages, the cluster
view of one set of heartbeats); ``TorchState`` against ``JaxState`` on
one disk format (bit for bit both ways, ZeRO-1 rows resharded 1 → 2 and
2 → 1 on two gloo ranks); and the integration scenarios with
``examples/elastic_train.py`` on gloo: a worker's death, blame,
blacklist and resume, and a host added mid-run, each with the loss
trajectory of an unbroken run, bit for bit, and the driver's cluster view
of the workers' heartbeats (their metric snapshots and a clean
flight-recorder cross-check)."""

import json
import os
import sys
import textwrap
import threading
import time

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd_t
from horovod_tpu.elastic import discovery as jdiscovery
from horovod_tpu.elastic import driver as jdriver
from horovod_tpu.elastic import notification as jnotification
from horovod_tpu.elastic.state import JaxState
from horovod_tpu_torch import elastic
from horovod_tpu_torch import training as t_training
from horovod_tpu_torch.elastic.discovery import (FixedHosts,
                                                 HostDiscoveryPoller,
                                                 HostUpdateResult,
                                                 ScriptDiscovery, diff_hosts)
from horovod_tpu_torch.elastic.driver import (Blacklist, ElasticDriver)
from horovod_tpu_torch.elastic.exceptions import (HostsUpdatedInterrupt,
                                                  WorkerFailureError)
from horovod_tpu_torch.elastic.notification import (
    WorkerNotificationClient, WorkerNotificationManager,
    WorkerNotificationService)
from horovod_tpu_torch.elastic.state import ObjectState, TorchState
from horovod_tpu_torch.run.rendezvous import KVStoreServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))
import test_torch_ckpt as tc  # noqa: E402

WIDTHS = ["--device", "cpu", "--layers", "1", "--d-model", "32", "--heads",
          "2", "--vocab", "64", "--seq-len", "16", "--batch", "2"]


# -- host discovery ---------------------------------------------------------

def test_fixed_hosts_accepts_spec_dict_and_list():
    from horovod_tpu_torch.run.allocation import HostSlots
    assert FixedHosts("h1:4,h2").find_available_hosts_and_slots() == \
        {"h1": 4, "h2": 1}
    assert FixedHosts({"a": 2}).find_available_hosts_and_slots() == {"a": 2}
    fh = FixedHosts([HostSlots("x", 3)])
    assert fh.find_available_hosts_and_slots() == {"x": 3}
    fh.set({"y": 1})
    assert fh.find_available_hosts_and_slots() == {"y": 1}


def test_script_discovery(tmp_path):
    script = tmp_path / "discover.sh"
    script.write_text("#!/bin/sh\necho hostA:2\necho '# comment'\n"
                      "echo hostB\n")
    script.chmod(0o755)
    assert ScriptDiscovery(str(script)).find_available_hosts_and_slots() \
        == {"hostA": 2, "hostB": 1}
    bad = tmp_path / "bad.sh"
    bad.write_text("#!/bin/sh\nexit 3\n")
    bad.chmod(0o755)
    assert ScriptDiscovery(str(bad)).find_available_hosts_and_slots() == {}
    malformed = tmp_path / "malformed.sh"
    malformed.write_text("#!/bin/sh\necho hostA:2\necho 'hostB:'\n")
    malformed.chmod(0o755)
    assert ScriptDiscovery(
        str(malformed)).find_available_hosts_and_slots() == {}
    for s in (script, bad, malformed):  # the JAX package reads them alike
        assert jdiscovery.ScriptDiscovery(
            str(s)).find_available_hosts_and_slots() == ScriptDiscovery(
                str(s)).find_available_hosts_and_slots()


DIFFS = [({"a": 2, "b": 1, "c": 1}, {"a": 2, "b": 2, "d": 1}),
         ({"a": 2, "b": 1}, {"a": 2, "b": 1}), ({"a": 2}, {"a": 1}),
         ({}, {"x": 3}), ({"x": 3, "y": 1}, {}), ({"a": 1}, {"a": 4, "b": 0})]


@pytest.mark.parametrize("old,new", DIFFS)
def test_diff_hosts_equals_jax(old, new):
    assert diff_hosts(old, new) == jdiscovery.diff_hosts(old, new)


def test_diff_hosts():
    added, removed, res = diff_hosts({"a": 2, "b": 1, "c": 1},
                                     {"a": 2, "b": 2, "d": 1})
    assert (added, removed, res) == (["b", "d"], ["c"],
                                     HostUpdateResult.MIXED)
    assert diff_hosts({"a": 2}, {"a": 2}) == ([], [],
                                              HostUpdateResult.NO_UPDATE)
    assert diff_hosts({"a": 2}, {"a": 1})[1] == ["a"]


def test_poller_detects_membership_change():
    fh = FixedHosts({"a": 1})
    seen, done = [], threading.Event()

    def on_update(added, removed, current, res):
        seen.append((added, removed, res))
        done.set()

    poller = HostDiscoveryPoller(fh, poll_interval=0.02,
                                 on_update=on_update)
    poller.start()
    try:
        assert poller.current() == {"a": 1}
        fh.set({"a": 1, "b": 2})
        assert done.wait(5), "the poller never reported the added host"
    finally:
        poller.stop()
    assert seen[0] == (["b"], [], HostUpdateResult.ADDED)


# -- the blacklist and the driver's bounds --------------------------------

def test_blacklist_exponential_backoff_then_permanent():
    now = {"t": 0.0}
    bl = Blacklist(threshold=3, base_delay=10.0, max_delay=1000.0,
                   clock=lambda: now["t"])
    assert not bl.excluded("h")
    bl.record_failure("h")
    assert bl.excluded("h") and not bl.blacklisted("h")
    now["t"] = 11.0
    assert not bl.excluded("h")
    bl.record_failure("h")
    now["t"] = 25.0
    assert bl.excluded("h")
    now["t"] = 35.0
    assert not bl.excluded("h")
    bl.record_failure("h")
    now["t"] = 1e9
    assert bl.blacklisted("h") and bl.excluded("h")
    assert bl.hosts == {"h"} and not bl.excluded("other")


def test_driver_waits_for_min_np_and_times_out():
    driver = ElasticDriver(FixedHosts({"a": 1}), min_np=1,
                           poll_interval=0.05, hopeless_grace=0.5)
    assert driver.wait_for_available_slots(1, timeout=5) == {"a": 1}
    for _ in range(3):
        driver.blacklist.record_failure("a")
    with pytest.raises(TimeoutError, match="blacklisted=\\['a'\\]"):
        driver.wait_for_available_slots(1, timeout=0.3)
    start = time.monotonic()
    with pytest.raises(TimeoutError):
        driver.wait_for_available_slots(1, timeout=600)
    assert time.monotonic() - start < 30
    driver.stop()


@pytest.mark.parametrize("min_np,max_np", [(0, None), (4, 2), (-1, 3),
                                           (2, 2), (1, None)])
def test_driver_np_bounds_equal_jax(min_np, max_np):
    """The same bounds raise the same errors, word for word, in both
    drivers (or build in both)."""
    def outcome(cls, fixed):
        try:
            d = cls(fixed({"a": 1}), min_np=min_np, max_np=max_np)
            d.stop()
            return "ok"
        except ValueError as e:
            return str(e)
    got = outcome(ElasticDriver, FixedHosts)
    assert got == outcome(jdriver.ElasticDriver, jdiscovery.FixedHosts)
    if min_np < 1:
        assert "min_np" in got
    elif max_np is not None and max_np < min_np:
        assert "max_np" in got


# -- the notification plane ----------------------------------------------------

def test_notification_roundtrip_and_commit_interrupt():
    manager = WorkerNotificationManager()
    service = WorkerNotificationService(manager=manager, host="127.0.0.1")
    try:
        client = WorkerNotificationClient("127.0.0.1", service.port)
        assert client.ping()
        assert client.notify_hosts_updated("added")
        state = ObjectState(notification_manager=manager, x=1)
        with pytest.raises(HostsUpdatedInterrupt) as ei:
            state.commit()
        assert ei.value.res == "added"
        state.commit()  # the mailbox drained; the progress was saved
        assert state.has_commit()
    finally:
        service.shutdown()


def test_notification_requires_matching_key():
    manager = WorkerNotificationManager()
    service = WorkerNotificationService(key=b"right-key", manager=manager,
                                        host="127.0.0.1")
    try:
        bad = WorkerNotificationClient("127.0.0.1", service.port,
                                       key=b"wrong-key")
        assert not bad.notify_hosts_updated()
        assert manager.poll() is None
    finally:
        service.shutdown()


@pytest.mark.parametrize("client_pkg", ["jax", "port"])
@pytest.mark.parametrize("key", [None, b"one-run-key"])
def test_notification_across_the_packages(client_pkg, key):
    """One wire format: a JAX client reaches a port service and a port
    client a JAX service, under one key (or the local one)."""
    service_mod = jnotification if client_pkg == "port" else elastic.\
        notification
    client_mod = elastic.notification if client_pkg == "port" else \
        jnotification
    manager = service_mod.WorkerNotificationManager()
    service = service_mod.WorkerNotificationService(
        key=key, manager=manager, host="127.0.0.1")
    try:
        client = client_mod.WorkerNotificationClient(
            "127.0.0.1", service.port, key=key)
        assert client.ping()
        assert client.notify_hosts_updated("removed")
        assert manager.poll() == "removed"
        if key is not None:
            wrong = client_mod.WorkerNotificationClient(
                "127.0.0.1", service.port, key=b"another key")
            assert not wrong.notify_hosts_updated()
            assert manager.poll() is None
    finally:
        service.shutdown()


# -- states: commit / restore / sync --------------------------------------------

@pytest.fixture()
def world():
    hvd_t.shutdown()
    hvd_t.init(device="cpu")
    yield
    hvd_t.shutdown()


def test_object_state_commit_restore():
    state = ObjectState(counter=0, blob={"k": [1, 2]})
    state.commit()
    state.counter = 7
    state.blob["k"].append(3)
    state.restore()
    assert state.counter == 0 and state.blob == {"k": [1, 2]}


def _step_n(step, n=1):
    x, y = tc._data()
    for _ in range(n):
        step(torch.from_numpy(x), torch.from_numpy(y))


@pytest.mark.parametrize("cfg", tc.CONFIGS, ids=tc._cid)
def test_torch_state_commit_restore_sync_roundtrip(world, tmp_path, cfg):
    """Commit takes a host copy (the next steps, in place, do not reach
    it); restore brings it back bit for bit; a fresh state over the same
    directory restores the last commit from disk (the step counter and
    the keyword too); sync in one process keeps it."""
    model, opt, step = tc._port_mlp(*cfg)
    state = TorchState(model, opt, step.state, directory=str(tmp_path),
                       epoch=3)
    _step_n(step, 2)
    state.commit()
    committed = tc._port_flat(model, opt, step)
    _step_n(step, 2)
    state.epoch = 9
    assert step.state.step == 4
    state.restore()
    assert step.state.step == 2 and state.epoch == 3
    tc._assert_port_flat_equal(tc._port_flat(model, opt, step), committed)
    state.flush()

    model2, opt2, step2 = tc._port_mlp(*cfg)
    fresh = TorchState(model2, opt2, step2.state, directory=str(tmp_path),
                       epoch=0)
    assert fresh.sync() == 0
    assert step2.state.step == 2 and fresh.epoch == 3
    assert fresh.restores == 1 and fresh.last_restore_s > 0
    tc._assert_port_flat_equal(tc._port_flat(model2, opt2, step2),
                               committed)


def test_torch_state_rank_gate_blocks_nonzero_rank_writes(tmp_path,
                                                          monkeypatch):
    """Every rank writes its own shard, but the MANIFEST is rank 0's: a
    lone rank 1 leaves a torn directory invisible to restore, and its
    flush surfaces the missing commit."""
    from horovod_tpu_torch import ckpt
    from horovod_tpu_torch.ckpt import manifest
    monkeypatch.setenv("HOROVOD_RANK", "1")
    monkeypatch.setenv("HOROVOD_SIZE", "2")
    monkeypatch.setenv("HOROVOD_CKPT_TIMEOUT", "1")
    state = TorchState(directory=str(tmp_path), x=np.asarray(1.0))
    state.commit()
    with pytest.raises(RuntimeError, match="MANIFEST"):
        state.flush()
    sdir = manifest.step_dir(str(tmp_path), 1)
    assert os.path.isfile(os.path.join(sdir, manifest.shard_name(1, 2)))
    assert not manifest.is_complete(str(tmp_path), 1)
    assert ckpt.latest_complete_step(str(tmp_path)) is None
    state._ckpt.close()


@pytest.mark.parametrize("cfg", tc.CONFIGS, ids=tc._cid)
def test_jax_state_commit_restores_in_torch_state(world, tmp_path, cfg):
    """A ``JaxState(directory=..., train_state=...)`` commit after 2
    steps, restored by ``TorchState`` bit for bit (the commit counter
    too)."""
    jstate, _ = tc._jax_mlp(1, *cfg, steps=2)
    js = JaxState(directory=str(tmp_path), train_state=jstate)
    js.commit()
    js.commit()
    js.flush()
    model, opt, step = tc._port_mlp(*cfg)
    state = TorchState(model, opt, step.state, directory=str(tmp_path))
    state.restore()
    assert step.state.step == 2 and state._commit_count == 2
    tc._assert_state_equal(jstate, [tc._port_flat(model, opt, step)])
    tc.hvd_j.shutdown()


@pytest.mark.parametrize("cfg", tc.CONFIGS, ids=tc._cid)
def test_torch_state_commit_restores_in_jax_state(world, tmp_path, cfg):
    """The port trains 2 steps from the JAX package's initial parameters
    and commits through ``TorchState(directory=...)``; a ``JaxState``
    over the directory restores it bit for bit."""
    import jax
    jstate0, _ = tc._jax_mlp(1, *cfg, steps=0)
    params0 = jax.tree_util.tree_map(np.asarray, jstate0.params)
    model, opt, step = tc._port_mlp(*cfg, params0)
    _step_n(step, 2)
    state = TorchState(model, opt, step.state, directory=str(tmp_path))
    state.commit()
    state.flush()
    js = JaxState(directory=str(tmp_path), train_state=jstate0)
    js.restore()
    assert int(js.train_state.step) == 2 and js._commit_count == 1
    tc._assert_state_equal(js.train_state,
                           [tc._port_flat(model, opt, step)])
    tc.hvd_j.shutdown()


def test_commit_survives_buffer_reuse(world, tmp_path):
    """Two commits write two sets of host buffers in turn: a restore of
    the newest after a third state change still holds its values, and
    the checkpointer's pinned staging is not shared."""
    model, opt, step = tc._port_mlp("adamw", True)
    state = TorchState(model, opt, step.state)
    flats = []
    for _ in range(3):
        _step_n(step)
        state.commit()
        flats.append(tc._port_flat(model, opt, step))
    _step_n(step, 2)
    state.restore()
    tc._assert_port_flat_equal(tc._port_flat(model, opt, step), flats[-1])


# -- the retry loop ------------------------------------------------------------

def test_run_decorator_restores_on_worker_failure():
    state = ObjectState(value=0)
    calls = {"n": 0}

    @elastic.run
    def train(state):
        calls["n"] += 1
        state.value += 10
        if calls["n"] == 1:
            raise WorkerFailureError("peer died")
        state.commit()
        return state.value

    assert train(state) == 10 and calls["n"] == 2


def test_run_decorator_keeps_progress_on_hosts_updated():
    manager = WorkerNotificationManager()
    state = ObjectState(notification_manager=manager, step=0)
    resets = []
    state.register_reset_callbacks([lambda: resets.append(True)])

    @elastic.run
    def train(state):
        while state.step < 4:
            state.step += 1
            if state.step == 2:
                manager.handle_hosts_updated("added")
            state.commit()
        return state.step

    assert train(state) == 4 and resets == [True]


def test_run_decorator_reset_limit(monkeypatch):
    monkeypatch.setenv("HOROVOD_ELASTIC_RESET_LIMIT", "2")
    state = ObjectState(x=0)

    @elastic.run
    def train(state):
        raise WorkerFailureError("always")

    with pytest.raises(WorkerFailureError, match="giving up after 2"):
        train(state)


def test_elastic_train_loop_recovers_mid_run(world):
    """A membership interrupt midway re-syncs in process and finishes;
    committed progress is never recomputed, and the losses are an
    unbroken run's."""
    x, y = tc._data()

    def run(interrupt):
        model, opt, step = tc._port_mlp("sgd", False)
        manager = WorkerNotificationManager()
        state = TorchState(model, opt, step.state,
                           notification_manager=manager)
        seen = []

        def on_step(n, loss):
            seen.append((n, loss))
            if interrupt and n == 3:
                manager.handle_hosts_updated("removed")

        t_training.elastic_train_loop(
            state, step, lambda n: (torch.from_numpy(x),
                                    torch.from_numpy(y)), num_steps=6,
            on_step=on_step)
        return seen

    seen = run(True)
    assert [n for n, _ in seen] == [1, 2, 3, 4, 5, 6]
    assert seen == run(False)


def test_elastic_train_loop_resets_error_feedback_after_a_restore(world):
    """A worker failure rolls back to the commit, and the step's error
    feedback restarts from zeros (the residuals of a rolled-back step
    must not reach the retry); an interrupt without rollback keeps it."""
    x, y = tc._data()
    model, opt, step = tc._port_mlp("sgd", False)
    resets = []
    calls = {"n": 0}

    def flaky(inputs, labels):
        calls["n"] += 1
        if calls["n"] == 3:
            raise WorkerFailureError("peer died")
        return step(inputs, labels)

    flaky.state = step.state
    flaky.reset_error_feedback = lambda: resets.append(step.state.step)
    state = TorchState(model, opt, step.state)
    got = []
    t_training.elastic_train_loop(
        state, flaky, lambda n: (torch.from_numpy(x), torch.from_numpy(y)),
        num_steps=4, on_step=lambda n, loss: got.append(n))
    assert got == [1, 2, 3, 4] and resets == [2]
    with pytest.raises(ValueError, match="step_state"):
        t_training.elastic_train_loop(TorchState(model, opt, object()),
                                      step, lambda n: None, 1)


# -- the driver's cluster view (the heartbeat's consumer) ----------------------

def _heartbeats(kv, epoch, beats):
    for rank, hb in beats.items():
        kv.put(f"elastic/heartbeat/{epoch}/{rank}", json.dumps(hb).encode())


def test_cluster_view_equals_jax_on_one_set_of_heartbeats():
    """The same heartbeats on one store, read by both drivers: per-rank
    step and metrics, the straggler ratio and flags, the fleet goodput
    and the flight-recorder cross-check (rank 2 diverged) agree."""
    kv = KVStoreServer()
    kv.start()
    now = time.time()

    def digest(seq, h):
        return {"seq": seq, "hash": h, "hist": [[seq - 1, h - 1],
                                                [seq, h]]}

    beats = {0: {"step": 5, "time": now, "metrics": {
                 "step": 5, "step_seconds_p50": 0.1, "goodput": {
                     "compute": 4.0, "data_wait": 1.0}},
                 "flightrec": digest(10, 77)},
             1: {"step": 5, "time": now, "metrics": {
                 "step": 5, "step_seconds_p50": 0.1},
                 "flightrec": digest(10, 77)},
             2: {"step": 4, "time": now, "metrics": {
                 "step": 4, "step_seconds_p50": 0.5, "goodput": {
                     "compute": 2.0}},
                 "flightrec": digest(10, 99)}}
    try:
        views = []
        for drv, fixed in ((ElasticDriver, FixedHosts),
                           (jdriver.ElasticDriver, jdiscovery.FixedHosts)):
            d = drv(fixed({"h0": 1, "h1": 1, "h2": 1}), min_np=3, kv=kv,
                    poll_interval=0.05)
            d.rendezvous()
            _heartbeats(kv, d.epoch, beats)
            view = d.cluster_view()
            d.stop()
            view["flightrec"] = {k: v for k, v in view["flightrec"].items()
                                 if k != "detail"}
            views.append(json.loads(json.dumps(view)))
    finally:
        kv.stop()
    got, want = views
    assert got == want and got["epoch"] == 1
    assert got["stragglers"] == [2] and got["flightrec"]["desynced"] == [2]
    assert got["ranks"]["0"]["step_seconds_p50"] == 0.1
    assert got["goodput"]["ratio"] == pytest.approx(6.0 / 7.0)


def test_worker_heartbeat_carries_snapshot_and_digest(tmp_path):
    """``WorkerContext.report_progress`` publishes the step, the metrics
    snapshot (``instruments.kv_snapshot``) and the recorder's digest
    (``recorder.current_digest``) on the store; the endpoint it
    published answers the driver's ping."""
    from horovod_tpu_torch.diag import recorder
    from horovod_tpu_torch.elastic.worker import WorkerContext
    from horovod_tpu_torch.telemetry import get_registry, instruments
    kv = KVStoreServer()
    port = kv.start()
    recorder.install(dump_dir=str(tmp_path), handle_signals=False)
    get_registry().counter(instruments.STEP_TOTAL, "steps").inc(7)
    ctx = WorkerContext(rank=1, epoch=4, kv_addr="127.0.0.1", kv_port=port,
                        auth_key=b"")
    try:
        recorder.collective_enter("allreduce", name="g")
        ctx.report_progress(step=7)
        hb = json.loads(kv.get("elastic/heartbeat/4/1"))
        assert hb["step"] == 7 and hb["metrics"]["step"] >= 7
        assert hb["flightrec"] == json.loads(json.dumps(
            recorder.current_digest()))
        ep = json.loads(kv.get("elastic/notif/4/1"))
        assert WorkerNotificationClient(ep["addr"], ep["port"]).ping()
    finally:
        ctx.shutdown()
        recorder.uninstall(dump=False)
        kv.stop()


# -- ZeRO-1 rows across worlds on two gloo ranks --------------------------------

_RESHARD_WORKER = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    sys.path.insert(0, {tests!r})
    import horovod_tpu_torch as hvd
    import test_torch_ckpt as tc
    from horovod_tpu_torch.elastic import TorchState
    hvd.init(device="cpu")
    r = hvd.rank()
    model, opt, step = tc._port_mlp("adamw", True)
    state = TorchState(model, opt, step.state, directory={one!r})
    state.sync()  # restores the world-1 commit: 1 -> 2
    out = {{"restored": tc._listed(tc._port_flat(model, opt, step)),
           "step": step.state.step}}
    x, y = tc._data()
    n = tc.BATCH // 2
    step(torch.from_numpy(x[r * n:(r + 1) * n]),
         torch.from_numpy(y[r * n:(r + 1) * n]))
    two = TorchState(model, opt, step.state, directory={two!r})
    two.commit()
    two.flush()
    out["saved"] = tc._listed(tc._port_flat(model, opt, step))
    print("RESULT", json.dumps([r, out]), flush=True)
    hvd.shutdown()
""")


def _rows_equal(whole, parts):
    """A world-1 flat state against the flats of the ranks of a larger
    world: the replicated leaves equal, ZeRO rows concatenated over the
    ranks equal the whole row over its used elements, zeros past it."""
    assert len(whole) == len(parts[0])
    for i, leaf in enumerate(whole):
        if not isinstance(leaf, dict):
            for p in parts:
                np.testing.assert_array_equal(p[i], leaf)
            continue
        for key, value in leaf.items():
            if not isinstance(value, dict):
                for p in parts:
                    np.testing.assert_array_equal(p[i][key], value)
                continue
            row = value[0]
            rows = {}
            for p in parts:
                rows.update(p[i][key])
            cat = np.concatenate([rows[r] for r in sorted(rows)])
            np.testing.assert_array_equal(cat[:row.size], row, err_msg=key)
            assert not cat[row.size:].any()


def test_zero_rows_restore_one_to_two_and_two_to_one(world, tmp_path):
    """AdamW over ZeRO-1 rows: a world-1 ``TorchState`` commit restores
    on 2 gloo ranks (1 -> 2), each rank's rows its slice of the whole
    ones, bit for bit; the ranks' world-2 commit after one more step
    restores at world 1 (2 -> 1), bit for bit their state."""
    one, two = str(tmp_path / "one"), str(tmp_path / "two")
    model, opt, step = tc._port_mlp("adamw", True)
    _step_n(step, 2)
    state = TorchState(model, opt, step.state, directory=one)
    state.commit()
    state.flush()
    whole = tc._port_flat(model, opt, step)
    src = _RESHARD_WORKER.format(tests=os.path.join(REPO, "tests"),
                                 one=one, two=two)
    ranks = tc._run_ranks(src, 2, [])
    assert [rk["step"] for rk in ranks] == [2, 2]
    _rows_equal(whole, [tc._unlisted(rk["restored"]) for rk in ranks])
    model1, opt1, step1 = tc._port_mlp("adamw", True)
    back = TorchState(model1, opt1, step1.state, directory=two)
    back.restore()
    assert step1.state.step == 3
    _rows_equal(tc._port_flat(model1, opt1, step1),
                [tc._unlisted(rk["saved"]) for rk in ranks])


# -- integration: examples/elastic_train.py under a driver on gloo -------------

def _unbroken_losses(steps):
    """The example's losses in one process, unbroken (every rank trains
    on the same batch, so any world gives these)."""
    from test_torch_chaos import _unbroken_losses as losses
    return losses(steps)


def _records(log):
    return [json.loads(line) for line in log.read_text().splitlines()]


def _launch_env():
    return {"HOROVOD_TELEMETRY": "1", "OMP_NUM_THREADS": "1"}


def _run_driver(driver, launch, max_epochs, timeout=180.0):
    """``driver.run_job(launch)`` with every epoch's workers killed, and
    the test failed, past ``timeout`` seconds."""
    jobs, expired = [], threading.Event()

    def tracked(slots, epoch, env):
        job = launch(slots, epoch, env)
        jobs.append(job)
        return job

    def expire():
        expired.set()
        for job in jobs:
            job.kill_all(9)

    timer = threading.Timer(timeout, expire)
    timer.start()
    try:
        epochs = driver.run_job(tracked, max_epochs=max_epochs)
    finally:
        timer.cancel()
    assert not expired.is_set(), f"the job outlived {timeout:.0f} s"
    return epochs


def test_worker_death_blacklist_rerendezvous_resume(tmp_path):
    """hostA's rank SIGKILLs itself after each epoch's first step in
    epochs 1 and 2 (two gloo ranks, hostA and hostB); the driver blames
    and, at threshold 2, blacklists hostA; epoch 3 runs on hostB alone,
    restores the last commit from disk and finishes. Each step is logged
    once, its loss the unbroken run's, bit for bit; hostB's evictions
    by the launcher's fan-out drain nothing."""
    from horovod_tpu_torch.examples.elastic_train import local_launch
    steps = 5
    log = tmp_path / "losses.jsonl"
    kv = KVStoreServer()
    port = kv.start()
    try:
        driver = ElasticDriver(
            FixedHosts({"hostA": 1, "hostB": 1}), min_np=1, max_np=2,
            blacklist=Blacklist(threshold=2, base_delay=0.0), kv=kv,
            poll_interval=0.2)
        launch = local_launch(port, [
            *WIDTHS, "--steps", steps, "--ckpt-dir", tmp_path / "ckpt",
            "--log", log, "--die", "kill", "--die-host", "hostA",
            "--die-until-epoch", "3", "--die-after", "1"], _launch_env(),
            log_dir=str(tmp_path))
        epochs = _run_driver(driver, launch, max_epochs=6)
        progress = driver.worker_progress()
    finally:
        kv.stop()
    assert epochs == 3
    assert driver.blacklist.blacklisted("hostA")
    assert not driver.blacklist.excluded("hostB")
    assert driver.blacklist.drains("hostB") == 0
    records = _records(log)
    losses = [r for r in records if "loss" in r]
    done = [r for r in records if "done" in r]
    assert [r["host"] for r in losses[:2]] == ["hostA", "hostA"]
    assert all(r["host"] == "hostB" for r in losses[2:])
    assert [r["step"] for r in losses] == list(range(1, steps + 1))
    assert done and done[0]["resumed_from"] == 2 and \
        done[0]["done"] == steps and done[0]["world"] == 1
    want = _unbroken_losses(steps)
    assert [r["loss"] for r in losses] == want
    assert progress[0]["step"] == steps
    # the worker of epoch 3 took steps 3 to 5: its snapshot counts them
    assert progress[0]["metrics"]["step"] == steps - 2


def test_membership_change_graceful_rerendezvous(tmp_path):
    """A host added mid-run: the poller diffs the set, the driver
    notifies, the worker drains at a commit with ``EXIT_RENDEZVOUS`` (no
    blame), and epoch 2 runs on both hosts from the committed step. The
    losses are the unbroken run's; the timeline has the membership
    markers; the cluster view of epoch 2 carries both ranks' metric
    snapshots and a clean cross-check of their flight-recorder digests."""
    from horovod_tpu_torch.examples.elastic_train import local_launch
    from horovod_tpu_torch.utils.timeline import Timeline
    steps = 40
    log = tmp_path / "losses.jsonl"
    tl_path = tmp_path / "timeline.json"
    discovery = FixedHosts({"hostA": 1})
    kv = KVStoreServer()
    port = kv.start()
    timeline = Timeline(str(tl_path))
    grown = threading.Event()

    def grow_later():
        deadline = time.time() + 120
        while time.time() < deadline:
            if kv.get("elastic/heartbeat/1/0") is not None:
                break
            time.sleep(0.05)
        discovery.set({"hostA": 1, "hostB": 1})
        grown.set()

    try:
        driver = ElasticDriver(discovery, min_np=1, max_np=2, kv=kv,
                               poll_interval=0.1, timeline=timeline)
        launch = local_launch(port, [
            *WIDTHS, "--steps", steps, "--step-sleep", "0.1", "--ckpt-dir",
            tmp_path / "ckpt", "--log", log],
            {**_launch_env(), "HOROVOD_FLIGHTREC": "1"})
        threading.Thread(target=grow_later, daemon=True).start()
        epochs = _run_driver(driver, launch, max_epochs=4)
        view = driver.cluster_view()
        progress = driver.worker_progress()
    finally:
        kv.stop()
        timeline.close()
    assert grown.is_set()
    assert epochs == 2
    assert driver.blacklist.hosts == set()
    records = _records(log)
    done = [r for r in records if "done" in r]
    assert done and done[0]["done"] == steps and done[0]["world"] == 2
    assert done[0]["resumed_from"] > 0
    losses = [r for r in records if "loss" in r]
    assert [r["step"] for r in losses] == list(range(1, steps + 1))
    assert [r["loss"] for r in losses] == _unbroken_losses(steps)
    names = {e["name"] for e in json.loads(tl_path.read_text())}
    assert {"MEMBERSHIP_UPDATED", "MEMBERSHIP_RENDEZVOUS"} <= names
    assert set(view["ranks"]) == {0, 1}
    for rank in (0, 1):
        # the snapshot's step count (the heartbeat's own step under it,
        # as in the JAX view): the steps epoch 2's workers took
        assert view["ranks"][rank]["step"] == \
            steps - done[0]["resumed_from"]
        assert view["ranks"][rank]["last_heartbeat"] > 0
        assert view["ranks"][rank]["step_seconds_p50"] > 0
    assert [progress[r]["step"] for r in (0, 1)] == [steps, steps]
    assert view["flightrec"]["desynced"] == []
    assert view["flightrec"]["stuck"] == []
    assert set(view["flightrec"]["seqs"]) == {0, 1}
    assert view["healthy_hosts"] == ["hostA", "hostB"]
