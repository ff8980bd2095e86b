"""The port's goodput ledger and report against the JAX package's: the
same script of charges, brackets and settles on an injected clock gives
the same phases, as floats; the same dumps give the same report text;
the port's LM step settles every step; the loader charges ``data_wait``
and the checkpointer ``ckpt_stall``; and two ranks' injected stalls are
attributed on a fake clock (no sleeps)."""

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd_t
from horovod_tpu.telemetry import ledger as jled
from horovod_tpu.telemetry import registry as jreg
from horovod_tpu.telemetry import report as jreport
from horovod_tpu_torch.telemetry import ledger as tled
from horovod_tpu_torch.telemetry import registry as treg
from horovod_tpu_torch.telemetry import report as treport


def _ledger(mod, reg_mod, enabled=True):
    t = [0.0]
    led = mod.TimeLedger(clock=lambda: t[0], registry=reg_mod.MetricsRegistry(),
                         enabled=enabled)
    return led, t


def _settle_residual(led, t):
    led.start()
    t[0] = 1.0
    led.charge("data_wait", 0.3)
    t[0] = 2.0
    led.settle_step()


def _clipped(led, t):
    led.start()
    led.charge("data_wait", 3.0)
    led.charge("ckpt_stall", 1.0)
    t[0] = 1.0
    led.settle_step()


def _idle_split(led, t):
    led.start()
    t[0] = 0.1
    led.settle_idle()
    t[0] = 3.0
    led.settle_idle()


def _bracket_inner(led, t):
    led.start()
    with led.phase("re-rendezvous", charge="rendezvous_recovery"):
        t[0] = 2.0
        led.charge("ckpt_stall", 0.5)
        t[0] = 3.0
    led.settle_idle()


def _preemption(led, t):
    led.start()
    t[0] = 1.0
    with led.phase("preemption"):
        t[0] = 1.4
    led.finalize()


def _mid_bracket(led, t):
    led.start()
    ctx = led.phase("ckpt_restore", charge="rendezvous_recovery")
    ctx.__enter__()
    t[0] = 4.0
    led.settle_idle()
    t[0] = 5.0
    ctx.__exit__(None, None, None)
    led.settle_idle()


def _nested(led, t):
    led.start()
    parent = led.phase("re-rendezvous", charge="rendezvous_recovery")
    parent.__enter__()
    t[0] = 1.0
    child = led.phase("ckpt_restore", charge="rendezvous_recovery")
    child.__enter__()
    t[0] = 3.0
    led.settle_idle()
    t[0] = 4.0
    child.__exit__(None, None, None)
    t[0] = 5.0
    parent.__exit__(None, None, None)
    led.finalize()


def _steps_and_compile(led, t):
    led.start()
    for i in range(5):
        t[0] += 0.125
        led.charge("data_wait", 0.01 * i)
        led.charge("compile", 0.05 if i == 0 else 0.0)
        led.charge("exposed_collective", 0.002)
        t[0] += 0.25
        led.settle_step()
    led.note_compiled_path()
    t[0] += 0.75  # an unexplained gap past the idle threshold
    led.charge("not a phase", 0.1)  # books as overhead


SCRIPTS = {"settle_residual": _settle_residual, "clipped": _clipped,
           "idle_split": _idle_split, "bracket_inner": _bracket_inner,
           "preemption": _preemption, "mid_bracket": _mid_bracket,
           "nested": _nested, "steps_and_compile": _steps_and_compile}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_ledger_phases_equal_the_jax_ledgers(name):
    """One script on both ledgers: every phase, the wall, the
    unattributed tail, the ratio, the steps, the compiled-path flag and
    the dominant sink equal as floats, live and after a final settle."""
    ours, t1 = _ledger(tled, treg)
    ref, t2 = _ledger(jled, jreg)
    SCRIPTS[name](ours, t1)
    SCRIPTS[name](ref, t2)
    assert ours.snapshot() == ref.snapshot()
    assert ours.dominant_sink() == ref.dominant_sink()
    assert ours.finalize() == ref.finalize()
    assert tled.PHASES == jled.PHASES
    assert tled.IDLE_THRESHOLD_S == jled.IDLE_THRESHOLD_S


def test_health_label_and_disabled_ledger_as_the_jax_ones(monkeypatch):
    for mod, reg in ((tled, treg), (jled, jreg)):
        led, _ = _ledger(mod, reg, enabled=False)
        with led.phase("re-rendezvous", charge="rendezvous_recovery"):
            with led.phase("ckpt_restore", charge="rendezvous_recovery"):
                assert led.active_health_label() == "ckpt_restore"
            assert led.active_health_label() == "re-rendezvous"
        led.charge("data_wait", 1.0)
        led.settle_step()
        assert not led.started and led.active_health_label() is None
    monkeypatch.setenv("HOROVOD_GOODPUT", "0")
    assert not tled.enabled() and not jled.enabled()
    monkeypatch.setenv("HOROVOD_GOODPUT", "1")
    assert tled.enabled() and jled.enabled()


def test_ledger_mirrors_into_the_registry_as_the_jax_one():
    outs = []
    for mod, reg_mod in ((tled, treg), (jled, jreg)):
        reg = reg_mod.MetricsRegistry()
        t = [0.0]
        led = mod.TimeLedger(clock=lambda: t[0], registry=reg, enabled=True)
        led.start()
        led.charge("data_wait", 0.25)
        t[0] = 1.0
        led.settle_step()
        outs.append(reg.render_prometheus())
    assert outs[0] == outs[1]


def _synth_dump(mod, reg_mod, directory, rank, phases, steps=4):
    led, t = _ledger(mod, reg_mod)
    led.start()
    for p, s in phases.items():
        led.charge(p, s)
    t[0] = sum(phases.values()) + 1.0
    led.settle_step()
    led._steps_settled = steps
    return led.write_dump(str(directory), rank)


def test_report_on_the_same_dumps_gives_the_same_text(tmp_path, capsys):
    """Dumps of both packages (one rank each, two elastic lives of rank
    2, a merged trace beside them) read by both reports: the same dict
    and the same text, and ``hvd-doctor perf`` of the port prints it."""
    from horovod_tpu_torch.diag.doctor import doctor_cli
    (tmp_path / "e1").mkdir()
    (tmp_path / "e2").mkdir()
    _synth_dump(tled, treg, tmp_path, 0, {"data_wait": 3.0,
                                          "ckpt_stall": 0.5})
    _synth_dump(jled, jreg, tmp_path, 1, {"data_wait": 2.0, "compile": 1.0})
    _synth_dump(tled, treg, tmp_path / "e1", 2, {"compile": 0.5})
    _synth_dump(tled, treg, tmp_path / "e2", 2,
                {"rendezvous_recovery": 1.0})
    import json
    (tmp_path / "merged.json").write_text(json.dumps(
        [{"name": "a", "ph": "i", "ts": 0, "pid": 0},
         {"name": "b", "ph": "i", "ts": 4_500_000, "pid": 0}]))
    texts = []
    for mod in (treport, jreport):
        dumps, skipped = mod.load_dumps(str(tmp_path))
        assert sorted(dumps) == [0, 1, 2] and not skipped
        report = mod.aggregate(dumps)
        mod.crosscheck_trace(report, str(tmp_path / "merged.json"))
        texts.append((report, mod.format_report(report)))
    assert texts[0] == texts[1]
    assert "DOMINANT TIME SINK (fleet): data_wait" in texts[0][1]
    assert doctor_cli(["perf", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert texts[0][1] in out
    block = treport.goodput_block(_ledger(tled, treg)[0], validate=False)
    assert set(block) == set(jreport.goodput_block(
        _ledger(jled, jreg)[0], validate=False))


@pytest.fixture()
def cpu_world():
    hvd_t.shutdown()
    hvd_t.init(device="cpu")
    yield hvd_t
    hvd_t.shutdown()


def test_lm_step_settles_every_step(cpu_world):
    from horovod_tpu_torch import training
    from horovod_tpu_torch.models.transformer import (Transformer,
                                                      TransformerConfig)
    cfg = TransformerConfig(vocab_size=64, num_layers=1, num_heads=2,
                            d_model=32, d_ff=64, dtype=torch.float32)
    model = Transformer(cfg, generator=torch.Generator().manual_seed(0))
    opt = hvd_t.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                     lr=0.1))
    step = training.make_lm_train_step(model, opt)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, 64, size=(2, 16)))
    led = tled.get_ledger()
    assert led is cpu_world.basics._state.ledger
    for _ in range(4):
        step(tokens)
    snap = led.snapshot()
    assert snap["steps"] == 4 and snap["phases"]["compute"] > 0
    # the step's collectives book as compute, not exposed
    assert snap["phases"]["exposed_collective"] == 0.0
    hvd_t.allreduce(torch.ones(3))
    assert led.snapshot()["phases"]["exposed_collective"] > 0
    fin = led.finalize()
    assert fin["unattributed_seconds"] <= 0.02 * fin["wall_seconds"]


def test_loader_charges_data_wait_and_checkpointer_ckpt_stall(cpu_world,
                                                              tmp_path):
    import time

    from horovod_tpu_torch import data
    from horovod_tpu_torch.ckpt import AsyncCheckpointer
    from horovod_tpu_torch.telemetry import instruments as tinst

    class Slow(data.ArraySource):
        def batch(self, idx):
            time.sleep(0.06)
            return super().batch(idx)

    x = np.arange(32, dtype=np.float32).reshape(16, 2)
    inst = tinst.data_instruments(treg.MetricsRegistry())
    led = tled.get_ledger()
    with data.PrefetchLoader(Slow((x,)), 4, rank=0, world=1, epochs=1,
                             depth=1, telemetry=inst) as loader:
        got = sum(1 for _ in loader)
    assert got == 4 and inst.batches.value == 4
    assert led.snapshot()["phases"]["data_wait"] >= 0.05
    assert inst.wait_seconds.sum >= 0.05
    reg = treg.MetricsRegistry()
    ck = AsyncCheckpointer(str(tmp_path / "ck"), rank=0, world=1,
                           registry=reg)
    stall0 = led.snapshot()["phases"]["ckpt_stall"]
    ck.save(1, {"w": np.arange(64, dtype=np.float32)}, block=True)
    ck.close()
    assert led.snapshot()["phases"]["ckpt_stall"] > stall0
    assert reg.get(tinst.CKPT_SAVE_SECONDS).count == 1
    assert reg.get(tinst.CKPT_BYTES_WRITTEN).value > 0
    assert reg.get(tinst.CKPT_INFLIGHT).value == 0


def test_two_rank_injected_stall_attribution(tmp_path, capsys):
    """Two ranks' ledgers on a fake clock: each step charges an injected
    data stall as the loader does, every other save an injected
    checkpoint stall as the checkpointer does, the step's compute
    settles; the dumps' report attributes exactly the injected seconds
    and names ``data_wait`` the dominant sink, fleet-wide and on each
    rank."""
    from horovod_tpu_torch.diag.doctor import doctor_cli
    steps, data_s, ckpt_s, compute_s = 8, 0.05, 0.03, 0.02
    for rank in (0, 1):
        led, t = _ledger(tled, treg)
        led.start()
        for i in range(steps):
            t[0] += data_s * (rank + 1)
            led.charge("data_wait", data_s * (rank + 1))
            if i % 2:
                t[0] += ckpt_s
                led.charge("ckpt_stall", ckpt_s)
            t[0] += compute_s
            led.settle_step()
        assert led.write_dump(str(tmp_path), rank,
                              extra={"build_info": {"world": "2"}})
    dumps, _ = treport.load_dumps(str(tmp_path))
    report = treport.aggregate(dumps)
    for rank in (0, 1):
        phases = report["ranks"][rank]["phases"]
        assert phases["data_wait"] == pytest.approx(steps * data_s
                                                    * (rank + 1))
        assert phases["ckpt_stall"] == pytest.approx(steps // 2 * ckpt_s)
        assert phases["compute"] == pytest.approx(steps * compute_s)
        assert report["ranks"][rank]["unattributed_seconds"] < 1e-6
        assert report["ranks"][rank]["dominant_sink"] == "data_wait"
    assert report["fleet"]["dominant_sink"] == "data_wait"
    assert doctor_cli(["perf", str(tmp_path)]) == 0
    assert "DOMINANT TIME SINK (fleet): data_wait" in capsys.readouterr().out
