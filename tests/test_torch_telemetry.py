"""The port's telemetry plane against the JAX package's: the registry's
exposition text byte for byte, the instrument catalogue, the metrics
server's four endpoints, the host timeline and the cross-rank merge, and
a small LM trained through ``make_train_step(telemetry=True)`` bit for
bit as with telemetry off, with its counters equal to the schedule's
and no sync in the step."""

import json
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd_t
from horovod_tpu.telemetry import instruments as jinst
from horovod_tpu.telemetry import merge as jmerge
from horovod_tpu.telemetry import registry as jreg
from horovod_tpu_torch.telemetry import instruments as tinst
from horovod_tpu_torch.telemetry import merge as tmerge
from horovod_tpu_torch.telemetry import registry as treg


@pytest.fixture()
def cpu_world():
    hvd_t.shutdown()
    hvd_t.init(device="cpu")
    yield hvd_t
    hvd_t.shutdown()


# -- the registry ------------------------------------------------------------

def _script(reg_mod):
    """One sequence of registry operations (every kind, labels with
    escapes, custom buckets, a deferred gauge, aliases, unregister)."""
    r = reg_mod.MetricsRegistry()
    r.install_aliases({"hvd_a_total": "horovod_a_total"})
    c = r.counter("hvd_a_total", 'help with "quotes"\nand a newline')
    c.inc()
    c.inc(2.5)
    lc = r.counter("hvd_b_total", "labelled", label_names=("op", "kind"))
    lc.labels("allreduce", 'q"x').inc(7)
    lc.labels("alltoall", "a\\b").inc(1e-7)
    g = r.gauge("hvd_g", "a gauge")
    g.set(3)
    g.inc(0.25)
    g.dec(1)
    r.gauge("hvd_fn").set_function(lambda: 1.0 / 3.0)
    r.gauge("hvd_bad").set_function(lambda: 1 / 0)
    h = r.histogram("hvd_h_seconds", "a histogram")
    for v in (0.0005, 0.003, 0.003, 1.5, 200.0):
        h.observe(v)
    hl = r.histogram("hvd_fill", "fill", label_names=("kind",),
                     buckets=tuple(i / 10 for i in range(1, 11)))
    for i, v in enumerate((0.05, 0.5, 0.95, 1.0)):
        hl.labels("rs" if i % 2 else "ag").observe(v)
    r.counter("hvd_empty", "labelled, no children", label_names=("x",))
    r.counter("hvd_gone").inc()
    r.unregister("hvd_gone")
    return r


def test_registry_exposition_is_the_jax_registrys_byte_for_byte():
    ours, ref = _script(treg), _script(jreg)
    assert ours.render_prometheus() == ref.render_prometheus()
    a, b = ours.snapshot(), ref.snapshot()
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], float) and np.isnan(a[k]):
            assert np.isnan(b[k])
        else:
            assert a[k] == b[k], k
    hist = ours.get("hvd_h_seconds")
    assert [hist.quantile(q) for q in (0.5, 0.9, 1.0)] == [
        ref.get("hvd_h_seconds").quantile(q) for q in (0.5, 0.9, 1.0)]
    with pytest.raises(ValueError):
        ours.gauge("hvd_a_total")


# -- the instrument catalogue ------------------------------------------------

def _families(inst, reg_mod, ledger_mod):
    """Every family the catalogue's helpers register, in a fresh
    registry: ``{name: (kind, help, label names)}``."""
    r = reg_mod.MetricsRegistry()
    inst.StepInstruments(registry=r)
    inst.ckpt_instruments(r)
    inst.data_instruments(r)
    inst.stalled_ranks_gauge(r)
    inst.record_xray({"device_seconds": {"idle": 1.0},
                      "bucketed_fraction": 1.0,
                      "collectives": {"all_reduce": {
                          "exposed_seconds": 0.1, "effective_gbps": 2.0}}},
                     registry=r)
    ledger_mod.TimeLedger(registry=r, enabled=True).start()
    out = {}
    for name, m in r._metrics.items():
        out[name] = (m.kind, m.help, m.label_names)
    return out


def _default_families(inst, reg):
    inst.record_collective("allreduce", 8, logical_nbytes=16)
    inst.record_bucket("rs", 0.5, 8, dispatch_s=0.001, dtype="float32")
    inst.install_compile_listeners()
    names = (inst.COLLECTIVE_CALLS, inst.COLLECTIVE_BYTES,
             inst.COLLECTIVE_LOGICAL_BYTES, inst.WIRE_BYTES,
             inst.WIRE_LOGICAL_BYTES, inst.WIRE_COMPRESSION_RATIO,
             inst.BUCKET_FILL_RATIO, inst.BUCKET_DISPATCH_SECONDS,
             inst.COMPILE_SECONDS, inst.COMPILE_CACHE_HITS,
             inst.COMPILE_CACHE_MISSES)
    out = {}
    for n in names:
        m = reg.get_registry().get(n)
        out[n] = (m.kind, m.help, m.label_names)
    return out


def test_instrument_catalogue_is_the_jax_catalogue_less_serve():
    from horovod_tpu.telemetry import ledger as jled
    from horovod_tpu_torch.telemetry import ledger as tled
    want = tuple(n for n in jinst.CATALOGUE
                 if not n.startswith("hvd_serve_"))
    assert tinst.CATALOGUE == want
    assert tinst.LEGACY_ALIASES == jinst.LEGACY_ALIASES
    for name in want:
        const = [k for k, v in vars(jinst).items() if v == name
                 and k.isupper()]
        assert const and all(getattr(tinst, k) == name for k in const)
    ours = _families(tinst, treg, tled)
    assert ours == _families(jinst, jreg, jled)
    assert _default_families(tinst, treg) == _default_families(jinst, jreg)
    # the default registry serves the legacy names, as the JAX one does
    text = treg.get_registry().render_prometheus()
    assert "horovod_collective_calls_total{op=\"allreduce\"}" in text


def test_build_info_names_torch_cuda_and_the_device():
    r = treg.MetricsRegistry()
    tinst.build_info_gauge(registry=r)
    m = r.get(tinst.BUILD_INFO)
    assert m.label_names == ("version", "torch", "cuda", "device", "world")
    (labels, value), = m.sample().items()
    assert value == 1.0 and labels[1] == torch.__version__
    assert labels[3] == ("cpu" if not torch.cuda.is_available()
                         else labels[3])
    assert set(tinst.build_info_labels()) == set(m.label_names)


def test_record_compile_books_the_ledger_and_counters():
    from horovod_tpu_torch.telemetry import ledger as tled
    led = tled.reset_run(registry=treg.MetricsRegistry())
    reg = treg.get_registry()
    before = reg.get(tinst.COMPILE_SECONDS).value
    hits = reg.get(tinst.COMPILE_CACHE_HITS).value
    tinst.record_compile(0.25, cache_hit=True)
    tinst.record_compile(0.5)
    assert reg.get(tinst.COMPILE_SECONDS).value == before + 0.75
    assert reg.get(tinst.COMPILE_CACHE_HITS).value == hits + 1
    assert led.snapshot()["phases"]["compile"] == 0.75


# -- the server ----------------------------------------------------------------

def _get(port, path, timeout=60):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=timeout) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _tiny_lm(seed=0, layers=1, d=32, vocab=64):
    from horovod_tpu_torch.models.transformer import (Transformer,
                                                      TransformerConfig)
    cfg = TransformerConfig(vocab_size=vocab, num_layers=layers,
                            num_heads=2, d_model=d, d_ff=2 * d,
                            dtype=torch.float32)
    return Transformer(cfg, generator=torch.Generator().manual_seed(seed))


def test_server_endpoints(cpu_world, tmp_path):
    from horovod_tpu_torch import diag, training
    from horovod_tpu_torch.telemetry import ledger as tled
    from horovod_tpu_torch.telemetry.server import MetricsServer
    reg = treg.MetricsRegistry()
    reg.counter("hvd_step_total", "steps").inc(3)
    led = tled.get_ledger()
    srv = MetricsServer(port=0, registry=reg, profile_dir=str(tmp_path),
                        health_fn=lambda: (
                            {"status": "recovering", "phase": p}
                            if (p := led.active_health_label()) else
                            {"step": 3}))
    port = srv.start()
    try:
        code, text = _get(port, "/metrics")
        assert code == 200 and text == reg.render_prometheus()
        code, body = _get(port, "/healthz")
        assert code == 200 and json.loads(body)["step"] == 3
        with led.phase("ckpt_restore", charge="rendezvous_recovery"):
            code, body = _get(port, "/healthz")
        assert code == 503 and json.loads(body)["phase"] == "ckpt_restore"
        code, _ = _get(port, "/flightrec")
        assert code == 404
        diag.install(dump_dir=str(tmp_path / "fr"), handle_signals=False)
        try:
            code, body = _get(port, "/flightrec?dump=1")
            assert code == 200 and json.loads(body)["flightrec"] == 1
            assert (tmp_path / "fr" / "flightrec.rank0.json").exists()
        finally:
            diag.uninstall(dump=False)
        code, _ = _get(port, "/profile?result=1")
        assert code == 404
        # the capture opens and closes on the steps' thread: steps run
        # here while the request waits on another
        model = _tiny_lm()
        opt = hvd_t.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1))
        step = training.make_lm_train_step(model, opt)
        tokens = torch.from_numpy(np.random.default_rng(0).integers(
            0, 64, size=(2, 16)))
        got = {}
        t = threading.Thread(target=lambda: got.update(
            r=_get(port, "/profile?seconds=0.1&wait=1", timeout=120)))
        t.start()
        while t.is_alive():
            step(tokens)
            t.join(0.01)
        code, body = got["r"]
        summary = json.loads(body)["summary"]
        assert code == 200 and summary["device_lanes"] >= 1
        assert summary["bucketed_fraction"] >= 0.95
        code, body = _get(port, "/profile?result=1")
        assert code == 200 and json.loads(body)["summary"] == summary
        assert list(tmp_path.glob("plugins/profile/*/xray.rank0.json"))
        code, _ = _get(port, "/nope")
        assert code == 404
    finally:
        srv.stop()


# -- the timeline and the merge ------------------------------------------------

def _trace_files(tmp_path):
    a = tmp_path / "t.rank0.json"
    b = tmp_path / "t.rank1.json"
    c = tmp_path / "t.rank2.json"
    a.write_text(json.dumps([
        {"name": jmerge.CLOCK_SYNC, "ph": "i", "ts": 0, "pid": 0,
         "args": {"unix_time_us": 10_000_000, "rank": 0}},
        {"name": "s", "ph": "i", "ts": 100, "pid": 0},
        {"name": "step_dispatch", "cat": "flow", "ph": "s", "id": 1,
         "ts": 5, "pid": 0, "tid": "marker"},
        {"name": "hop", "cat": jmerge.GLOBAL_FLOW_CAT, "ph": "f", "id": 9,
         "ts": 6, "pid": 0}]))
    # torn: a half-written event and no closing bracket
    b.write_text(json.dumps([
        {"name": jmerge.CLOCK_SYNC, "ph": "i", "ts": 0, "pid": 0,
         "args": {"unix_time_us": 10_001_500, "rank": 1}},
        {"name": "s", "ph": "i", "ts": 100, "pid": 0}])[:-1]
        + ',\n{"name": "half", "ph": "X", "ar')
    c.write_text(json.dumps([{"name": "x", "ph": "i", "ts": 7, "pid": 0}]))
    return [str(a), str(b), str(c)]


def test_merge_is_the_jax_merge(tmp_path):
    paths = _trace_files(tmp_path)
    ours = tmerge.merge_traces(paths, str(tmp_path / "ours.json"))
    ref = jmerge.merge_traces(paths, str(tmp_path / "ref.json"))
    assert ours == ref
    assert (tmp_path / "ours.json").read_text() == \
        (tmp_path / "ref.json").read_text()
    assert tmerge.CLOCK_SYNC == jmerge.CLOCK_SYNC
    rc = tmerge.main(["-o", str(tmp_path / "cli.json"),
                      str(tmp_path / "t.rank*.json")])
    assert rc == 0 and json.loads(
        (tmp_path / "cli.json").read_text()) == ours


def test_port_timeline_reads_in_both_merges(tmp_path):
    from horovod_tpu_torch.utils.timeline import Timeline
    paths = []
    for rank in (0, 1):
        p = tmp_path / f"host.rank{rank}.json"
        tl = Timeline(str(p), rank=rank, host="h")
        flow = tl.flow_start("step_dispatch")
        tl.bucket_marker("RS", 0, 1024, flow_id=flow)
        tl.counter("step", {"step_ms": 1.5})
        tl.flow_end("step_dispatch", flow)
        tl.close()
        tl.close()  # idempotent
        assert json.loads(p.read_text())[0]["name"] == "process_name"
        paths.append(str(p))
    ours = tmerge.merge_traces(paths)
    assert ours == jmerge.merge_traces(paths)
    ids = {e["id"] for e in ours if e.get("ph") in ("s", "t", "f")}
    assert ids == {1, 1_000_001}  # namespaced per rank


# -- the train step with telemetry on ------------------------------------------

def _lm_run(tele, steps, tokens, monkeypatch=None):
    from horovod_tpu_torch import convert, training
    model = _tiny_lm(seed=5, layers=2)
    opt = hvd_t.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-3),
        named_parameters=convert.flax_named_parameters(model),
        sharded_update=True)
    step = training.make_train_step(model, opt, accum_steps=2,
                                    overlap_grads=True, telemetry=tele)
    x, y = tokens[:, :-1], tokens[:, 1:]
    if monkeypatch is not None:
        real_item = torch.Tensor.item
        pkg = str(__import__("pathlib").Path(training.__file__).parent)

        def item(self):
            if sys._getframe(1).f_code.co_filename.startswith(pkg):
                raise AssertionError("the step read a tensor (.item())")
            return real_item(self)

        def no_sync(*a, **k):
            raise AssertionError("the step synchronized the device")

        monkeypatch.setattr(torch.Tensor, "item", item)
        monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    losses = [step(x, y) for _ in range(steps - 1)]
    if monkeypatch is not None:
        monkeypatch.undo()
    ref_norm = _accum_grad_norm(model, x, y, microbatches=2)
    if monkeypatch is not None:
        monkeypatch.setattr(torch.Tensor, "item", item)
        monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    losses.append(step(x, y))
    if monkeypatch is not None:
        monkeypatch.undo()
    return ([float(v) for v in losses],
            {n: p.detach().clone() for n, p in model.named_parameters()},
            step, ref_norm)


def _accum_grad_norm(model, x, y, microbatches):
    """Plain autograd on a copy of ``model``: the norm of the mean of the
    microbatches' gradients, the averaged gradient of one step at world
    1."""
    import copy
    from horovod_tpu_torch import training
    m = copy.deepcopy(model)
    for p in m.parameters():
        p.grad = None
    n = x.shape[0] // microbatches
    sum(training.softmax_cross_entropy(m(x[k * n:(k + 1) * n]),
                                       y[k * n:(k + 1) * n])
        for k in range(microbatches)).div(microbatches).backward()
    return float(torch.linalg.vector_norm(torch.cat(
        [p.grad.reshape(-1).double() for p in m.parameters()])))


def _count(reg, name, labels=None):
    m = reg.get(name)
    if m is None:
        return 0
    if labels is None:
        return m.value if m.kind != "histogram" else m.count
    child = m.labels(*labels)
    return child.count if m.kind == "histogram" else child.value


def test_lm_step_with_telemetry_is_bit_for_bit_and_counts(cpu_world,
                                                          monkeypatch):
    steps = 3
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, 64, size=(4, 17)))
    off_losses, off_params, _, _ = _lm_run(False, steps, tokens)
    reg = treg.get_registry()
    before = {k: _count(reg, *k) for k in (
        (tinst.STEP_TOTAL,), (tinst.EXAMPLES_TOTAL,),
        (tinst.BUCKET_FILL_RATIO, ("rs",)),
        (tinst.BUCKET_FILL_RATIO, ("ag",)),
        (tinst.BUCKET_DISPATCH_SECONDS, ("rs",)))}
    on_losses, on_params, step, ref_norm = _lm_run(True, steps, tokens,
                                                   monkeypatch)
    assert on_losses == off_losses
    for n, p in off_params.items():
        assert torch.equal(on_params[n], p), n
    nb = len(step.schedule.buckets)
    after = {k: _count(reg, *k) for k in before}
    assert after[(tinst.STEP_TOTAL,)] - before[(tinst.STEP_TOTAL,)] == steps
    assert after[(tinst.EXAMPLES_TOTAL,)] - \
        before[(tinst.EXAMPLES_TOTAL,)] == steps * 4
    # 2 microbatches reduce-scatter every bucket; ZeRO-1 gathers each once
    assert after[(tinst.BUCKET_FILL_RATIO, ("rs",))] - \
        before[(tinst.BUCKET_FILL_RATIO, ("rs",))] == steps * 2 * nb
    assert after[(tinst.BUCKET_DISPATCH_SECONDS, ("rs",))] - \
        before[(tinst.BUCKET_DISPATCH_SECONDS, ("rs",))] == steps * 2 * nb
    assert after[(tinst.BUCKET_FILL_RATIO, ("ag",))] - \
        before[(tinst.BUCKET_FILL_RATIO, ("ag",))] == steps * nb
    # the deferred gauges read at scrape time: the last loss, and the
    # norm of the last step's averaged gradient (plain autograd's; the
    # two-rank paths are held in tests/test_torch_gspmd.py)
    assert reg.get(tinst.LOSS).value == on_losses[-1]
    np.testing.assert_allclose(reg.get(tinst.GRAD_NORM).value, ref_norm,
                               rtol=1e-5)
    assert step.instruments.steps is reg.get(tinst.STEP_TOTAL)


def test_allgather_with_logical_bytes_stays_differentiable(cpu_world):
    """A byte count for the counters does not change the call's path:
    the gather still carries a gradient."""
    from horovod_tpu_torch.ops import collective
    child = treg.get_registry().counter(
        tinst.COLLECTIVE_LOGICAL_BYTES, label_names=("op",)).labels(
            "allgather")
    before = child.value
    x = torch.randn(3, 2, requires_grad=True)
    out = collective.allgather(x, logical_nbytes=96)
    (out * 2).sum().backward()
    assert torch.equal(out.detach(), x.detach())
    assert torch.equal(x.grad, torch.full_like(x, 2.0))
    assert child.value - before == 96
