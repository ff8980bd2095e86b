"""Request tracing and the serve doctor of the port
(horovod_tpu_torch/serve/tracing.py, diag/serve_doctor.py) against the JAX
package's (tests/test_serve_tracing.py's contract):

* the span table and the doctor's classifier are JAX's, both ways;
* ``RequestTrace.finalize`` gives JAX's dict on the same scripts; the
  tracer's sampling, SLO tail and env knobs decide alike;
* on one fake clock the port engine's traces equal the JAX engine's
  dict for dict;
* tracing shapes nothing: a traced and an untraced engine give the same
  tokens and launch the same operations;
* each doctor reads the other package's dumps and reports alike;
* a fleet's chaos eviction: one trace spans both replicas, the doctor
  charges the hop window, the Chrome merge links cut -> resume.
"""

import io
import json
import time

import pytest
from torch.utils._python_dispatch import TorchDispatchMode

from test_torch_serve import (  # noqa: F401
    JAX,
    PORT,
    make_engine,
    one_torch_thread,
    oracle,
    prompts,
    run_until,
)
from test_torch_serve_fleet import make_fleet, wait_mid_stream

from horovod_tpu.diag import serve_doctor as jdoctor
from horovod_tpu.serve import tracing as jtracing
from horovod_tpu_torch.diag import serve_doctor as tdoctor
from horovod_tpu_torch.serve import tracing as ttracing
from horovod_tpu_torch.telemetry import instruments
from horovod_tpu_torch.telemetry.registry import MetricsRegistry

TRACING = {False: jtracing, True: ttracing}


def test_span_table_matches_jax_and_both_classifiers():
    assert ttracing.SPAN_KINDS == jtracing.SPAN_KINDS
    assert set(ttracing.SPAN_KINDS) == set(tdoctor.PHASE_OF_KIND)
    assert tdoctor.PHASE_OF_KIND == jdoctor.PHASE_OF_KIND
    assert tdoctor.STALL_PHASES == jdoctor.STALL_PHASES
    for phase in tdoctor.STALL_PHASES:
        assert phase in set(tdoctor.PHASE_OF_KIND.values())
    assert ttracing._GAP_KIND_OF_PHASE == jtracing._GAP_KIND_OF_PHASE
    assert (ttracing.TRACE_ENV, ttracing.TRACE_DIR_ENV,
            ttracing.TRACE_SLO_ENV, ttracing.NDJSON_NAME) == \
        (jtracing.TRACE_ENV, jtracing.TRACE_DIR_ENV, jtracing.TRACE_SLO_ENV,
         jtracing.NDJSON_NAME)


def _script(mod, name):
    tr = mod.RequestTrace(f"r-{name}", clock=lambda: 0.0)
    if name == "tiles":
        tr.phase(0.0, "queued")
        tr.span("dispatch", 1.0, 1.2, actor="router")
        tr.phase(1.2, "prefilling")
        tr.span("prefill", 1.4, 2.0, actor="r0", chunk=[0, 4])
        tr.phase(2.0, "decoding")
        tr.span("decode", 2.0, 3.0, actor="r0", batch=2)
        return tr.finalize(end=4.0)
    if name == "unattributed":
        tr.span("decode", 1.0, 2.0)
        return tr.finalize(end=4.0)
    if name == "drain_hop":
        tr.phase(0.0, "queued")
        tr.event("submit", 0.0, actor="r0")
        tr.event("drain", 0.1, actor="r0", on=True)
        tr.event("cut", 2.0, actor="r0")
        tr.phase(2.0, "redispatching")
        tr.event("resumed", 2.5, actor="r1")
        tr.phase(2.5, "decoding")
        tr.span("decode", 2.5, 3.0, actor="r1")
        return tr.finalize(end=3.0)
    if name == "other_drain":
        tr.event("drain", 0.1, actor="r9", on=True)
        tr.event("cut", 2.0, actor="r0")
        tr.event("resumed", 2.5, actor="r1")
        return tr.finalize(end=3.0)
    if name == "two_hops":
        tr.phase(0.0, "queued")
        for k, (c, r) in enumerate(((1.0, 1.5), (2.0, 2.2))):
            tr.event("cut", c, actor=f"r{k}", hop=k + 1)
            tr.phase(c, "redispatching")
            tr.event("resumed", r, actor=f"r{k + 1}")
            tr.phase(r, "decoding")
            tr.span("decode", r, r + 0.3, actor=f"r{k + 1}")
        tr.phase(2.5, "decoding")
        tr.phase(2.5, "decoding")
        return tr.finalize(end=3.0)
    raise ValueError(name)


@pytest.mark.parametrize("name", ["tiles", "unattributed", "drain_hop",
                                  "other_drain", "two_hops"])
def test_finalize_matches_jax(name):
    j, t = _script(jtracing, name), _script(ttracing, name)
    assert t == j
    assert tdoctor.phase_totals(t) == jdoctor.phase_totals(j)
    assert tdoctor.dominant_stall(tdoctor.phase_totals(t)) == \
        jdoctor.dominant_stall(jdoctor.phase_totals(j))


def test_tracer_sampling_slo_and_env_match_jax():
    for mod in (jtracing, ttracing):
        t = mod.ServeTracer(sample=0.25, clock=lambda: 0.0)
        assert sum(t.begin(i) is not None for i in range(100)) == 25
    runs = []
    for mod in (jtracing, ttracing):
        clk = {"t": 0.0}
        t = mod.ServeTracer(sample=0.0, slo_ms=100.0, clock=lambda: clk["t"])
        fast = t.begin("fast")
        clk["t"] = 0.05
        a = t.finish(fast)
        slow = t.begin("slow")
        clk["t"] = 0.25
        runs.append((fast.keep, a, t.finish(slow), t.traces()))
    assert runs[0] == runs[1]
    envs = [{}, {"HOROVOD_SERVE_TRACE": "0"}, {"HOROVOD_SERVE_TRACE": "1"},
            {"HOROVOD_SERVE_TRACE": "0.5"}, {"HOROVOD_SERVE_TRACE": "junk"},
            {"HOROVOD_SERVE_TRACE_SLO_MS": "250"},
            {"HOROVOD_SERVE_TRACE_SLO_MS": "x", "HOROVOD_SERVE_TRACE": "on"}]
    for env in envs:
        got = []
        for mod in (jtracing, ttracing):
            t = mod.ServeTracer.from_env(env=env)
            got.append(None if t is None else (t.sample, t.slo_ms,
                                               t.out_dir))
        assert got[0] == got[1], env
    t = ttracing.ServeTracer.from_env(env={}, out_dir="/tmp/x")
    assert t.sample == 0.0 and t.out_dir == "/tmp/x"


class TickClock:
    """A fake clock that moves 1 ms at every read: both packages' engines
    read it in the same order, so their traces match to the float."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 0.001
        return self.t


def _traced_run(side, out_dir=None):
    clk = TickClock()
    tracer = TRACING[side.port].ServeTracer(sample=1.0, clock=clk,
                                            out_dir=out_dir)
    eng = make_engine(side, max_slots=2, clock=clk, tracer=tracer)
    shared = prompts(8, (8,))[0]
    R = side.engine.Request
    reqs = [eng.submit(R(shared + tail, 4, request_id=i))
            for i, tail in enumerate(prompts(9, (3, 3, 3)))]
    run_until(eng, reqs)
    eng.set_draining(True)
    eng.set_draining(False)
    late = eng.submit(R(shared[:5], 3, request_id=9, trace=True))
    run_until(eng, [late])
    tracer.close()
    return tracer.traces(), [r.generated for r in reqs + [late]], eng


def test_engine_traces_match_jax_on_one_fake_clock():
    (jt, jtok, _), (tt, ttok, eng) = _traced_run(JAX), _traced_run(PORT)
    assert ttok == jtok
    assert tt == jt
    for tr in tt:
        assert tr["attributed_fraction"] >= 0.98
        kinds = {s["kind"] for s in tr["spans"] if not s.get("gap")}
        assert {"prefill", "decode"} <= kinds
        assert {"submit", "admitted", "done"} <= {e["name"]
                                                   for e in tr["events"]}
    cached = [e["cached_tokens"] for tr in tt for e in tr["events"]
              if e["name"] == "admitted"]
    assert max(cached) > 0
    assert eng._live_traces == 0


class OpLog(TorchDispatchMode):
    """Every aten operation dispatched while it is on."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def test_traced_engine_launches_what_the_untraced_one_does():
    """Tracing is host bookkeeping: the same tokens, and the same aten
    operations in the same order."""
    ps = prompts(7, (6, 6, 6))

    def run(tracer):
        eng = make_engine(PORT, max_slots=2, tracer=tracer)
        reqs = [eng.submit(PORT.engine.Request(p, 5)) for p in ps]
        with OpLog() as log:
            run_until(eng, reqs)
        return [r.generated for r in reqs], log.ops, eng.dispatches

    off, on = run(None), run(ttracing.ServeTracer(sample=1.0))
    assert on[0] == off[0]
    assert on[1] == off[1] and len(on[1]) > 100
    assert on[2] == off[2]


def test_untraced_hot_path_records_nothing():
    eng = make_engine(PORT, max_slots=2)
    r = eng.submit(PORT.engine.Request(list(range(5)), 4))
    run_until(eng, [r])
    assert r.trace is None and eng._live_traces == 0
    assert r.admitted_at is not None
    assert r.first_token_time >= r.admitted_at >= r.arrival


def test_each_doctor_reads_the_others_dumps(tmp_path):
    """The fake-clock runs' ndjson dumps, one from each package: the
    port's doctor over JAX's dump and JAX's over the port's give the
    same reports, equal to each package's own."""
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    _traced_run(JAX, out_dir=str(jdir))
    _traced_run(PORT, out_dir=str(tdir))
    reports = {}
    for name, doctor in (("jax", jdoctor), ("port", tdoctor)):
        for dump in (jdir, tdir):
            for slo in (None, 5.0):
                paths = doctor.find_dumps(str(dump))
                traces, skipped = doctor.load_traces(paths)
                assert skipped == 0 and len(traces) == 4
                reports[(name, dump.name, slo)] = doctor.aggregate(
                    traces, slo_ms=slo)
    for slo in (None, 5.0):
        want = reports[("jax", "jax", slo)]
        for key, rep in reports.items():
            if key[2] == slo:
                assert rep == want, key
    buf_j, buf_t = io.StringIO(), io.StringIO()
    jdoctor.run(str(tdir), slo_ms=5.0, stream=buf_j)
    tdoctor.run(str(jdir), slo_ms=5.0, stream=buf_t)
    assert buf_t.getvalue() == buf_j.getvalue()
    assert "hvd-doctor serve" in buf_t.getvalue()
    # a half-written trailing line is skipped, not fatal
    with open(tdir / ttracing.NDJSON_NAME, "a") as fh:
        fh.write('{"request_id": "torn"')
    assert tdoctor.load_traces(tdoctor.find_dumps(str(tdir)))[1] == 1
    assert tdoctor.main([str(tdir), "--json"]) == 0
    assert tdoctor.main([str(tmp_path / "none")]) == 2


def test_attribution_snapshot_windows_under_concurrent_streams():
    eng = make_engine(PORT, kv=dict(num_blocks=128)).start()
    try:
        warm = eng.generate(prompts(9, (4,))[0], 2)
        warm.result(timeout=60)
        base = eng.attribution_snapshot()
        t0 = time.monotonic()
        reqs = [eng.generate(p, 8) for p in prompts(10, (5,) * 6)]
        mid = eng.attribution_snapshot()
        for r in reqs:
            r.result(timeout=60)
        time.sleep(0.05)
        end = eng.attribution_snapshot()
        wall = time.monotonic() - t0
        assert set(end) == set(base)
        for k in end:
            assert end[k] >= mid[k] - 1e-9 >= base[k] - 2e-9
        explained = sum(end[k] - base[k] for k in end)
        assert 0.5 * wall <= explained <= wall + 0.25
    finally:
        eng.stop()


def test_fleet_chaos_trace_hop_doctor_and_chrome_merge(tmp_path):
    """2 replicas, streams cut by an eviction: a hopped stream's ONE trace
    spans both replicas, the doctor charges its hop window, and the
    merged Chrome trace links cut -> resume across pids."""
    reg = MetricsRegistry()
    out_dir = tmp_path / "st"
    tracer = ttracing.ServeTracer(sample=1.0, out_dir=str(out_dir))
    router, _ = make_fleet(reg, pace=0.003, num_blocks=128, mbps=16)
    router._tracer = tracer
    n_new = 24
    try:
        reqs = [router.generate(p, n_new) for p in prompts(41, (5,) * 5)]
        assert wait_mid_stream(reqs, n_new)
        router.evict("r0")
        for r in reqs:
            assert r.result(timeout=120) == oracle(r.prompt, n_new)
        assert router.dropped == 0
        bumped = {k: v + 1.0 for k, v in router.replica(
            "r1").engine._params.items()}
        hist = instruments.serve_weight_swap_histogram(reg)
        before = hist.count
        router.install_weights(bumped, version=2)
        assert hist.count > before
    finally:
        router.stop()
        tracer.close()
    traces = tracer.traces()
    assert len(traces) == len(reqs)
    hopped = [tr for tr in traces if tr["hops"]]
    assert hopped
    for tr in hopped:
        actors = {s.get("actor") for s in tr["spans"]} | \
            {e.get("actor") for e in tr["events"]}
        assert {"r0", "r1"} <= actors
        assert tr["attributed_fraction"] >= 0.98
        totals = tdoctor.phase_totals(tr)
        window = sum(b - a for a, b in tr["hop_windows"])
        assert totals.get("redispatch_hop", 0.0) == pytest.approx(
            window, rel=0.05, abs=1e-4)
    lines = [json.loads(ln) for ln in
             (out_dir / ttracing.NDJSON_NAME).read_text().splitlines() if ln]
    assert {t["request_id"] for t in lines} == \
        {t["request_id"] for t in traces}
    assert tdoctor.run(str(out_dir), stream=io.StringIO())["requests"] == 5
    merged_path = out_dir / "servetrace.merged.json"
    tracer.write_chrome(str(merged_path))
    merged = json.loads(merged_path.read_text())
    events = merged["traceEvents"] if isinstance(merged, dict) else merged
    names = {e["args"]["name"]: e["pid"] for e in events
             if e.get("name") == "process_name"}
    assert {"serve r0", "serve r1"} <= set(names)
    flows = [e for e in events if e.get("ph") in ("s", "f")]
    by_id = {}
    for e in flows:
        assert e["cat"] == "hvd_global_flow"
        by_id.setdefault(e["id"], []).append(e)
    assert any(len(pair) == 2 and pair[0]["pid"] != pair[1]["pid"]
               for pair in by_id.values())


def test_chrome_files_match_jax_on_the_fake_clock_traces(tmp_path):
    """The per-actor Chrome files of the same finalized traces: equal
    event for event but the wall-clock anchor."""
    traces, _, _ = _traced_run(PORT)
    out = []
    for mod in (jtracing, ttracing):
        t = mod.ServeTracer(sample=1.0, clock=lambda: 0.0)
        paths = t.chrome_files(str(tmp_path / mod.__name__), traces=traces)
        files = []
        for p in paths:
            events = json.loads(open(p).read())
            for e in events:
                e.get("args", {}).pop("unix_time_us", None)
            files.append(events)
        out.append(files)
    assert out[0] == out[1] and len(out[1]) == 1
