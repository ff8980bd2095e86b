"""The port's serve fleet (horovod_tpu_torch/serve/fleet) on the CPU: two
engine replicas behind the router, the JAX package's fleet contract
(tests/test_serve_fleet.py) on the same weights as
tests/test_torch_serve.py:

* a chaos eviction mid-stream drops nothing, and every stream equals the
  unbroken run's (the single-shot oracle in fp32; an unbroken engine's
  stream bit for bit in bf16, where the survivor replays the generated
  tokens through decode);
* a spot notice file drains its replica gracefully;
* a rolling reload never closes admission;
* dispatch skips a draining replica; headroom counts only the cache's
  sole-reference blocks; the router's clock stamps the client's
  latencies;
* the fleet frontend streams the JAX fleet frontend's lines, reports
  ``down`` when every replica is dead, and a submit after stop is loud.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from test_torch_serve import (  # noqa: F401
    JAX,
    PORT,
    make_engine,
    one_torch_thread,
    oracle,
    prompts,
    run_until,
)

from horovod_tpu.parallel import mesh as jmesh
from horovod_tpu.serve import fleet as jfleet
from horovod_tpu.telemetry import registry as jreg
from horovod_tpu_torch.serve import engine as tengine
from horovod_tpu_torch.serve.fleet import FleetRouter, FleetServer, Replica
from horovod_tpu_torch.serve.sampling import SamplingParams
from horovod_tpu_torch.telemetry import instruments
from horovod_tpu_torch.telemetry.registry import MetricsRegistry


def slow(eng, seconds=0.003):
    """Stretch each decode iteration so a stream is still in flight when
    the test evicts its replica (the arithmetic is untouched)."""
    decode = eng._decode_step

    def step(decoding):
        time.sleep(seconds)
        return decode(decoding)

    eng._decode_step = step
    return eng


def make_fleet(reg, grace=5.0, max_slots=4, notice_files=(None, None),
               dtype="float32", pace=0.0, side=PORT, **kv):
    """Two replicas behind a started router (each engine on the CPU)."""
    meshes = [{}, {}]
    if not side.port:
        # the JAX replicas on disjoint halves of the CPU mesh, as the JAX
        # package's fleet tests place them
        devs = jax.devices()
        half = max(1, len(devs) // 2)
        meshes = [{"mesh": jmesh.build_mesh(devs[:half])},
                  {"mesh": jmesh.build_mesh(devs[half:] or devs[:half])}]
    engines = [make_engine(side, max_slots=max_slots, registry=reg,
                           name=f"r{i}", dtype=dtype, kv=kv, **meshes[i])
               for i in range(2)]
    if pace:
        for eng in engines:
            slow(eng, pace)
    router = (FleetRouter if side.port else jfleet.FleetRouter)(
        registry=reg, grace=grace)
    for i, eng in enumerate(engines):
        router.add_replica(f"r{i}", eng, env={}, notice_file=notice_files[i],
                           poll_interval=0.01)
    router.start()
    return router, engines


def _gauge(reg, state):
    return instruments.serve_replicas_gauge(reg).labels(state).value


def wait_mid_stream(reqs, n_new, victim="r0", timeout=60):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if any(r.replica == victim and 0 < len(r.generated) < n_new
               for r in reqs):
            return True
        time.sleep(0.002)
    return False


def test_dispatch_skips_draining_replica_and_counts_states():
    reg = MetricsRegistry()
    router, engines = make_fleet(reg)
    try:
        assert _gauge(reg, "ready") == 2
        router.drain_traffic("r0", grace=0.5)
        assert engines[0].draining
        assert _gauge(reg, "ready") == 1 and _gauge(reg, "draining") == 1
        assert router.healthz()["status"] == "ok"
        reqs = [router.generate(p, 4) for p in prompts(40, (4, 4))]
        for r in reqs:
            assert r.result(timeout=60) == oracle(r.prompt, 4)
            assert r.replica == "r1"
        router.evict("r0")
        assert _gauge(reg, "dead") == 1
        h = router.healthz()
        assert h["replicas"]["r0"]["state"] == "dead"
        assert h["status"] == "ok" and h["ready_replicas"] == 1
    finally:
        router.stop()


def test_replica_headroom_counts_only_sole_ref_cache_entries():
    eng = make_engine(PORT, max_slots=2, kv=dict(num_blocks=8, mbps=8))
    rep = Replica("r", eng)
    assert rep.headroom_for(7)
    r1 = eng.generate(list(range(8)), 8)
    for _ in range(10):
        eng.step()
        if r1.state == "decode":
            break
    assert eng.prefix_cache.size == 2 and eng.prefix_cache.reclaimable() == 0
    assert rep.headroom_for(3) and not rep.headroom_for(4)
    run_until(eng, [r1])
    assert eng.prefix_cache.reclaimable() == 2 and rep.headroom_for(7)
    h = rep.health()
    assert h["state"] == "ready" and h["prefix_cache_blocks"] == 2


def test_fleet_request_timestamps_use_router_clock():
    t = [100.0]
    router = FleetRouter(registry=MetricsRegistry(), clock=lambda: t[0])
    freq = router.generate([1, 2, 3], 4)
    assert freq.arrival == 100.0
    t[0] = 101.5
    freq._emit("token", 7)
    assert freq.first_token_time == 101.5 and freq.token_times == [101.5]
    router.stop()


def _chaos(dtype, n_new=32, sampled=False):
    reg = MetricsRegistry()
    router, engines = make_fleet(reg, dtype=dtype, pace=0.003,
                                 num_blocks=128, mbps=16)
    sp = (SamplingParams(temperature=0.8, top_p=0.9, seed=4) if sampled
          else None)
    try:
        reqs = [router.generate(p, n_new, sampling=sp)
                for p in prompts(41, (5, 6, 7, 5, 8))]
        assert wait_mid_stream(reqs, n_new), "no stream in flight on r0"
        router.evict("r0")
        outs = [r.result(timeout=120) for r in reqs]
        assert router.dropped == 0
        assert router.redispatched >= 1
        assert all(len(o) == n_new for o in outs)
        extra = router.generate(prompts(42, (4,))[0], 4)
        extra_out = extra.result(timeout=60)
    finally:
        router.stop()
    return reqs, outs, extra, extra_out


def test_fleet_chaos_eviction_mid_stream_zero_drop():
    """fp32: every stream, hopped or not, equals the single-shot oracle;
    the survivor keeps serving."""
    reqs, outs, extra, extra_out = _chaos("float32")
    for r, o in zip(reqs, outs):
        assert o == oracle(r.prompt, len(o)), f"{r.id}: {r.hops} hop(s)"
    assert extra_out == oracle(extra.prompt, 4)


@pytest.mark.parametrize("sampled", [False, True])
def test_fleet_chaos_in_bf16_equals_the_unbroken_run(sampled):
    """bf16, greedy and seeded: a hopped stream replays its generated
    tokens on the survivor and comes out bit for bit the stream of an
    unbroken engine."""
    reqs, outs, _, _ = _chaos("bfloat16", sampled=sampled)
    eng = make_engine(PORT, dtype="bfloat16", kv=dict(num_blocks=128,
                                                      mbps=16))
    ref = [eng.generate(r.prompt, len(o), sampling=r.sampling)
           for r, o in zip(reqs, outs)]
    run_until(eng, ref)
    assert any(r.hops for r in reqs)
    assert outs == [r.generated for r in ref]


def test_fleet_spot_notice_file_drains_gracefully(tmp_path):
    reg = MetricsRegistry()
    notice = tmp_path / "preempt-notice"
    router, engines = make_fleet(reg, grace=30.0,
                                 notice_files=(str(notice), None))
    try:
        reqs = [router.generate(p, 6) for p in prompts(42, (5,) * 4)]
        notice.write_text("preempted\n")
        outs = [r.result(timeout=120) for r in reqs]
        deadline = time.time() + 60
        while router.replica("r0").state != "dead" and \
                time.time() < deadline:
            time.sleep(0.01)
        assert router.replica("r0").state == "dead"
        assert router.dropped == 0
        for r, o in zip(reqs, outs):
            assert o == oracle(r.prompt, 6)
        assert router.healthz()["ready_replicas"] == 1
    finally:
        router.stop()


def test_fleet_rolling_reload_never_closes_admission():
    from test_torch_serve import lm
    reg = MetricsRegistry()
    router, engines = make_fleet(reg)
    _, _, _, params = lm()
    try:
        statuses, stop_probe = [], threading.Event()

        def probe():
            while not stop_probe.is_set():
                statuses.append(router.healthz()["status"])
                time.sleep(0.002)

        t = threading.Thread(target=probe, daemon=True)
        t.start()
        background = [router.generate(p, 12) for p in prompts(43, (4,) * 3)]
        router.install_weights(params, version=5)
        during = router.generate(prompts(44, (4,))[0], 4)
        stop_probe.set()
        t.join(timeout=30)
        assert not t.is_alive()
        assert router.weights_version == 5
        assert all(e.weights_version == 5 for e in engines)
        assert statuses and "down" not in statuses
        for r in background + [during]:
            assert r.result(timeout=120) == oracle(r.prompt,
                                                   r.max_new_tokens)
        assert router.dropped == 0
        hist = instruments.serve_weight_swap_histogram(reg)
        assert hist.count >= 2
    finally:
        router.stop()


def _fleet_http(side):
    reg = (MetricsRegistry() if side.port else jreg.MetricsRegistry())
    router, _ = make_fleet(reg, side=side)
    server = (FleetServer if side.port else jfleet.FleetServer)(router,
                                                               port=0)
    port = server.start()
    p = prompts(44, (5,))[0]
    out = {}
    try:
        def post(body):
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/generate",
                data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as resp:
                return [json.loads(ln) for ln in resp]

        out["greedy"] = post({"tokens": p, "max_new_tokens": 6})
        out["seeded"] = [post({"tokens": p, "max_new_tokens": 6,
                               "temperature": 0.9, "top_p": 0.8,
                               "seed": 11})[-1]["tokens"] for _ in range(2)]
        h = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/healthz", timeout=10).read())
        out["health"] = (h["status"], h["ready_replicas"])
        scrape = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics", timeout=10).read().decode()
        out["families"] = sorted(
            ln.split()[2] for ln in scrape.splitlines()
            if ln.startswith("# TYPE hvd_serve_"))
        bad = urllib.request.Request(f"http://127.0.0.1:{port}/generate",
                                     data=b'{"tokens": [1], "temperature": -1}')
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(bad, timeout=10)
        out["bad"] = e.value.code
        router.evict("r0")
        router.evict("r1")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                   timeout=10)
        out["dead"] = (e.value.code, json.loads(e.value.read())["status"])
        out["after"] = post({"tokens": p, "max_new_tokens": 6})[-1]
    finally:
        server.stop()
        router.stop()
    return out


def test_fleet_frontend_matches_the_jax_frontend():
    j, t = _fleet_http(JAX), _fleet_http(PORT)
    assert t == j
    p = prompts(44, (5,))[0]
    assert t["greedy"][-1] == {"done": True, "tokens": oracle(p, 6),
                               "finish_reason": "length", "hops": 0}
    assert [ln["token"] for ln in t["greedy"][:-1]] == oracle(p, 6)
    assert t["seeded"][0] == t["seeded"][1]
    assert t["health"] == ("ok", 2) and t["bad"] == 400
    assert "hvd_serve_replicas" in t["families"]
    assert t["dead"] == (503, "down")
    assert "no live replica" in t["after"]["error"]


def test_fleet_submit_after_stop_is_loud():
    router, _ = make_fleet(MetricsRegistry())
    router.stop()
    with pytest.raises(tengine.RequestError, match="stopped"):
        router.generate([1, 2, 3], 2)
    assert all(e._stop.is_set() for e in (r.engine for r in router.replicas))


def test_fleet_redispatch_counter_counts_hops():
    reg = MetricsRegistry()
    router, _ = make_fleet(reg, pace=0.003, num_blocks=128, mbps=16)
    try:
        reqs = [router.generate(p, 24) for p in prompts(45, (5,) * 4)]
        assert wait_mid_stream(reqs, 24)
        router.evict("r0")
        for r in reqs:
            r.result(timeout=120)
        counter = instruments.serve_redispatch_counter(reg)
        assert counter.value == router.redispatched >= 1
        assert sum(r.hops for r in reqs) == router.redispatched
    finally:
        router.stop()
    np.testing.assert_equal(router.dropped, 0)
