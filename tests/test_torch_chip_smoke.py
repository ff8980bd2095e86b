"""``chip_smoke.py``'s phases 12d (the tokens-sharded layer's all-to-all
form against its gather form) and 14 (checkpoints of the sharded and
accumulating states) rehearsed on the CPU at a tiny size: the LM at 2
layers of width 64, the MoE layer at width 64 over 512 tokens. The
phases' own holds run as on the card (bit for bit resumes, the forms'
bounds); what needs the card is stood in for: its memory and cache
calls return nothing, its timer is the host's, and the kernels' launch
counts (the plain versions launch nothing) are not read. Run with ``-s``
to see the figures each phase prints.
"""

import os
import sys
import time

import pytest
import torch

import horovod_tpu_torch as hvd_t
from horovod_tpu_torch.ops import flash_attention as fa
from horovod_tpu_torch.utils import benchmarks as bench

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402

DEV = torch.device("cpu")


def _host_ms(fn, iters=10, warmup=2):
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return 1e3 * (time.perf_counter() - t0) / iters


@pytest.fixture()
def rehearsal(monkeypatch):
    for name in ("empty_cache", "synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    for name in ("memory_allocated", "max_memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: 0)
    monkeypatch.setattr(bench, "sync", lambda: None)
    monkeypatch.setattr(bench, "cuda_time_ms", _host_ms)
    monkeypatch.setattr(cs, "_want_launches", lambda *a: None)
    for key, value in dict(layers=2, d_model=64, heads=4, vocab=128,
                           seq_len=32, batch=4).items():
        monkeypatch.setitem(cs.LM, key, value)
    monkeypatch.setattr(cs, "EP_BATCH", 2)
    init = hvd_t.init
    monkeypatch.setattr(hvd_t, "init", lambda *a, **k: init(device="cpu"))
    yield
    hvd_t.shutdown()


def test_token_forms_rehearsed(rehearsal):
    """12d's comparison of the two forms over 4 expert shards (8 experts,
    8 groups), bf16 and fp32: its holds pass, as on the card."""
    gen = torch.Generator().manual_seed(13)
    x = torch.randn(512, 64, generator=gen).to(torch.bfloat16)
    g = torch.randn(512, 64, generator=gen).to(torch.bfloat16)
    kw = dict(num_experts=8, d_model=64, d_ff=256, num_groups=8,
              capacity_factor=2.0, dtype=torch.bfloat16, device=DEV)
    cs._moe_token_forms(torch, DEV, bench, kw, x, g)


@pytest.mark.parametrize("phase", ["14a", "14b", "14c"])
def test_phase_14_rehearsed(rehearsal, phase):
    """14a (model shards saved at R 2, restored at R 2, 1, 4), 14b (the
    MoE LM whole and over 4 expert shards, both ways) and 14c
    (``backward_passes_per_step=2`` saved inside a window and at its
    boundary): every resume holds as on the card."""
    if phase == "14a":
        cs.phase_tp_resume(fa, torch, DEV, bench)
    elif phase == "14b":
        cs.phase_ep_resume(fa, torch, DEV, bench)
    else:
        cs.phase_multi_steps_resume(hvd_t, fa, torch, DEV, bench)


def test_phase_15_rehearsed(rehearsal, monkeypatch):
    """15a-15d (the GSPMD LM steps against phase 5's and 6a's losses,
    the int8 island and the bf16 cast wire, the checkpoints crossing
    between the explicit and the GSPMD ZeRO-1 steps): every hold passes,
    as on the card."""
    monkeypatch.setattr(cs, "profile_step", lambda *a, **k: None)
    losses, _, tok_s = cs.phase_full(hvd_t, fa, torch, bench)
    hvd_t.init()
    step, _, _, tokens = cs._lm_bench(bench, torch,
                                      seq_len=cs.LM["seq_len"],
                                      sharded_update=True)
    losses_6a = [float(step(tokens)) for _ in range(cs.STEPS)]
    hvd_t.shutdown()
    cs.phase_spmd(hvd_t, fa, torch, bench, losses, tok_s, losses_6a, 1)


def test_phase_16_rehearsed(rehearsal, monkeypatch, tmp_path):
    """16a-16c (the telemetry and diagnosis planes on phase 5's and 6b's
    steps: losses bit for bit, the scrape's counters, the ledger, the
    x-rays against this script's own union, ``/profile`` while steps
    run, the doctor over the dumps): every hold passes, and 16c's dumps
    are kept for 19c with its healthy report. The kernels' build is
    stood in for by a booked compile, the device work of a CPU capture
    is its operators."""
    from horovod_tpu_torch import _build, training
    from horovod_tpu_torch.telemetry import instruments
    monkeypatch.setattr(cs, "profile_step",
                        lambda *a, **k: {"matmuls": 0.0})
    monkeypatch.setattr(_build, "load",
                        lambda: instruments.record_compile(0.001))
    monkeypatch.setattr(cs, "DEVICE_WORK", ("cpu_op",))
    losses, _, tok_s = cs.phase_full(hvd_t, fa, torch, bench)
    hvd_t.init()
    seq = cs.LM["seq_len"]
    _, model, opt, tokens = cs._lm_bench(bench, torch, seq_len=seq + 1,
                                         sharded_update=True)
    step = training.make_train_step(model, opt, accum_steps=2,
                                    overlap_grads=True)
    losses_6b = [float(step(tokens[:, :seq], tokens[:, 1:seq + 1]))
                 for _ in range(cs.STEPS)]
    hvd_t.shutdown()
    keep = str(tmp_path / "flightrec")
    launches, doctor = cs.phase_telemetry(hvd_t, fa, torch, bench, losses,
                                          losses_6b, tok_s, "card",
                                          keep=keep)
    assert set(launches) == {"fwd", "dq", "dkv"}
    assert doctor["dir"] == keep and doctor["classification"] == "healthy"
    assert os.path.isfile(os.path.join(keep, "flightrec.rank0.json"))
    assert doctor["last_event"]["k"] == "step"


def test_phase_17_runs_through_main_after_the_kernel_phases():
    """Phase 17 is called by ``main()`` after the kernel phases and phase
    16, its workers run ``examples/elastic_train.py`` on the card
    (``--device cuda``), its launches join the kernels line, and the
    last line stays the device JSON."""
    import ast
    src = open(cs.__file__).read()
    tree = ast.parse(src)
    main = [n for n in tree.body if isinstance(n, ast.FunctionDef)
            and n.name == "main"][0]
    calls = [n.func.id for n in ast.walk(main) if isinstance(n, ast.Call)
             and isinstance(n.func, ast.Name)]
    assert "phase_elastic" in calls
    for earlier in ("phase_kernels", "phase_slice_shape", "phase_full",
                    "phase_telemetry"):
        assert calls.index(earlier) < calls.index("phase_elastic"), earlier
    assert "launches_17" in ast.unparse(main).split("kernels = []")[1]
    assert cs.ELASTIC_DEVICE == "cuda" and cs.ELASTIC_STEP_SLEEP == 0.0
    fn = ast.unparse([n for n in tree.body if isinstance(n, ast.FunctionDef)
                      and n.name == "phase_elastic"][0])
    assert "local_launch" in fn and "'--device', ELASTIC_DEVICE" in fn
    last = main.body[-2]  # print(json.dumps({"ok": True, ...})); return 0
    assert '"ok": True' in ast.unparse(last).replace("'", '"')
    assert '"platform": "gpu"' in ast.unparse(last).replace("'", '"')


def test_phase_17_rehearsed(rehearsal, monkeypatch):
    """17a and 17b on the CPU at the tiny size: the workers run
    ``examples/elastic_train.py --device cpu`` (fp32, so the reference
    losses are the same LM's unbroken fp32 run in this process); a step
    sleeps 0.5 s so the SIGTERM lands mid-run; the plain kernels launch
    nothing, so the launch counts are not held. Every other hold passes:
    the epochs, the blame and the drain, the losses bit for bit, the
    force-commit inside the grace."""
    import numpy as np

    monkeypatch.setattr(cs, "ELASTIC_DEVICE", "cpu")
    monkeypatch.setattr(cs, "ELASTIC_STEP_SLEEP", 0.5)
    monkeypatch.setattr(cs, "EVICT_AFTER_S", 0.3)
    monkeypatch.setattr(cs, "_worker_launches", lambda *a: None)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    hvd_t.init()
    lm = cs.LM
    step, _, _, _ = bench.make_lm_bench(
        batch=lm["batch"], seq_len=lm["seq_len"], layers=lm["layers"],
        d_model=lm["d_model"], heads=lm["heads"], vocab=lm["vocab"],
        flash=True, dtype=torch.float32)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, lm["vocab"], size=(lm["batch"], lm["seq_len"])).astype(
            np.int64))
    losses = [float(step(tokens)) for _ in range(cs.STEPS)]
    cs.phase_elastic(hvd_t, torch, losses)


def test_phase_18_runs_through_main_after_phase_17():
    """Phase 18 is called by ``main()`` after phase 17 (the kernels line
    and the last line stay as they were)."""
    import ast
    tree = ast.parse(open(cs.__file__).read())
    main = [n for n in tree.body if isinstance(n, ast.FunctionDef)
            and n.name == "main"][0]
    calls = [n.func.id for n in ast.walk(main) if isinstance(n, ast.Call)
             and isinstance(n.func, ast.Name)]
    assert calls.index("phase_elastic") < calls.index("phase_serve")
    assert calls.index("phase_serve") < calls.index("print", calls.index(
        "phase_serve"))
    assert cs.SERVE["blocks"] == 1025 and cs.SERVE["chunk"] == 256
    assert cs.SERVE["prefix"] % cs.SERVE["chunk"] == 0


def test_phase_18_rehearsed(rehearsal, monkeypatch):
    """18a-18c on the CPU at the tiny size (pool of 65 blocks of 4
    tokens, 4 slots, chunk 8, prompts of 8-40 tokens, 8 new, a 16-token
    shared prefix): every hold passes as on the card — the load bit for
    bit, the prefix hit and the fork, the attribution within 2 % of the
    wall, the greedy tokens against the teacher-forced oracle, the
    seeded streams alone, the fleet's eviction with every stream 18a's,
    ``/generate`` and ``/metrics``."""
    for key, value in dict(block=4, max_seq_len=64, slots=4, blocks=65,
                           chunk=8, new=8, prompt_lo=8, prompt_hi=40,
                           prefix=16).items():
        monkeypatch.setitem(cs.SERVE, key, value)
    monkeypatch.setattr(cs, "profile_step", lambda *a, **k: {})
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cs.phase_serve(hvd_t, fa, torch, bench, "card")
    finally:
        torch.set_num_threads(n)


def test_phase_19_runs_through_main_after_phase_18():
    """Phase 19 is called by ``main()`` after phase 18, its launches join
    the kernels line, and the last line stays the device JSON."""
    import ast
    tree = ast.parse(open(cs.__file__).read())
    main = [n for n in tree.body if isinstance(n, ast.FunctionDef)
            and n.name == "main"][0]
    calls = [n.func.id for n in ast.walk(main) if isinstance(n, ast.Call)
             and isinstance(n.func, ast.Name)]
    assert calls.index("phase_serve") < calls.index("phase_timer_tuner")
    assert calls.index("phase_timer_tuner") < calls.index("phase_tools")
    assert "launches_19" in ast.unparse(main).split("kernels = []")[1]
    assert cs.SLOPE == dict(iters=4, rounds=3) and cs.LINT_TARGETS is None
    assert cs.TUNE_WIRES == ["none", "bf16", "int8"]


def test_phase_19_rehearsed(rehearsal, monkeypatch, tmp_path):
    """19a-19c on the CPU at the tiny size: the slope window over the
    tiny LM's step is no upper bound and K1's is reported; the tuner at
    world 1 returns ``(None, {})`` with the JAX package's reason and
    leaves the config as it was; the tools' subprocess (lint over two
    files of the port, so the rehearsal stays short) exits 0 for the
    lint, reads the rounds and imports no JAX; the ``bin/`` scripts with
    JAX unimportable: the lint as the ``python -m`` run, ``hvdrun-torch
    --check-build`` listing the native core, and ``hvd-doctor-torch``
    over a port recorder's clean dump giving the in-process doctor's
    classification and last event."""
    monkeypatch.setattr(cs, "clocks_line", lambda: "no card")
    monkeypatch.setattr(cs, "LINT_TARGETS", [
        "horovod_tpu_torch/telemetry/trend.py",
        "horovod_tpu_torch/utils/benchmarks.py"])
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        launches = cs.phase_timer_tuner(
            hvd_t, fa, torch, DEV, bench, {"fwd": {"ms": 0.0}}, 1e5)
    finally:
        torch.set_num_threads(n)
    assert set(launches) == {"fwd", "dq", "dkv"}
    from horovod_tpu_torch.diag import doctor
    from horovod_tpu_torch.diag.recorder import FlightRecorder
    rec = FlightRecorder(capacity=16, rank=0, size=1,
                         dump_dir=str(tmp_path))
    rec.step_begin(3)
    rec.step_end(3)
    rec.dump(reason="shutdown")
    report = doctor.diagnose(doctor.load_dumps(str(tmp_path))[0],
                             expected_size=1)
    want = dict(dir=str(tmp_path), classification=report["classification"],
                last_event=report["per_rank"][0]["last_event"])
    assert want["classification"] == "healthy"
    cs.phase_tools(want)


def test_phase_20_runs_through_main_after_phase_19():
    """Phase 20 is called by ``main()`` after phase 19 (20a, then 20b on
    phase 18's kept manifest), its 20a launches join the kernels line,
    and the last line stays the device JSON."""
    import ast
    tree = ast.parse(open(cs.__file__).read())
    main = [n for n in tree.body if isinstance(n, ast.FunctionDef)
            and n.name == "main"][0]
    calls = [n.func.id for n in ast.walk(main) if isinstance(n, ast.Call)
             and isinstance(n.func, ast.Name)]
    assert calls.index("phase_tools") < calls.index("phase_zero_mesh")
    assert calls.index("phase_zero_mesh") < calls.index("phase_serve_mesh")
    assert "launches_20" in ast.unparse(main).split("kernels = []")[1]
    assert "serve_root" in ast.unparse(main).split("phase_serve(")[1][:80]


def test_phase_20_rehearsed(rehearsal, monkeypatch, tmp_path):
    """20a and 20b on the CPU at the tiny size: 20a's turns bit for bit
    6b's losses and its restored next loss the unbroken run's; 20b's two
    ranks (this script with ``--serve-rank``, device cpu) on phase 18's
    manifest: the ranks' streams, pools and tables equal, the greedy
    tokens within the oracle rule, the sampled stream 18a's."""
    from horovod_tpu_torch import training
    # 18a at 8 requests (20b drives the first 8) keeps the rehearsal short
    for key, value in dict(block=4, max_seq_len=64, slots=4, blocks=65,
                           chunk=8, new=8, prompt_lo=8, prompt_hi=40,
                           prefix=16, requests=8).items():
        monkeypatch.setitem(cs.SERVE, key, value)
    monkeypatch.setattr(cs, "profile_step", lambda *a, **k: {})
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        hvd_t.init()
        _, model, opt, tokens = cs._lm_bench(
            bench, torch, seq_len=cs.LM["seq_len"] + 1, sharded_update=True)
        step = training.make_train_step(model, opt, accum_steps=2,
                                        overlap_grads=True)
        seq = cs.LM["seq_len"]
        losses_6b = [float(step(tokens[:, :seq], tokens[:, 1:seq + 1]))
                     for _ in range(cs.STEPS)]
        hvd_t.shutdown()
        launches = cs.phase_zero_mesh(hvd_t, fa, torch, bench, losses_6b)
        assert set(launches) == {"fwd", "dq", "dkv"}
        root = str(tmp_path / "serve")
        os.makedirs(root)
        streams, metrics = cs.phase_serve(hvd_t, fa, torch, bench, "card",
                                          root=root)
        assert set(metrics) == {"decode_tok_s", "itl_p50_ms", "itl_p99_ms"}
        cs.phase_serve_mesh(torch, root, streams, metrics, "card",
                            device="cpu")
    finally:
        torch.set_num_threads(n)


def test_phase_21_runs_through_main_after_phase_20():
    """Phase 21 is called by ``main()`` after phase 20, its workers'
    launches join the kernels line, and ``--native-rank`` runs a rank."""
    import ast
    tree = ast.parse(open(cs.__file__).read())
    main = [n for n in tree.body if isinstance(n, ast.FunctionDef)
            and n.name == "main"][0]
    calls = [n.func.id for n in sorted(
        (n for n in ast.walk(main) if isinstance(n, ast.Call)
         and isinstance(n.func, ast.Name)), key=lambda n: n.lineno)]
    assert calls.index("phase_serve_mesh") < calls.index("phase_native_core")
    assert "launches_21" in ast.unparse(main).split("kernels = []")[1]
    assert "native_rank" in calls


def test_phase_21_rehearsed(rehearsal, monkeypatch):
    """21a and 21b on the CPU at the tiny size: the core built (or
    loaded) and listed by ``--check-build``, this process mapping the
    port's library only; two ``--native-rank`` workers under
    ``python -m horovod_tpu_torch.run -np 2`` (device cpu): the host
    collectives equal numpy, the uneven join, both ranks' parameters bit
    for bit equal and bit for bit the one-process average (the plain
    kernels launch nothing, so the launch counts are not held)."""
    monkeypatch.setattr(cs, "_worker_launches", lambda *a: None)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    # an earlier test in this worker may have mapped the JAX package's
    # core (its capability probes load it); the phase maps no other
    mapped = cs._mapped_cores
    foreign = {p for p in mapped() if "horovod_tpu_torch" not in p}
    monkeypatch.setattr(cs, "_mapped_cores",
                        lambda: [p for p in mapped() if p not in foreign])
    launches = cs.phase_native_core(torch, "card", device="cpu")
    assert set(launches) == {"fwd", "dq", "dkv"}


def test_phase_22_runs_through_main_after_phase_21():
    """Phase 22 is called by ``main()`` after phase 21, and adds nothing
    to the kernels line."""
    import ast
    tree = ast.parse(open(cs.__file__).read())
    main = [n for n in tree.body if isinstance(n, ast.FunctionDef)
            and n.name == "main"][0]
    calls = [n.func.id for n in sorted(
        (n for n in ast.walk(main) if isinstance(n, ast.Call)
         and isinstance(n.func, ast.Name)), key=lambda n: n.lineno)]
    assert calls.index("phase_native_core") < calls.index("phase_examples")
    assert calls.index("phase_examples") < calls.index("print", calls.index(
        "phase_examples"))
    assert "launches_22" not in ast.unparse(main)


def test_phase_22_rehearsed(rehearsal, monkeypatch):
    """22a-22c on the CPU at the JAX example test's smoke size: the
    ImageNet driver's two runs (the second resumes the first), the
    synthetic benchmark and the classic torch drivers, every hold as on
    the card."""
    monkeypatch.setattr(cs, "EXAMPLES", dict(
        depth=18, num_filters=4, image_size=32, num_classes=4, batch=2,
        examples=8, synth_model="resnet18", synth_warmup=1, synth_iters=1,
        synth_per_iter=1))
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        cs.phase_examples(hvd_t, fa, torch, "card", device="cpu")
    finally:
        torch.set_num_threads(n)


def test_phase_23_runs_through_main_after_phase_22():
    """Phase 23 is called by ``main()`` after phase 22, with phase 5's
    losses, and adds nothing to the kernels line."""
    import ast
    tree = ast.parse(open(cs.__file__).read())
    main = [n for n in tree.body if isinstance(n, ast.FunctionDef)
            and n.name == "main"][0]
    calls = [n.func.id for n in sorted(
        (n for n in ast.walk(main) if isinstance(n, ast.Call)
         and isinstance(n.func, ast.Name)), key=lambda n: n.lineno)]
    assert calls.index("phase_examples") < calls.index("phase_positions")
    assert calls.index("phase_positions") < calls.index("print", calls.index(
        "phase_positions"))
    assert "phase_positions(hvd, fa, torch, losses)" in ast.unparse(main)
    assert "launches_23" not in ast.unparse(main)


def test_phase_23_rehearsed(rehearsal, monkeypatch):
    """23a-23c on the CPU at the tiny size: phase 5's LM at explicit
    positions (no flash kernel called: the wrappers raise here), its
    logits at ``arange`` and at packed positions within
    ``POSITIONS_LOGITS`` of the plain fp32 reference's, the two
    references ``POSITIONS_SEEN`` bounds apart, its first loss within
    ``POSITIONS_RTOL`` of phase 5's, the packed steps repeated bit for
    bit, ``allgather(tiled=False)`` at world 1."""
    monkeypatch.setattr(cs, "profile_step", lambda *a, **k: None)
    losses, _, _ = cs.phase_full(hvd_t, fa, torch, bench)
    monkeypatch.setattr(cs, "POSITIONS_BATCH", cs.LM["batch"])

    def refuse(*args, **kwargs):
        raise AssertionError("explicit positions reached a flash kernel")
    monkeypatch.setattr(fa, "attention", refuse)
    cs.phase_positions(hvd_t, fa, torch, losses, device="cpu")
