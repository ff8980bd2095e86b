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


def test_phase_16_rehearsed(rehearsal, monkeypatch):
    """16a-16c (the telemetry and diagnosis planes on phase 5's and 6b's
    steps: losses bit for bit, the scrape's counters, the ledger, the
    x-rays against this script's own union, ``/profile`` while steps
    run, the doctor over the dumps): every hold passes. The kernels'
    build is stood in for by a booked compile, the device work of a CPU
    capture is its operators."""
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
    cs.phase_telemetry(hvd_t, fa, torch, bench, losses, losses_6b, tok_s,
                       "card")


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
