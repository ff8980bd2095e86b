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
