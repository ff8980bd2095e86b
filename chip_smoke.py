#!/usr/bin/env python3
"""Smoke run of horovod_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``horovod_tpu_torch/csrc`` with nvcc and
runs these phases; any failure raises:

* 3a: each kernel against its plain PyTorch version on the card;
* 3b: the kernels at the main paths' shapes, the whole batch (5, 6a)
  and one of 2 microbatches (6b, 6c): error, planted faults and
  repeatability at both, times beside the plain version's and the
  library's at the whole batch;
* 4: one small LM step on the card against the same step on the CPU;
* 4b: the same small LM trained 3 steps through ``make_train_step``
  (2 microbatches, overlapped reduce-scatter pipeline, ZeRO-1) on the
  card against the CPU;
* 5: the port's main path at full width: ``init()`` over NCCL, the
  12-layer d768 LM at sequence 2048 and batch 8 in bf16 with flash
  attention, trained 5 steps through ``DistributedOptimizer``'s fused
  allreduce;
* 6a-6c: the same LM through the rest of the exchange: 6a
  ``make_lm_train_step`` with ZeRO-1, 6b ``make_train_step`` with 2
  microbatches, the overlapped pipeline and ZeRO-1, 6c 6b without
  ZeRO-1;
* 3c: the wire quantizer (int8, fp8_e4m3, fp8_e5m2) on the card against
  the CPU, bit for bit;
* 4c: a small BatchNorm ResNet trained 3 steps through ``make_train_step``
  (2 microbatches, overlap, ZeRO-1, int8 wire with error feedback) on the
  card against the CPU;
* 7a: ``bench.py``'s headline, ResNet-101 at 256 images of 224x224 in
  bf16 on fp32 parameters, SGD with momentum through the fused
  allreduce: img/s, MFU, memory, buckets, and a profile by layer;
* 7b: ``bench.py --overlap --compression``: the same ResNet-101 through
  4 microbatches, the overlapped pipeline, ZeRO-1 and AdamW at each wire
  (none, bf16, fp8_e4m3, int8, with error feedback): step time, memory,
  wire bytes, the quantizer's cost and losses held to ``WIRE_EPSILON`` of
  the uncompressed run's;
* 7c: VGG-16 at 64 images of 224x224 through the fused allreduce;
* 8a: 6b's LM fed by ``make_train_step(loader=...)`` from a prefetch
  loader: 4 steps unbroken (twice) against 2 steps, an
  ``AsyncCheckpointer`` save, a fresh model, optimizer, step and loader
  restored from it (state and cursor) and 2 more steps: losses and
  parameters bit for bit, or within twice the unbroken runs' own
  difference; the state's bytes, each save's blocking ms (a first save
  makes the pinned buffers, the second reuses them: the making and the
  device-to-host copy apart), the background write and commit, and the
  restore;
* 8b: 7b's ResNet-101 state (ZeRO-1 AdamW rows, BatchNorm statistics)
  saved and restored into a fresh model: every tensor bit for bit, and
  the next step's loss against the unbroken run's;
* 9: the port's launcher: ``--check-build``; 9a phase 5's LM trained by
  ``examples/lm_benchmark.py`` under ``python -m horovod_tpu_torch.run
  -np 1`` with the startup broadcast, warmup and metric callbacks: each
  kernel once per layer and step, a falling loss, the warmup's rates,
  tokens/s beside phase 5's; 9b ``run(probe, np=1)``, an allreduce on
  the card through the programmatic launcher; 9c a job whose rank
  raises exits 1 within the grace period;
* 10a: the flash ring (``parallel/ring.py``) at the main attention shape
  over R = 2 and 4 ranks held in this process: out, lse, dq, dk and dv
  against one flash call over the whole sequence and against the ring on
  the plain versions, twice for the same bits, R^2 launches of each
  kernel, the time against the whole-sequence call, the share of blocks
  that see no key, and the peak memory of forward and backward against
  the dense ring's at R = 4;
* 10b: phase 5's LM, weights and batch through ``make_lm_train_step``'s
  seq branch on a (1, 1) (data, seq) mesh: step 1's loss bit for bit
  phase 5's, later steps within 1e-3, tokens/s beside phase 5's;
* 11a: Adasum and the two-level reduction at full width, R = 4 ranks
  held in this process (``parallel.axis.local_axes``): the gradients of
  phase 5's LM for four seeded batches, packed into the fused 64 MB
  buckets, through the Adasum tree over 4 ranks and the two-level
  Adasum over (2 dcn x 2 data), each held against the same tree in fp64
  on the card (every bucket within ``ADASUM_RTOL`` of its largest
  element), and the two-level average over (2 x 2) against the flat
  average in fp64 (each element within fp32 summation order,
  ``R 2^-24 mean_r |x_r|``); ms per tree, the tree's memory bound (a
  read of a and b and a write of the result, per rank and level) and
  its share, the peak memory, and the bytes the dcn stage moves against
  a flat allreduce, from the shapes;
* 11b: phase 5's LM, weights and batch on a (1, 1) (dcn, data) mesh,
  through ``DistributedOptimizer(hierarchical=True)`` and
  ``op=Adasum``: at world 1 both reductions are the identity, so all
  five losses equal phase 5's bit for bit; tokens/s beside phase 5's;
* 11c: 7a's ResNet-101 with ``bn_cross_replica_axes=("data",)`` at
  world 1: every step's loss within ``1e-5 |loss| + 4 max_k |perturbed_k
  - 7a_k|`` of 7a's, where the perturbed run is 7a's from weights moved
  by 1e-6 relative (the net's own sensitivity to rounding: at world 1
  the two BatchNorms differ only in how they round), img/s and
  BatchNorm device ms beside 7a's from the profile.

6b and 7b also time the bucket packing and unpacking with each leaf in
its flax layout beside torch's own layout.

Phases 4, 4b, 5, 6a, 6b, 6c, 8a, 10b and 11b each count the kernels'
launches from 0 on the card and must launch each kernel once per layer
and microbatch and step; 9a's worker counts its own. The last line of
output is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

and the line before it a JSON object with each kernel's launches on the
main paths (phase 5 and 11b's two runs, each counted from 0), error
against its plain version, time, plain time, bound and library time. After the timed steps of phases 5 and 6b one
more step runs under ``torch.profiler`` for the device's busy share and
the time by layer and by kernel.
Exits non-zero without printing a result when CUDA is unavailable or the
package is missing.

    python3 chip_smoke.py --tune

builds the kernels, times each tile configuration of the bf16 K1, K2 and
K3 kernels at the main path's shape and stops, printing no result lines.
"""

import argparse
import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# H100 SXM published dense peaks (NVIDIA data sheet, 700 W)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

# the full-width workload (bench.py lm_tokens_per_sec(flash=True))
LM = dict(layers=12, d_model=768, heads=12, vocab=32000, seq_len=2048,
          batch=8)
STEPS = 5
# bench.py's image workloads: the headline (--model resnet101
# --batch-size 256 --image-size 224), its --overlap --compression matrix
# (adamw, --accum-steps 4) and --model vgg16 at batch 64
RESNET = dict(model="resnet101", batch=256, image_size=224)
OVERLAP_ACCUM = 4
WIRES = ("none", "bf16", "fp8_e4m3", "int8")
VGG = dict(model="vgg16", batch=64, image_size=224, steps=3)
# ranks of the ring that phase 10a holds in one process
RING_RANKS = (2, 4)
# phase 11a: ranks held in one process, the (dcn, data) mesh of the
# two-level runs, and the bound of an Adasum tree against the same tree
# in fp64, as a share of the bucket's largest element: the fp32 dot
# products of a 64 MB bucket sum 16 M terms (cuBLAS's blocked sums: a
# relative error of a few 1e-7), each level's combine rounds once more
ADASUM_RANKS, TWO_LEVEL = 4, (2, 2)
ADASUM_RTOL = 1e-5
# the JAX package's compressed-vs-exact contract (__graft_entry__.py
# WIRE_EPSILON, WIRE_EPSILON_FLOOR): every step's loss within 5 %
WIRE_EPSILON, WIRE_EPSILON_FLOOR = 0.05, 1e-3

CSRC = "horovod_tpu_torch/csrc/"
KERNELS = {  # name -> (wrapper, TPU kernel it replaces, bf16 source, design)
    "fwd": ("flash_fwd", "horovod_tpu/ops/flash_attention.py:128",
            CSRC + "flash_fwd_sm90.cu", "wgmma+tma"),
    "dq": ("flash_dq", "horovod_tpu/ops/flash_attention.py:191",
           CSRC + "flash_dq_sm90.cu", "wgmma+tma"),
    "dkv": ("flash_dkv", "horovod_tpu/ops/flash_attention.py:237",
            CSRC + "flash_dkv_sm90.cu", "wgmma+tma"),
}
# tile configurations of the bf16 Hopper kernels that --tune compares at
# the main path's shape, by parameter: K1 and K2 keys per kv tile and
# stages, K3 stages (its q tile is 64 rows at D 64)
TUNE = {"fwd": (("keys", "stages"), [(64, 2), (64, 3), (128, 2), (128, 3)]),
        "dq": (("keys", "stages"), [(64, 2), (64, 3), (128, 2), (128, 3)]),
        "dkv": (("stages",), [(2,), (3,)])}

# error bound, element by element, (atol, rtol, ttol) by input dtype:
#     |kernel - plain| <= atol + rtol |plain| + ttol terms
# where terms is the root of the sum of squares of the terms the element
# sums (P V for out, dS K for dq, dS^T Q for dk, P^T dO for dv). fp32:
# summation order only. bf16: the outputs round to bf16, so two fp32
# values a hair apart can land one bf16 step apart, at most 2^-7 of the
# value (under rtol); P and dS round to bf16, a relative error of up to
# 2^-8 in each term, at other points of the online softmax than in the
# plain version, so the two sums part by a random walk of about
# 2.3e-3 terms (ttol is near nine of its steps). atol keeps elements
# that are exactly 0 (rows that see no key) from a bound of 0.
TOL = {"float32": (1e-5, 1e-5, 1e-5), "bfloat16": (1e-5, 1e-2, 2e-2)}
# the 64 rows that the planted faults of phase 3b leave out: half of one
# of K1's 128-key tiles, one of K3's 64-row q tiles, and for K2 half of a
# 128-key tile or one 64-key tile
TILE = slice(1024, 1088)
# trace categories of work on the device; annotation ranges on the
# device's lanes span kernels and are left out
DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _rand(shape, dtype, gen, device):
    import torch
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device="cpu").to(device=device, dtype=dtype)


def _err(got, want):
    return float((got.float() - want.float()).abs().max())


def _terms(fa, q, k, v, g, lse, delta, kw):
    """For each output of the three kernels, per element, the root of
    the sum of squares of the terms it sums: the scale of the rounding
    of P and dS. Built from the plain version's own P and dS."""
    p, ds = fa._p_ds(q, k, v, g, lse, delta, kw["causal"], kw["sm_scale"],
                     kw.get("q_offset", 0), kw.get("kv_offset", 0))
    p2, ds2 = p.square(), ds.square()

    def rss(w2, x):
        return w2.matmul(x.float().square()).sqrt()

    return {"fwd out": rss(p2, v), "dq": rss(ds2, k),
            "dk": rss(ds2.transpose(1, 2), q),
            "dv": rss(p2.transpose(1, 2), g)}


def _excess(got, want, dtype, terms=None):
    """The largest |got - want| / (atol + rtol |want| + ttol terms) over
    the elements: the check passes at 1 or below."""
    atol, rtol, ttol = TOL[dtype]
    got, want = got.float(), want.float()
    bound = atol + rtol * want.abs()
    if terms is not None:
        bound = bound + ttol * terms
    return float(((got - want).abs() / bound).max())


def _check(name, got, want, dtype, terms=None):
    err, worst = _err(got, want), _excess(got, want, dtype, terms)
    ok = worst <= 1.0  # False on NaN too
    print(f"  {name:<44} max_abs_err {err:.3e}  worst element at "
          f"{worst:.3f} of tol  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: an element is {worst} times its "
                             f"tolerance {TOL[dtype]} (atol, rtol, ttol)")
    return err


def _check_lse(fa, lse, want):
    """Rows that see no key carry exactly the NEG_INF sentinel; the other
    rows are fp32 log-sum-exps held to the fp32 bound."""
    dead = want <= fa.NEG_INF / 2
    if not bool((lse[dead] == fa.NEG_INF).all()):
        raise AssertionError("lse: a row that sees no key lost the sentinel")
    return _check(f"fwd lse ({int(dead.sum())} sentinel rows exact)",
                  lse[~dead], want[~dead], "float32")


def run_case(fa, torch, dev, dtype_name, bh, sq, skv, d, causal, q_off,
             kv_off, out_f32=False, seed=0):
    """K1, K2 and K3 against their plain versions on one set of inputs;
    returns the three max errors."""
    dtype = getattr(torch, dtype_name)
    gen = torch.Generator().manual_seed(seed)
    q = _rand((bh, sq, d), dtype, gen, dev)
    k = _rand((bh, skv, d), dtype, gen, dev)
    v = _rand((bh, skv, d), dtype, gen, dev)
    g = _rand((bh, sq, d), dtype, gen, dev)
    kw = dict(causal=causal, sm_scale=1.0 / d ** 0.5, q_offset=q_off,
              kv_offset=kv_off)
    tag = (f"{dtype_name} bh{bh} sq{sq} skv{skv} d{d} "
           f"{'causal' if causal else 'full'} off({q_off},{kv_off})")
    print(f" case {tag}{' fp32-out' if out_f32 else ''}")
    out, lse = fa.flash_fwd(q, k, v, **kw)
    p_out, p_lse = fa.flash_fwd_plain(q, k, v, **kw)
    delta = (g.float() * p_out.float()).sum(-1)
    terms = _terms(fa, q, k, v, g, p_lse, delta, kw)
    torch.cuda.synchronize()
    e_fwd = max(_check("fwd out", out, p_out, dtype_name, terms["fwd out"]),
                _check_lse(fa, lse, p_lse))
    bkw = dict(kw, out_dtype=torch.float32 if out_f32 else None)
    dq = fa.flash_dq(q, k, v, g, p_lse, delta, **bkw)
    dk, dv = fa.flash_dkv(q, k, v, g, p_lse, delta, **bkw)
    p_dq = fa.flash_dq_plain(q, k, v, g, p_lse, delta, **bkw)
    p_dk, p_dv = fa.flash_dkv_plain(q, k, v, g, p_lse, delta, **bkw)
    torch.cuda.synchronize()
    want_dt = torch.float32 if out_f32 else dtype
    assert dq.dtype == dk.dtype == dv.dtype == want_dt
    e_dq = _check("dq", dq, p_dq, dtype_name, terms["dq"])
    e_dkv = max(_check("dk", dk, p_dk, dtype_name, terms["dk"]),
                _check("dv", dv, p_dv, dtype_name, terms["dv"]))
    return e_fwd, e_dq, e_dkv


def phase_kernels(fa, torch, dev):
    print("== phase 3a: each kernel against its plain version")
    cases = [
        ("bfloat16", 4, 256, 256, 64, True, 0, 0),
        ("bfloat16", 4, 256, 256, 64, False, 0, 0),
        ("bfloat16", 3, 200, 200, 64, True, 0, 0),      # ragged S
        ("bfloat16", 3, 200, 136, 64, False, 0, 0),     # ragged, sq != skv
        ("bfloat16", 2, 192, 192, 64, True, 0, 100),    # fully-masked rows
        ("bfloat16", 2, 130, 260, 64, True, 130, 0),    # later query shard
        ("bfloat16", 2, 160, 160, 128, True, 0, 0),     # widest head
        ("bfloat16", 2, 100, 100, 40, True, 0, 0),      # padded head dim
        ("bfloat16", 2, 320, 320, 64, True, 0, 0),      # S not a multiple of 128
        ("bfloat16", 1, 1024, 1024, 128, True, 0, 0),   # widest head at length
        ("bfloat16", 2, 192, 192, 16, True, 0, 0),      # narrow head
        ("bfloat16", 2, 96, 96, 8, True, 0, 0),         # narrowest head
        ("bfloat16", 2, 200, 200, 96, False, 0, 0),     # half of the second 64 columns
        ("bfloat16", 2, 200, 72, 64, False, 0, 0),      # kv shorter than a tile
        ("float32", 3, 200, 200, 64, True, 0, 0),
        ("float32", 2, 96, 96, 128, False, 0, 0),
        ("float32", 2, 120, 120, 24, True, 0, 50),
    ]
    for case in cases:
        run_case(fa, torch, dev, *case)
    # fp32 partials of bf16 inputs: the ring-attention form of K2/K3
    run_case(fa, torch, dev, "bfloat16", 2, 256, 256, 64, True, 0, 64,
             out_f32=True)
    run_case(fa, torch, dev, "bfloat16", 2, 200, 200, 64, False, 0, 0,
             out_f32=True)


def _bound_ms(kind, bh, s, d, dtype_name, itemsize):
    """Least time for the work at causal shape [bh, s, d]: the larger of
    the products' FLOPs over the tensor-core peak and the bytes (inputs
    read once, outputs written once) over the memory rate."""
    pairs = bh * s * (s + 1) // 2  # visible (query, key) pairs
    elems = bh * s * d
    row = bh * s * 4               # one fp32 value per row (lse, delta)
    products, nbytes = {
        "fwd": (2, 4 * elems * itemsize + row),               # q k v | o lse
        "dq": (3, 5 * elems * itemsize + 2 * row),            # q k v g lse delta | dq
        "dkv": (4, 6 * elems * itemsize + 2 * row),           # q k v g lse delta | dk dv
    }[kind]
    flops = 2 * products * pairs * d
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype_name], nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes"), flops, nbytes


def _planted_faults(fa, torch, q, k, v, g, lse, delta, kw, plain):
    """What kernels that each leave out one tile of their loop (``TILE``,
    mid-sequence) would output, made from the plain versions: K1 without
    that kv tile's P.V (its weight kept in l), K2 without that kv tile,
    K3 without that q tile. ``plain`` holds the plain fp32 results."""
    t, f32 = TILE.start, dict(kw, out_dtype=torch.float32)
    k_t, v_t = k[:, TILE], v[:, TILE]
    o_t, lse_t = fa.flash_fwd_plain(q, k_t, v_t, kv_offset=t, **kw)
    out = plain["fwd out"] - o_t.float() * torch.exp(lse_t - lse)[..., None]
    dq = plain["dq"] - fa.flash_dq_plain(q, k_t, v_t, g, lse, delta,
                                         kv_offset=t, **f32)
    dk_t, dv_t = fa.flash_dkv_plain(q[:, TILE], k, v, g[:, TILE],
                                    lse[:, TILE], delta[:, TILE],
                                    q_offset=t, **f32)
    return {"fwd out": out, "dq": dq, "dk": plain["dk"] - dk_t,
            "dv": plain["dv"] - dv_t}


def _hold_at_shape(fa, torch, dev, bh, s, d):
    """Each bf16 kernel at causal shape [bh, s, d] against its plain
    version, twice for the same bits, and planted faults that must fail
    the same check. Returns each kernel's error and the inputs."""
    name, dtype = "bfloat16", torch.bfloat16
    print(f"  shape [{bh}, {s}, {d}]:")
    gen = torch.Generator().manual_seed(1)
    q, k, v, g = (_rand((bh, s, d), dtype, gen, dev) for _ in range(4))
    kw = dict(causal=True, sm_scale=1.0 / d ** 0.5)
    f32 = dict(kw, out_dtype=torch.float32)
    out, lse = fa.flash_fwd(q, k, v, **kw)
    p_out, p_lse = fa.flash_fwd_plain(q, k, v, **kw)
    delta = (g.float() * out.float()).sum(-1)
    terms = _terms(fa, q, k, v, g, lse, delta, kw)
    errs = {"fwd": max(_check("fwd out", out, p_out, name, terms["fwd out"]),
                       _check_lse(fa, lse, p_lse))}
    # the plain outputs in fp32; in bf16 they round to the plain version's
    plain = {"fwd out": p_out.float(),
             "dq": fa.flash_dq_plain(q, k, v, g, lse, delta, **f32)}
    plain["dk"], plain["dv"] = fa.flash_dkv_plain(q, k, v, g, lse, delta,
                                                  **f32)
    del p_out, p_lse
    errs["dq"] = _check("dq", fa.flash_dq(q, k, v, g, lse, delta, **kw),
                        plain["dq"].to(dtype), name, terms["dq"])
    dk, dv = fa.flash_dkv(q, k, v, g, lse, delta, **kw)
    errs["dkv"] = max(
        _check("dk", dk, plain["dk"].to(dtype), name, terms["dk"]),
        _check("dv", dv, plain["dv"].to(dtype), name, terms["dv"]))
    del dk, dv
    # the kernels own their output rows (no atomics): two runs, same bits
    for kind, run in (("fwd", lambda: fa.flash_fwd(q, k, v, **kw)),
                      ("dq", lambda: (fa.flash_dq(q, k, v, g, lse, delta,
                                                  **kw),)),
                      ("dkv", lambda: fa.flash_dkv(q, k, v, g, lse, delta,
                                                   **kw))):
        first, again = run(), run()
        same = all(torch.equal(a, b) for a, b in zip(first, again))
        print(f"  {kind} run twice: {'identical bits' if same else 'DIFFER'}")
        if not same:
            raise AssertionError(f"{kind}: two runs on the same inputs differ")
    del first, again
    print(f"  planted faults, each leaving out the tile {TILE.start}:"
          f"{TILE.stop} of its loop, must fail the same check:")
    bad = _planted_faults(fa, torch, q, k, v, g, lse, delta, kw, plain)
    for key, got in bad.items():
        want = plain[key].to(dtype)
        got = got.to(dtype)
        worst = _excess(got, want, name, terms[key])
        print(f"    {key:<8} max_abs_err {_err(got, want):.3e}  worst "
              f"element at {worst:.3f} of tol  (max|plain| "
              f"{float(want.float().abs().max()):.3e})  "
              f"{'rejected' if worst > 1.0 else 'ACCEPTED'}")
        if not worst > 1.0:
            raise AssertionError(f"the {name} tolerance accepts a {key} "
                                 "that leaves out a tile")
    del bad, plain, terms
    torch.cuda.empty_cache()
    return errs, (q, k, v, g, lse, delta, kw)


def phase_slice_shape(fa, torch, dev, bench):
    """Each kernel at the shapes the main paths give it: error against
    the plain version and the same check failing planted faults at the
    whole batch (phases 5 and 6a) and at one of 2 microbatches (6b, 6c);
    at the whole batch also time, plain time and the library's time."""
    import torch.nn.functional as F
    print("== phase 3b: kernels at the main path's shape")
    b, h, s = LM["batch"], LM["heads"], LM["seq_len"]
    d = LM["d_model"] // h
    bh, name = b * h, "bfloat16"
    micro, _ = _hold_at_shape(fa, torch, dev, bh // 2, s, d)
    errs, (q, k, v, g, lse, delta, kw) = _hold_at_shape(fa, torch, dev, bh,
                                                         s, d)
    errs = {kind: max(err, micro[kind]) for kind, err in errs.items()}

    calls = {
        "fwd": (lambda: fa.flash_fwd(q, k, v, **kw),
                lambda: fa.flash_fwd_plain(q, k, v, **kw)),
        "dq": (lambda: fa.flash_dq(q, k, v, g, lse, delta, **kw),
               lambda: fa.flash_dq_plain(q, k, v, g, lse, delta, **kw)),
        "dkv": (lambda: fa.flash_dkv(q, k, v, g, lse, delta, **kw),
                lambda: fa.flash_dkv_plain(q, k, v, g, lse, delta, **kw)),
    }
    # the library yardsticks, in SDPA's [B, H, S, D] layout; the port
    # never calls them. The forward: scaled_dot_product_attention. The
    # backward: aten's flash backward, one call for dq, dk and dv, so it
    # stands against K2 and K3 alike.
    aten = torch.ops.aten
    qs, ks, vs, gs = (x.view(b, h, s, d) for x in (q, k, v, g))
    sdpa_fwd = bench.cuda_time_ms(lambda: F.scaled_dot_product_attention(
        qs, ks, vs, is_causal=True, scale=kw["sm_scale"]), iters=20)
    o_l, lse_l, cum_q, cum_k, max_q, max_k, seed, offset = \
        aten._scaled_dot_product_flash_attention(
            qs, ks, vs, 0.0, True, False, scale=kw["sm_scale"])[:8]

    def sdpa_bwd():
        return aten._scaled_dot_product_flash_attention_backward(
            gs, qs, ks, vs, o_l, lse_l, cum_q, cum_k, max_q, max_k, 0.0,
            True, seed, offset, scale=kw["sm_scale"])

    lib_dq = sdpa_bwd()[0].view(bh, s, d)
    print(f"  library backward dq against the kernel's: max_abs_err "
          f"{_err(lib_dq, fa.flash_dq(q, k, v, g, lse, delta, **kw)):.3e}")
    del lib_dq
    sdpa_bwd_ms = bench.cuda_time_ms(sdpa_bwd, iters=20)
    library = {"fwd": sdpa_fwd, "dq": sdpa_bwd_ms, "dkv": sdpa_bwd_ms}
    rows = {}
    for kind, (kern, plain) in calls.items():
        ms = bench.cuda_time_ms(kern, iters=20)
        plain_ms = bench.cuda_time_ms(plain, iters=5, warmup=1)
        torch.cuda.empty_cache()
        bound, by, flops, nbytes = _bound_ms(kind, bh, s, d, name, 2)
        rows[kind] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                          bound_by=by, max_abs_err=errs[kind],
                          library_ms=library[kind],
                          tflops=flops / ms / 1e9)
        print(f"  {kind:<4} {ms:9.3f} ms  plain {plain_ms:9.3f} ms  "
              f"bound {bound:7.3f} ms ({by}; {flops / 1e9:.1f} GFLOP, "
              f"{nbytes / 1e6:.1f} MB)  {flops / ms / 1e9:.1f} TFLOP/s  "
              f"{100 * bound / ms:.1f}% of bound")
    print(f"  library: sdpa fwd {sdpa_fwd:.3f} ms, flash bwd (dq, dk, dv) "
          f"{sdpa_bwd_ms:.3f} ms; port fwd {rows['fwd']['ms']:.3f} ms, "
          f"dq + dkv {rows['dq']['ms'] + rows['dkv']['ms']:.3f} ms")
    return rows


def phase_tune(fa, torch, dev, bench, lib):
    """Each tile configuration of the bf16 K1, K2 and K3 kernels at the
    main path's shape, timed in turns, each held to the default's output."""
    import ctypes
    print("== tune: tile configurations at the main path's shape")
    b, h, s = LM["batch"], LM["heads"], LM["seq_len"]
    d = LM["d_model"] // h
    bh, scale = b * h, 1.0 / d ** 0.5
    gen = torch.Generator().manual_seed(1)
    q, k, v, g = (_rand((bh, s, d), torch.bfloat16, gen, dev)
                  for _ in range(4))
    kw = dict(causal=True, sm_scale=scale)
    out, lse = fa.flash_fwd(q, k, v, **kw)
    delta = (g.float() * out.float()).sum(-1)
    dq = fa.flash_dq(q, k, v, g, lse, delta, **kw)
    dk, dv = fa.flash_dkv(q, k, v, g, lse, delta, **kw)
    o2, lse2 = torch.empty_like(out), torch.empty_like(lse)
    dq2 = torch.empty_like(dq)
    dk2, dv2 = torch.empty_like(dk), torch.empty_like(dv)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptr = [x.data_ptr() for x in (q, k, v, g, lse, delta)]

    def fwd(keys, stages):
        return lib.hvd_flash_fwd_sm90(
            ptr[0], ptr[1], ptr[2], o2.data_ptr(), lse2.data_ptr(), bh, s, s,
            d, 0, 0, 1, ctypes.c_float(scale), keys, stages, stream)

    def dq_(keys, stages):
        return lib.hvd_flash_dq_sm90(
            *ptr, dq2.data_ptr(), 0, bh, s, s, d, 0, 0, 1,
            ctypes.c_float(scale), keys, stages, stream)

    def dkv(stages):
        return lib.hvd_flash_dkv_sm90(
            *ptr, dk2.data_ptr(), dv2.data_ptr(), 0, bh, s, s, d, 0, 0, 1,
            ctypes.c_float(scale), stages, stream)

    for kind, call, want, got in (("fwd", fwd, (out, lse), (o2, lse2)),
                                  ("dq", dq_, (dq,), (dq2,)),
                                  ("dkv", dkv, (dk, dv), (dk2, dv2))):
        names, cfgs = TUNE[kind]
        label = {c: " ".join(f"{n} {x}" for n, x in zip(names, c))
                 for c in cfgs}
        times = {}
        for rnd in range(2):  # two rounds, configurations in turns
            for cfg in cfgs:
                rc = call(*cfg)
                if rc != 0:
                    raise RuntimeError(f"{kind} {cfg}: CUDA error {rc}")
                torch.cuda.synchronize()
                err = max(_err(a, b_) for a, b_ in zip(got, want))
                ms = bench.cuda_time_ms(lambda: call(*cfg), iters=20)
                times.setdefault(cfg, []).append(ms)
                print(f"  {kind} {label[cfg]} round {rnd}: {ms:.4f} ms  "
                      f"max_abs_err against the default {err:.3e}")
        best = min(times, key=lambda c: min(times[c]))
        print(f"  {kind} fastest: {label[best]} ({min(times[best]):.4f} ms)")


def _want_launches(fa, label, want):
    """The kernels' launches since the last reset must be ``want`` each."""
    launches = dict(fa.LAUNCHES)
    print(f"  {label} launches: {launches}")
    if launches != {"fwd": want, "dq": want, "dkv": want}:
        raise AssertionError(f"{label}: launches {launches}, want {want} "
                             "of each")


def phase_parity(fa, torch, dev):
    """One LM step (loss and gradients, 2 layers, fp32) on the card
    through the kernels and on the CPU through the plain versions, with
    the same weights and tokens."""
    from horovod_tpu_torch import training
    from horovod_tpu_torch.models.transformer import (Transformer,
                                                      TransformerConfig)
    print("== phase 4: small LM step, card against CPU")
    cfg = TransformerConfig(vocab_size=512, num_layers=2, num_heads=4,
                            d_model=256, d_ff=1024, dtype=torch.float32,
                            flash_attention=True)
    cpu = Transformer(cfg, generator=torch.Generator().manual_seed(3))
    card = Transformer(cfg, device=dev)
    card.load_state_dict(cpu.state_dict())
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, size=(2, 384)))
    losses = []
    for model, toks in ((cpu, tokens), (card, tokens.to(dev))):
        fa.reset_launches()
        loss = training.softmax_cross_entropy(model(toks)[:, :-1],
                                              toks[:, 1:])
        loss.backward()
        losses.append(loss.item())
    _want_launches(fa, "card step", cfg.num_layers)
    print(f"  loss cpu {losses[0]:.7f} card {losses[1]:.7f}")
    if not abs(losses[0] - losses[1]) <= 1e-5 * abs(losses[0]):
        raise AssertionError(f"loss differs: {losses}")
    worst = 0.0
    for (n, pc), (_, pg) in zip(cpu.named_parameters(),
                                card.named_parameters()):
        err = _err(pg.grad.cpu(), pc.grad)
        bound = 1e-6 + 1e-4 * float(pc.grad.abs().max())
        worst = max(worst, err / bound)
        if err > bound:
            raise AssertionError(f"grad {n}: error {err} above {bound}")
    print(f"  grads agree: worst error at {worst:.3f} of its tolerance "
          "(1e-6 + 1e-4 max|g|)")


def _model_flops(lm):
    """FLOPs one rank's step needs, recompute not counted: 6 per matmul
    weight per token (forward and backward), plus causal attention's six
    products (two forward, four backward) over the visible pairs."""
    d, b, s = lm["d_model"], lm["batch"], lm["seq_len"]
    weights = lm["layers"] * 12 * d * d + d * lm["vocab"]  # d_ff = 4 d
    pairs = b * s * (s + 1) // 2
    return 6 * weights * b * s + lm["layers"] * 6 * 2 * pairs * d


def _drive(label, hvd, fa, torch, bench, step, batch, want, per_step_tokens,
           exchange, profile=False):
    """Run ``step(*batch)`` STEPS times with the kernels' launch counts
    set to 0 just before and read just after; print the step time,
    tokens/s, peak memory, the exchange and the launches; hold the
    losses (finite, falling) and the launches (``want`` of each kernel).
    Returns the losses, the launches and the median step ms."""
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()  # count only this path's launches
    losses, times = [], []
    for _ in range(STEPS):
        t = time.perf_counter()
        loss = step(*batch)
        bench.sync()
        times.append(time.perf_counter() - t)
        losses.append(float(loss))
    launches = dict(fa.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    step_ms = 1e3 * float(np.median(times[1:]))
    ntok = per_step_tokens * hvd.size()
    print(f"  {label} losses {[round(x, 5) for x in losses]}")
    print(f"  {label} step ms {[round(1e3 * x, 2) for x in times]} (first "
          f"includes warm-up); median of steps 2..{STEPS}: {step_ms:.2f} ms, "
          f"{ntok / step_ms * 1e3:.0f} tokens/s")
    rate = _model_flops(LM) / (step_ms / 1e3)  # this rank's FLOP/s
    print(f"  {label} model FLOPs {_model_flops(LM) / 1e12:.2f} T per step "
          f"and rank: {rate / 1e12:.1f} TFLOP/s, "
          f"{100 * rate / PEAK_FLOPS['bfloat16']:.2f}% of the bf16 peak")
    print(f"  {label} peak device memory {peak / 2**30:.2f} GiB")
    print(f"  {label} {exchange()}")
    print(f"  {label} launches: {launches}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{label}: non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{label}: loss did not decrease: {losses}")
    if launches != {"fwd": want, "dq": want, "dkv": want}:
        raise AssertionError(f"{label}: launches {launches}, want {want} "
                             "of each")
    if profile:
        profile_step(torch, lambda: step(*batch), step_ms)
    return losses, launches, step_ms


def _schedule_line(schedule):
    padded = sum(schedule.padded_sizes) * schedule.buckets[0].dtype.itemsize
    return (f"bucket schedule: {len(schedule.buckets)} buckets, "
            f"{padded / 1e6:.1f} MB padded, world {schedule.world}")


def _lm_bench(bench, torch, **kw):
    return bench.make_lm_bench(
        batch=LM["batch"], layers=LM["layers"], d_model=LM["d_model"],
        heads=LM["heads"], vocab=LM["vocab"], flash=True,
        dtype=torch.bfloat16, lr=3e-4, weight_decay=1e-4, **kw)


def phase_full(hvd, fa, torch, bench):
    print("== phase 5: full-width data-parallel LM training")
    hvd.init()  # the card and NCCL
    print(f"  init: rank {hvd.rank()} size {hvd.size()} device "
          f"{hvd.device()} backend "
          f"{torch.distributed.get_backend()}")
    t0 = time.perf_counter()
    step, model, opt, tokens = _lm_bench(bench, torch, seq_len=LM["seq_len"])
    bench.sync()
    nparams = sum(p.numel() for p in model.parameters())
    print(f"  model: {nparams / 1e6:.2f} M params, built and broadcast in "
          f"{time.perf_counter() - t0:.2f} s")

    def exchange():
        buckets = opt.last_buckets
        return (f"fused allreduce: {len(buckets)} buckets, "
                f"{sum(b.nbytes for b in buckets) / 1e6:.1f} MB per step")

    losses, launches, step_ms = _drive(
        "5", hvd, fa, torch, bench, step, (tokens,),
        LM["layers"] * STEPS, LM["batch"] * LM["seq_len"], exchange,
        profile=True)
    tok_s = LM["batch"] * LM["seq_len"] * hvd.size() / step_ms * 1e3
    hvd.shutdown()
    return losses, launches, tok_s


def phase_parity_exchange(hvd, fa, torch):
    """The phase-4 LM trained 3 steps through ``make_train_step`` with 2
    microbatches, the overlapped reduce-scatter pipeline and ZeRO-1
    AdamW: once on the CPU (gloo, the kernels' plain versions), once on
    the card (NCCL, the kernels), from the same weights and batch."""
    from horovod_tpu_torch import convert, training
    from horovod_tpu_torch.models.transformer import (Transformer,
                                                      TransformerConfig)
    print("== phase 4b: small LM, 2 microbatches, overlap + ZeRO-1, "
          "card against CPU")
    cfg = TransformerConfig(vocab_size=512, num_layers=2, num_heads=4,
                            d_model=256, d_ff=1024, dtype=torch.float32,
                            flash_attention=True)
    start = Transformer(cfg, generator=torch.Generator().manual_seed(4))
    p0 = {n: p.detach().clone() for n, p in start.named_parameters()}
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, size=(4, 385)))
    # AdamW's update lr m / (sqrt(v) + eps) is near lr sign(g) early on,
    # so at eps 1e-8 a rounding-level difference in a gradient that
    # nearly cancels moves its parameter by up to lr |dg| / eps, beyond
    # the bound below; at eps 1e-4 the update is at most lr / eps = 10
    # times as sensitive as the gradient, and the check sees the exchange
    runs = {}
    for where in ("cpu", "cuda"):
        hvd.init(device=where)
        dev = hvd.device()
        model = Transformer(cfg, device=dev)
        model.load_state_dict(start.state_dict())
        opt = hvd.DistributedOptimizer(
            torch.optim.AdamW(model.parameters(), lr=1e-3,
                              betas=(0.9, 0.999), eps=1e-4,
                              weight_decay=1e-4),
            named_parameters=convert.flax_named_parameters(model),
            sharded_update=True)
        training.create_train_state(model, opt)
        step = training.make_train_step(model, opt, accum_steps=2,
                                        overlap_grads=True)
        x, y = tokens[:, :-1].to(dev), tokens[:, 1:].to(dev)
        fa.reset_launches()
        losses = [float(step(x, y)) for _ in range(3)]
        runs[where] = (losses, {n: p.detach().cpu() for n, p in
                                model.named_parameters()})
        print(f"  {where}: {_schedule_line(opt.zero_state.plan.schedule)}; "
              f"losses {[f'{v:.7f}' for v in losses]}")
        hvd.shutdown()
    # the CPU run takes the plain versions; the card's launches each
    # kernel once per layer, microbatch and step
    _want_launches(fa, "card", cfg.num_layers * 2 * 3)
    (cpu_losses, cpu_p), (card_losses, card_p) = runs["cpu"], runs["cuda"]
    for a, b in zip(cpu_losses, card_losses):
        if not abs(a - b) <= 1e-5 * abs(a):
            raise AssertionError(f"loss differs: cpu {cpu_losses}, card "
                                 f"{card_losses}")
    worst = 0.0
    for n, pc in cpu_p.items():
        err = _err(card_p[n], pc)
        bound = 1e-6 + 1e-4 * _err(pc, p0[n])
        worst = max(worst, err / bound)
        if err > bound:
            raise AssertionError(f"param {n}: error {err} above {bound}")
    print(f"  params after 3 steps agree: worst error at {worst:.3f} of "
          "its tolerance (1e-6 + 1e-4 max|p - p0|)")


def phase_exchange_full(hvd, fa, torch, bench, phase5_losses):
    """The full-width LM through the rest of the exchange: 6a ZeRO-1 in
    ``make_lm_train_step``; 6b ``make_train_step`` with 2 microbatches,
    the overlapped pipeline and ZeRO-1 (profiled); 6c 6b without
    ZeRO-1."""
    import gc
    from horovod_tpu_torch import training
    print("== phase 6: full-width LM through ZeRO-1 and the overlapped "
          "bucket pipeline")
    hvd.init()
    layers, seq = LM["layers"], LM["seq_len"]

    step, model, opt, tokens = _lm_bench(bench, torch, seq_len=seq,
                                         sharded_update=True)
    schedule = opt.zero_state.plan.schedule
    losses, _, _ = _drive("6a", hvd, fa, torch, bench, step, (tokens,),
                       layers * STEPS, LM["batch"] * seq,
                       lambda: "ZeRO-1 " + _schedule_line(schedule))
    # the same weights and batch as phase 5, and at world 1 the same
    # math: only the rounding of the update differs (ZeRO-1 adds the
    # gathered delta (p + u) - p where phase 5 adds u, an fp32 ulp at
    # most), and in bf16 compute that can move a weight's bf16 cast by
    # one bf16 step. The loss falls about 10 % over phase 5's steps, so
    # a bucket's update lost or applied twice moves it far past 1e-3
    for i, (a, b) in enumerate(zip(losses, phase5_losses)):
        if not abs(a - b) <= 1e-3 * abs(b):
            raise AssertionError(f"6a step {i + 1} loss {a} against phase "
                                 f"5's {b}: beyond 1e-3 relative")
    print(f"  6a against phase 5: largest relative loss difference "
          f"{max(abs(a - b) / abs(b) for a, b in zip(losses, phase5_losses)):.3e}"
          " (bound 1e-3)")
    del step, model, opt, tokens
    for label, sharded in (("6b", True), ("6c", False)):
        gc.collect()
        torch.cuda.empty_cache()
        _, model, opt, tokens = _lm_bench(bench, torch, seq_len=seq + 1,
                                          sharded_update=sharded)
        step = training.make_train_step(model, opt, accum_steps=2,
                                        overlap_grads=True)
        batch = (tokens[:, :seq], tokens[:, 1:seq + 1])
        what = "ZeRO-1" if sharded else "all-gather + AdamW"
        _drive(label, hvd, fa, torch, bench, step, batch,
               2 * layers * STEPS, LM["batch"] * seq,
               lambda: (f"2 microbatches, overlapped reduce-scatter, "
                        f"{what}; {_schedule_line(step.schedule)}"),
               profile=label == "6b")
        if label == "6b":
            _layout_cost("6b", torch, bench, step.schedule, opt)
        del step, model, opt, tokens, batch
    hvd.shutdown()


def _quantizer_input(torch):
    """Rows of 1000 elements: a zero chunk, a tail of 232, spikes of
    +-3e38 beside values of 1e-30, a row of one sign, a constant row."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((5, 1000)) * np.exp(rng.uniform(-12, 12,
                                                            (5, 1000)))
    x[0, :256] = 0.0
    x[1, 300], x[1, 301] = 3e38, -3e38
    x[2, 5:9] = [1e-30, -1e-30, 0.0, 5e-31]
    x[3] = np.abs(x[3])
    x[4] = 0.5
    return torch.from_numpy(x.astype(np.float32))


def phase_quantizer(torch, dev):
    """Each chunked wire format on the card against the CPU, at chunk 256
    and at a clamped chunk: the same wire bytes, scales and decoded values,
    bit for bit."""
    from horovod_tpu_torch.ops import compression as comp
    print("== phase 3c: wire quantizer, card against CPU")
    x = _quantizer_input(torch)
    for name in ("int8", "fp8_e4m3", "fp8_e5m2"):
        for chunk in (256, 100):
            q = comp.by_name(name).for_length(chunk)
            want = q.roundtrip(x)
            got = [t.cpu() for t in q.roundtrip(x.to(dev))]
            dec = q.decompress_flat(got[0].to(dev), got[1].to(dev),
                                    torch.bfloat16, n=x.shape[-1]).cpu()
            want_dec = q.decompress_flat(want[0], want[1], torch.bfloat16,
                                         n=x.shape[-1])
            parts = {"wire": torch.equal(got[0].view(torch.uint8),
                                         want[0].view(torch.uint8)),
                     "scales": torch.equal(got[1], want[1]),
                     "round trip": torch.equal(got[2], want[2]),
                     "bf16 decode": torch.equal(dec.view(torch.int16),
                                                want_dec.view(torch.int16))}
            differ = [k for k, same in parts.items() if not same]
            print(f"  {name:<9} chunk {q.chunk:>3}: wire {tuple(got[0].shape)}"
                  f", scales {tuple(got[1].shape)}, round trip, bf16 decode:"
                  f" {'DIFFER: ' + ', '.join(differ) if differ else 'identical bits'}")
            if differ:
                raise AssertionError(f"{name} chunk {chunk}: the card's "
                                     f"{', '.join(differ)} differ from the "
                                     "CPU's")


def phase_parity_resnet(hvd, torch):
    """A small BatchNorm ResNet trained 3 steps through
    ``make_train_step`` (2 microbatches, the overlapped pipeline, ZeRO-1,
    an int8 wire with error feedback, 64 KB buckets) on the CPU (gloo)
    and on the card (NCCL), in fp32 from the same weights and batch; and
    once more on the CPU from the weights perturbed by 1e-6 relative, to
    measure how far rounding alone moves this net.

    The bound of each element of a tensor (parameters and BatchNorm
    statistics) is 1e-6 + 1e-4 max|x - x0| + 4 max|x_perturbed - x|, and
    of each loss 1e-5 |loss| + 4 |loss_perturbed - loss|. The last term is
    the net's own sensitivity: BatchNorm over 4 images amplifies a
    rounding-level change of a gradient whose terms cancel. The card's
    summation order differs from the CPU's by rounding, so it may part
    from the CPU as far as rounding parts the CPU from itself. Besides, an
    int8 element that rounding moves across a rounding boundary moves by
    one quantization step, its chunk's absmax / 127, which can be far
    more than its own tensor moved (a BatchNorm bias beside a large
    gradient): at most 1 in 1000 elements may exceed the bound, and each
    only by 2 max|x - x0| / 127 over its group (the largest movement
    bounds every chunk's absmax). A stream race (a residual read before
    its encode, a bucket decoded before it arrived) moves whole buckets
    by their whole update."""
    from horovod_tpu_torch import convert, training
    from horovod_tpu_torch.models import resnet
    from horovod_tpu_torch.utils import benchmarks as bench
    print("== phase 4c: small BatchNorm ResNet, 2 microbatches, overlap + "
          "ZeRO-1 + int8 wire with error feedback, card against CPU")
    kw = dict(num_filters=8, num_classes=10, dtype=torch.float32)
    start = resnet.ResNet18(generator=torch.Generator().manual_seed(5),
                            **kw)
    s0 = {n: t.clone() for n, t in start.state_dict().items()}
    images, labels = bench.synthetic_batch(8, 32, seed=5, num_classes=10)
    runs = {}
    for label, where, jitter in (("cpu", "cpu", False),
                                 ("cpu perturbed", "cpu", True),
                                 ("card", "cuda", False)):
        hvd.init(device=where)
        dev = hvd.device()
        model = resnet.ResNet18(**kw)
        model.load_state_dict(start.state_dict())
        if jitter:
            gen = torch.Generator().manual_seed(9)
            with torch.no_grad():
                for p in model.parameters():
                    p.mul_(1 + 1e-6 * torch.randn(p.shape, generator=gen))
        model.to(dev)
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
            named_parameters=convert.flax_named_parameters(model),
            sharded_update=True, compression="int8", threshold_bytes=1 << 16)
        step = training.make_train_step(model, opt, accum_steps=2,
                                        overlap_grads=True)
        losses = [float(step(images.to(dev), labels.to(dev)))
                  for _ in range(3)]
        runs[label] = (losses, {n: t.detach().cpu().clone()
                                for n, t in model.state_dict().items()})
        print(f"  {label}: {_schedule_line(step.schedule)}, wire "
              f"{step.wire.name}; losses {[f'{v:.7f}' for v in losses]}")
        hvd.shutdown()
    (cpu_l, cpu), (pert_l, pert), (card_l, card) = (
        runs["cpu"], runs["cpu perturbed"], runs["card"])
    for a, p, b in zip(cpu_l, pert_l, card_l):
        if not abs(a - b) <= 1e-5 * abs(a) + 4 * abs(p - a):
            raise AssertionError(f"loss differs: cpu {cpu_l}, card {card_l}"
                                 f", cpu perturbed {pert_l}")
    print(f"  losses: card against cpu "
          f"{max(abs(a - b) for a, b in zip(cpu_l, card_l)):.3e}, cpu "
          f"perturbed against cpu "
          f"{max(abs(a - p) for a, p in zip(cpu_l, pert_l)):.3e}")
    params = {n for n, _ in start.named_parameters()}
    for group, names in (("params", [n for n in cpu if n in params]),
                         ("BatchNorm statistics",
                          [n for n in cpu if n not in params
                           and cpu[n].is_floating_point()])):
        # the largest movement in the group bounds an int8 step: no chunk's
        # absmax exceeds the largest gradient (or delta), which moved its
        # element about that far
        step = 2 * max(float((cpu[n] - s0[n]).abs().max())
                       for n in names) / 127
        worst, flips, worst_flip, total = 0.0, 0, 0.0, 0
        for name in names:
            want, got = cpu[name], card[name]
            err = (got - want).abs()
            tight = 1e-6 + 1e-4 * float((want - s0[name]).abs().max())
            bound = tight + 4 * float((pert[name] - want).abs().max())
            over = err > bound
            if not bool(got.isfinite().all()) or \
                    bool((err[over] > tight + step).any()):
                raise AssertionError(
                    f"{name}: card against cpu {float(err.max())}, bound "
                    f"{bound}, and {tight + step} for a rounding flip")
            total += want.numel()
            flips += int(over.sum())
            if bool(over.any()):
                worst_flip = max(worst_flip, float(err[over].max()) / step)
            if bool((~over).any()):
                worst = max(worst, float(err[~over].max()) / bound)
        if flips > total // 1000:
            raise AssertionError(f"{group}: {flips} of {total} elements past "
                                 "their bound: more than rounding flips")
        print(f"  {group} after 3 steps: worst element at {worst:.3f} of its "
              f"tensor's bound; {flips} of {total} past it (int8 rounding "
              f"flips), the largest at {worst_flip:.3f} of 2 max|x - x0| / "
              "127")
    for name, want in cpu.items():
        if not want.is_floating_point() and not torch.equal(card[name],
                                                            want):
            raise AssertionError(f"{name}: {card[name]} != {want}")


def _conv_macs(torch, model, image_size):
    """Multiply-adds of one image's forward: every convolution's output
    elements times its input channels and window, counted by hooks on a
    one-image forward, plus every fully connected layer's weights."""
    from horovod_tpu_torch.models.resnet import Conv
    macs = []

    def hook(mod, _inp, out):
        k = mod.weight.shape
        macs.append(out[0].numel() * k[1] * k[2] * k[3])

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, Conv)]
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            model(torch.zeros(1, 3, image_size, image_size,
                              device=next(model.parameters()).device))
    finally:
        for h in hooks:
            h.remove()
        model.train(was_training)
    dense = sum(m.weight.numel() for m in model.modules()
                if isinstance(m, torch.nn.Linear))
    return sum(macs) + dense


def _drive_images(label, torch, bench, step, batch, steps, flops, exchange,
                  layers=None, ranges=None):
    """Run ``step(*batch)`` ``steps`` times; print the losses, the step
    times, img/s, MFU, peak memory and the exchange; hold the losses
    (finite, and the last below the first). With ``layers``, profile one
    more step. Returns the losses and the median step ms of steps 2.."""
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for _ in range(steps):
        t = time.perf_counter()
        loss = step(*batch)
        bench.sync()
        times.append(time.perf_counter() - t)
        losses.append(float(loss))
    peak = torch.cuda.max_memory_allocated()
    step_ms = 1e3 * float(np.median(times[1:]))
    images = batch[0].shape[0]
    rate = flops / (step_ms / 1e3)
    print(f"  {label} losses {[round(x, 5) for x in losses]}")
    print(f"  {label} step ms {[round(1e3 * x, 2) for x in times]} (first "
          f"includes warm-up); median of steps 2..{steps}: {step_ms:.2f} "
          f"ms, {images / step_ms * 1e3:.1f} img/s")
    print(f"  {label} model FLOPs {flops / 1e12:.2f} T per step: "
          f"{rate / 1e12:.1f} TFLOP/s, {100 * rate / PEAK_FLOPS['bfloat16']:.2f}"
          "% of the bf16 peak (MFU)")
    print(f"  {label} peak device memory {peak / 2**30:.2f} GiB")
    print(f"  {label} {exchange()}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{label}: non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{label}: loss did not decrease: {losses}")
    by_layer = None
    if layers is not None:
        by_layer = profile_step(torch, lambda: step(*batch), step_ms, layers,
                                ranges)
    return losses, step_ms, by_layer


def _wire_bytes(schedule, wire, reduce_scatters):
    """``(logical, wire)`` bytes one rank sends in a step of the
    overlapped pipeline: ``reduce_scatters`` reduce-scatters and one
    all-gather of every bucket, ``world`` rows of a shard each, at
    ``wire``'s ``wire_bytes`` (a chunked format pays its row padding and
    scales), as the JAX package's telemetry counts them."""
    logical = on_wire = 0
    for bucket, shard in zip(schedule.buckets, schedule.shard_sizes):
        q = wire.for_length(shard) if wire is not None and wire.chunked \
            else wire
        width = (shard * bucket.dtype.itemsize if q is None
                 else q.wire_bytes(shard, bucket.dtype))
        passes = (reduce_scatters + 1) * schedule.world
        logical += passes * shard * bucket.dtype.itemsize
        on_wire += passes * width
    return logical, on_wire


def _quantize_ms(torch, bench, schedule, wire, dev):
    """Card ms of one microbatch's encode of every bucket (the
    ``[world, shard]`` rows with error feedback: add the residual, round
    trip, new residual) plus the decode of what arrives, on a seeded
    gradient: the compression's own cost in the reduce-scatter."""
    gen = torch.Generator(device=dev).manual_seed(0)
    flats = [torch.randn(n, generator=gen, device=dev)
             for n in schedule.padded_sizes]
    res = [torch.zeros_like(f) for f in flats]

    def run():
        for f, r, shard in zip(flats, res, schedule.shard_sizes):
            q = wire.for_length(shard) if wire.chunked else wire
            rows = (f + r).view(schedule.world, shard)
            w, scales, deq = q.roundtrip(rows)
            r.copy_((rows - deq).view(-1))
            q.decompress_flat(w, scales, torch.float32, n=shard).sum(0)

    return bench.cuda_time_ms(run, iters=5, warmup=1)


def phase_resnet(hvd, torch, bench):
    """7a: ``bench.py``'s headline; 7b: its overlap x compression matrix;
    7c: VGG-16."""
    import gc
    from horovod_tpu_torch.ops import compression as comp
    # as upstream's pytorch_synthetic_benchmark.py: cuDNN picks each
    # convolution's algorithm by timing them at the first step
    torch.backends.cudnn.benchmark = True
    hvd.init()
    dev = hvd.device()
    print("== phase 7a: ResNet-101, 256 images of 224x224, bf16 on fp32 "
          "parameters, SGD(0.01, momentum 0.9), fused allreduce")
    t0 = time.perf_counter()
    step, model, opt, batch = bench.make_resnet_bench(**RESNET)
    bench.sync()
    nparams = sum(p.numel() for p in model.parameters())
    macs = _conv_macs(torch, model, RESNET["image_size"])
    flops = 6 * macs * RESNET["batch"]
    print(f"  model: {nparams / 1e6:.2f} M params, {macs / 1e9:.3f} G "
          f"multiply-adds an image forward, built and broadcast in "
          f"{time.perf_counter() - t0:.2f} s")

    def exchange():
        buckets = opt.last_buckets
        return (f"fused allreduce: {len(buckets)} buckets "
                f"{[round(b.nbytes / 1e6, 1) for b in buckets]} MB, "
                f"{sum(b.nbytes for b in buckets) / 1e6:.1f} MB per step")

    losses_7a, ms_7a, layers_7a = _drive_images(
        "7a", torch, bench, step, batch, STEPS, flops, exchange,
        layers=RESNET_LAYERS)
    del step, model, opt, batch
    print(f"== phase 7b: ResNet-101, {OVERLAP_ACCUM} microbatches, "
          "overlapped pipeline, ZeRO-1, AdamW(1e-3, weight decay 1e-4), "
          "error feedback, at each wire")
    runs = {}
    for name in WIRES:
        gc.collect()
        torch.cuda.empty_cache()
        step, model, opt, batch = bench.make_resnet_bench(
            **RESNET, optimizer="adamw", accum_steps=OVERLAP_ACCUM,
            overlap_grads=True, sharded_update=True, compression=name)
        wire = comp.by_name(name)
        if step.wire is not wire:
            raise AssertionError(f"7b {name}: the step was built with "
                                 f"{step.wire!r}")
        logical, on_wire = _wire_bytes(step.schedule, wire, OVERLAP_ACCUM)

        def exchange():
            return (f"{_schedule_line(step.schedule)}; wire bytes a step "
                    f"({OVERLAP_ACCUM} reduce-scatters, 1 all-gather): "
                    f"logical {logical / 1e6:.1f} MB, wire "
                    f"{on_wire / 1e6:.1f} MB, ratio "
                    f"{logical / on_wire:.3f}")

        losses, _, _ = _drive_images(
            f"7b {name}", torch, bench, step, batch, STEPS, flops, exchange,
            layers=RESNET_LAYERS)
        if wire is not None:
            ms = _quantize_ms(torch, bench, step.schedule, wire, dev)
            print(f"  7b {name} quantizer: {ms:.3f} ms a microbatch to "
                  "encode every bucket with its residual and decode it, "
                  f"{OVERLAP_ACCUM * ms:.3f} ms a step")
        runs[name] = losses
        if name == "none":
            _layout_cost("7b", torch, bench, step.schedule, opt)
        del step, model, opt, batch
    exact = np.asarray(runs["none"])
    for name in WIRES[1:]:
        rel = float(np.max(np.abs(np.asarray(runs[name]) - exact)
                           / np.maximum(np.abs(exact), WIRE_EPSILON_FLOOR)))
        print(f"  7b {name} against none: largest relative loss "
              f"difference {rel:.3e} (bound {WIRE_EPSILON})")
        if not rel <= WIRE_EPSILON:
            raise AssertionError(f"7b {name}: losses {runs[name]} beyond "
                                 f"{WIRE_EPSILON} of {runs['none']}")
    gc.collect()
    torch.cuda.empty_cache()
    print("== phase 7c: VGG-16, 64 images of 224x224, bf16 on fp32 "
          "parameters, SGD(0.01, momentum 0.9), fused allreduce")
    step, model, opt, batch = bench.make_resnet_bench(
        model=VGG["model"], batch=VGG["batch"],
        image_size=VGG["image_size"])
    macs = _conv_macs(torch, model, VGG["image_size"])
    print(f"  model: {sum(p.numel() for p in model.parameters()) / 1e6:.2f}"
          f" M params, {macs / 1e9:.3f} G multiply-adds an image forward")
    _drive_images("7c", torch, bench, step, batch, VGG["steps"],
                  6 * macs * VGG["batch"],
                  lambda: f"fused allreduce: {len(opt.last_buckets)} buckets,"
                  f" {sum(b.nbytes for b in opt.last_buckets) / 1e6:.1f} MB"
                  " per step")
    del step, model, opt, batch
    hvd.shutdown()
    return dict(losses=losses_7a, step_ms=ms_7a, layers=layers_7a,
                flops=flops)


def _layout_cost(label, torch, bench, schedule, opt):
    """What the flax layouts cost the buckets: packing every bucket of
    ``schedule`` (each leaf in its flax layout, one copy) and unpacking
    it into the parameters' shapes and adding it to them (ZeRO-1's delta
    add), beside the same with each leaf in torch's own layout. Each as
    the card's time and the host's (``_costs``): a pack runs once a
    microbatch, an unpack once a step."""
    from horovod_tpu_torch.ops import fusion
    leaves = [p.detach() for p in opt.params]
    plain = fusion.bucket_schedule(leaves, schedule.world,
                                   threshold_bytes=opt.threshold_bytes)
    scratch = [torch.zeros_like(p) for p in leaves]
    out = {}
    for name, sched in (("flax", schedule), ("torch", plain)):
        flats = [fusion.pack_padded(sched, i, leaves)
                 for i in range(len(sched.buckets))]

        def pack(sched=sched):
            for i in range(len(sched.buckets)):
                fusion.pack_padded(sched, i, leaves)

        def unpack(sched=sched, flats=flats):
            for i, flat in enumerate(flats):
                for j, part in fusion.unpack_bucket(sched, i, flat,
                                                    leaves).items():
                    scratch[j].add_(part)

        out[name] = [_costs(torch, bench, fn) for fn in (pack, unpack)]
        del flats
    print(f"  {label} buckets ({len(schedule.buckets)}), device ms / host "
          "ms: pack, flax layout "
          f"{out['flax'][0][0]:.3f} / {out['flax'][0][1]:.3f}, torch layout "
          f"{out['torch'][0][0]:.3f} / {out['torch'][0][1]:.3f}; unpack + "
          f"add, flax layout {out['flax'][1][0]:.3f} / "
          f"{out['flax'][1][1]:.3f}, torch layout {out['torch'][1][0]:.3f} "
          f"/ {out['torch'][1][1]:.3f}")


def _costs(torch, bench, fn):
    """``(device ms, host ms)`` of one ``fn()`` after a warm-up call, each
    the median of 3: the host's wall time from an idle card to the end of
    the work, and the card's time between two events around ``fn()``
    queued behind a spin of about twice that wall time, so the host has
    issued all of it before the card starts it and no launch gap of the
    host's counts."""
    fn()
    bench.sync()
    walls = []
    for _ in range(3):
        t = time.perf_counter()
        fn()
        bench.sync()
        walls.append(time.perf_counter() - t)
    host = 1e3 * float(np.median(walls))
    devs = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(4e6 * (host + 1)))  # ~2 GHz: 2 (host + 1) ms
        start.record()
        fn()
        end.record()
        end.synchronize()
        devs.append(start.elapsed_time(end))
    return float(np.median(devs)), host


def _flat_tensors(leaves):
    """The tensors of a flat train state, ZeRO rows included."""
    from horovod_tpu_torch import ckpt
    out = []
    for leaf in leaves:
        if isinstance(leaf, ckpt.ZeroLeaf):
            for _, bucket, value in leaf.entries:
                out += list(value.values()) if bucket is not None else [value]
        else:
            out.append(leaf)
    return out


def _state_copy(torch, leaves):
    """A device copy of every tensor of a flat train state (numpy counts
    as they are)."""
    return [t.detach().clone() if torch.is_tensor(t) else np.array(t)
            for t in _flat_tensors(leaves)]


def _state_diff(torch, a, b):
    """The largest absolute difference between two state copies."""
    worst = 0.0
    for x, y in zip(a, b):
        if torch.is_tensor(x):
            worst = max(worst, float((x.double() - y.double()).abs().max()))
        else:
            worst = max(worst, float(np.abs(np.asarray(x, np.float64)
                                            - np.asarray(y, np.float64))
                                     .max()))
    return worst


def _hold_repeat(label, got, repeat):
    """``got``, the resumed run's distance from the unbroken one, is 0
    when two unbroken runs repeat bit for bit (``repeat`` 0), and
    otherwise within twice their difference."""
    bound = 2 * repeat
    print(f"  {label}: resumed against unbroken {got:.3e}, two unbroken "
          f"runs {repeat:.3e} (bound {bound:.3e}"
          f"{', bit for bit' if repeat == 0 else ''})")
    if not got <= bound:
        raise AssertionError(f"{label}: the resumed run is {got} from the "
                             f"unbroken one, beyond {bound}")


def _timed_save(torch, saver, step_no, leaves, meta):
    """Save ``leaves`` through ``saver`` and wait for the commit; prints
    the state's bytes, ``save()``'s blocking ms (of it: making the
    pinned buffers, and the device-to-host copy) and the background
    write and commit ms."""
    blocking = saver.save(step_no, leaves, meta=meta)
    saver.flush()
    tensor_bytes = sum(t.numel() * t.element_size() if torch.is_tensor(t)
                       else np.asarray(t).nbytes
                       for t in _flat_tensors(leaves))
    print(f"  save of step {step_no}: state {tensor_bytes / 1e6:.1f} MB in "
          f"tensors, shard file {saver.last_bytes / 1e6:.1f} MB; save() "
          f"blocked {1e3 * blocking:.1f} ms (pinned buffers made "
          f"{1e3 * saver.last_pin_s:.1f} ms, device-to-host copy "
          f"{1e3 * saver.last_copy_s:.1f} ms), background write + commit "
          f"{1e3 * (saver.last_save_s - blocking):.1f} ms")


def _timed_restore(bench, root, step_no, rebuild):
    """Restore the newest checkpoint under ``root`` into the state
    ``rebuild()`` returns (``(flat_fn, load_fn)``); prints the restore's
    ms and returns the saved ``meta``."""
    from horovod_tpu_torch import ckpt
    flat_fn, load_fn = rebuild()
    bench.sync()
    t0 = time.perf_counter()
    got_step, restored, got_meta = ckpt.restore_sharded(root, flat_fn())
    load_fn(restored)
    bench.sync()
    restore_s = time.perf_counter() - t0
    if got_step != step_no:
        raise AssertionError(f"restored step {got_step}, saved {step_no}")
    print(f"  restore of step {step_no}: {1e3 * restore_s:.1f} ms")
    return got_meta


def phase_resume(hvd, fa, torch, bench):
    """8a: phase 6b's LM (2 microbatches, overlap, ZeRO-1, AdamW) fed by
    ``make_train_step(loader=...)`` from an ``ArraySource`` of seeded
    tokens: 4 steps unbroken, twice; then 2 steps, each followed by a
    save through ``AsyncCheckpointer``, a fresh model, optimizer, step
    and loader, the state and the loader's cursor restored from the
    second save, and 2 more steps. Losses and
    parameters equal the unbroken run's, bit for bit when two unbroken
    runs repeat bit for bit, else within twice their difference."""
    import gc
    import tempfile
    from horovod_tpu_torch import ckpt, convert, data, training
    print("== phase 8a: full-width LM, 4 steps unbroken against 2 + save + "
          "restore + 2, fed by the prefetch loader")
    hvd.init()
    layers, seq, batch = LM["layers"], LM["seq_len"], LM["batch"]
    toks = np.random.default_rng(8).integers(
        0, LM["vocab"], size=(4 * batch, seq + 1)).astype(np.int64)
    source = data.ArraySource((toks[:, :seq], toks[:, 1:]))

    def build():
        gc.collect()
        torch.cuda.empty_cache()
        _, model, opt, _ = _lm_bench(bench, torch, seq_len=seq + 1,
                                     sharded_update=True)
        loader = data.PrefetchLoader(source, batch, seed=8)
        step = training.make_train_step(model, opt, accum_steps=2,
                                        overlap_grads=True, loader=loader)
        return model, opt, step, loader

    fa.reset_launches()  # count only this path's launches
    runs = []
    for _ in range(2):
        model, opt, step, loader = build()
        losses = [float(step()) for _ in range(4)]
        runs.append((losses, _state_copy(torch, convert.train_state_to_flat(
            model, opt, step.state))))
        loader.close()
        del model, opt, step, loader
    model, opt, step, loader = build()
    holder = {}

    def rebuild():
        holder["run"] = build()
        m, o, s, _ = holder["run"]
        return (lambda: convert.train_state_to_flat(m, o, s.state),
                lambda flat: convert.train_state_from_flat(m, o, s.state,
                                                           flat))

    losses = []
    with tempfile.TemporaryDirectory() as root:
        # a save after each step: the first makes the pinned buffers,
        # the second reuses them (a job's steady state)
        saver = ckpt.AsyncCheckpointer(root, keep=2)
        for step_no in (1, 2):
            losses.append(float(step()))
            _timed_save(torch, saver, step_no, convert.train_state_to_flat(
                model, opt, step.state), {"data_cursor": loader.cursor()})
        saver.close()
        loader.close()
        del model, opt, step, loader, saver
        meta = _timed_restore(bench, root, 2, rebuild)
    model, opt, step, loader = holder.pop("run")
    loader.set_cursor(meta["data_cursor"])
    if step.state.step != 2:
        raise AssertionError(f"restored step count {step.state.step}")
    losses += [float(step()) for _ in range(2)]
    state = _state_copy(torch, convert.train_state_to_flat(model, opt,
                                                           step.state))
    loader.close()
    del model, opt, step, loader
    want = 2 * layers * (4 + 4 + 2 + 2)
    _want_launches(fa, "8a", want)
    (l1, s1), (l2, s2) = runs
    print(f"  8a losses unbroken {[round(x, 6) for x in l1]}, again "
          f"{[round(x, 6) for x in l2]}, resumed "
          f"{[round(x, 6) for x in losses]}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"8a: non-finite loss: {losses}")
    _hold_repeat("8a losses", max(abs(a - b) for a, b in zip(losses, l1)),
                 max(abs(a - b) for a, b in zip(l1, l2)))
    _hold_repeat("8a state after 4 steps", _state_diff(torch, state, s1),
                 _state_diff(torch, s1, s2))
    del runs, state, s1, s2
    gc.collect()
    torch.cuda.empty_cache()
    hvd.shutdown()


def phase_resume_resnet(hvd, torch, bench):
    """8b: phase 7b's ResNet-101 state (4 microbatches, overlap, ZeRO-1,
    AdamW rows, BatchNorm statistics) after 2 steps, saved and restored
    into a fresh model and optimizer: every restored tensor equals the
    saved one bit for bit, and the next step's loss equals the unbroken
    run's (bit for bit when the step repeats bit for bit from the same
    state, else within twice its repeat difference)."""
    import gc
    import tempfile
    from horovod_tpu_torch import ckpt, convert
    print("== phase 8b: ResNet-101 (7b's AdamW over ZeRO-1 rows and "
          "BatchNorm statistics), save and restore")
    hvd.init()

    def build():
        gc.collect()
        torch.cuda.empty_cache()
        return bench.make_resnet_bench(
            **RESNET, optimizer="adamw", accum_steps=OVERLAP_ACCUM,
            overlap_grads=True, sharded_update=True, compression="none")

    step, model, opt, batch = build()
    for _ in range(2):
        step(*batch)
    flat = convert.train_state_to_flat(model, opt, step.state)
    saved = _state_copy(torch, flat)
    holder = {}

    def rebuild():
        holder["run"] = build()
        s, m, o, _ = holder["run"]
        return (lambda: convert.train_state_to_flat(m, o, s.state),
                lambda f: convert.train_state_from_flat(m, o, s.state, f))

    with tempfile.TemporaryDirectory() as root:
        saver = ckpt.AsyncCheckpointer(root, keep=2)
        _timed_save(torch, saver, 2, flat, None)
        saver.close()
        _timed_restore(bench, root, 2, rebuild)
        unbroken = float(step(*batch))
        # the same step again from the same state: its own repeat
        _, restored, _ = ckpt.restore_sharded(
            root, convert.train_state_to_flat(model, opt, step.state))
        convert.train_state_from_flat(model, opt, step.state, restored)
        again = float(step(*batch))
    del step, model, opt, batch, flat
    step, model, opt, batch = holder.pop("run")
    got = _state_copy(torch, convert.train_state_to_flat(model, opt,
                                                         step.state))
    diff = _state_diff(torch, got, saved)
    print(f"  8b restored tensors against saved: largest difference "
          f"{diff:.3e} over {len(saved)} tensors")
    if diff != 0:
        raise AssertionError(f"8b: the restore is {diff} from the save")
    resumed = float(step(*batch))
    print(f"  8b next loss: unbroken {unbroken:.7f}, again {again:.7f}, "
          f"resumed {resumed:.7f}")
    _hold_repeat("8b next loss", abs(resumed - unbroken),
                 abs(again - unbroken))
    del step, model, opt, batch, got, saved
    gc.collect()
    torch.cuda.empty_cache()
    hvd.shutdown()


# kernel-name patterns of the step's layers, in the order they are tried;
# work on any stream but the step's own is NCCL's (below)
COLLECTIVES = "collectives (NCCL's streams: reduce-scatter, all-gather, " \
    "allreduce)"
LAYERS = (("attention kernels", ("flash_",)),
          ("matmuls", ("nvjet", "gemm", "cutlass", "xmma")),
          (COLLECTIVES, ("nccl",)),
          ("optimizer", ("multi_tensor", "foreach")),
          ("reductions (norms, softmax, loss)", ("reduce", "softmax")),
          ("elementwise and copies", ("elementwise", "copy", "cat",
                                      "Memcpy", "Memset")))
# the image models' layers: BatchNorm's kernels before the convolutions'
# (cuDNN's names), the optimizer's, then the rest of the elementwise work
# (ReLU, casts, padding, residual adds, the quantizer, the packing)
RESNET_LAYERS = (("BatchNorm", ("batch_norm", "bn_fw", "bn_bw", "welford")),
                 ("convolutions and matmuls (cuDNN, cuBLAS)",
                  ("conv", "xmma", "implicit", "gemm", "cutlass", "nvjet",
                   "dgrad", "wgrad", "fprop", "cudnn", "sm90_", "nhwc",
                   "nchw")),
                 (COLLECTIVES, ("nccl",)),
                 ("optimizer", ("multi_tensor", "foreach")),
                 ("other elementwise, reductions and copies",
                  ("elementwise", "reduce", "copy", "cat", "pad",
                   "max_pool", "Memcpy", "Memset")))


def _hvdrun(argv, timeout):
    """``python -m horovod_tpu_torch.run *argv`` from this checkout, its
    output captured. Returns the completed process and its seconds."""
    import os
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    t = time.perf_counter()
    rv = subprocess.run([sys.executable, "-m", "horovod_tpu_torch.run",
                         *argv], cwd=ROOT, env=env, capture_output=True,
                        text=True, timeout=timeout)
    return rv, time.perf_counter() - t


def _hvdrun_ok(label, argv, timeout):
    rv, secs = _hvdrun(argv, timeout)
    if rv.returncode != 0:
        raise AssertionError(f"{label}: hvdrun exited {rv.returncode}:\n"
                             f"{rv.stdout[-3000:]}\n{rv.stderr[-6000:]}")
    return rv, secs


# 9c's worker: rank 1 uses the card and raises, rank 0 would sleep for
# ten minutes unless the launcher's fan-out terminates it
_FAILING_WORKER = """
import os, sys, time
import torch
if os.environ["HOROVOD_RANK"] == "1":
    torch.ones(1, device="cuda").sum().item()
    print("RAISING_AT", time.time(), file=sys.stderr, flush=True)
    raise RuntimeError("planted failure on rank 1")
time.sleep(600)
"""


def phase_launch(hvd, torch, kind, phase5_tok_s):
    """9: the port's own launcher. 9a trains phase 5's LM under
    ``hvdrun -np 1`` through the callbacks (examples/lm_benchmark.py);
    9b ships a function of the package through ``run()``; 9c a job
    whose rank raises must fail, and fast."""
    from horovod_tpu_torch.examples.probe import probe
    from horovod_tpu_torch.run import launcher
    from horovod_tpu_torch.run import run as hvd_run

    # the worker needs the card's memory that this process's caching
    # allocator holds after the earlier phases
    hvd.shutdown()
    torch.cuda.empty_cache()
    print("== phase 9: the port's launcher (hvdrun)")
    rv, _ = _hvdrun_ok("--check-build", ["--check-build"], 120)
    for line in rv.stdout.splitlines():
        print("  " + line)

    print("== phase 9a: full-width LM under hvdrun -np 1 with the "
          "callbacks")
    warmup = 1
    rv, secs = _hvdrun_ok("9a", [
        "-np", "1", sys.executable, "-m",
        "horovod_tpu_torch.examples.lm_benchmark",
        "--batch", str(LM["batch"]), "--seq-len", str(LM["seq_len"]),
        "--layers", str(LM["layers"]), "--d-model", str(LM["d_model"]),
        "--heads", str(LM["heads"]), "--vocab", str(LM["vocab"]),
        "--steps", str(STEPS), "--warmup", str(warmup)], 600)
    out = json.loads([ln for ln in rv.stdout.splitlines()
                      if ln.startswith("{")][-1])
    losses, lrs = out["losses"], out["lrs"]
    warm = out["warm_steps"]
    ran = len(losses)
    print(f"  9a losses {[round(x, 5) for x in losses]}")
    print(f"  9a learning rates {lrs}")
    print(f"  9a step ms {[round(x, 2) for x in out['step_ms']]}; epoch "
          f"losses averaged by MetricAverageCallback {out['epoch_losses']}")
    print(f"  9a launches {out['launches']} over {ran} steps")
    print(f"  9a worker: imports {out['import_s']:.2f} s, init "
          f"{out['init_s']:.2f} s, first device allocation "
          f"{out['context_s']:.2f} s, kernel library load "
          f"{out['kernel_load_s']:.3f} s, model build and broadcast "
          f"{out['build_s']:.2f} s; hvdrun wall {secs:.2f} s, of it "
          f"{sum(out['step_ms']) / 1e3:.2f} s in the {ran} steps")
    print(f"  9a tokens/s {out['value']:.1f} (median of the {STEPS} timed "
          f"steps) against phase 5's {phase5_tok_s:.1f} in this call "
          "(reported, not held: host step times swing between calls)")
    want = LM["layers"] * (1 + warmup + STEPS)
    if ran != 1 + warmup + STEPS or warm != 1 + warmup:
        raise AssertionError(f"9a: ran {ran} steps, {warm} warm")
    if out["launches"] != {"fwd": want, "dq": want, "dkv": want}:
        raise AssertionError(f"9a: launches {out['launches']}, want "
                             f"{want} of each")
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"9a: losses not finite and falling: {losses}")
    # LearningRateWarmupCallback: the first epoch's batches ramp from the
    # rate to size() times it, the second holds the target
    lr0, world = out["initial_lr"], out["world"]
    expect = [lr0 * world if i >= warm
              else lr0 + (lr0 * world - lr0) * (i / warm)
              for i in range(ran)]
    if lrs != expect:
        raise AssertionError(f"9a: learning rates {lrs}, want {expect}")
    if out["device"] != "cuda" or out["device_name"] != kind:
        raise AssertionError(f"9a: ran on {out['device']} "
                             f"{out['device_name']}")

    print("== phase 9b: run(probe, np=1): an allreduce on the card through "
          "the programmatic launcher")
    t = time.perf_counter()
    results = hvd_run(probe, np=1)
    print(f"  9b results {results} in {time.perf_counter() - t:.2f} s")
    if results != [(0, 1, kind, [1.0] * 4)]:
        raise AssertionError(f"9b: {results}, want rank 0 of 1 on {kind} "
                             "averaging to 1.0")

    print("== phase 9c: a rank that raises fails the job")
    rv, secs = _hvdrun(["-np", "2", sys.executable, "-c", _FAILING_WORKER],
                       300)
    ended = time.time()
    raised = [float(ln.split()[1]) for ln in rv.stderr.splitlines()
              if ln.startswith("RAISING_AT")]
    grace = launcher.grace_seconds()
    late = ended - raised[0] if raised else math.inf
    print(f"  9c hvdrun exit {rv.returncode} after {secs:.2f} s, "
          f"{late:.2f} s after rank 1 raised (grace {grace:.0f} s)")
    print("  9c " + rv.stderr.strip().splitlines()[-1])
    if rv.returncode != 1 or late > grace or \
            "process with rank 1 exited with code 1" not in rv.stderr:
        raise AssertionError(f"9c: want exit 1 within {grace} s of rank "
                             f"1's failure:\n{rv.stderr[-4000:]}")


def _ring_shards(shards, *xs):
    """Each [bh, s, d] input cut along the sequence into ``shards``
    contiguous blocks, one per rank."""
    return [[c.contiguous() for c in x.chunk(shards, dim=1)] for x in xs]


def _ring_pass(ring, shards, qs, ks, vs, gs, sm_scale):
    """The flash ring's forward and backward over ``shards`` ranks held
    in this process (``axis.LocalAxis``): per-rank ``(outs, lses, dqs,
    dks, dvs)``."""
    from horovod_tpu_torch.parallel import axis as axis_lib
    axis = axis_lib.LocalAxis(shards)
    outs, lses = ring._flash_ring_forward(axis, qs, ks, vs, True, sm_scale)
    grads = ring._flash_ring_backward(axis, qs, ks, vs, outs, lses, gs,
                                      True, sm_scale)
    return (outs, lses) + grads


def _ring_run(ring, torch, shards, q, k, v, g, sm_scale):
    """``_ring_pass`` on whole-sequence inputs: ``(out, lse, dq, dk,
    dv)`` over the whole sequence."""
    parts = _ring_pass(ring, shards, *_ring_shards(shards, q, k, v, g),
                       sm_scale)
    return tuple(torch.cat(x, dim=1) for x in parts)


@contextlib.contextmanager
def _plain_kernels(fa):
    """The kernel wrappers replaced by their plain versions, which also
    run on the card's tensors: the ring on the plain versions."""
    kept = fa.flash_fwd, fa.flash_dq, fa.flash_dkv
    fa.flash_fwd, fa.flash_dq, fa.flash_dkv = (
        fa.flash_fwd_plain, fa.flash_dq_plain, fa.flash_dkv_plain)
    try:
        yield
    finally:
        fa.flash_fwd, fa.flash_dq, fa.flash_dkv = kept


def _ring_peak_gib(ring, torch, shards, x, use_flash):
    """Peak device memory above the inputs of the ring's forward and
    backward through autograd (flash or dense), shards in one process."""
    from horovod_tpu_torch.parallel import axis as axis_lib
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    qs, ks, vs = ([c.detach().clone().requires_grad_()
                   for c in x.chunk(shards, dim=1)] for _ in range(3))
    outs = ring._ring_attention(axis_lib.LocalAxis(shards), qs, ks, vs,
                                use_flash=use_flash)
    sum(o.float().square().sum() for o in outs).backward()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del qs, ks, vs, outs
    return peak / 2**30


def phase_ring(fa, torch, dev, bench):
    """10a: the flash ring at the main attention shape over R ranks held
    in this process, through the kernels: held against one flash call
    over the whole sequence and against the ring on the plain versions,
    twice for the same bits, its launches counted, timed against the
    whole-sequence call, and its peak memory against the dense ring's."""
    from horovod_tpu_torch.parallel import ring
    b, h, s = LM["batch"], LM["heads"], LM["seq_len"]
    d = LM["d_model"] // h
    bh, name = b * h, "bfloat16"
    print(f"== phase 10a: flash ring attention, [{b}x{h}, {s}, {d}] bf16 "
          f"causal, R in {RING_RANKS} ranks in one process")
    gen = torch.Generator().manual_seed(10)
    q, k, v, g = (_rand((bh, s, d), torch.bfloat16, gen, dev)
                  for _ in range(4))
    kw = dict(causal=True, sm_scale=1.0 / d ** 0.5)
    out, lse = fa.flash_fwd(q, k, v, **kw)
    delta = (g.float() * out.float()).sum(-1)
    whole = (out, lse, fa.flash_dq(q, k, v, g, lse, delta, **kw),
             *fa.flash_dkv(q, k, v, g, lse, delta, **kw))
    terms = _terms(fa, q, k, v, g, lse, delta, kw)
    keys = ("out", "lse", "dq", "dk", "dv")
    term = dict(zip(keys, (terms["fwd out"], None, terms["dq"], terms["dk"],
                           terms["dv"])))

    def hold(label, got, want):
        for key, a, b_ in zip(keys, got, want):
            _check(f"{label} {key}", a, b_,
                   "float32" if key == "lse" else name, term[key])

    def whole_call():
        o, l_ = fa.flash_fwd(q, k, v, **kw)
        dl = (g.float() * o.float()).sum(-1)
        return o, fa.flash_dq(q, k, v, g, l_, dl, **kw), \
            fa.flash_dkv(q, k, v, g, l_, dl, **kw)

    rows = {}
    for shards in RING_RANKS:
        print(f"  R = {shards}: blocks of {s // shards} positions")
        fa.reset_launches()
        got = _ring_run(ring, torch, shards, q, k, v, g, kw["sm_scale"])
        _want_launches(fa, f"R={shards} forward + backward", shards ** 2)
        hold(f"R={shards} against the whole-sequence kernels", got, whole)
        with _plain_kernels(fa):
            plain = _ring_run(ring, torch, shards, q, k, v, g,
                              kw["sm_scale"])
        hold(f"R={shards} against the ring on the plain versions", got,
             plain)
        del plain
        again = _ring_run(ring, torch, shards, q, k, v, g, kw["sm_scale"])
        same = all(torch.equal(a, b_) for a, b_ in zip(got, again))
        print(f"  R={shards} run twice: "
              f"{'identical bits' if same else 'DIFFER'}")
        if not same:
            raise AssertionError(f"ring R={shards}: two runs differ")
        del got, again
        # the ring's work only: the shards are cut outside the timer
        cut = _ring_shards(shards, q, k, v, g)
        ms = bench.cuda_time_ms(lambda: _ring_pass(
            ring, shards, *cut, kw["sm_scale"]), iters=5)
        del cut
        whole_ms = bench.cuda_time_ms(whole_call, iters=5)
        dead = shards * (shards - 1) // 2  # blocks wholly in the future
        rows[shards] = dict(ms=ms, whole_ms=whole_ms,
                            dead=dead / shards ** 2)
        print(f"  R={shards} ring forward + backward {ms:.3f} ms against "
              f"one flash call over the whole sequence {whole_ms:.3f} ms "
              f"({ms / whole_ms:.2f}x); {dead} of {shards ** 2} blocks "
              f"({100 * dead / shards ** 2:.1f}%) see no key and are "
              "launched anyway")
    del terms, term, whole
    x = fa._from_bh(q, b, h)
    peak = {flash: _ring_peak_gib(ring, torch, RING_RANKS[-1], x, flash)
            for flash in (True, False)}
    print(f"  R={RING_RANKS[-1]} peak device memory of forward + backward "
          f"through autograd: flash ring {peak[True]:.3f} GiB, dense ring "
          f"{peak[False]:.3f} GiB ({peak[False] / peak[True]:.1f}x)")
    if not peak[True] * 2 < peak[False]:
        raise AssertionError(f"the flash ring's backward is not bounded: "
                             f"{peak}")
    torch.cuda.empty_cache()
    return rows


def phase_seq_lm(hvd, fa, torch, bench, phase5_losses, phase5_tok_s):
    """10b: phase 5's LM, weights and batch through the seq branch of
    ``make_lm_train_step`` on a (1, 1) (data, seq) mesh: a ring of one
    block a layer."""
    from horovod_tpu_torch.parallel.mesh import build_mesh
    print("== phase 10b: full-width LM through make_lm_train_step(mesh="
          "(1, 1) data x seq, seq_axis='seq')")
    hvd.init()
    mesh = build_mesh((1, 1), ("data", "seq"))
    step, model, opt, tokens = _lm_bench(bench, torch, seq_len=LM["seq_len"],
                                         mesh=mesh, seq_axis="seq")
    assert model.cfg.sequence_axis == "seq" and opt.axes == ("data", "seq")
    losses, _, step_ms = _drive(
        "10b", hvd, fa, torch, bench, step, (tokens,),
        LM["layers"] * STEPS, LM["batch"] * LM["seq_len"],
        lambda: f"fused allreduce over {opt.axes}: "
                f"{len(opt.last_buckets)} buckets", profile=True)
    tok_s = LM["batch"] * LM["seq_len"] / step_ms * 1e3
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, phase5_losses)]
    print(f"  10b step 1 loss {losses[0]!r} against phase 5's "
          f"{phase5_losses[0]!r}: "
          f"{'bit for bit' if losses[0] == phase5_losses[0] else 'DIFFERS'}"
          f"; largest relative difference over the steps {max(rel):.3e}")
    print(f"  10b tokens/s {tok_s:.1f} against phase 5's {phase5_tok_s:.1f} "
          f"in this call ({100 * (tok_s / phase5_tok_s - 1):+.1f}%)")
    if losses[0] != phase5_losses[0] or max(rel) > 1e-3:
        raise AssertionError(f"10b losses {losses} against phase 5's "
                             f"{phase5_losses}")
    hvd.shutdown()


def _grad_sets(torch, model, params, n, batch_shape, vocab):
    """The fp32 gradients of the LM's loss on ``n`` seeded batches, one
    list a rank, in the order of ``params``."""
    from horovod_tpu_torch import training
    dev = params[0].device
    sets = []
    for seed in range(1, n + 1):
        rng = np.random.default_rng(seed)
        tokens = torch.from_numpy(rng.integers(0, vocab, size=batch_shape))
        tokens = tokens.to(dev)
        model.zero_grad(set_to_none=True)
        training.softmax_cross_entropy(model(tokens)[:, :-1],
                                       tokens[:, 1:]).backward()
        sets.append([p.grad.detach().clone() for p in params])
    model.zero_grad(set_to_none=True)
    return sets


def _combine64(torch, a, b):
    """The Adasum operator in fp64, the JAX package's zero-norm rule."""
    dot, na2, nb2 = torch.dot(a, b), torch.dot(a, a), torch.dot(b, b)
    ca = 1.0 - dot / (2.0 * na2) if float(na2) > 0 else 1.0
    cb = 1.0 - dot / (2.0 * nb2) if float(nb2) > 0 else 1.0
    return a * ca + b * cb


def _tree64(torch, vecs):
    """The XOR tree in fp64 (``adasum_tree_np``'s schedule): the common
    result."""
    vecs, d = [v.double() for v in vecs], 1
    while d < len(vecs):
        vecs = [_combine64(torch, *((vecs[i], vecs[i ^ d]) if i < i ^ d
                                    else (vecs[i ^ d], vecs[i])))
                for i in range(len(vecs))]
        d <<= 1
    return vecs[0]


def _two_level64(torch, vecs, shape):
    """The two-level Adasum in fp64 (``hierarchical_adasum_np``): node
    sums, zero-padded chunks, the tree per chunk across nodes, / the
    node size."""
    nodes, local = shape
    n = vecs[0].numel()
    pad = (-n) % local
    sums = [sum(vecs[c * local + i].double() for i in range(local))
            for c in range(nodes)]
    sums = [torch.cat([s, s.new_zeros(pad)]).view(local, -1) for s in sums]
    out = torch.cat([_tree64(torch, [s[i] for s in sums])
                     for i in range(local)])
    return out[:n] / local


def phase_two_level_full(hvd, torch, bench):
    """11a: Adasum and the two-level reduction at full width, every rank
    in this process."""
    from horovod_tpu_torch import basics
    from horovod_tpu_torch.ops import adasum, fusion
    from horovod_tpu_torch.parallel import axis, hierarchical
    print(f"== phase 11a: Adasum and the two-level reduction at full width: "
          f"phase 5's LM gradients of {ADASUM_RANKS} seeded batches, "
          f"{ADASUM_RANKS} ranks in this process, 64 MB buckets")
    hvd.init()
    t0 = time.perf_counter()
    _, model, opt, _ = _lm_bench(bench, torch, seq_len=LM["seq_len"])
    # in the order phase 5's fused allreduce packs them (flax's leaves)
    sets = _grad_sets(torch, model, opt.params, ADASUM_RANKS,
                      (LM["batch"], LM["seq_len"]), LM["vocab"])
    del model, opt
    buckets = fusion.plan_buckets(sets[0], basics.fusion_threshold())
    nparams = sum(g.numel() for g in sets[0])
    print(f"  gradients: {ADASUM_RANKS} x {nparams / 1e6:.2f} M fp32 "
          f"({nparams * 4 / 1e9:.3f} GB a rank) in {len(buckets)} buckets, "
          f"made in {time.perf_counter() - t0:.2f} s")
    flat = axis.LocalAxis(ADASUM_RANKS)
    two = axis.local_axes(TWO_LEVEL, ("dcn", "data"))
    ici, dcn = [two["data"]], two["dcn"]
    runs = {
        "tree": lambda xs: adasum._adasum_tree(xs, flat),
        "two-level adasum": lambda xs: adasum._hierarchical_adasum(
            xs, ici, dcn),
        "two-level average": lambda xs: hierarchical._allreduce(
            xs, ici, dcn, "average"),
    }
    worst = dict.fromkeys(runs, 0.0)
    ms = dict.fromkeys(runs, 0.0)
    peak = dict.fromkeys(runs, 0)
    for bucket in buckets:
        xs = [fusion._pack(bucket, g) for g in sets]
        for name, run in runs.items():
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            outs = run(xs)
            torch.cuda.synchronize()
            peak[name] = max(peak[name],
                             torch.cuda.max_memory_allocated() - base)
            if name == "tree":
                ref = _tree64(torch, xs)
            elif name == "two-level adasum":
                ref = _two_level64(torch, xs, TWO_LEVEL)
            else:
                ref = sum(x.double() for x in xs) / ADASUM_RANKS
                # each element within fp32 summation order of the mean
                bound = ADASUM_RANKS * 2.0 ** -24 * (
                    sum(x.double().abs() for x in xs) / ADASUM_RANKS)
            for r, out in enumerate(outs):
                if not bool(out.isfinite().all()):
                    raise AssertionError(f"11a {name}: rank {r} not finite")
                if not torch.equal(out, outs[0]):
                    raise AssertionError(f"11a {name}: rank {r} differs "
                                         "from rank 0")
            err = (outs[0].double() - ref).abs()
            if name == "two-level average":
                share = float((err / bound.clamp_min(1e-30)).max())
                if not bool((err <= bound).all()):
                    raise AssertionError(f"11a {name}: an element at "
                                         f"{share:.3f} of its bound")
            else:
                share = float(err.max()) / (ADASUM_RTOL *
                                            float(ref.abs().max()))
                if share > 1.0:
                    raise AssertionError(f"11a {name}: worst error "
                                         f"{float(err.max())!r} past "
                                         f"{ADASUM_RTOL} of max|ref|")
            worst[name] = max(worst[name], share)
            ms[name] += bench.cuda_time_ms(lambda: run(xs), iters=3,
                                           warmup=1)
            del outs, ref, err
        del xs
    del sets
    levels = ADASUM_RANKS.bit_length() - 1
    elems = sum(b.nbytes for b in buckets) // 4
    # a read of a and b and a write of the result, per rank and level
    bound_bytes = {"tree": ADASUM_RANKS * levels * 3 * elems * 4,
                   "two-level adasum": ADASUM_RANKS * (
                       TWO_LEVEL[0].bit_length() - 1) * 3 * elems * 4
                   // TWO_LEVEL[1]}
    for name in runs:
        line = (f"  11a {name}: {ms[name]:.3f} ms over every bucket; worst "
                f"error at {worst[name]:.3f} of its bound; peak "
                f"{peak[name] / 2**30:.2f} GiB above the inputs")
        if name in bound_bytes:
            b_ms = bound_bytes[name] / PEAK_BYTES * 1e3
            line += (f"; memory bound of its tree {b_ms:.3f} ms "
                     f"({bound_bytes[name] / 1e9:.2f} GB at "
                     f"{PEAK_BYTES / 1e12:.2f} TB/s), "
                     f"{100 * b_ms / ms[name]:.1f}% of bound")
        print(line)
    padded = 4 * sum(sum(b.sizes) + (-sum(b.sizes)) % TWO_LEVEL[1]
                     for b in buckets)
    print(f"  11a dcn stage bytes a rank (from the shapes): flat allreduce "
          f"{sum(b.nbytes for b in buckets) / 1e6:.1f} MB, two-level "
          f"{padded / TWO_LEVEL[1] / 1e6:.1f} MB across dcn "
          f"({padded / TWO_LEVEL[1] / sum(b.nbytes for b in buckets):.3f} "
          f"of flat at local size {TWO_LEVEL[1]})")
    hvd.shutdown()


def phase_two_level_lm(hvd, fa, torch, bench, phase5_losses, phase5_tok_s):
    """11b: phase 5's LM on a (1, 1) (dcn, data) mesh through the
    two-level reduction and through Adasum: both the identity at world
    1, so the losses are phase 5's bit for bit. Returns each kernel's
    launches over both runs."""
    from horovod_tpu_torch.parallel.mesh import build_mesh
    launches = {}
    for label, kw in (("11b hierarchical", dict(hierarchical=True)),
                      ("11b adasum", dict(op=hvd.Adasum))):
        args = ", ".join(f"{k}={v!r}" for k, v in kw.items())
        print(f"== phase {label}: full-width LM on a (1, 1) dcn x data "
              f"mesh, DistributedOptimizer({args})")
        hvd.init()
        mesh = build_mesh((1, 1), ("dcn", "data"))
        step, model, opt, tokens = _lm_bench(bench, torch,
                                             seq_len=LM["seq_len"],
                                             mesh=mesh, **kw)
        assert opt.axes == ("dcn", "data")
        losses, got, step_ms = _drive(
            label, hvd, fa, torch, bench, step, (tokens,),
            LM["layers"] * STEPS, LM["batch"] * LM["seq_len"],
            lambda: f"fused buckets over {opt.axes}: "
                    f"{len(opt.last_buckets)} buckets, op {opt.op}, "
                    f"hierarchical {opt.hierarchical_resolved()}")
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        tok_s = LM["batch"] * LM["seq_len"] / step_ms * 1e3
        same = losses == phase5_losses
        print(f"  {label} losses against phase 5's: "
              f"{'bit for bit' if same else 'DIFFER'}; tokens/s "
              f"{tok_s:.1f} against phase 5's {phase5_tok_s:.1f} in this "
              f"call ({100 * (tok_s / phase5_tok_s - 1):+.1f}%)")
        if not same:
            raise AssertionError(f"{label}: losses {losses} against phase "
                                 f"5's {phase5_losses}")
        del step, model, opt, tokens
        hvd.shutdown()
    return launches


def _perturbed(torch, model, rel=1e-6, seed=9):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(1 + rel * torch.randn(p.shape, generator=gen).to(p.device))


def phase_sync_bn(hvd, torch, bench, run_7a):
    """11c: 7a's ResNet-101 with synchronized BatchNorm at world 1."""
    import gc
    from horovod_tpu_torch.models.resnet import SYNC_BN_RANGE
    print("== phase 11c: ResNet-101 as 7a with bn_cross_replica_axes="
          "('data',) (synchronized BatchNorm, flax's statistics)")
    hvd.init()
    step, model, opt, batch = bench.make_resnet_bench(**RESNET)
    _perturbed(torch, model)
    pert, _, _ = _drive_images("11c 7a perturbed by 1e-6", torch, bench,
                               step, batch, STEPS, run_7a["flops"],
                               lambda: "per-rank BatchNorm")
    del step, model, opt, batch
    gc.collect()
    torch.cuda.empty_cache()
    step, model, opt, batch = bench.make_resnet_bench(
        **RESNET, bn_cross_replica_axes=("data",))
    losses, step_ms, layers = _drive_images(
        "11c", torch, bench, step, batch, STEPS, run_7a["flops"],
        lambda: f"fused allreduce: {len(opt.last_buckets)} buckets",
        layers=RESNET_LAYERS, ranges={SYNC_BN_RANGE: "BatchNorm"})
    ref = run_7a["losses"]
    bn, bn_7a = layers["BatchNorm"], run_7a["layers"]["BatchNorm"]
    images = RESNET["batch"]
    print(f"  11c img/s {images / step_ms * 1e3:.1f} against 7a's "
          f"{images / run_7a['step_ms'] * 1e3:.1f} in this call; BatchNorm "
          f"device ms {bn:.2f} against 7a's {bn_7a:.2f} "
          f"({bn / bn_7a:.2f}x); collectives {layers[COLLECTIVES]:.2f} ms "
          f"against {run_7a['layers'][COLLECTIVES]:.2f}")
    diffs = [abs(a - b) for a, b in zip(losses, ref)]
    sens = [abs(p - b) for p, b in zip(pert, ref)]
    print(f"  11c losses against 7a's: {[f'{d:.3e}' for d in diffs]}; the "
          f"perturbed run against 7a's: {[f'{d:.3e}' for d in sens]}")
    # the bound: the run's own sensitivity, the largest spread rounding
    # opened between two runs of 7a over the steps, four times over
    for d, b in zip(diffs, ref):
        if not d <= 1e-5 * abs(b) + 4 * max(sens):
            raise AssertionError(f"11c losses {losses} against 7a's {ref} "
                                 f"(perturbed {pert})")
    del step, model, opt, batch
    hvd.shutdown()


def _launched_in(trace, ranges):
    """The correlation ids of the work launched on the host inside a
    profiler range named in ``ranges`` (``{range name: layer}``):
    ``{correlation: layer}``. A launch is inside a range when it falls in
    the range's interval on the same host thread."""
    events = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    spans = [(e["tid"], e["ts"], e["ts"] + e["dur"], ranges[e["name"]])
             for e in events if e.get("cat") == "user_annotation"
             and e.get("name") in ranges]
    out = {}
    for e in events:
        if e.get("cat") != "cuda_runtime":
            continue
        for tid, lo, hi, layer in spans:
            if e["tid"] == tid and lo <= e["ts"] <= hi:
                out[e.get("args", {}).get("correlation")] = layer
                break
    return out


def profile_step(torch, run, step_ms, layers=LAYERS, ranges=None):
    """Device time by layer and by kernel over one more ``run()``, read
    from the profiler's trace (kernels, copies and memsets only), and the
    device's idle share: 1 - the union of their intervals / the
    unprofiled median step time. The stream with the most device time is
    the step's; NCCL's collectives run on streams of their own (at world
    1 its reduce-scatters and all-gathers are copies), so work there is
    attributed to the collectives whatever its name. ``ranges`` (``{host
    profiler range: layer}``) attributes the step stream's work launched
    inside such a range to its layer, whatever its name. Returns the
    milliseconds by layer."""
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    # a range is a host event: tracing the host too, where one is asked
    activities = [ProfilerActivity.CUDA] + (
        [ProfilerActivity.CPU] if ranges else [])
    with profile(activities=activities) as prof:
        run()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "step.json"
        prof.export_chrome_trace(str(path))
        trace = json.loads(path.read_text())
    launched = _launched_in(trace, ranges or {})
    work = sorted(((e["ts"], e["dur"], e["name"],
                    e.get("args", {}).get("stream"),
                    launched.get(e.get("args", {}).get("correlation")))
                   for e in trace["traceEvents"]
                   if e.get("ph") == "X" and e.get("cat") in DEVICE_WORK),
                  key=lambda w: w[0])
    busy, end = 0.0, -math.inf  # microseconds, overlaps counted once
    for ts, dur, _, _, _ in work:
        busy += max(0.0, ts + dur - max(ts, end))
        end = max(end, ts + dur)
    busy /= 1e3
    if busy <= 0:
        raise AssertionError("the profiler recorded no device time")
    per_stream = {}
    for _, dur, _, stream, _ in work:
        per_stream[stream] = per_stream.get(stream, 0.0) + dur
    main_stream = max(per_stream, key=per_stream.get)
    by_name = {}
    for _, dur, name, stream, in_range in work:
        side = stream != main_stream
        key = (name, side, None if side else in_range)
        ms, n = by_name.get(key, (0.0, 0))
        by_name[key] = (ms + dur / 1e3, n + 1)
    total = sum(ms for ms, _ in by_name.values())
    print(f"  profiled step: {busy:.2f} ms of device work "
          f"({len(by_name)} kinds, {total:.2f} ms summed, "
          f"{len(per_stream)} streams) in a {step_ms:.2f} ms step: device "
          f"idle {100 * (1 - busy / step_ms):.1f}%")
    by_layer = dict.fromkeys([name for name, _ in layers] + ["other"], 0.0)
    for (name, side, in_range), (ms, _) in by_name.items():
        layer = COLLECTIVES if side else in_range or next(
            (layer for layer, pats in layers
             if any(p in name for p in pats)), "other")
        by_layer[layer] += ms
    for layer, ms in by_layer.items():
        print(f"    {ms:9.3f} ms {100 * ms / total:5.1f}%  {layer}")
    if ranges:
        print(f"    ({sum(1 for w in work if w[4])} kernels, copies and "
              f"memsets launched inside the ranges {sorted(ranges)})")
    top = sorted(by_name.items(), key=lambda item: -item[1][0])[:12]
    for (name, side, in_range), (ms, n) in top:
        print(f"    {ms:9.3f} ms {100 * ms / total:5.1f}%  x{n:<4} "
              f"{'[NCCL stream] ' if side else ''}"
              f"{'[' + in_range + '] ' if in_range else ''}{name[:90]}")
    return by_layer


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tune", action="store_true",
                    help="time the tile configurations, then stop")
    args = ap.parse_args(argv)
    if not (ROOT / "horovod_tpu_torch" / "__init__.py").is_file():
        print("chip_smoke: horovod_tpu_torch is not beside this script",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import _build
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.utils import benchmarks as bench

    torch.backends.cuda.matmul.allow_tf32 = False  # plain fp32 stays fp32
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    print("== phase 2: kernel build")
    t0 = time.perf_counter()
    lib = _build.build()
    print(f"  built in {time.perf_counter() - t0:.1f} s -> {lib}")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if any(w in line for w in ("entry function", "registers", "spill",
                                   "setmaxnreg", "wgmma", "arning")):
            print("  ptxas:", line.strip())
    dev = torch.device("cuda", 0)
    if args.tune:
        phase_tune(fa, torch, dev, bench, _build.load())
        return 0
    phase_kernels(fa, torch, dev)
    rows = phase_slice_shape(fa, torch, dev, bench)
    phase_quantizer(torch, dev)
    phase_parity(fa, torch, dev)
    phase_parity_exchange(hvd, fa, torch)
    phase_parity_resnet(hvd, torch)
    losses, launches, phase5_tok_s = phase_full(hvd, fa, torch, bench)
    phase_exchange_full(hvd, fa, torch, bench, losses)
    run_7a = phase_resnet(hvd, torch, bench)
    phase_resume(hvd, fa, torch, bench)
    phase_resume_resnet(hvd, torch, bench)
    phase_launch(hvd, torch, kind, phase5_tok_s)
    phase_ring(fa, torch, dev, bench)
    phase_seq_lm(hvd, fa, torch, bench, losses, phase5_tok_s)
    torch.cuda.empty_cache()
    phase_two_level_full(hvd, torch, bench)
    torch.cuda.empty_cache()
    launches_11b = phase_two_level_lm(hvd, fa, torch, bench, losses,
                                      phase5_tok_s)
    torch.cuda.empty_cache()
    phase_sync_bn(hvd, torch, bench, run_7a)

    kernels = []
    for kind_ in ("fwd", "dq", "dkv"):
        wrapper, replaces, source, design = KERNELS[kind_]
        kernels.append(dict(name=wrapper, route="cuda", source=source,
                            replaces=replaces, design=design,
                            launches=launches[kind_] + launches_11b[kind_],
                            **rows[kind_]))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
