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
  BatchNorm device ms beside 7a's from the profile;
* 12a: one full-width block (bf16, flash) over R = 2 and 4 model shards
  held in this process (``parallel.axis.LocalAxis``), forward and
  backward: each shard's output and input gradient against the
  unsharded block's, and its weight gradients against the matching
  slices of the unsharded ones, within R 2^-7 max|want| (the R bf16
  partial sums against one, ``_shard_bound``); R launches of each
  kernel; K1-K3 at each shard's attention shape, [B H/R, 2048, 64],
  against their plain versions; the shards' time against the block's;
* 12b: phase 5's LM, weights and batch through ``make_tp_lm_train_step``
  on a (1, 1) (data, model) mesh: one computation with phase 5's, so all
  five losses bit for bit phase 5's; tokens/s beside phase 5's;
* 12c: the MoE LM at phase 5's widths (``MOE``: every 2nd block a top-1
  MoE of 8 experts, capacity 2.0, 8 token groups) through
  ``make_tp_lm_train_step(model_axis=None, expert_axis="expert")`` on a
  (1, 1) (data, expert) mesh: losses finite and falling, the auxiliary
  terms finite; tokens/s, memory, the share of token choices dropped at
  capacity, and a profile split into the dispatch and combine einsums,
  the expert FFN, attention and the rest;
* 12d: one MoE layer at full width (T 16384 x d 768, 8 experts, 8
  groups) over 4 expert shards in this process, the tokens replicated
  over the axis and sharded over it: no token routed differently from
  the unsharded layer, outputs and the gradients of the gate, w_in,
  w_out and the input within ``_shard_bound``; times; with the tokens
  sharded, GShard's all-to-all form against the gather form: in bf16
  the outputs and expert gradients bit for bit, the gate's and input's
  gradients and the auxiliary terms within ``_shard_bound``, in fp32
  all within ``_fp32_order`` (M = R); both forms' times and the bytes
  each moves a shard, from the shapes;
* 13a: phase 5's LM, weights and batch as the embedding, its 12 blocks
  stacked over S stages held in this process (``parallel.pipeline``
  over a ``LocalAxis``) and the head, one step through GPipe, GPipe with
  remat and 1F1B at (S 2, M 4) and (S 4, M 8), against the unstaged
  forward and backward: the loss, every gradient within M 2^-7 max
  (``_pipe_bound``), GPipe against remat and 1F1B within fp32 summation
  order, K1-K3 launched M L times each (remat: K1 2 M L; 1F1B: K1
  M L (2S - 1) / S), the peak memory above the step's start (1F1B at most
  half of GPipe's at S 4), ms against the unstaged step, a profile of
  1F1B at S 4, and K1-K3 at a micro's attention shape against their
  plain versions;
* 13b: 1F1B at S 2, M 4 over 2 model shards of each stage (Megatron's
  blocks), every shard in this process, against 13a's S 2 1F1B within
  ``_shard_bound`` over the stack's 24 row-parallel sums;
* 14a: phase 5's LM at ``RESUME_LAYERS`` (6) of its 12 layers, weights
  and batch, over 2 model shards in this process (``make_tp_lm_train_step_shards``, AdamW): 4 steps unbroken
  against 2 steps, an ``AsyncCheckpointer`` save of the state gathered
  whole, a restore and 2 more steps; restored at R = 2 the losses and
  every leaf bit for bit, restored at R = 1 and R = 4 the next loss
  within ``_shard_bound``; K1-K3 once a layer, shard and step; the
  state's bytes, ``save()``'s blocking ms (of it the pinned buffers, the
  gathers and the device-to-host copy), the write and commit, the
  restores;
* 14b: 12c's MoE LM state, at 6 of its 12 layers, saved whole and
  restored with its experts cut 4 ways in this process, and saved cut
  and restored whole (on 4 of phase 5's 8 sequences): the next loss bit
  for bit the run it resumes where the cut is the same, within
  ``_shard_bound`` where it is not;
* 14c: phase 5's LM at 6 of its 12 layers through
  ``DistributedOptimizer(backward_passes_per_step=2)`` (optax's
  ``MultiStepsState``), saved
  after mini-step 1 (inside a window) and 2 (at its boundary): each
  resume repeats the unbroken run's losses and state bit for bit;
* 15a: phase 5's LM, weights and batch through the GSPMD step
  (``make_lm_train_step(spmd=True)``: DTensor placements on ``init()``'s
  ``("data",)`` mesh, the flash kernels as an island a layer): every
  loss within ``GSPMD_EPSILON`` of phase 5's (and whether bit for bit),
  tokens/s beside phase 5's, a profile (device work, idle share), the
  collectives it records (none at world 1);
* 15b: the same with ZeRO-1 (rows ``Shard(0)``) against 6a's losses, and
  the peak memory of both;
* 15c: the int8 chunked island against 15a and the bf16 cast wire with
  ZeRO-1 against 15b, within ``WIRE_EPSILON`` at every step; the
  island's ``hvd_grad_norm`` against an fp64 norm of the reduced
  gradient, rtol 1e-5;
* 15d: 15b's state saved (``convert``, ``ckpt.AsyncCheckpointer``) and
  restored into the explicit ZeRO-1 step, and an explicit ZeRO-1 state
  into the GSPMD step: each next loss bit for bit the step taken from
  the saved state itself;
* 16a: the telemetry and diagnosis planes on (``init()`` with a metrics
  server on an ephemeral loopback port and the flight recorder armed):
  the kernels rebuilt into a fresh directory (booked to the goodput
  ledger's ``compile``), phase 5's LM through ``make_lm_train_step(
  telemetry=True)`` and 6b's through ``make_train_step(telemetry=True)``:
  losses bit for bit phase 5's and 6b's, each kernel once per layer,
  microbatch and step, ``hvd_step_total`` and the collective and bucket
  counters of ``/metrics`` equal to the steps' schedules, ``/healthz``
  200, and after a final settle the ledger's unattributed time under 2 %
  of its wall; tokens/s beside phase 5's and the ledger's phases;
* 16b: ``step.xray(k=3)`` (``telemetry/xprof.py``) on phase 5's step and
  on 15a's GSPMD step: the named share of device time at least 0.95 and
  its busy time within 1 % of this script's own union of the capture's
  kernels, copies and memsets; each category's ms per step, the verdict,
  and ``matmul_conv`` beside ``profile_step``'s matmuls; then
  ``/profile?seconds=1&wait=1`` while steps run must return a summary;
* 16c: ``/flightrec?dump=1``, and the doctor over the dump after
  ``shutdown()``'s final one: healthy, naming the last step (the dumps
  are kept for 19c);
* 17a: elastic training: an ``ElasticDriver`` in this process over
  ``FixedHosts`` hostA and hostB (``min_np = max_np = 1``,
  ``Blacklist(threshold=2, base_delay=0)``, the port's
  ``KVStoreServer``) runs one ``examples/elastic_train.py`` worker on
  the card an epoch: phase 5's LM, weights and batch through
  ``make_lm_train_step`` under ``elastic_train_loop``, a
  ``TorchState`` committing every step to disk. hostA's worker SIGKILLs
  itself after 2 steps (their commit durable) in epochs 1 and 2; epoch 3
  restores on hostB and finishes the 5 steps. 3 epochs, hostA
  blacklisted, each step computed once with phase 5's loss bit for bit,
  K1-K3 once a layer and step of each worker; each recovery's seconds
  from the death to the next first loss (the rendezvous, spawn, imports,
  ``init()`` on NCCL, kernel library load, build, restore, sync, first
  step), the commits' blocking ms and the restores' ms;
* 17b: graceful eviction: the same worker under a seeded ``ChaosMonkey``
  (``kinds=sigterm,count=1``) armed at its first committed step: the
  SIGTERM's eviction force-commits inside its grace, announces hostA and
  exits ``EXIT_RENDEZVOUS``; the driver drains hostA without blame and
  epoch 2 resumes on hostB: no blame, every logged loss phase 5's bit for
  bit; the force-commit's ms against the grace, the recovery's seconds;
* 18a: serving (``horovod_tpu_torch/serve``): phase 5's LM trained its 5
  steps, saved as a sharded ``TrainState`` and loaded params-only
  through ``serve.loader.load_params`` (bit for bit the trained model),
  served by a ``ServeEngine`` on the card (paged KV pool of 1025 blocks
  of 16 tokens, 8 slots, 2048 tokens a sequence, prefill chunk 256):
  16 seeded requests of 128-1536 prompt tokens and 64 new tokens, a
  pair sharing a 512-token prefix (the first prefilled alone, then the
  second: a prefix-cache hit, then an exact resubmission of the first:
  a copy-on-write fork, then the other 14), 2 sampled at temperature
  0.8, top-p 0.9; driven by ``step()``: TTFT and inter-token p50/p99, decode and
  prefill tokens/s, the cached-prefill fraction, ``time_breakdown``
  within 2 % of the wall, peak memory, no flash kernel launched (the
  serving path attends densely); every greedy token the argmax of the
  teacher-forced oracle (the ordinary forward over prompt + generated)
  or within one bf16 step of its top logit; each seeded stream bit for
  bit alone as in the batch; a decode step with every slot busy, timed
  and profiled (device work, idle share);
* 18b: the 16 requests through a ``FleetRouter`` over two engines on
  the card, half the pool each; one replica evicted mid-stream: nothing
  dropped, at least one re-dispatch, every stream equal to 18a's; the
  seconds the cut streams lost;
* 18c: request 4 through ``ServeServer``'s ``/generate`` on 18a's
  engine: the streamed tokens the engine's; ``/metrics``' serve counts
  equal to what was served;
* 19a: ``utils.benchmarks.slope_window`` (iters 4, 3 rounds) over phase
  5's LM step: the slope's time a step beside phase 5's median from the
  host clock (an upper bound fails), the launches once a layer and step;
  K1 at the main shape through the slope window beside 3b's CUDA-event
  time (reported);
* 19b: ``autotune_fusion_threshold`` over the step's gradients with the
  wires none, bf16 and int8 at world 1 on NCCL: ``(None, {})`` with the
  JAX package's reason, word for word, and the config as it was;
* 19c: in a subprocess, ``python -m horovod_tpu_torch.analysis.cli``
  over the port's tree (exit 0) and ``python -m
  horovod_tpu_torch.telemetry.trend`` over the repo's rounds (exit code
  and rows printed), neither importing ``jax`` nor ``horovod_tpu``; then
  the checkout's scripts, each in a process where ``jax`` and
  ``horovod_tpu`` cannot be imported: ``bin/hvd-lint-torch`` (the exit
  code and last line of the ``python -m`` run), ``bin/hvdrun-torch
  --check-build`` (exit 0, the native core listed) and
  ``bin/hvd-doctor-torch <16c's dumps> --json`` (16c's classification
  and last event);
* 20a: 6b's configuration built with ``DistributedOptimizer(axes=
  ("data",), sharded_update=True)`` on a (data 1, model 1) mesh (ZeRO-1
  over a part of the mesh), in turns with 6b on ``init()``'s mesh: every
  turn's losses bit for bit 6b's, K1-K3 once a layer, microbatch and
  step; its state saved and restored into a fresh model, optimizer and
  step gives the unbroken run's next loss bit for bit; step ms, tokens/s
  and peak memory of each turn;
* 20b: the serve engine over 2 gloo ranks sharing the card (this script
  with ``--serve-rank``, twice: NCCL puts no two ranks on one device),
  each holding 18a's LM loaded params-only from phase 18's manifest and
  a replicated pool, the 8 slots split 4 and 4: rank 0 drives 8 of 18a's
  requests (the shared prefix, the fork, one sampled), rank 1 follows;
  the ranks' streams, pools and block tables equal, every greedy token
  within 18a's oracle rule, the sampled stream bit for bit 18a's; decode
  tokens/s, inter-token p50/p99 and the exchange's share of the decode
  time beside 18a's (no speed claim: one card);
* 21a: the native host core (``horovod_tpu_torch/_core.py``) built from
  ``cxx/`` with ``g++`` (its seconds printed), ``--check-build`` with the
  core's controller and ring-collective boxes checked, and this
  process's mapped ``libhvdcore`` the port's build under ``_build/``;
* 21b: the classic torch API (``horovod_tpu_torch.torch``) on 2 ranks
  sharing the card (``python -m horovod_tpu_torch.run -np 2`` of this
  script with ``--native-rank``; the first collective after ``init()``
  starts the core, controller 127.0.0.1, port 0 through the launcher's
  store): host collectives on seeded arrays equal to numpy exactly
  (allreduce sum, average, min and max, allgather of unequal rows,
  broadcast, alltoall, reducescatter with a remainder, card tensors
  staged and in place, an uneven Join returning the last rank, a
  barrier) and Adasum within rtol 1e-4, atol 1e-5 of numpy's; then
  phase 5's LM at ``NATIVE["layers"]`` layers, ``NATIVE["batch"]``
  sequences a rank from the seed plus the rank: rank 1 perturbs its
  weights, ``broadcast_parameters`` and ``broadcast_optimizer_state``
  run, and ``DistributedOptimizer(AdamW)`` takes ``NATIVE["steps"]``
  steps, with rank 1's AdamW state drifted after the first and rank 0's
  brought back by ``broadcast_optimizer_state``; both
  ranks' parameters equal bit for bit, and equal a one-process run on the
  card that averages both ranks' gradients as ``(g0 + g1) / 2``; each
  step's time, the host exchange's share of it and the workers' start
  time printed (no claim); the ranks' K1-K3 launches join the kernels
  line;
* 22a: the port's example drivers in this process at world 1, each
  through its ``main(argv)``: ``examples/imagenet_resnet50`` at full
  width (``EXAMPLES``: ResNet-50, 224x224, 1000 classes, batch 64 over
  256 synthetic examples, the prefetch loader, the fused allreduce, SGD
  with momentum), one epoch, then a run to two epochs that resumes the
  first's checkpoint: finite losses, the disjoint-shard and resume
  lines; the second run's step times and img/s, its peak memory and each
  checkpoint's write ms;
* 22b: ``examples/synthetic_benchmark --model resnet50 --batch-size 64``
  (3 warm-up batches, 3 slope-window iterations of 10): img/s and MFU
  from hook-counted multiply-adds; then the driver's step read once
  more through ``utils.benchmarks.timed_throughput`` (one window of
  10): finite and positive, printed with its ``upper_bound`` flag;
* 22c: Horovod's classic ``pytorch_synthetic_benchmark`` and
  ``pytorch_mnist`` over ``horovod_tpu_torch.torch`` with their tensors
  on the card: img/s, and MNIST learning (the driver's own assert). No
  flash kernel runs in phase 22.

Phase 23 (the LM's training forward at explicit positions, which the
JAX package takes as arbitrary, so attention runs dense and no flash
kernel launches), at phase 5's full width, weights and batch, bf16 on
fp32 parameters, AdamW:

* 23a: one step with ``positions = arange(S)`` given, at phase 5's batch
  or the largest that fits the dense scores (``POSITIONS_BATCH``,
  printed): K1-K3 launch 0 times, the logits of its forward are within
  ``POSITIONS_LOGITS`` of max|want| of the plain reference's at the same
  positions, and the first loss is within ``POSITIONS_RTOL`` of phase
  5's first loss (each gap printed). The plain reference is the same
  model's forward with its dense attention swapped for the script's
  own, all in fp32, masked by the positions the script made (not those
  the model passes on);
* 23b: the logits at packed positions (two documents of S / 2, each
  from 0) within ``POSITIONS_LOGITS`` of the plain reference's at the
  packed positions, while the reference at ``arange`` lies at least
  ``POSITIONS_SEEN`` times that bound from it (a mask that ignored the
  packing would fail); then three steps at the packed positions: finite
  losses, and a repeat from the same start gives the same losses bit
  for bit;
* 23c: ``allgather(tiled=False)`` over NCCL at world 1: ``[1, ...]``, its
  input's values.

6b and 7b also time the bucket packing and unpacking with each leaf in
its flax layout beside torch's own layout.

Phases 4, 4b, 5, 6a, 6b, 6c, 8a, 10b, 11b, 12b, 12c, 14a-14c, 15, 19a
and 20a each
count the kernels' launches from 0 on the card and must launch each
kernel once per layer, shard, microbatch and step (13a and 13b as their
schedules say); 9a's and 17's workers count their own. The last line of output is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

and the line before it a JSON object with each kernel's launches on the
main paths (phase 5, 11b's two runs, 12b, 12c, phase 13's seven
runs, 14a, phase 15's and phase 16's runs, 19a's windows and 20a's
turns, each
counted from 0, and phase 17's and 21b's workers, each counting its own
from its first step),
error
against its plain version, time, plain time, bound and library time. After the timed steps of phases 5, 6b and 15a one
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
import io
import json
import math
import os
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# H100 SXM published dense peaks (NVIDIA data sheet, 700 W)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

# phase 23: the dense attention's saved scores and probabilities (fp32
# softmax output and its bf16 copy, heads x S^2 a sequence and layer);
# the batch is the largest power of 2 up to phase 5's whose estimate
# fits the free memory; its first loss within the port's bf16 tolerance
# of phase 5's flash one
POSITIONS_BATCH = None  # None: chosen as above
POSITIONS_RTOL = 2e-2
# the dense path's logits against the plain fp32 reference, normwise:
# every element within this share of max|want| (the port's bf16
# tolerance); and how many such bounds away from the packed reference the
# arange one must lie, so that the check can see a wrong mask
POSITIONS_LOGITS = 2e-2
POSITIONS_SEEN = 5

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
# phase 12: model shards of one block held in one process (12a), the MoE
# LM's settings (examples/jax_lm_moe.py's at the LM's full width: every
# 2nd block a top-1 MoE of 8 experts, capacity factor 2.0, 8 token
# groups), and the expert axis of 12d's layer
TP_RANKS = (2, 4)
MOE = dict(moe_every=2, num_experts=8, moe_top_k=1, moe_capacity_factor=2.0,
           moe_num_groups=8)
EXPERT_RANKS = 4
# phase 13: the (stages, micros) of 13a, each through GPipe, GPipe with
# remat and 1F1B, the steps timed after the checked one, and 13b's model
# shards of each stage
PIPE = ((2, 4), (4, 8))
PIPE_SCHEDULES = ("gpipe", "remat", "1f1b")
PIPE_TIMED = 3
PIPE_RANKS = 2
# phase 14: 14a's model shards, and 14b's sequences (its 4 expert shards
# in one process each hold the dense part and its activations)
TP_CKPT_RANKS = 2
EP_BATCH = 4
# 14a's, 14b's and 14c's depth (their widths kept): half the LM's 12
# layers, since their checkpoints' writes and reads held the script past
# 800 s
RESUME_LAYERS = 6
# phase 18: the serving plane on phase 5's LM: the KV pool (block 16,
# 2048 tokens a sequence = 128 blocks, 8 slots, 1025 blocks incl. the
# null block), the prefill chunk, and 18a's requests: prompts of
# prompt_lo..prompt_hi tokens, `new` tokens each, a pair sharing a
# `prefix`-token prefix, `sampled` of them at temperature / top_p
SERVE = dict(block=16, max_seq_len=2048, slots=8, blocks=1025, chunk=256,
             requests=16, new=64, prompt_lo=128, prompt_hi=1536, prefix=512,
             sampled=2, temperature=0.8, top_p=0.9)
# the greedy tokens' bound against the teacher-forced oracle: the top
# logit, or within one bf16 step of it (2^-7 of the row's largest
# |logit|): the decode path's matmuls and softmax run over other shapes
# than the full forward's, so bf16 rounding can part near-tied logits
SERVE_TIE = 2.0 ** -7
# phase 19: the slope window over phase 5's step (iters, rounds) and over
# K1 at the main shape; 19b's wire grid; the JAX package's reason for a
# world of 1 over the default axes, word for word (ops/fusion.py:639);
# 19c's lint targets (None: the port's default surface)
SLOPE = dict(iters=4, rounds=3)
K1_SLOPE_ITERS = 64
TUNE_WIRES = ["none", "bf16", "int8"]
WORLD_ONE_REASON = ("world size 1 over axes ('data',): the fused "
                    "collectives are local no-ops, so threshold timings "
                    "carry no signal")
LINT_TARGETS = None
# phase 21b: the classic torch API's run of phase 5's LM over 2 ranks on
# the card (depth cut, widths kept), and the bound on its parameters
# against the one-process average where they are not bit for bit
NATIVE = dict(layers=2, batch=2, steps=3)
NATIVE_RTOL = 1e-6
# phase 22: the example drivers at world 1 in this process: 22a the
# ImageNet trainer's ResNet-50 at full width over 256 synthetic examples
# (4 steps an epoch), 22b the synthetic benchmark's ResNet-50, 22c the
# classic torch drivers at their defaults
EXAMPLES = dict(depth=50, num_filters=64, image_size=224, num_classes=1000,
                batch=64, examples=256, synth_model="resnet50",
                synth_warmup=3, synth_iters=3, synth_per_iter=10)


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


def _smi(fields):
    """``nvidia-smi``'s reading of ``fields`` on the first card."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def card_line():
    return _smi("name,power.limit")


def clocks_line():
    """The card's SM clock, power draw and temperature now."""
    return _smi("clocks.sm,power.draw,temperature.gpu")


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
           exchange, profile=False, flops=None):
    """Run ``step(*batch)`` STEPS times with the kernels' launch counts
    set to 0 just before and read just after; print the step time,
    tokens/s, peak memory, the exchange and the launches; hold the
    losses (finite, falling) and the launches (``want`` of each kernel).
    ``flops`` is the model FLOPs of one rank's step (default phase 5's
    LM). Returns the losses, the launches and the median step ms."""
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
    flops = flops or _model_flops(LM)
    rate = flops / (step_ms / 1e3)  # this rank's FLOP/s
    print(f"  {label} model FLOPs {flops / 1e12:.2f} T per step "
          f"and rank: {rate / 1e12:.1f} TFLOP/s, "
          f"{100 * rate / PEAK_FLOPS['bfloat16']:.2f}% of the bf16 peak")
    print(f"  {label} peak device memory {peak / 2**30:.2f} GiB")
    print(f"  {label} {exchange()}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{label}: non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{label}: loss did not decrease: {losses}")
    _want_launches(fa, label, want)
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
    peak_6a = torch.cuda.max_memory_allocated()
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
        got, _, _ = _drive(label, hvd, fa, torch, bench, step, batch,
                           2 * layers * STEPS, LM["batch"] * seq,
                           lambda: (f"2 microbatches, overlapped "
                                    f"reduce-scatter, {what}; "
                                    f"{_schedule_line(step.schedule)}"),
                           profile=label == "6b")
        if label == "6b":
            losses_6b = got
            _layout_cost("6b", torch, bench, step.schedule, opt)
        del step, model, opt, tokens, batch
    hvd.shutdown()
    return losses, peak_6a, losses_6b


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
    """A device copy of every tensor of a flat train state (a model
    shard's cut leaves gathered whole; numpy counts as they are)."""
    from horovod_tpu_torch import ckpt
    return [t.gather() if isinstance(t, ckpt.GatheredLeaf)
            else t.detach().clone() if torch.is_tensor(t) else np.array(t)
            for t in _flat_tensors(leaves)]


def _leaf_bytes(torch, t):
    """The bytes of a state leaf (a gathered leaf's whole size)."""
    if torch.is_tensor(t):
        return t.numel() * t.element_size()
    if hasattr(t, "gather"):
        return math.prod(t.shape) * torch.empty(
            (), dtype=t.dtype).element_size()
    return np.asarray(t).nbytes


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
    tensor_bytes = sum(_leaf_bytes(torch, t) for t in _flat_tensors(leaves))
    print(f"  save of step {step_no}: state {tensor_bytes / 1e6:.1f} MB in "
          f"tensors, shard file {saver.last_bytes / 1e6:.1f} MB; save() "
          f"blocked {1e3 * blocking:.1f} ms (pinned buffers made "
          f"{1e3 * saver.last_pin_s:.1f} ms, gathers of cut leaves "
          f"{1e3 * saver.last_gather_s:.1f} ms, device-to-host copy "
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


def _shard_bound(label, got, want, ranks, sums=1):
    """Hold a sharded result to the unsharded one. The R shards' partial
    products (a row-parallel projection's, or the combine's over the
    experts) each round to bf16 once, and their sum rounds R - 1 more
    times, where the unsharded product rounds once: R more roundings, each
    up to a bf16 ulp (2^-7 relative) of a value that the tensor's largest
    element bounds. What follows a sum (the residual add, the norm, the
    MLP, the backward) carries these differences on at the same scale,
    and a difference of one ulp in a sum can flip the rounding of what
    adds to it. So every element must lie within R 2^-7 max|want| (a
    normwise bound: the error of a product is bounded by the size of its
    operands, not of its result). Through a stack of ``sums`` such sums
    (two a block: the attention output's and the MLP's) the residual
    stream carries each one's difference on, and independent roundings
    add as a random walk: sqrt(sums) R 2^-7 max|want|."""
    got, want = got.detach().float(), want.detach().float()
    bound = math.sqrt(sums) * ranks * 2.0 ** -7 * float(want.abs().max())
    err = _err(got, want)
    worst = err / bound if bound > 0 else math.inf * err
    ok = worst <= 1.0  # False on NaN too
    name = "R 2^-7" if sums == 1 else f"sqrt({sums}) R 2^-7"
    print(f"    {label:<40} max_abs_err {err:.3e}  at {worst:.3f} of "
          f"{name} max|want| = {bound:.3e}  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: max_abs_err {err} is {worst} times "
                             f"{name} max|want|, R = {ranks}")
    return worst


def phase_tp_block(fa, torch, dev, bench):
    """12a: one full-width block over R model shards held in this process
    (``LocalAxis``), forward and backward, against the unsharded block;
    K1-K3 at each shard's attention shape against their plain versions;
    the sharded block's time against the unsharded one's."""
    from horovod_tpu_torch import convert
    from horovod_tpu_torch.models.transformer import (Axes, Transformer,
                                                      TransformerConfig,
                                                      block_shards,
                                                      single_axes)
    from horovod_tpu_torch.parallel import axis as axis_lib
    from horovod_tpu_torch.parallel import ring, tensor
    b, h, s, d = LM["batch"], LM["heads"], LM["seq_len"], LM["d_model"]
    print(f"== phase 12a: one block at full width (d_model {d}, {h} heads, "
          f"d_ff {4 * d}, [{b}, {s}] bf16, flash) over R in {TP_RANKS} "
          "model shards in one process, against the unsharded block")
    # one layer and a small vocabulary: the block is what is held
    cfg = TransformerConfig(vocab_size=64, num_layers=1, num_heads=h,
                            d_model=d, d_ff=4 * d, dtype=torch.bfloat16,
                            flash_attention=True)
    gen = torch.Generator().manual_seed(12)
    x = _rand((b, s, d), torch.bfloat16, gen, dev)
    g = _rand((b, s, d), torch.bfloat16, gen, dev)
    positions = ring.default_positions(None, b, s, device=dev)

    def run(blocks, axes):
        xs = [x.clone().requires_grad_() for _ in blocks]
        outs = block_shards(blocks, xs, positions, axes,
                            contiguous_positions=True)
        torch.autograd.backward(outs, [g] * len(outs))
        return outs, xs

    def seeded(shard=None):
        return Transformer(cfg, generator=torch.Generator().manual_seed(12),
                           device=dev, shard=shard)

    whole = seeded()
    blk = whole.blocks[0]
    fa.reset_launches()
    (want,), (x_want,) = run([blk], single_axes())
    # the unsharded gradients in flax layout (zeros where the block's
    # forward does not reach: the embedding, the head, the final norm)
    full_grads = convert.flax_from_params(
        {n: torch.zeros_like(p) if p.grad is None else p.grad
         for n, p in whole.named_parameters()}, whole)
    base_ms = bench.cuda_time_ms(lambda: run([blk], single_axes()), iters=3)
    specs = tensor.transformer_param_specs(whole, "model")
    rows = {}
    for ranks in TP_RANKS:
        print(f"  R = {ranks}: {h // ranks} heads and d_ff {4 * d // ranks} "
              "a shard")
        models = [seeded(tensor.Shard("model", i, ranks))
                  for i in range(ranks)]
        blocks = [m.blocks[0] for m in models]
        one = axis_lib.single_axis(ranks)
        axes = Axes(axis_lib.LocalAxis(ranks), one, one)
        fa.reset_launches()
        outs, xs = run(blocks, axes)
        _want_launches(fa, f"R={ranks} forward + backward", ranks)
        worst = 0.0
        for i, (m, out, xg) in enumerate(zip(models, outs, xs)):
            worst = max(worst, _shard_bound(f"shard {i} output", out, want,
                                            ranks),
                        _shard_bound(f"shard {i} input gradient", xg.grad,
                                     x_want.grad, ranks))
            block = convert.params_from_flax(convert.shard_flax(
                full_grads, specs, {"model": (i, ranks)}), m)
            for name, p in m.blocks[0].named_parameters():
                worst = max(worst, _shard_bound(
                    f"shard {i} grad {name}", p.grad,
                    block[f"blocks.0.{name}"].to(dev), ranks))
        del outs, xs
        ms = bench.cuda_time_ms(lambda: run(blocks, axes), iters=3)
        rows[ranks] = dict(ms=ms, worst=worst)
        print(f"  R={ranks} worst element at {worst:.3f} of its bound; "
              f"forward + backward of the {ranks} shards {ms:.3f} ms against "
              f"the unsharded block's {base_ms:.3f} ms ({ms / base_ms:.2f}x)")
        print(f"  R={ranks}: K1-K3 at a shard's attention shape against "
              "their plain versions")
        _hold_at_shape(fa, torch, dev, b * h // ranks, s, d // h)
        del models, blocks
        torch.cuda.empty_cache()
    return rows


def phase_tp_lm(hvd, fa, torch, bench, phase5_losses, phase5_tok_s):
    """12b: phase 5's LM, weights and batch through
    ``make_tp_lm_train_step`` on a (1, 1) (data, model) mesh: every axis
    of one rank, so the step is phase 5's op for op (the operators are
    identities, the loss ``softmax_cross_entropy``, AdamW the
    ``DistributedOptimizer``'s inner one) and all five losses must equal
    phase 5's bit for bit. Returns the kernels' launches."""
    from horovod_tpu_torch.parallel.mesh import build_mesh
    print("== phase 12b: full-width LM through make_tp_lm_train_step on a "
          "(1, 1) data x model mesh")
    hvd.init()
    mesh = build_mesh((1, 1), ("data", "model"))
    step, model, opt, tokens = _lm_bench(bench, torch, seq_len=LM["seq_len"],
                                         mesh=mesh, model_axis="model")
    assert model.shard.model_axis == "model"
    losses, launches, step_ms = _drive(
        "12b", hvd, fa, torch, bench, step, (tokens,),
        LM["layers"] * STEPS, LM["batch"] * LM["seq_len"],
        lambda: "plain AdamW, no gradient exchange at data 1")
    tok_s = LM["batch"] * LM["seq_len"] / step_ms * 1e3
    same = losses == phase5_losses
    print(f"  12b losses against phase 5's: "
          f"{'bit for bit' if same else 'DIFFER'}; tokens/s {tok_s:.1f} "
          f"against phase 5's {phase5_tok_s:.1f} in this call "
          f"({100 * (tok_s / phase5_tok_s - 1):+.1f}%)")
    if not same:
        raise AssertionError(f"12b losses {losses} against phase 5's "
                             f"{phase5_losses}")
    del step, model, opt, tokens
    hvd.shutdown()
    return launches


def phase_moe_lm(hvd, fa, torch, bench, phase5_tok_s):
    """12c: the MoE LM at phase 5's widths (``MOE``) through
    ``make_tp_lm_train_step(model_axis=None, expert_axis="expert")`` on a
    (1, 1) (data, expert) mesh: falling losses, finite auxiliary terms,
    each kernel once a layer and step; tokens/s, memory, the share of
    dropped token choices and the step's device work split four ways.
    Returns the kernels' launches."""
    from horovod_tpu_torch.models import moe as moe_lib
    from horovod_tpu_torch.parallel.mesh import build_mesh
    print(f"== phase 12c: MoE LM at full width ({MOE}) through "
          "make_tp_lm_train_step(model_axis=None, expert_axis='expert') on "
          "a (1, 1) data x expert mesh")
    hvd.init()
    mesh = build_mesh((1, 1), ("data", "expert"))
    t0 = time.perf_counter()
    step, model, opt, tokens = _lm_bench(bench, torch, seq_len=LM["seq_len"],
                                         mesh=mesh, expert_axis="expert",
                                         **MOE)
    bench.sync()
    moes = [blk.moe for blk in model.blocks if blk.use_moe]
    nparams = sum(p.numel() for p in model.parameters())
    ntok = LM["batch"] * LM["seq_len"]
    print(f"  model: {nparams / 1e6:.2f} M params, {len(moes)} MoE blocks, "
          f"built in {time.perf_counter() - t0:.2f} s")
    # model FLOPs: a top-1 token runs one expert, the dense MLP's size,
    # plus the gate; the capacity's empty slots and the dispatch are not
    # useful work
    flops = _model_flops(LM) + 6 * len(moes) * LM["d_model"] * \
        MOE["num_experts"] * ntok

    def exchange():
        terms = [(m.sown["load_balance"].item(), m.sown["router_z"].item(),
                  m.dropped.item()) for m in moes]
        if not all(math.isfinite(v) for row in terms for v in row):
            raise AssertionError(f"12c: non-finite auxiliary terms {terms}")
        return ("MoE blocks (load_balance, router_z, dropped share): "
                + ", ".join(f"({a:.4f}, {z:.3f}, {100 * dr:.2f}%)"
                            for a, z, dr in terms))

    dropped = []  # each step's shares, read after the timed steps

    def counted(toks):
        loss = step(toks)
        dropped.append(torch.stack([m.dropped for m in moes]))
        return loss

    losses, launches, step_ms = _drive(
        "12c", hvd, fa, torch, bench, counted, (tokens,),
        LM["layers"] * STEPS, ntok, exchange, flops=flops)
    print(f"  12c tokens/s {ntok / step_ms * 1e3:.1f} against phase 5's "
          f"{phase5_tok_s:.1f} in this call; token choices dropped at "
          f"capacity, mean over the MoE blocks, by step: "
          f"{[round(100 * float(d.mean()), 2) for d in dropped]}%")
    layers = (("MoE dispatch and combine einsums", ()),
              ("MoE expert FFN", ()),
              ("attention kernels", ("flash_",)),
              (COLLECTIVES, ("nccl",)))
    profile_step(torch, lambda: step(tokens), step_ms, layers=layers,
                 ranges={moe_lib.DISPATCH_RANGE: layers[0][0],
                         moe_lib.EXPERTS_RANGE: layers[1][0]})
    del step, model, opt, tokens, moes
    hvd.shutdown()
    return launches


def phase_moe_layer(torch, dev, bench):
    """12d: one full-width MoE layer (T = B S tokens, ``MOE``'s experts
    and groups) over an expert axis of ``EXPERT_RANKS`` held in this
    process, the tokens replicated over it (the train step's layout) and
    sharded over it (the JAX layer tests'), forward and backward against
    the unsharded layer: routing, output and gradients."""
    from horovod_tpu_torch.models import moe as moe_lib
    from horovod_tpu_torch.parallel import axis as axis_lib
    T, d = LM["batch"] * LM["seq_len"], LM["d_model"]
    E, G, n = MOE["num_experts"], MOE["moe_num_groups"], EXPERT_RANKS
    print(f"== phase 12d: one MoE layer at full width (T {T} x d {d}, E {E}, "
          f"G {G}, top-1, bf16) over an expert axis of {n} in one process")
    kw = dict(num_experts=E, d_model=d, d_ff=4 * d, num_groups=G,
              capacity_factor=MOE["moe_capacity_factor"],
              dtype=torch.bfloat16, device=dev)

    def layer(shard=(0, 1)):
        return moe_lib.MoE(**kw, expert_shard=shard,
                           generator=torch.Generator().manual_seed(13))

    gen = torch.Generator().manual_seed(13)
    x = _rand((T, d), torch.bfloat16, gen, dev)
    g = _rand((T, d), torch.bfloat16, gen, dev)
    whole, shards = layer(), [layer((i, n)) for i in range(n)]
    # routing: every shard routes the same replicated tokens
    choice = moe_lib._route(whole, x, G)[2].argmax(-1)
    differ = sum(int((moe_lib._route(m, x, G)[2].argmax(-1) != choice).sum())
                 for m in shards)
    print(f"  tokens whose first choice differs from the unsharded layer's, "
          f"over the {n} shards: {differ}")
    if differ:
        raise AssertionError(f"12d: {differ} tokens route differently")

    def run(mods, axis, sharded):
        k = len(mods) if sharded else 1
        xs = [c.clone().requires_grad_() for c in x.chunk(k)] if sharded \
            else [x.clone().requires_grad_() for _ in mods]
        gs = list(g.chunk(k)) if sharded else [g] * len(mods)
        outs = moe_lib.moe_shards(mods, xs, axis,
                                  axis_lib.single_axis(len(mods)),
                                  tokens_sharded=sharded)
        torch.autograd.backward(
            [(o.float() * gg.float()).sum() + moe_lib.aux_loss(m)
             for o, gg, m in zip(outs, gs, mods)])
        return outs, xs

    (want,), (x_want,) = run([whole], axis_lib.single_axis(), False)
    want_grads = {name: p.grad.clone() for name, p in whole.named_parameters()}
    base_ms = bench.cuda_time_ms(
        lambda: run([whole], axis_lib.single_axis(), False), iters=3)
    for sharded in (False, True):
        tag = "tokens sharded" if sharded else "tokens replicated"
        for m in shards:
            m.zero_grad(set_to_none=True)
        outs, xs = run(shards, axis_lib.LocalAxis(n), sharded)
        print(f"  {tag} over the expert axis:")
        if sharded:
            _shard_bound("output", torch.cat(outs), want, n)
            _shard_bound("input gradient", torch.cat([v.grad for v in xs]),
                         x_want.grad, n)
        else:
            for i, (out, v) in enumerate(zip(outs, xs)):
                _shard_bound(f"shard {i} output", out, want, n)
                _shard_bound(f"shard {i} input gradient", v.grad,
                             x_want.grad, n)
        for i, m in enumerate(shards):
            _shard_bound(f"shard {i} grad gate", m.gate.grad,
                         want_grads["gate"], n)
        for name in ("w_in", "w_out"):
            _shard_bound(f"grad {name}", torch.cat(
                [m.get_parameter(name).grad for m in shards]),
                want_grads[name], n)
        del outs, xs
        ms = bench.cuda_time_ms(
            lambda: run(shards, axis_lib.LocalAxis(n), sharded), iters=3)
        print(f"  {tag}: forward + backward of the {n} shards {ms:.3f} ms "
              f"against the unsharded layer's {base_ms:.3f} ms "
              f"({ms / base_ms:.2f}x); dropped share "
              f"{100 * whole.dropped.item():.2f}%")
    del whole, shards
    torch.cuda.empty_cache()
    _moe_token_forms(torch, dev, bench, kw, x, g)


def _moe_token_forms(torch, dev, bench, kw, x, g):
    """12d, the tokens sharded over the expert axis: GShard's all-to-all
    form (``moe.tokens_all_to_all``, each shard routing its own G/R
    groups) against the gather form (``moe.tokens_gathered``), forward
    and backward on the same layer shards. Both dispatch each slot one
    token and feed the experts the same ``[G, E/R, C, d]``, so at top-1
    the outputs and the gradients of w_in and w_out are bit for bit in
    bf16 (the layer's dtype). The gate's gradient (R shards' partial sums
    over their tokens against one sum over all of them), the input's and
    the auxiliary terms (local means summed over the axis) change their
    summation order: in bf16, where each shard's partial gate gradient
    rounds to bf16, within ``_shard_bound``; in fp32 within
    ``_fp32_order`` (M = R), and there the outputs and expert gradients
    too (the gate's matmul takes another shape). Times of both forms in
    bf16, and the bytes each moves a shard, from the shapes."""
    from horovod_tpu_torch.models import moe as moe_lib
    from horovod_tpu_torch.parallel import axis as axis_lib
    T, d = x.shape
    E, G, n = kw["num_experts"], kw["num_groups"], EXPERT_RANKS
    t = T // G
    C = moe_lib.capacity(t, E, kw["capacity_factor"])
    print(f"  12d tokens sharded: the all-to-all form against the gather "
          f"form over {n} expert shards (G {G}, C {C})")

    def shards(dtype):
        return [moe_lib.MoE(**dict(kw, dtype=dtype), expert_shard=(i, n),
                            generator=torch.Generator().manual_seed(13))
                for i in range(n)]

    def run(form, mods):
        for m in mods:
            m.zero_grad(set_to_none=True)
        xs = [c.to(mods[0].dtype).clone().requires_grad_()
              for c in x.chunk(n)]
        outs = form(mods, xs, axis_lib.LocalAxis(n))
        torch.autograd.backward(
            [(o.float() * gg.float()).sum() + moe_lib.aux_loss(m)
             for o, gg, m in zip(outs, g.chunk(n), mods)])
        return mods, xs, outs

    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        (am, ax, ao), (bm, bx, bo) = (
            run(moe_lib.tokens_all_to_all, shards(dtype)),
            run(moe_lib.tokens_gathered, shards(dtype)))
        same = {"output": torch.equal(torch.cat(ao), torch.cat(bo))}
        for w in ("w_in", "w_out"):
            same[f"grad {w}"] = all(torch.equal(a.get_parameter(w).grad,
                                                b.get_parameter(w).grad)
                                    for a, b in zip(am, bm))
        print(f"    {name}: bit for bit: {same}")
        if dtype == torch.bfloat16 and not all(same.values()):
            raise AssertionError(f"12d {name}: the forms differ: {same}")

        def held(label, pairs):
            """The worst of the shards' ``(got, want)`` pairs."""
            got = torch.stack([a.float().reshape(-1) for a, _ in pairs])
            want = torch.stack([b.float().reshape(-1) for _, b in pairs])
            if dtype == torch.float32:
                worst = _fp32_order(label, got, want, n)
                print(f"    {name} {label:<28} at {worst:.3f} of 2 R^2 "
                      "2^-24 max|want|")
            else:
                _shard_bound(f"{name} {label}", got, want, n)

        if dtype == torch.float32:
            # the gate's fp32 matmul over G/R groups a shard against G in
            # one call: cuBLAS picks its kernel by shape, so the logits,
            # and the combine weights after them, may part in their last
            # bits
            held("output", [(torch.cat(ao), torch.cat(bo))])
            for w in ("w_in", "w_out"):
                held(f"grad {w}", [(a.get_parameter(w).grad,
                                    b.get_parameter(w).grad)
                                   for a, b in zip(am, bm)])
        held("input gradient", [(torch.cat([v.grad for v in ax]),
                                 torch.cat([v.grad for v in bx]))])
        held("grad gate, every shard", [(a.gate.grad, b.gate.grad)
                                        for a, b in zip(am, bm)])
        for key in ("load_balance", "router_z"):
            held(f"{key}, every shard", [(a.sown[key], b.sown[key])
                                         for a, b in zip(am, bm)])
        del am, ax, ao, bm, bx, bo
        torch.cuda.empty_cache()
    item = torch.empty((), dtype=kw["dtype"]).element_size()
    a2a = 2 * (n - 1) / n * (G // n) * E * C * d * item
    gathered = 2 * (n - 1) / n * T * d * item
    print(f"  12d bytes a shard moves forward ({kw['dtype']}): all-to-all "
          f"form 2 x (R-1)/R x [G/R, E, C, d] = {a2a / 1e6:.2f} MB; gather "
          f"form (R-1)/R x T d gathered + as much reduce-scattered = "
          f"{gathered / 1e6:.2f} MB ({gathered / a2a:.2f}x)")
    mods = shards(torch.bfloat16)
    for label, form in (("all-to-all", moe_lib.tokens_all_to_all),
                        ("gather", moe_lib.tokens_gathered)):
        ms = bench.cuda_time_ms(lambda: run(form, mods), iters=3)
        print(f"  12d {label} form, bf16: forward + backward of the {n} "
              f"shards {ms:.3f} ms")


def _lm_full(torch, dev, shard=None, layers=None, **moe):
    """Phase 5's LM (12c's with ``MOE`` as ``moe``): its config, weights
    (seed 0, cut to ``shard``) and batch (seed 0, rank 0), without the
    optimizer; ``layers`` (None: ``LM``'s) cuts its depth."""
    from horovod_tpu_torch.models.transformer import (Transformer,
                                                      TransformerConfig)
    cfg = TransformerConfig(vocab_size=LM["vocab"],
                            num_layers=layers or LM["layers"],
                            num_heads=LM["heads"], d_model=LM["d_model"],
                            d_ff=4 * LM["d_model"], dtype=torch.bfloat16,
                            flash_attention=True, **moe)
    model = Transformer(cfg, generator=torch.Generator().manual_seed(0),
                        device=dev, shard=shard)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, LM["vocab"], size=(LM["batch"], LM["seq_len"])).astype(
            np.int64)).to(dev)
    return cfg, model, tokens


def _lm_adamw(torch, params):
    """Phase 5's AdamW (optax.adamw's defaults, decay 1e-4) over
    ``params``."""
    return torch.optim.AdamW(params, lr=3e-4, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


def _stacked_blocks(torch, model):
    """The model's blocks' parameters stacked ``{name: [L, ...]}``: fp32
    leaves of their own, the model's untouched."""
    from horovod_tpu_torch.parallel import pipeline
    with torch.no_grad():
        stacked = pipeline.stack_params([dict(b.named_parameters())
                                         for b in model.blocks])
    return {k: v.requires_grad_() for k, v in stacked.items()}


def _normwise(label, got, want, scale, name):
    """The worst element's error as a share of ``scale`` max|want|;
    raises above 1 (and on NaN)."""
    got, want = got.detach().float(), want.detach().float()
    bound = scale * float(want.abs().max())
    err = _err(got, want)
    worst = err / bound if bound > 0 else math.inf * err
    if not worst <= 1.0:
        raise AssertionError(f"{label}: max_abs_err {err} is {worst} times "
                             f"{name} max|want|")
    return worst


def _pipe_bound(label, got, want, micros):
    """Hold a microbatched gradient to the unstaged one. The GEMMs of a
    microbatch take other shapes (cuBLAS may sum their K dims in another
    order, so an activation can round to the next bf16 step), and each
    micro's weight gradient rounds to bf16 once before the fp32 sum over
    the micros, where the unstaged product rounds once: M more roundings,
    each up to a bf16 ulp (2^-7 relative) of a value the leaf's largest
    element bounds, carried on at that scale through the layers
    (``_shard_bound``'s argument with M micros for R shards). So every
    element within M 2^-7 max|want|, a normwise bound."""
    return _normwise(label, got, want, micros * 2.0 ** -7, "M 2^-7")


def _fp32_order(label, got, want, micros):
    """Two sums of the same M fp32 terms in other orders part by at most
    2 (M - 1) 2^-24 sum_m |term_m|; with the terms of a leaf bounded by
    M max|want| in sum (each micro's gradient about 1/M of the whole),
    every element within 2 M^2 2^-24 max|want|."""
    return _normwise(label, got, want, 2 * micros ** 2 * 2.0 ** -24,
                     "2 M^2 2^-24")


def _pipe_launches(schedule, stages, micros, layers):
    """K1-K3 launches of one step: each micro through each layer once
    forward (K1) and once backward (K2, K3); remat recomputes every
    layer's forward in backward, 1F1B every stage's but the last's."""
    n = micros * layers
    fwd = {"gpipe": n, "remat": 2 * n,
           "1f1b": n * (2 * stages - 1) // stages}[schedule]
    return {"fwd": fwd, "dq": n, "dkv": n}


def _pipeline_step(torch, schedule, cfg, model, tokens, stacked, stage,
                   micros, block_fn):
    """One step of the LM through ``schedule`` over ``stage``: the
    embedding, the stacked blocks (``stacked``: each shard's whole
    stack), the final norm, the head and the mean next-token loss, each
    micro's mean over M (for 1F1B inside ``per_micro_loss`` on the last
    stage, for GPipe after it). Returns the loss, the blocks' gradients
    (each shard's, ``{name: [L / S, ...]}``) and the embedding's."""
    import torch.nn.functional as F
    from horovod_tpu_torch import training
    from horovod_tpu_torch.parallel import pipeline

    def own(dicts):  # each shard's block of the layers
        return [pipeline.split_stages(d, stage)[p]
                for p, d in enumerate(dicts)]

    model.zero_grad(set_to_none=True)
    embed = model.embed.weight
    h = F.embedding(tokens, embed).to(cfg.dtype)
    mb = tokens.shape[0] // micros

    def head(y, m):
        toks = tokens[m * mb:(m + 1) * mb]
        logits = F.linear(model.norm(y), model.lm_head.weight.to(cfg.dtype))
        return training.softmax_cross_entropy(logits.float()[:, :-1],
                                              toks[:, 1:]) / micros

    if schedule == "1f1b":
        losses, grads, dh = pipeline.pipeline_train_1f1b(
            block_fn, own(stacked), [h.detach()] * len(stacked),
            lambda ys, m: [head(y, m) for y in ys], stage=stage,
            n_micro=micros, with_input_grad=True)
        h.backward(dh[0])
        return losses[0], grads, embed.grad
    for st in stacked:
        for v in st.values():
            v.grad = None
    outs = pipeline.pipelined_forward(block_fn, own(stacked),
                                      [h] * len(stacked), stage=stage,
                                      n_micro=micros,
                                      remat=schedule == "remat")
    # the head and loss a micro at a time, as 1F1B's per_micro_loss
    # runs them: the same function at the same shapes
    loss = sum(head(y, m) for m, y in enumerate(outs[-1].chunk(micros)))
    loss.backward()
    return loss.detach(), own([{k: v.grad for k, v in st.items()}
                               for st in stacked]), embed.grad


def _stage_grads(torch, grads, stages):
    """Each stage's block gradients (the first shard of each) stacked
    back into ``{name: [L, ...]}``."""
    return {k: torch.cat([grads[p][k] for p in stages]) for k in grads[0]}


def phase_pipeline(fa, torch, dev):
    """13a: phase 5's LM split into the embedding, its 12 blocks stacked
    over S stages held in this process (``LocalAxis``) and the head,
    trained one step through GPipe, GPipe with remat and 1F1B at each
    (S, M) of ``PIPE``, against the unstaged step on the same weights and
    batch: loss and gradients, peak memory, ms, launches, and K1-K3 at a
    micro's attention shape. Returns the launches and 1F1B's S 2 run."""
    from horovod_tpu_torch import training
    from horovod_tpu_torch.models.transformer import (single_axes,
                                                      stage_block_fn)
    from horovod_tpu_torch.parallel import axis as axis_lib
    L, B, S_len = LM["layers"], LM["batch"], LM["seq_len"]
    print(f"== phase 13a: full-width LM ({L} layers, d_model "
          f"{LM['d_model']}, [{B}, {S_len}] bf16, flash) through GPipe, "
          f"GPipe with remat and 1F1B over (stages, micros) in {PIPE}, "
          "every stage in one process, against the unstaged step")
    cfg, model, tokens = _lm_full(torch, dev)

    def unstaged():
        model.zero_grad(set_to_none=True)
        loss = training.softmax_cross_entropy(model(tokens)[:, :-1],
                                              tokens[:, 1:])
        loss.backward()
        return loss.detach()

    def measured(run):
        """``run()`` with the launches counted from 0 and the peak memory
        above what was held before."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        fa.reset_launches()
        out = run()
        torch.cuda.synchronize()
        return (out, dict(fa.LAUNCHES),
                (torch.cuda.max_memory_allocated() - held) / 2 ** 30)

    def step_ms(run):
        times = []
        for _ in range(PIPE_TIMED):
            t = time.perf_counter()
            run()
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t))
        return float(np.median(times))

    loss_u, launches_u, mem_u = measured(unstaged)
    want = {k: torch.stack([dict(b.named_parameters())[k].grad
                            for b in model.blocks])
            for k, _ in model.blocks[0].named_parameters()}
    want_embed = model.embed.weight.grad.clone()
    ms_u = step_ms(unstaged)
    model.zero_grad(set_to_none=True)
    print(f"  unstaged: loss {loss_u.item()!r}, {ms_u:.2f} ms a step "
          f"(forward + backward, median of {PIPE_TIMED}), peak "
          f"{mem_u:.2f} GiB above the held memory, launches {launches_u}")
    stacked = _stacked_blocks(torch, model)
    block_fn = stage_block_fn([model.blocks[0]], single_axes())
    rows, launches, keep = {}, [], None
    for S, M in PIPE:
        stage = axis_lib.LocalAxis(S)
        b = B // M
        print(f"  S {S}, M {M} ({b} sequence{'s' if b > 1 else ''} a "
              f"micro, {L // S} layers a stage); each gradient leaf within "
              f"M 2^-7 max|unstaged| (`_pipe_bound`):")
        got = {}
        for schedule in PIPE_SCHEDULES:
            def run():
                return _pipeline_step(torch, schedule, cfg, model, tokens,
                                      [stacked] * S, stage, M, block_fn)
            (loss, grads, g_embed), n, mem = measured(run)
            expect = _pipe_launches(schedule, S, M, L)
            if n != expect:
                raise AssertionError(f"13a {schedule} S {S} M {M}: launches "
                                     f"{n}, want {expect}")
            launches.append(n)
            grads = _stage_grads(torch, grads, list(range(S)))
            rel = abs(loss.item() - loss_u.item()) / abs(loss_u.item())
            if not rel <= 1e-3:
                raise AssertionError(f"13a {schedule} S {S} M {M}: loss "
                                     f"{loss.item()} against {loss_u.item()}")
            worst, name = max((_pipe_bound(f"13a {schedule} {k}", grads[k],
                                           want[k], M), k) for k in want)
            worst_e = _pipe_bound(f"13a {schedule} embedding", g_embed,
                                  want_embed, M)
            ms = step_ms(run)
            if (S, M, schedule) == (*PIPE[-1], "1f1b"):
                profile_step(torch, run, ms)
            got[schedule] = (loss, grads, g_embed)
            rows[S, M, schedule] = dict(loss=loss.item(), ms=ms, mem=mem,
                                        worst=max(worst, worst_e))
            print(f"    {schedule:<6} loss {loss.item()!r} (rel "
                  f"{rel:.2e}); worst gradient element at {worst:.3f} of "
                  f"its bound ({name}), embedding {worst_e:.3f}; "
                  f"{ms:.2f} ms ({ms / ms_u:.2f}x the unstaged step); "
                  f"peak {mem:.2f} GiB ({mem / mem_u:.2f}x); launches {n}")
            del grads, g_embed
        for other in ("remat", "1f1b"):
            (la, ga, ea), (lb, gb, eb) = got["gpipe"], got[other]
            same = (la.item() == lb.item() and torch.equal(ea, eb) and
                    all(torch.equal(ga[k], gb[k]) for k in ga))
            worst = max([_fp32_order(f"13a gpipe vs {other} {k}", gb[k],
                                     ga[k], M) for k in ga] +
                        [_fp32_order(f"13a gpipe vs {other} embedding", eb,
                                     ea, M)])
            print(f"    gpipe against {other}: "
                  f"{'bit for bit' if same else 'differ'}; worst element "
                  f"at {worst:.3f} of 2 M^2 2^-24 max|gpipe|; losses "
                  f"{la.item()!r} and {lb.item()!r}")
        if S == 2:
            keep = got["1f1b"]
        del got
        mem_g, mem_1 = (rows[S, M, s]["mem"] for s in ("gpipe", "1f1b"))
        print(f"    1F1B holds {mem_1:.2f} GiB against GPipe's "
              f"{mem_g:.2f} GiB ({mem_1 / mem_g:.2f}x)")
        if S == 4 and not mem_1 <= 0.5 * mem_g:
            raise AssertionError(f"13a S 4: 1F1B's {mem_1} GiB is over half "
                                 f"GPipe's {mem_g} GiB")
        print(f"  K1-K3 at a micro's attention shape against their plain "
              "versions")
        _hold_at_shape(fa, torch, dev, b * LM["heads"], S_len,
                       LM["d_model"] // LM["heads"])
        torch.cuda.empty_cache()
    del stacked, model, want, want_embed
    torch.cuda.empty_cache()
    return launches, keep


def phase_pipeline_shards(fa, torch, dev, f1b_s2):
    """13b: 1F1B at S 2, M 4 over R = ``PIPE_RANKS`` model shards of each
    stage, every shard in this process (``local_axes((2, R), ("stage",
    "model"))``), the blocks Megatron's (``copy_to``/``reduce_from`` over
    the model axis), against 13a's S 2 1F1B run within ``_shard_bound``
    over the stack's 2 L row-parallel sums. Returns the launches."""
    from horovod_tpu_torch.models.transformer import Axes, stage_block_fn
    from horovod_tpu_torch.parallel import axis as axis_lib
    from horovod_tpu_torch.parallel import tensor
    S, M, R, L = 2, 4, PIPE_RANKS, LM["layers"]
    print(f"== phase 13b: 1F1B at S {S}, M {M} over {R} model shards of "
          "each stage, both axes in one process")
    models, stacked = [], []
    for m in range(R):
        cfg, model, tokens = _lm_full(torch, dev,
                                      tensor.Shard("model", m, R))
        models.append(model)
        stacked.append(_stacked_blocks(torch, model))
    axes = axis_lib.local_axes((S, R), ("stage", "model"))
    one = axis_lib.single_axis(R)
    block_fn = stage_block_fn([m.blocks[0] for m in models],
                              Axes(axis_lib.LocalAxis(R), one, one))
    # the unsharded head and loss on every model shard of the last stage
    whole = _lm_full(torch, dev)[1]
    t0 = time.perf_counter()
    fa.reset_launches()
    loss, grads, g_embed = _pipeline_step(
        torch, "1f1b", cfg, whole, tokens,
        [stacked[p % R] for p in range(S * R)], axes["stage"], M, block_fn)
    torch.cuda.synchronize()
    n = dict(fa.LAUNCHES)
    ms = 1e3 * (time.perf_counter() - t0)
    expect = {k: R * v for k, v in _pipe_launches("1f1b", S, M, L).items()}
    print(f"  launches {n} (R times 13a's S {S} 1F1B); one step {ms:.2f} ms "
          "with its first calls")
    if n != expect:
        raise AssertionError(f"13b: launches {n}, want {expect}")
    loss_a, grads_a, embed_a = f1b_s2
    # the stack's 2 L row-parallel sums, each R shards' partial products
    sums = 2 * L
    worst = _shard_bound("13b loss", loss, loss_a, R, sums)
    worst = max(worst, _shard_bound("13b embedding gradient", g_embed,
                                    embed_a, R, sums))
    for m in range(R):
        mine = _stage_grads(torch, grads, [s * R + m for s in range(S)])
        for k, g in mine.items():
            full = grads_a[k]
            dims = [i for i, (a, c) in enumerate(zip(full.shape, g.shape))
                    if a != c]
            want = full if not dims else full.narrow(
                dims[0], m * g.shape[dims[0]], g.shape[dims[0]])
            worst = max(worst, _shard_bound(f"13b shard {m} {k}", g, want,
                                            R, sums))
    print(f"  13b worst element at {worst:.3f} of sqrt({sums}) R 2^-7 "
          "max|13a|")
    del models, stacked, whole, grads
    torch.cuda.empty_cache()
    return [n]


def _tp_shards(torch, dev, ranks, moe=False, batch=None, layers=None):
    """Phase 5's LM (12c's MoE LM with ``moe``; ``layers`` deep, None:
    ``LM``'s), its seed-0 weights cut into ``ranks`` model shards (expert
    shards) held in this process, each with phase 5's AdamW, and their
    step over a ``LocalAxis`` (``make_tp_lm_train_step_shards``);
    ``step()`` runs one step on phase 5's batch (its first ``batch``
    sequences) and returns the loss. Returns ``(models, optimizers,
    step)``."""
    from horovod_tpu_torch.models.transformer import Axes
    from horovod_tpu_torch.parallel import axis as axis_lib
    from horovod_tpu_torch.parallel import tensor
    models = []
    for i in range(ranks):
        shard = (tensor.Shard(expert_axis="expert", expert_index=i,
                              expert_size=ranks) if moe
                 else tensor.Shard("model", i, ranks))
        _, model, tokens = _lm_full(torch, dev, shard, layers=layers,
                                    **(MOE if moe else {}))
        models.append(model)
    tokens = tokens[:batch]
    opts = [_lm_adamw(torch, m.parameters()) for m in models]
    one, local = axis_lib.single_axis(ranks), axis_lib.LocalAxis(ranks)
    inner = tensor.make_tp_lm_train_step_shards(
        models, opts, Axes(one, local, one) if moe else Axes(local, one, one))

    def step():
        return float(inner([tokens] * ranks)[0])

    step.state = inner.state
    return models, opts, step


def _gathered_save(torch, saver, step_no, leaves):
    """``_timed_save`` of a model-shard state, with the device's peak
    above the state during ``save()``: one leaf at a time is gathered
    whole (or, where its flax layout is a transposed view, made
    contiguous for the copy to the host) and freed once that copy is
    queued, so the peak holds one whole leaf, plus the shards'
    flax-layout copies of it where a gather needs them (at most one
    more): within twice the state's largest leaf."""
    largest = max(_leaf_bytes(torch, t) for t in _flat_tensors(leaves))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    _timed_save(torch, saver, step_no, leaves, None)
    above = torch.cuda.max_memory_allocated() - before
    print(f"  save's device peak above the state {above / 1e6:.1f} MB: "
          f"{above / largest:.2f} of its largest leaf, whole "
          f"({largest / 1e6:.1f} MB)")
    if not above <= 2 * largest:
        raise AssertionError(f"save's device peak {above} above the state, "
                             f"beyond twice its largest leaf {largest}")


def _resume_from(bench, root, step_no, build):
    """A fresh state from ``build()`` (``(model, optimizer, step)``,
    each a list of shards or not) restored from the newest checkpoint
    under ``root``, timed (``_timed_restore``)."""
    from horovod_tpu_torch import convert
    holder = {}

    def rebuild():
        holder["run"] = build()
        m, o, s = holder["run"]
        return (lambda: convert.train_state_to_flat(m, o, s.state),
                lambda flat: convert.train_state_from_flat(m, o, s.state,
                                                           flat))

    _timed_restore(bench, root, step_no, rebuild)
    return holder.pop("run")


def _free(torch):
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def _same(label, got, want):
    """Losses bit for bit."""
    print(f"  {label}: {[round(x, 6) for x in got]} against "
          f"{[round(x, 6) for x in want]}")
    if got != want:
        raise AssertionError(f"{label}: {got} differ from {want}")


def _loss_bound(torch, label, got, want, ranks):
    """A resumed run whose shard layout changed: its loss within
    ``_shard_bound`` of the unbroken run's."""
    print(f"  {label}: {got!r} against {want!r} (difference "
          f"{abs(got - want):.3e})")
    return _shard_bound(label, torch.tensor([got]), torch.tensor([want]),
                        ranks)


def phase_tp_resume(fa, torch, dev, bench):
    """14a: phase 5's LM (``RESUME_LAYERS`` deep), weights and batch, over
    ``TP_CKPT_RANKS`` model
    shards held in this process, each with AdamW: 4 steps unbroken
    against 2 steps, an ``AsyncCheckpointer`` save of the state (each cut
    leaf gathered whole: the JAX package's tensor-parallel checkpoint), a
    restore and 2 more steps. Restored at R = 2 the losses and every leaf
    equal the unbroken run's bit for bit; restored at R = 1 (the plain
    tensor-parallel step) and at R = 4 the next loss lies within
    ``_shard_bound`` of the unbroken run's. K1-K3 launch once a layer,
    shard and step. Returns the kernels' launches."""
    import tempfile
    from horovod_tpu_torch import ckpt, convert
    R, layers = TP_CKPT_RANKS, min(RESUME_LAYERS, LM["layers"])
    print(f"== phase 14a: the LM at full width and {layers} layers over R = "
          f"{R} model shards in one process (AdamW), 4 steps unbroken "
          "against 2 + save of the gathered state + restore at R = "
          f"{R}, 1, 4")

    def build(ranks):
        _free(torch)
        return _tp_shards(torch, dev, ranks, layers=layers)

    fa.reset_launches()  # count only this path's launches
    models, opts, step = build(R)
    unbroken = [step() for _ in range(4)]
    want = _state_copy(torch, convert.train_state_to_flat(models, opts,
                                                          step.state))
    del models, opts, step
    models, opts, step = build(R)
    _same("14a first 2 steps against the unbroken run's",
          [step() for _ in range(2)], unbroken[:2])
    worst = 0.0
    with tempfile.TemporaryDirectory() as root:
        saver = ckpt.AsyncCheckpointer(root, keep=1)
        _gathered_save(torch, saver, 2, convert.train_state_to_flat(
            models, opts, step.state))
        saver.close()
        del models, opts, step, saver
        for ranks in (R, 1, 4):
            models, opts, step = _resume_from(bench, root, 2,
                                              lambda: build(ranks))
            if step.state.step != 2:
                raise AssertionError(f"14a: restored step {step.state.step}")
            if ranks == R:
                _same(f"14a R={ranks} resumed steps 3, 4",
                      [step() for _ in range(2)], unbroken[2:])
                diff = _state_diff(torch, _state_copy(
                    torch, convert.train_state_to_flat(models, opts,
                                                       step.state)), want)
                print(f"  14a R={ranks} state after 4 steps against the "
                      f"unbroken run's: largest difference {diff}")
                if diff != 0:
                    raise AssertionError(f"14a: state differs by {diff}")
            else:
                worst = max(worst, _loss_bound(
                    torch, f"14a R={ranks} resumed step 3", step(),
                    unbroken[2], max(ranks, R)))
            del models, opts, step
    del want
    _free(torch)
    _want_launches(fa, "14a", layers * (4 * R + 2 * R + 2 * R + 1 + 4))
    print(f"  14a: worst resumed loss at {worst:.3f} of its bound")
    return dict(fa.LAUNCHES)


def phase_ep_resume(fa, torch, dev, bench):
    """14b: 12c's MoE LM state (``MOE``, ``RESUME_LAYERS`` deep) saved
    whole and restored with its experts cut ``EXPERT_RANKS`` ways in this
    process, and saved so (the expert weights and their moments
    gathered) and restored whole: the
    next step's loss bit for bit the run it resumes where the cut is the
    same, within ``_shard_bound`` where it is not. On the first
    ``EP_BATCH`` sequences of phase 5's batch: the 4 shards each hold the
    dense part and its activations."""
    import tempfile
    from horovod_tpu_torch import ckpt, convert
    R, layers = EXPERT_RANKS, min(RESUME_LAYERS, LM["layers"])
    print(f"== phase 14b: the MoE LM ({MOE}) at {layers} layers on "
          f"{EP_BATCH} x {LM['seq_len']} tokens: saved whole and restored "
          f"cut {R} ways, saved cut and restored whole")

    def build(ranks):
        _free(torch)
        return _tp_shards(torch, dev, ranks, moe=True, batch=EP_BATCH,
                          layers=layers)

    def resume(root, step_no, ranks):
        return _resume_from(bench, root, step_no, lambda: build(ranks))

    fa.reset_launches()
    models, opts, step = build(1)
    unbroken = [step() for _ in range(3)]
    del models, opts, step
    models, opts, step = build(1)
    _same("14b whole, first 2 steps", [step() for _ in range(2)],
          unbroken[:2])
    with tempfile.TemporaryDirectory() as root:
        saver = ckpt.AsyncCheckpointer(root, keep=2)
        _timed_save(torch, saver, 2, convert.train_state_to_flat(
            models, opts, step.state), None)
        del models, opts, step
        models, opts, step = resume(root, 2, 1)
        _same("14b whole -> whole, step 3", [step()], unbroken[2:])
        del models, opts, step
        models, opts, step = resume(root, 2, R)
        c3 = step()
        worst = _loss_bound(torch, f"14b whole -> {R} shards, step 3", c3,
                            unbroken[2], R)
        _gathered_save(torch, saver, 3, convert.train_state_to_flat(
            models, opts, step.state))
        saver.close()
        c4 = step()
        del models, opts, step, saver
        models, opts, step = resume(root, 3, R)
        _same(f"14b {R} shards -> {R} shards, step 4", [step()], [c4])
        del models, opts, step
        models, opts, step = resume(root, 3, 1)
        worst = max(worst, _loss_bound(
            torch, f"14b {R} shards -> whole, step 4", step(), c4, R))
        del models, opts, step
    _free(torch)
    _want_launches(fa, "14b", layers * (3 + 2 + 1 + 1) + R * layers * 3)
    print(f"  14b: worst resumed loss at {worst:.3f} of its bound")


def phase_multi_steps_resume(hvd, fa, torch, dev, bench):
    """14c: phase 5's LM (``RESUME_LAYERS`` deep), weights and batch,
    through ``DistributedOptimizer(backward_passes_per_step=2)`` (optax's
    ``MultiStepsState`` in the checkpoint), 4 mini-steps unbroken against
    a save after mini-step 1 (inside a window) and after mini-step 2 (at
    its boundary), each restored into a fresh model and optimizer and
    run to mini-step 4: every loss and the final state bit for bit."""
    import tempfile
    from horovod_tpu_torch import ckpt, convert, training
    layers = min(RESUME_LAYERS, LM["layers"])
    print(f"== phase 14c: the LM at full width and {layers} layers through "
          "DistributedOptimizer(backward_passes_per_step=2), saved inside a "
          "window and at its boundary")
    hvd.init()

    def build():
        _free(torch)
        _, model, tokens = _lm_full(torch, dev, layers=layers)
        opt = hvd.DistributedOptimizer(
            _lm_adamw(torch, model.parameters()),
            named_parameters=convert.flax_named_parameters(model),
            backward_passes_per_step=2)
        inner = training.make_lm_train_step(model, opt)

        def step():
            return float(inner(tokens))

        step.state = inner.state
        return model, opt, step

    fa.reset_launches()
    model, opt, step = build()
    unbroken = [step() for _ in range(4)]
    want = _state_copy(torch, convert.train_state_to_flat(model, opt,
                                                          step.state))
    del model, opt, step
    for mini in (1, 2):
        model, opt, step = build()
        _same(f"14c first {mini} mini-steps", [step() for _ in range(mini)],
              unbroken[:mini])
        with tempfile.TemporaryDirectory() as root:
            saver = ckpt.AsyncCheckpointer(root, keep=1)
            _timed_save(torch, saver, mini, convert.train_state_to_flat(
                model, opt, step.state), None)
            saver.close()
            del model, opt, step, saver
            model, opt, step = _resume_from(bench, root, mini, build)
        print(f"  14c restored mini_step {opt._mini_step}, gradient_step "
              f"{opt._gradient_step}")
        _same(f"14c resumed after mini-step {mini}",
              [step() for _ in range(mini, 4)], unbroken[mini:])
        diff = _state_diff(torch, _state_copy(
            torch, convert.train_state_to_flat(model, opt, step.state)),
            want)
        print(f"  14c state after 4 mini-steps against the unbroken run's: "
              f"largest difference {diff}")
        if diff != 0:
            raise AssertionError(f"14c: state differs by {diff}")
        del model, opt, step
    del want
    _free(torch)
    _want_launches(fa, "14c", layers * 12)
    hvd.shutdown()


# phase 15: the GSPMD steps against the explicit ones, every step's loss
# within the JAX package's bar (__graft_entry__.py GSPMD_EPSILON)
GSPMD_EPSILON = 1e-4


def _rel_gap(label, got, want, bound, floor=0.0):
    """Every loss of ``got`` within ``bound`` relative (the denominator
    at least ``floor``) of ``want``'s; says whether they are bit for
    bit. Returns the largest gap."""
    worst = max(abs(a - b) / max(abs(b), floor) for a, b in zip(got, want))
    print(f"  {label}: {[round(x, 6) for x in got]} against "
          f"{[round(x, 6) for x in want]}: largest relative gap "
          f"{worst:.3e} (bound {bound:g})"
          f"{', bit for bit' if got == want else ', not bit for bit'}")
    if not worst <= bound:
        raise AssertionError(f"{label}: {got} beyond {bound:g} of {want}")
    return worst


def phase_spmd(hvd, fa, torch, bench, phase5_losses, phase5_tok_s,
               losses_6a, peak_6a):
    """15a-15d: phase 5's LM, weights and batch through the GSPMD steps
    (``make_lm_train_step(spmd=True)``: DTensor placements on ``init()``'s
    ``("data",)`` mesh at world 1 over NCCL, K1-K3 as an island a layer):
    15a against phase 5's losses, tokens/s and a profile; 15b ZeRO-1
    (rows ``Shard(0)``) against 6a's losses and peak memory; 15c the int8
    chunked island against 15a and the bf16 cast wire with ZeRO-1
    against 15b (``WIRE_EPSILON``); 15d 15b's state saved (``convert``,
    ``ckpt.AsyncCheckpointer``) and restored into the explicit ZeRO-1
    step, and an explicit ZeRO-1 state restored into the GSPMD step: each
    next loss bit for bit the step taken from the saved state itself.
    Returns the kernels' launches."""
    import tempfile
    from horovod_tpu_torch import ckpt, convert, training
    print("== phase 15: the GSPMD steps (DTensor placements) at full width")
    hvd.init()
    layers, seq = LM["layers"], LM["seq_len"]
    ntok = LM["batch"] * seq
    total = {"fwd": 0, "dq": 0, "dkv": 0}

    def count(launches):
        for k in total:
            total[k] += launches[k]

    def build(**kw):
        _free(torch)
        return _lm_bench(bench, torch, seq_len=seq, **kw)

    def state_of(**kw):  # (model, optimizer, step), as _resume_from takes
        step, model, opt, _ = build(**kw)
        return model, opt, step

    t0 = time.perf_counter()
    step, model, opt, tokens = build(spmd=True)
    print(f"  15a built in {time.perf_counter() - t0:.2f} s; plan: mesh "
          f"{step.plan.mesh.axis_names} {step.plan.mesh.shape}, "
          f"{step.plan.device_mesh}, batch "
          f"{step.program.batch_placements}, parameters Replicate()")
    losses_a, launches, ms_a = _drive(
        "15a", hvd, fa, torch, bench, step, (tokens,), layers * STEPS, ntok,
        lambda: "exchange: Partial buckets redistributed to Replicate()",
        profile=True)
    count(launches)
    _rel_gap("15a against phase 5", losses_a, phase5_losses, GSPMD_EPSILON)
    tok_a = ntok * hvd.size() / ms_a * 1e3
    print(f"  15a {tok_a:.1f} tokens/s against phase 5's {phase5_tok_s:.1f}"
          f" ({tok_a / phase5_tok_s:.3f}x)")
    print(f"  15a compiled_collectives {step.compiled_collectives}, by axes "
          f"{step.compiled_axis_collectives} (world 1: DTensor skips the "
          "collectives of a mesh dim of one rank, so the path issues "
          "none)")
    del step, model, opt, tokens

    step, model, opt, tokens = build(spmd=True, sharded_update=True)
    schedule = opt.zero_state.plan.schedule
    losses_b, launches, _ = _drive(
        "15b", hvd, fa, torch, bench, step, (tokens,), layers * STEPS, ntok,
        lambda: "ZeRO-1 rows Shard(0); " + _schedule_line(schedule))
    peak_b = torch.cuda.max_memory_allocated()
    count(launches)
    _rel_gap("15b against 6a", losses_b, losses_6a, GSPMD_EPSILON)
    print(f"  15b peak device memory {peak_b / 2**30:.2f} GiB against 6a's "
          f"{peak_6a / 2**30:.2f} GiB ({peak_b / peak_6a:.3f}x)")
    print(f"  15b compiled_collectives {step.compiled_collectives}")

    # 15d: 15b's state, saved, restored into the explicit ZeRO-1 step
    fa.reset_launches()
    with tempfile.TemporaryDirectory() as root:
        saver = ckpt.AsyncCheckpointer(root, keep=1)
        _timed_save(torch, saver, STEPS, convert.train_state_to_flat(
            model, opt, step.state), None)
        saver.close()
        into = _resume_from(bench, root, STEPS,
                            lambda: state_of(sharded_update=True))
    restored = float(into[2](tokens))
    unbroken = float(training.make_lm_train_step(model, opt)(tokens))
    _same("15d GSPMD state -> explicit ZeRO-1 step, next loss against the "
          "explicit step from the state itself", [restored], [unbroken])
    del step, model, opt
    # and an explicit ZeRO-1 state (one more step of it) into the GSPMD step
    model, opt, step = into
    del into
    step(tokens)
    with tempfile.TemporaryDirectory() as root:
        saver = ckpt.AsyncCheckpointer(root, keep=1)
        _timed_save(torch, saver, STEPS + 2, convert.train_state_to_flat(
            model, opt, step.state), None)
        saver.close()
        into = _resume_from(bench, root, STEPS + 2,
                            lambda: state_of(spmd=True, sharded_update=True))
    restored = float(into[2](tokens))
    unbroken = float(training.make_lm_train_step(model, opt, spmd=True)(
        tokens))
    _same("15d explicit ZeRO-1 state -> GSPMD step, next loss against the "
          "GSPMD step from the state itself", [restored], [unbroken])
    _want_launches(fa, "15d", layers * 5)
    count(fa.LAUNCHES)
    del model, opt, step, into

    for label, kw, want in (
            ("15c int8 island", dict(compression="int8", telemetry=True),
             losses_a),
            ("15c bf16 cast, ZeRO-1", dict(compression="bf16",
                                           sharded_update=True), losses_b)):
        step, model, opt, tokens = build(spmd=True, **kw)
        got, launches, _ = _drive(
            label, hvd, fa, torch, bench, step, (tokens,), layers * STEPS,
            ntok, lambda: f"wire {step.wire.name}")
        count(launches)
        _rel_gap(f"{label} against {'15a' if want is losses_a else '15b'}",
                 got, want, WIRE_EPSILON, floor=WIRE_EPSILON_FLOOR)
        if kw.get("telemetry"):
            # the chunked island's hvd_grad_norm (at world 1 the wire
            # has no exchange, and .grad holds the reduced gradient)
            _grad_norm_check(label, torch, step, opt)
        del step, model, opt, tokens
    _free(torch)
    hvd.shutdown()
    return total


def _scrape(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=180) as resp:
        return resp.status, resp.read().decode()


def _metric(text, name, labels=""):
    """The value of one sample line of a Prometheus exposition."""
    head = name + ("{" + labels + "}" if labels else "") + " "
    for line in text.splitlines():
        if line.startswith(head):
            return float(line[len(head):])
    raise AssertionError(f"/metrics has no sample {head.strip()}")


def _counts(text, fill, calls):
    return {"steps": _metric(text, "hvd_step_total"),
            "rs": _metric(text, fill + "_count", 'kind="rs"')
            if 'kind="rs"' in text else 0.0,
            "ag": _metric(text, fill + "_count", 'kind="ag"')
            if 'kind="ag"' in text else 0.0,
            "allreduce": _metric(text, calls, 'op="allreduce"')
            if 'op="allreduce"' in text else 0.0}


def _xray_check(label, torch, xprof, summary, profile_dir, steps):
    """16b's holds on one X-ray: the gate, and its busy time against this
    script's union of the capture's kernels, copies and memsets. Prints
    each category's ms per step and the verdict; returns the device's
    busy ms per step from the union."""
    _, paths = xprof.find_capture(profile_dir)
    events = [e for p in paths for e in xprof.load_trace_file(p)]
    work = sorted((float(e["ts"]), float(e.get("dur", 0.0)))
                  for e in events if isinstance(e, dict)
                  and e.get("ph") == "X" and e.get("cat") in DEVICE_WORK)
    union_ms = _union_ms(work)
    busy_ms = 1e3 * summary["busy_seconds"]
    gap = abs(busy_ms - union_ms) / union_ms
    print(f"  {label} x-ray over {steps} steps: {summary['device_lanes']} "
          f"lanes, busy {busy_ms:.3f} ms against the union of kernels, "
          f"copies and memsets {union_ms:.3f} ms ({100 * gap:.3f}% apart, "
          f"bound 1%); named {100 * summary['bucketed_fraction']:.3f}% "
          f"(gate {100 * xprof.BUCKETED_GATE:.0f}%)")
    for cat in xprof.CATEGORIES:
        sec = summary["device_seconds"][cat]
        if sec > 0:
            print(f"    {1e3 * sec / steps:9.3f} ms/step  {cat}")
    idle = summary["device_seconds"]["idle"]
    total = sum(summary["device_seconds"].values())
    print(f"  {label} verdict {summary['verdict']}; device idle "
          f"{100 * idle / total:.1f}% of the capture's attributed time")
    if summary["bucketed_fraction"] < xprof.BUCKETED_GATE:
        raise AssertionError(f"{label}: the x-ray named "
                             f"{summary['bucketed_fraction']} of the "
                             "device time, under the gate")
    if gap > 0.01:
        raise AssertionError(f"{label}: x-ray busy {busy_ms} ms against "
                             f"the union {union_ms} ms")
    return union_ms / steps


def phase_telemetry(hvd, fa, torch, bench, phase5_losses, losses_6b,
                    phase5_tok_s, card, keep):
    """16a-16c (module docstring): the telemetry and diagnosis planes on
    phase 5's LM and 6b's configuration, at world 1 over NCCL. 16c's
    flight-recorder dumps are copied into the directory ``keep`` for
    19c. Returns the kernels' launches and 16c's report: ``dir``
    (``keep``), ``classification`` and the last event."""
    import shutil
    import tempfile
    from horovod_tpu_torch import _build, basics, telemetry, training
    from horovod_tpu_torch.diag import doctor
    from horovod_tpu_torch.telemetry import instruments as tinst
    from horovod_tpu_torch.telemetry import xprof
    print("== phase 16: the telemetry and diagnosis planes on the LM step")
    print(f"  {card}")
    layers, seq = LM["layers"], LM["seq_len"]
    ntok = LM["batch"] * seq
    total = {"fwd": 0, "dq": 0, "dkv": 0}

    def count():
        for k in total:
            total[k] += fa.LAUNCHES[k]

    with tempfile.TemporaryDirectory() as root:
        root = Path(root)
        env = {"HOROVOD_METRICS_PORT": "0", "HOROVOD_FLIGHTREC": "1",
               "HOROVOD_FLIGHTREC_DIR": str(root / "flightrec"),
               "HOROVOD_PROFILE_DIR": str(root / "profile")}
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            hvd.init()
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k)
                else:
                    os.environ[k] = v
        port = basics._state.metrics_server.port
        print(f"  metrics on http://127.0.0.1:{port}/metrics; flight "
              f"recorder {basics._state.flight_recorder.dump_path()}")
        # the kernels' build at first use, into a fresh directory: the
        # port's compile time
        built_in, _build._lib = _build.BUILD_DIR, None
        _build.BUILD_DIR = root / "build"
        t0 = time.perf_counter()
        try:
            _build.load()
        finally:
            _build.BUILD_DIR = built_in
        build_s = time.perf_counter() - t0
        print(f"  16a kernels rebuilt in {build_s:.2f} s")

        # 16a: phase 5's LM with telemetry on
        _free(torch)
        step, model, opt, tokens = _lm_bench(bench, torch, seq_len=seq,
                                             telemetry=True)
        _, text0 = _scrape(port, "/metrics")
        before = _counts(text0, tinst.BUCKET_FILL_RATIO,
                         tinst.COLLECTIVE_CALLS)
        losses, _, ms = _drive("16a", hvd, fa, torch, bench, step,
                               (tokens,), layers * STEPS, ntok,
                               lambda: (f"fused allreduce: "
                                        f"{len(opt.last_buckets)} buckets"))
        count()
        _same("16a make_lm_train_step(telemetry=True) against phase 5",
              losses, phase5_losses)
        tok_s = ntok * hvd.size() / ms * 1e3
        print(f"  16a {tok_s:.1f} tokens/s against phase 5's "
              f"{phase5_tok_s:.1f} ({tok_s / phase5_tok_s:.4f}x)")
        code, text = _scrape(port, "/metrics")
        after = _counts(text, tinst.BUCKET_FILL_RATIO,
                        tinst.COLLECTIVE_CALLS)
        # a step: the target count, one allreduce a bucket, the loss
        want = {"steps": STEPS,
                "allreduce": STEPS * (len(opt.last_buckets) + 2)}
        got = {k: after[k] - before[k] for k in want}
        print(f"  16a /metrics: {got} (want {want}); loss "
              f"{_metric(text, tinst.LOSS):.6f}, grad norm "
              f"{_metric(text, tinst.GRAD_NORM):.6f}")
        if code != 200 or got != want:
            raise AssertionError(f"16a: /metrics counts {got}, want {want}")
        by_layer = profile_step(torch, lambda: step(tokens), ms)
        _grad_norm_check("16a", torch, step, opt)
        count_5 = (step, tokens, by_layer, model, opt)
        del model, opt

        # 6b's configuration through make_train_step(telemetry=True)
        _, model6, opt6, tokens6 = _lm_bench(bench, torch, seq_len=seq + 1,
                                             sharded_update=True)
        step6 = training.make_train_step(model6, opt6, accum_steps=2,
                                         overlap_grads=True, telemetry=True)
        _, text = _scrape(port, "/metrics")
        before = _counts(text, tinst.BUCKET_FILL_RATIO,
                         tinst.COLLECTIVE_CALLS)
        fa.reset_launches()
        got6 = [float(step6(tokens6[:, :seq], tokens6[:, 1:seq + 1]))
                for _ in range(STEPS)]
        torch.cuda.synchronize()
        count()
        _want_launches(fa, "16a 6b", 2 * layers * STEPS)
        _same("16a make_train_step(telemetry=True) against 6b", got6,
              losses_6b)
        _, text = _scrape(port, "/metrics")
        after = _counts(text, tinst.BUCKET_FILL_RATIO,
                        tinst.COLLECTIVE_CALLS)
        nb = len(step6.schedule.buckets)
        want = {"steps": STEPS, "rs": 2 * STEPS * nb, "ag": STEPS * nb}
        got = {k: after[k] - before[k] for k in want}
        print(f"  16a 6b /metrics: {got} (want {want}); {nb} buckets; "
              f"grad norm {_metric(text, tinst.GRAD_NORM):.6f}")
        if got != want:
            raise AssertionError(f"16a 6b: /metrics counts {got}, want "
                                 f"{want}")
        print(f"  16a hvd_step_total {_metric(text, tinst.STEP_TOTAL):.0f} "
              "(phase 5's steps and profile_step's, 6b's)")
        code, body = _scrape(port, "/healthz")
        print(f"  16a /healthz {code} {body}")
        if code != 200:
            raise AssertionError(f"16a: /healthz answered {code}")
        del step6, model6, opt6, tokens6
        _free(torch)
        # the planes' cost on phase 5's step: telemetry on and off over
        # one model, in turns (off, on, on, off), 3 steps a turn
        step, tokens, by_layer, model, opt = count_5
        step_off = training.make_lm_train_step(model, opt, telemetry=False)
        turns = {"on": [], "off": []}
        for turn in ("off", "on", "on", "off"):
            run = step if turn == "on" else step_off
            for _ in range(3):
                t0 = time.perf_counter()
                run(tokens)
                bench.sync()
                turns[turn].append(1e3 * (time.perf_counter() - t0))
        on_ms, off_ms = (float(np.median(turns[k])) for k in ("on", "off"))
        print(f"  16a in turns (off, on, on, off; 3 steps each): telemetry "
              f"on {on_ms:.2f} ms, off {off_ms:.2f} ms ({on_ms / off_ms:.4f}x)"
              f"; on {[round(x, 2) for x in turns['on']]}, off "
              f"{[round(x, 2) for x in turns['off']]}")
        count_5 = (step, tokens, by_layer)
        del step_off, model, opt
        led = telemetry.get_ledger()
        snap = led.finalize()
        wall = snap["wall_seconds"]
        print(f"  16a ledger: wall {wall:.3f} s, {snap['steps']} steps, "
              f"goodput {snap['goodput_ratio']:.4f}, unattributed "
              f"{snap['unattributed_seconds']:.6f} s")
        for ph, sec in snap["phases"].items():
            print(f"    {sec:10.4f} s {100 * sec / wall:5.1f}%  {ph}")
        if snap["unattributed_seconds"] >= 0.02 * wall:
            raise AssertionError("16a: the ledger left 2% or more of the "
                                 "wall unattributed")
        # the build's own clock starts inside the timed call
        if snap["phases"]["compile"] < 0.99 * build_s:
            raise AssertionError("16a: the kernel build is not in the "
                                 "ledger's compile phase")

        # 16b: x-ray of phase 5's step, then of 15a's GSPMD step
        step, tokens, by_layer = count_5
        fa.reset_launches()
        _, summary = step.xray(tokens, k=3, profile_dir=str(root / "x5"))
        count()
        _want_launches(fa, "16b phase 5", layers * 4)
        busy5 = _xray_check("16b phase 5", torch, xprof, summary,
                            str(root / "x5"), 3)
        mm = 1e3 * summary["device_seconds"]["matmul_conv"] / 3
        print(f"  16b phase 5 matmul_conv {mm:.3f} ms/step against "
              f"profile_step's matmuls {by_layer['matmuls']:.3f} ms; "
              f"busy {busy5:.3f} ms/step")
        del step, tokens, count_5
        _free(torch)
        step, model, opt, tokens = _lm_bench(bench, torch, seq_len=seq,
                                             spmd=True)
        fa.reset_launches()
        _, summary = step.xray(tokens, k=3, profile_dir=str(root / "x15"))
        count()
        _want_launches(fa, "16b 15a", layers * 4)
        _xray_check("16b 15a", torch, xprof, summary, str(root / "x15"), 3)

        # /profile during the steps: the window opens and closes on them
        got = {}
        ask = threading.Thread(target=lambda: got.update(r=_scrape(
            port, "/profile?seconds=1&wait=1")))
        fa.reset_launches()
        ask.start()
        n = 0
        while ask.is_alive():
            step(tokens)
            n += 1
            ask.join(0.001)
        torch.cuda.synchronize()
        count()
        _want_launches(fa, "16b /profile", layers * n)
        code, body = got["r"]
        prof = json.loads(body).get("summary") or {}
        print(f"  16b /profile?seconds=1&wait=1 -> {code} over {n} steps: "
              f"verdict {prof.get('verdict')}, "
              f"{prof.get('steps')} steps captured, named "
              f"{prof.get('bucketed_fraction')}")
        if code != 200 or "verdict" not in prof:
            raise AssertionError(f"16b: /profile returned {code} {body}")
        _grad_norm_check("16b 15a", torch, step, opt)
        del step, model, opt, tokens
        _free(torch)

        # 16c: a dump on demand, then the doctor
        events = basics._state.flight_recorder.snapshot()["events"]
        last_step = [e for e in events if e["k"] == "step"][-1]["step"]
        code, body = _scrape(port, "/flightrec?dump=1")
        dump = root / "flightrec" / "flightrec.rank0.json"
        if code != 200 or not dump.is_file():
            raise AssertionError(f"16c: /flightrec?dump=1 answered {code}")
        live = doctor.diagnose(doctor.load_dumps(str(root / "flightrec"))[0],
                               expected_size=1)
        print(f"  16c on-demand dump: {live['classification']} "
              "(an on-demand dump carries no clean-exit reason), last "
              f"event {live['per_rank'][0]['last_event']}")
        hvd.shutdown()  # the recorder's final dump: reason shutdown
        report = doctor.run(str(root / "flightrec"), expected_size=1,
                            stream=sys.stdout)
        ev = report["per_rank"][0]["last_event"] or {}
        if report["classification"] != "healthy" or \
                ev.get("step") != last_step:
            raise AssertionError(f"16c: the doctor says "
                                 f"{report['classification']}, last event "
                                 f"{ev}; want healthy at step {last_step}")
        print(f"  16c doctor: healthy, last step {ev.get('step')}")
        shutil.copytree(root / "flightrec", keep, dirs_exist_ok=True)
    return total, dict(dir=keep, classification=report["classification"],
                       last_event=ev)


# phase 17: the steps a hostA worker takes before it dies (17a), the
# seconds from 17b's first committed step to its SIGTERM, the eviction's
# grace, and each run's deadline (its workers are killed past it)
ELASTIC_DEVICE = "cuda"
ELASTIC_STEP_SLEEP = 0.0  # a step's added seconds (none on the card)
ELASTIC_DIE_AFTER = 2
EVICT_AFTER_S = 1.0
GRACE_S = 30.0
ELASTIC_DEADLINE_S = 300.0


def _elastic_run(label, driver, launch, root, max_epochs):
    """``driver.run_job(launch)`` under ``ELASTIC_DEADLINE_S``; returns
    ``(epochs, {epoch: launch wall time})``. On any failure the workers'
    logs are printed and the run fails."""
    launched, jobs, expired = {}, [], threading.Event()

    def tracked(slots, epoch, env):
        job = launch(slots, epoch, env)
        launched[epoch] = job.launched_at
        jobs.append(job)
        return job

    def expire():
        expired.set()
        for job in jobs:
            job.kill_all(9)

    timer = threading.Timer(ELASTIC_DEADLINE_S, expire)
    timer.start()
    try:
        epochs = driver.run_job(tracked, max_epochs=max_epochs)
        if expired.is_set():
            raise AssertionError(f"{label}: past {ELASTIC_DEADLINE_S} s")
    except BaseException:
        for f in sorted(Path(root).glob("epoch-*.log")):
            print(f"  {label} {f.name}:\n" + "\n".join(
                f.read_text(errors="replace").splitlines()[-40:]))
        raise
    finally:
        timer.cancel()
    return epochs, launched


def _elastic_records(log):
    return [json.loads(x) for x in Path(log).read_text().splitlines()]


def _elastic_losses(label, records, phase5_losses, once):
    """Each logged loss bit for bit phase 5's at its step; with ``once``
    the steps 1..STEPS each logged once, in order, else each at least
    once; each worker's K1-K3 launches once a layer and logged step.
    Returns the launches summed over the workers."""
    losses = [r for r in records if "loss" in r]
    steps = [r["step"] for r in losses]
    if once and steps != list(range(1, STEPS + 1)):
        raise AssertionError(f"{label}: steps {steps}, each once wanted")
    if set(steps) != set(range(1, STEPS + 1)):
        raise AssertionError(f"{label}: steps {steps}")
    for r in losses:
        if r["loss"] != phase5_losses[r["step"] - 1]:
            raise AssertionError(
                f"{label}: step {r['step']} loss {r['loss']!r} (epoch "
                f"{r['epoch']}) against phase 5's "
                f"{phase5_losses[r['step'] - 1]!r}")
    total = {"fwd": 0, "dq": 0, "dkv": 0}
    for epoch in sorted({r["epoch"] for r in losses}):
        mine = [r for r in losses if r["epoch"] == epoch]
        got = mine[-1]["launches"]
        _worker_launches(f"{label} epoch {epoch}", got,
                         LM["layers"] * len(mine))
        for k in total:
            total[k] += got[k]
    print(f"  {label} losses {[r['loss'] for r in losses]} (epochs "
          f"{[r['epoch'] for r in losses]}): bit for bit phase 5's; "
          f"launches {total}, once a layer and step of each worker")
    return total


def _worker_launches(label, got, want):
    """A worker's count of each kernel's launches is ``want``."""
    if got != {"fwd": want, "dq": want, "dkv": want}:
        raise AssertionError(f"{label}: launches {got}, want {want} each")


def _recovery(label, t_death, launched_at, records, epoch):
    """Seconds from a death to the next epoch's first loss, split: the
    driver's blame and rendezvous, the spawn, the imports, ``init()`` on
    NCCL, the first allocation, the kernel library's load, the model's
    build, the restore, the sync and the first step."""
    resume = [r for r in records if r.get("event") == "resume"
              and r["epoch"] == epoch][0]
    first = [r for r in records if "loss" in r and r["epoch"] == epoch][0]
    parts = {
        "rendezvous": launched_at - t_death,
        "spawn": resume["t_start"] - launched_at,
        "imports": resume["import_s"],
        "init (NCCL)": resume["init_s"],
        "first allocation": resume["context_s"],
        "kernel load": resume["kernel_load_s"],
        "model build": resume["build_s"],
        "restore": resume["restore_s"],
        "sync": resume["time"] - resume["t_built"] - resume["restore_s"],
        "first step": first["time"] - resume["time"],
    }
    total = first["time"] - t_death
    print(f"  {label} recovery {total:.3f} s to epoch {epoch}'s first loss "
          f"(resumed from step {resume['resumed_from']}): " + ", ".join(
              f"{k} {v:.3f}" if v is not None else f"{k} none"
              for k, v in parts.items()))
    return total, parts


def _blocking_ms(records):
    """Every commit's blocking ms but each worker's first (a fresh
    start's commit, or None after a restore)."""
    out = []
    for r in records:
        if "commit_blocking_s" in r:
            out += [1e3 * x for x in r["commit_blocking_s"][1:]
                    if x is not None]
    return out


def phase_elastic(hvd, torch, phase5_losses):
    """17a, 17b: phase 5's LM, weights and batch in
    ``examples/elastic_train.py`` workers on this card, one an epoch,
    under an ``ElasticDriver`` of this process over ``FixedHosts``
    hostA and hostB (``min_np = max_np = 1``, ``Blacklist(threshold=2,
    base_delay=0)``, the port's ``KVStoreServer``), each worker through
    ``make_lm_train_step`` under ``elastic_train_loop`` with a
    ``TorchState`` committing every step to disk. 17a: hostA's worker
    SIGKILLs itself after 2 steps (their commit durable) in epochs 1 and
    2; epoch 3 restores on hostB and finishes. 17b: a seeded
    ``ChaosMonkey`` SIGTERMs epoch 1's worker after its first step; the
    eviction force-commits within its grace, announces hostA and exits
    ``EXIT_RENDEZVOUS``; the driver drains hostA without blame and epoch
    2 resumes on hostB. Returns the kernels' launches of both."""
    import tempfile

    from horovod_tpu_torch.chaos import ChaosMonkey, parse_spec
    from horovod_tpu_torch.elastic import (Blacklist, ElasticDriver,
                                           FixedHosts)
    from horovod_tpu_torch.examples.elastic_train import local_launch
    from horovod_tpu_torch.run.rendezvous import KVStoreServer

    # the workers need the card's memory this process's allocator holds
    hvd.shutdown()
    torch.cuda.empty_cache()
    print("== phase 17: elastic training on the card (worker death, "
          "graceful eviction)")
    widths = ["--device", ELASTIC_DEVICE, "--batch", LM["batch"],
              "--seq-len", LM["seq_len"],
              "--layers", LM["layers"], "--d-model", LM["d_model"],
              "--heads", LM["heads"], "--vocab", LM["vocab"], "--steps",
              STEPS, "--step-sleep", ELASTIC_STEP_SLEEP]
    total = {"fwd": 0, "dq": 0, "dkv": 0}

    def driver_of(kv):
        return ElasticDriver(FixedHosts({"hostA": 1, "hostB": 1}),
                             min_np=1, max_np=1, kv=kv, poll_interval=0.2,
                             blacklist=Blacklist(threshold=2,
                                                 base_delay=0.0))

    # -- 17a: death -> blame -> blacklist -> re-rendezvous -> resume
    with tempfile.TemporaryDirectory() as root:
        log = Path(root) / "losses.jsonl"
        kv = KVStoreServer()
        port = kv.start()
        t0 = time.perf_counter()
        try:
            driver = driver_of(kv)
            launch = local_launch(port, widths + [
                "--ckpt-dir", Path(root) / "ckpt", "--log", log, "--die",
                "kill", "--die-host", "hostA", "--die-until-epoch", 3,
                "--die-after", ELASTIC_DIE_AFTER], log_dir=root)
            epochs, launched = _elastic_run("17a", driver, launch, root,
                                            max_epochs=5)
        finally:
            kv.stop()
        wall_a = time.perf_counter() - t0
        records = _elastic_records(log)
        bl = driver.blacklist
        print(f"  17a {epochs} epochs in {wall_a:.1f} s; hostA failures "
              f"{bl.count('hostA')} (blacklisted {bl.blacklisted('hostA')}"
              f"), hostB failures {bl.count('hostB')}; epochs by host "
              f"{[(r['epoch'], r['host']) for r in records if 'loss' in r]}")
        if epochs != 3 or not bl.blacklisted("hostA") or \
                bl.count("hostB") or bl.drains("hostA"):
            raise AssertionError("17a: want 3 epochs and hostA blacklisted, "
                                 "hostB unblamed")
        got = _elastic_losses("17a", records, phase5_losses, once=True)
        for k in total:
            total[k] += got[k]
        deaths = [r for r in records if r.get("event") == "death"]
        recov_a = [_recovery("17a", d["time"], launched[d["epoch"] + 1],
                             records, d["epoch"] + 1) for d in deaths]
        blocking = _blocking_ms(records)
        restores = [1e3 * r["restore_s"] for r in records
                    if r.get("event") == "resume" and r["restore_s"]]
        print(f"  17a commit blocking ms (host copy and save()): "
              f"{[round(x, 2) for x in blocking]}, median "
              f"{float(np.median(blocking)):.2f}; restore ms "
              f"{[round(x, 2) for x in restores]}")
        if len(deaths) != 2 or len(restores) != 2:
            raise AssertionError(f"17a: {len(deaths)} deaths, "
                                 f"{len(restores)} restores")

    # -- 17b: a seeded SIGTERM, the bounded force-commit, the drain
    with tempfile.TemporaryDirectory() as root:
        log = Path(root) / "losses.jsonl"
        dumps = Path(root) / "flightrec"
        kv = KVStoreServer()
        port = kv.start()
        monkey = ChaosMonkey(parse_spec(
            f"seed=0,kinds=sigterm,count=1,interval={EVICT_AFTER_S},"
            "jitter=0"))
        evicted = {}
        t0 = time.perf_counter()
        try:
            driver = driver_of(kv)
            inner = local_launch(port, widths + [
                "--ckpt-dir", Path(root) / "ckpt", "--log", log],
                {"HOROVOD_FLIGHTREC": "1",
                 "HOROVOD_FLIGHTREC_DIR": str(dumps),
                 "HOROVOD_GRACE_SECONDS": str(GRACE_S)}, log_dir=root)

            def arm(job):
                # the monkey's clock starts at the worker's first
                # committed step (its heartbeat), so the SIGTERM lands
                # mid-run whatever the start-up took
                deadline = time.time() + ELASTIC_DEADLINE_S
                while time.time() < deadline and \
                        job.procs[0].poll() is None:
                    raw = kv.get("elastic/heartbeat/1/0")
                    if raw and (json.loads(raw).get("step") or 0) >= 1:
                        evicted["armed"] = time.time()
                        monkey.attach(job)
                        return
                    time.sleep(0.02)

            def launch(slots, epoch, env):
                if epoch == 2:  # the evicted worker's last dump
                    evicted["dump"] = json.loads(
                        (dumps / "flightrec.rank0.json").read_text())
                job = inner(slots, epoch, env)
                if epoch == 1:
                    threading.Thread(target=arm, args=(job,),
                                     daemon=True).start()
                return job

            epochs, launched = _elastic_run("17b", driver, launch, root,
                                            max_epochs=4)
        finally:
            monkey.stop()
            kv.stop()
        wall_b = time.perf_counter() - t0
        records = _elastic_records(log)
        bl = driver.blacklist
        applied = [(inj.kind, rank) for inj, rank, _ in
                   monkey.injections_done]
        preempt = [e for e in evicted.get("dump", {}).get("events", [])
                   if e.get("k") == "preempt" and "outcome" in e]
        print(f"  17b {epochs} epochs in {wall_b:.1f} s; injected "
              f"{applied} {EVICT_AFTER_S} s after the first committed "
              f"step; drains hostA {bl.drains('hostA')}, failures "
              f"{bl.count('hostA')}/{bl.count('hostB')}; eviction "
              f"{preempt[-1] if preempt else None}")
        if applied != [("sigterm", 0)] or epochs != 2 or \
                bl.count("hostA") or bl.count("hostB") or \
                bl.drains("hostA") != 1:
            raise AssertionError("17b: want one SIGTERM, 2 epochs, hostA "
                                 "drained without blame")
        if not preempt or preempt[-1]["outcome"] != "committed" or \
                not preempt[-1]["announced"] or \
                preempt[-1]["commit_seconds"] >= GRACE_S:
            raise AssertionError(f"17b: the force-commit {preempt} did not "
                                 f"finish inside the {GRACE_S} s grace")
        got = _elastic_losses("17b", records, phase5_losses, once=False)
        for k in total:
            total[k] += got[k]
        commit_ms = 1e3 * preempt[-1]["commit_seconds"]
        resumed = [r for r in records if r.get("event") == "resume"
                   and r["epoch"] == 2][0]["resumed_from"]
        print(f"  17b force-commit {commit_ms:.2f} ms against the "
              f"{GRACE_S:.0f} s grace; epoch 2 resumed from step "
              f"{resumed}")
        recov_b = _recovery("17b", evicted["armed"] + EVICT_AFTER_S,
                            launched[2], records, 2)
    print(f"  17 recovery s: 17a {[round(r[0], 3) for r in recov_a]}, "
          f"17b {recov_b[0]:.3f}")
    return total


def _pct(xs, q):
    return float(np.percentile(np.asarray(xs, dtype=np.float64), q))


def _serve_requests(rng, vocab):
    """18a's prompts (``SERVE``): request 0 and 1 share their first
    ``prefix`` tokens and part at the next one, request 0 is block-aligned
    (its exact resubmission forks its last shared block); requests 2 and
    3 sample. Returns ``[(prompt, sampling_kw)]``."""
    s = SERVE
    lengths = rng.integers(s["prompt_lo"], s["prompt_hi"] + 1,
                           size=s["requests"])
    prompts = [rng.integers(0, vocab, size=int(n)).tolist() for n in lengths]
    shared = prompts[0][:s["prefix"]]
    n0 = max(s["prefix"] + s["block"],
             len(prompts[0]) // s["block"] * s["block"])
    prompts[0] = shared + rng.integers(
        0, vocab, size=n0 - s["prefix"]).tolist()
    tail = rng.integers(0, vocab, size=max(
        1, len(prompts[1]) - s["prefix"])).tolist()
    tail[0] = (prompts[0][s["prefix"]] + 1) % vocab
    prompts[1] = shared + tail
    out = []
    for i, p in enumerate(prompts):
        kw = {}
        if 2 <= i < 2 + s["sampled"]:
            kw = dict(temperature=s["temperature"], top_p=s["top_p"],
                      seed=1000 + i)
        out.append((p, kw))
    return out


def _teacher_forced(torch, model, prompt, generated, label="18a"):
    """The rank of each greedy token under the port's ordinary forward
    over prompt + generated (no cache): ``(exact, tolerated, worst)``,
    worst the largest (top - chosen) / max|logit|; raises past the
    tie bound."""
    dev = model.lm_head.weight.device
    with torch.no_grad():
        logits = model(torch.tensor([prompt + generated[:-1]], device=dev))
    logits = logits[0, len(prompt) - 1:].float()
    chosen = logits.gather(1, torch.tensor(generated, device=dev)[:, None])
    chosen = chosen[:, 0]
    top = logits.max(dim=1).values
    scale = logits.abs().max(dim=1).values
    gap = ((top - chosen) / scale).cpu().numpy()
    exact = int((gap == 0).sum())
    if (gap > SERVE_TIE).any():
        i = int(np.argmax(gap))
        raise AssertionError(
            f"{label}: greedy token {i} ({generated[i]}) is {gap[i]:.4g} of "
            f"max|logit| below the oracle's top, past {SERVE_TIE}")
    return exact, len(generated) - exact, float(gap.max())


def _op_count(torch, run):
    """The aten operations ``run()`` dispatches (after autograd)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        run()
    return Count.n


def _drive_engine(eng, reqs):
    while not all(r.state in ("done", "failed") for r in reqs):
        eng.step()
    bad = [r.id for r in reqs if r.state != "done"]
    if bad:
        raise AssertionError(f"requests failed: {bad}")


def phase_serve(hvd, fa, torch, bench, card, root=None):
    """18a-18c (module docstring): the serving plane on phase 5's LM,
    its weights loaded from a manifest, saved under ``root`` (the
    caller's directory, kept for 20b; None: a temporary one). Returns
    18a's streams by request id and its decode tokens/s and inter-token
    p50 and p99 (ms)."""
    import tempfile
    import urllib.request as urlreq
    from horovod_tpu_torch import ckpt, convert
    from horovod_tpu_torch.serve import engine as engine_lib
    from horovod_tpu_torch.serve import kvcache, loader
    from horovod_tpu_torch.serve.fleet import FleetRouter
    from horovod_tpu_torch.serve.sampling import SamplingParams
    from horovod_tpu_torch.serve.server import ServeServer
    from horovod_tpu_torch.telemetry.registry import MetricsRegistry
    s = SERVE
    print("== phase 18: serving phase 5's LM (paged KV, continuous "
          "batching, fleet, HTTP)")
    print(f"  {card}")
    hvd.init()
    dev = hvd.device()
    step, model, opt, tokens = _lm_bench(bench, torch,
                                         seq_len=LM["seq_len"])
    for _ in range(STEPS):
        step(tokens)
    bench.sync()
    cfg = model.cfg
    with (contextlib.nullcontext(root) if root is not None
          else tempfile.TemporaryDirectory()) as root:
        t0 = time.perf_counter()
        ckpt.save_sharded(root, STEPS, convert.train_state_to_flat(
            model, opt, step.state), meta={"model_config": {
                "vocab_size": cfg.vocab_size, "num_layers": cfg.num_layers,
                "num_heads": cfg.num_heads, "d_model": cfg.d_model,
                "d_ff": cfg.d_ff}})
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded, params, meta = loader.load_params(
            root, loader.abstract_params(model))
        t_load = time.perf_counter() - t0
    del opt, step, tokens
    model.zero_grad(set_to_none=True)
    _free(torch)
    want = model.state_dict()
    got = convert.params_from_flax(params, model)
    for name, t in want.items():
        if not torch.equal(got[name], t.detach().cpu()):
            raise AssertionError(f"18: loaded {name} differs from the "
                                 "trained parameter")
    print(f"  weights: step {loaded} saved in {t_save:.2f} s, params-only "
          f"load in {t_load:.2f} s, bit for bit the trained model "
          f"(meta {meta['model_config']})")
    mbps = -(-s["max_seq_len"] // s["block"])
    kv = kvcache.KVCacheConfig(
        num_blocks=s["blocks"], block_size=s["block"],
        num_layers=cfg.num_layers, num_heads=cfg.num_heads,
        head_dim=cfg.d_model // cfg.num_heads, max_blocks_per_seq=mbps,
        dtype=cfg.dtype)
    print(f"  KV pool: {s['blocks']} blocks x {s['block']} tokens, "
          f"{mbps} blocks a sequence, {s['slots']} slots, chunk "
          f"{s['chunk']}: pool_bytes {kv.pool_bytes():,}")
    reg = MetricsRegistry()
    eng = engine_lib.ServeEngine(model, params, kv, device=dev,
                                 max_slots=s["slots"],
                                 prefill_chunk=s["chunk"], registry=reg,
                                 weights_version=loaded)
    specs = _serve_requests(np.random.default_rng(18), cfg.vocab_size)

    def request(i, **kw):
        p, skw = specs[i]
        return engine_lib.Request(
            p, s["new"], request_id=i,
            sampling=SamplingParams(**skw) if skw else None, **kw)

    # -- 18a: 16 requests, the pair's second after the first's prefill ---
    served = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    first = eng.submit(request(0))
    t_start = first.arrival
    while first.state not in ("decode", "done"):
        eng.step()
    # once the first's prompt blocks are cached (and held by it): the
    # pair's second request, the exact resubmission of the first (its
    # last prompt block is shared and about to be written, so admission
    # forks it), then the rest
    reqs = [first] + [eng.submit(request(1))]
    fork = eng.submit(engine_lib.Request(specs[0][0], s["new"],
                                         request_id="fork"))
    reqs += [eng.submit(request(i)) for i in range(2, s["requests"])]
    _drive_engine(eng, reqs + [fork])
    wall = eng._clock() - t_start
    peak = torch.cuda.max_memory_allocated()
    served += reqs + [fork]
    launches = dict(fa.LAUNCHES)
    if any(launches.values()):
        raise AssertionError(f"18a: serving launched flash kernels "
                             f"{launches} (decode and prefill attend "
                             "densely)")
    parts = eng.time_breakdown
    attributed = sum(parts.values())
    ttft = [r.first_token_time - r.arrival for r in reqs]
    itl = [b - a for r in reqs for a, b in zip(r.token_times,
                                               r.token_times[1:])]
    n_decode = sum(len(r.generated) - 1 for r in served)
    n_prefill = eng.prompt_tokens - eng.cached_prefill_tokens
    print(f"  18a {len(reqs)} requests (+1 fork) of {s['new']} tokens, "
          f"prompts {min(len(r.prompt) for r in reqs)}-"
          f"{max(len(r.prompt) for r in reqs)}: wall {wall:.3f} s, "
          f"{eng.dispatches['prefill']} prefill chunks, "
          f"{eng.dispatches['decode']} decode steps, "
          f"{eng.dispatches['fork']} fork(s)")
    print(f"  18a TTFT p50 {1e3 * _pct(ttft, 50):.1f} ms p99 "
          f"{1e3 * _pct(ttft, 99):.1f} ms; inter-token p50 "
          f"{1e3 * _pct(itl, 50):.2f} ms p99 {1e3 * _pct(itl, 99):.2f} ms")
    metrics = dict(decode_tok_s=n_decode / parts["decode"],
                   itl_p50_ms=1e3 * _pct(itl, 50),
                   itl_p99_ms=1e3 * _pct(itl, 99))
    print(f"  18a decode {n_decode / parts['decode']:.1f} tokens/s, "
          f"prefill {n_prefill / parts['prefill']:.1f} tokens/s; "
          f"cached-prefill fraction "
          f"{eng.cached_prefill_tokens / eng.prompt_tokens:.4f} "
          f"({eng.cached_prefill_tokens} of {eng.prompt_tokens})")
    rounded = {k: round(v, 4) for k, v in parts.items()}
    print(f"  18a time_breakdown {rounded}, sum {attributed:.4f} s against "
          f"wall {wall:.4f} s; peak device memory {peak / 2**30:.2f} GiB")
    print(f"  {card}")
    if abs(attributed - wall) > 0.02 * wall:
        raise AssertionError(f"18a: time_breakdown sums {attributed} s of "
                             f"a {wall} s wall")
    if reqs[1].cached_prompt_tokens != s["prefix"] or \
            eng.dispatches["fork"] < 1:
        raise AssertionError(f"18a: the prefix pair cached "
                             f"{reqs[1].cached_prompt_tokens} tokens, "
                             f"{eng.dispatches['fork']} forks")
    exact = tolerated = 0
    worst = 0.0
    for r in served:
        if r.sampling.temperature > 0:
            continue
        e, t, w = _teacher_forced(torch, model, r.prompt, r.generated)
        exact, tolerated, worst = exact + e, tolerated + t, max(worst, w)
    print(f"  18a greedy tokens against the teacher-forced oracle: {exact} "
          f"its argmax, {tolerated} within one bf16 step of its top "
          f"(largest gap {worst:.3g} of max|logit|)")
    eng.prefix_cache.clear()
    for r in reqs:
        if r.sampling.temperature > 0:
            alone = eng.submit(request(r.id))
            _drive_engine(eng, [alone])
            served.append(alone)
            eng.prefix_cache.clear()
            if alone.generated != r.generated:
                raise AssertionError(f"18a: seeded request {r.id} alone "
                                     f"{alone.generated} in the batch "
                                     f"{r.generated}")
    seeded = [r.id for r in reqs if r.sampling.temperature > 0]
    print(f"  18a seeded streams {seeded} bit for bit alone as in the "
          "batch")
    streams = {r.id: r.generated for r in reqs + [fork]}
    # where a decode step's time goes: all slots decoding, 3 steps timed,
    # then one under the profiler
    busy = [eng.submit(engine_lib.Request(
        specs[i][0][:s["chunk"]], 16, request_id=f"busy{i}"))
        for i in range(s["slots"])]
    while not all(r.state == "decode" for r in busy):
        eng.step()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        eng.step()
        times.append(time.perf_counter() - t0)
    decode_ms = 1e3 * float(np.median(times))
    print(f"  18a a decode step with {s['slots']} slots busy: "
          f"{[round(1e3 * t, 2) for t in times]} ms")
    profile_step(torch, eng.step, decode_ms)
    ops = _op_count(torch, eng.step)
    print(f"  18a {ops} aten operations a decode step: "
          f"{1e3 * decode_ms / ops:.1f} us of the step each")
    _drive_engine(eng, busy)
    served += busy

    # -- 18b: two replicas on the card, half the pool each; one evicted --
    half = kvcache.KVCacheConfig(
        num_blocks=(s["blocks"] - 1) // 2 + 1, block_size=s["block"],
        num_layers=cfg.num_layers, num_heads=cfg.num_heads,
        head_dim=cfg.d_model // cfg.num_heads, max_blocks_per_seq=mbps,
        dtype=cfg.dtype)
    freg = MetricsRegistry()
    router = FleetRouter(registry=freg, grace=5.0)
    for i in range(2):
        router.add_replica(f"r{i}", engine_lib.ServeEngine(
            model, params, half, device=dev, max_slots=s["slots"],
            prefill_chunk=s["chunk"], registry=freg, name=f"r{i}",
            weights_version=loaded), env={})
    router.start()
    try:
        freqs = [router.generate(specs[i][0], s["new"], sampling=(
            SamplingParams(**specs[i][1]) if specs[i][1] else None))
            for i in range(s["requests"])]
        deadline = time.monotonic() + 120
        while not any(r.replica == "r0" and 0 < len(r.generated) < s["new"]
                      for r in freqs):
            if time.monotonic() > deadline:
                raise AssertionError("18b: no stream in flight on r0")
            time.sleep(0.001)
        t_evict = time.monotonic()
        router.evict("r0")
        outs = [r.result(timeout=300) for r in freqs]
    finally:
        router.stop()
    hopped = [r for r in freqs if r.hops]
    lost = []
    for r in hopped:
        after = [t for t in r.token_times if t > t_evict]
        before = [t for t in r.token_times if t <= t_evict]
        if after and before:
            lost.append(after[0] - before[-1])
    print(f"  18b 2 replicas x {half.num_blocks} blocks "
          f"({half.pool_bytes():,} bytes each): {router.redispatched} "
          f"re-dispatch(es), {router.dropped} dropped; the cut streams "
          f"lost {[round(x, 4) for x in lost]} s between their tokens "
          f"around the eviction")
    if router.dropped or not router.redispatched:
        raise AssertionError(f"18b: dropped {router.dropped}, re-dispatched "
                             f"{router.redispatched}")
    for i, out in enumerate(outs):
        if out != streams[i]:
            raise AssertionError(f"18b: request {i} ({freqs[i].hops} "
                                 f"hops) {out} against 18a's {streams[i]}")
    print(f"  18b every stream ({len(outs)}, {len(hopped)} hopped) equals "
          "18a's")

    # -- 18c: one request over HTTP; /metrics against what was served ----
    server = ServeServer(eng, port=0)
    port = server.start()
    eng.start()
    try:
        body = json.dumps({"tokens": specs[4][0],
                           "max_new_tokens": s["new"]}).encode()
        with urlreq.urlopen(urlreq.Request(
                f"http://127.0.0.1:{port}/generate", data=body,
                headers={"Content-Type": "application/json"}),
                timeout=120) as resp:
            lines = [json.loads(ln) for ln in resp]
        _, scrape = _scrape(port, "/metrics")
    finally:
        server.stop()
        eng.stop()
    toks = [ln["token"] for ln in lines if "token" in ln]
    if toks != streams[4] or lines[-1].get("tokens") != streams[4]:
        raise AssertionError(f"18c: /generate streamed {toks}, the engine "
                             f"{streams[4]}")
    n_req = len(served) + 1
    n_tok = sum(len(r.generated) for r in served) + len(toks)
    got = (_metric(scrape, "hvd_serve_tokens_total"),
           _metric(scrape, "hvd_serve_requests_total",
                   'event="completed"'),
           _metric(scrape, "hvd_serve_ttft_seconds_count"))
    if got != (n_tok, n_req, n_req):
        raise AssertionError(f"18c: /metrics tokens, completed, TTFT count "
                             f"{got}, served {(n_tok, n_req, n_req)}")
    print(f"  18c /generate streamed request 4's {len(toks)} tokens as the "
          f"engine did; /metrics counts {n_tok} tokens, {n_req} completed "
          "requests, as served")
    del eng, model, params
    _free(torch)
    hvd.shutdown()
    return streams, metrics


def phase_timer_tuner(hvd, fa, torch, dev, bench, rows, phase5_tok_s):
    """19a: the slope-window timer over phase 5's LM step and over K1 at
    the main shape; 19b: the fusion autotuner over the step's gradients
    at world 1. Returns 19a's launches of the LM step."""
    from horovod_tpu_torch import basics
    print(f"== phase 19a: slope_window (iters {SLOPE['iters']}, "
          f"{SLOPE['rounds']} rounds) over phase 5's LM step, and over K1")
    hvd.init()
    step, model, opt, tokens = _lm_bench(bench, torch, seq_len=LM["seq_len"])
    step(tokens)  # the first step's warm-up, outside the windows
    bench.sync()

    def lm_once(n):
        return n + 1, step(tokens)

    fa.reset_launches()
    print(f"  19a card before the window (SM clock, power, temperature): "
          f"{clocks_line()}")
    dt, steps = bench.slope_window(lm_once, 0, SLOPE["iters"],
                                   rounds=SLOPE["rounds"])
    print(f"  19a card after the window: {clocks_line()}")
    _want_launches(fa, "19a", LM["layers"] * steps)
    launches = dict(fa.LAUNCHES)
    slope_ms = 1e3 * float(dt) / SLOPE["iters"]
    host_ms = LM["batch"] * LM["seq_len"] / phase5_tok_s * 1e3
    print(f"  19a {steps} steps: slope {slope_ms:.2f} ms a step against "
          f"phase 5's host-clock median {host_ms:.2f} ms "
          f"({slope_ms / host_ms:.3f}x); upper_bound {dt.upper_bound}, "
          f"asymmetric {dt.asymmetric}")
    if dt.upper_bound:
        raise AssertionError(f"19a: the slope window over the LM step is an "
                             f"upper bound ({float(dt)} s)")

    b, h, s = LM["batch"], LM["heads"], LM["seq_len"]
    d = LM["d_model"] // h
    gen = torch.Generator().manual_seed(1)
    q, k, v = (_rand((b * h, s, d), torch.bfloat16, gen, dev)
               for _ in range(3))
    kw = dict(causal=True, sm_scale=1.0 / d ** 0.5)

    def k1_once(n):
        return n + 1, fa.flash_fwd(q, k, v, **kw)[0]

    k1, _ = bench.slope_window(k1_once, 0, K1_SLOPE_ITERS)
    k1_ms = 1e3 * float(k1) / K1_SLOPE_ITERS
    print(f"  19a K1 [{b * h}, {s}, {d}] bf16 causal: slope {k1_ms:.4f} ms "
          f"a call ({K1_SLOPE_ITERS} iters) against 3b's CUDA events "
          f"{rows['fwd']['ms']:.4f} ms; upper_bound {k1.upper_bound}, "
          f"asymmetric {k1.asymmetric}")
    del q, k, v

    print(f"== phase 19b: autotune_fusion_threshold over the step's "
          f"gradients, wires {TUNE_WIRES}, world 1 on NCCL")
    grads = [p.grad for p in opt.params if p.grad is not None]
    cfg = basics._state.config
    before = (cfg.fusion_threshold, cfg.wire_dtype)
    t = time.perf_counter()
    best, timings = hvd.autotune_fusion_threshold(
        grads, wire_candidates=TUNE_WIRES)
    secs = time.perf_counter() - t
    after = (cfg.fusion_threshold, cfg.wire_dtype)
    print(f"  19b {len(grads)} gradients, "
          f"{sum(g.numel() * g.element_size() for g in grads) / 1e6:.1f} MB "
          f"on {grads[0].device}: returned {best!r}, {dict(timings)} in "
          f"{secs * 1e3:.2f} ms; reason: {timings.abstain_reason}")
    print(f"  19b config (fusion_threshold, wire_dtype) before {before}, "
          f"after {after}")
    if best is not None or dict(timings) or \
            timings.abstain_reason != WORLD_ONE_REASON or after != before:
        raise AssertionError(f"19b: at world 1 the tuner returned {best!r}, "
                             f"{dict(timings)}, {timings.abstain_reason!r}; "
                             f"config {before} -> {after}")
    del step, model, opt, tokens, grads
    _free(torch)
    hvd.shutdown()
    return launches


# 19c's subprocess: the lint CLI and the trend tool, each run as
# ``python -m`` runs it; then no JAX in the process
_TOOLS_PROBE = """
import contextlib, io, json, runpy, sys

def run(mod, argv):
    sys.argv = [mod] + argv
    out, err = io.StringIO(), io.StringIO()
    code = 0
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            runpy.run_module(mod, run_name="__main__", alter_sys=True)
        except SystemExit as e:
            code = e.code
    return code, out.getvalue(), err.getvalue()

root, targets = sys.argv[1], sys.argv[2:]
lint = run("horovod_tpu_torch.analysis.cli", ["--root", root] + targets)
trend = run("horovod_tpu_torch.telemetry.trend", [root, "--json"])
report = json.loads(trend[1]) if trend[0] in (0, 1) else {}
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "horovod_tpu"))
assert not bad, bad
print(json.dumps(dict(
    lint_rc=lint[0], lint_tail=(lint[1].strip().splitlines() or [""])[-1],
    lint_err=lint[2][-2000:], trend_rc=trend[0],
    rows=len(report.get("metrics", {})),
    rounds=len(report.get("rounds", [])), trend_err=trend[2][-300:])))
"""


# 19c's scripts of the checkout: each runs as a file, as its ``#!`` line
# runs it, in a process where the modules named in argv[1] cannot be
# imported (``None`` in ``sys.modules``)
_BLOCKED_RUN = """
import runpy, sys
for name in sys.argv[1].split(","):
    sys.modules[name] = None
sys.argv = sys.argv[2:]
runpy.run_path(sys.argv[0], run_name="__main__")
"""
NO_JAX = ("jax", "jaxlib", "flax", "optax", "horovod_tpu")


def start_script(name, args, blocked=NO_JAX):
    """``bin/<name> args`` from the checkout, with nothing installed and
    the modules ``blocked`` unimportable; returns the running process
    (text pipes)."""
    return subprocess.Popen(
        [sys.executable, "-c", _BLOCKED_RUN, ",".join(blocked),
         str(ROOT / "bin" / name), *args], cwd=ROOT, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def _tail(text):
    return (text.strip().splitlines() or [""])[-1]


def phase_tools(doctor_16c):
    """19c: hvd-lint-torch over the port's tree and the trend tool over
    the repo's rounds, in a subprocess that must not import JAX; beside
    it the checkout's ``bin/`` scripts with JAX unimportable:
    ``hvd-lint-torch`` as the ``python -m`` run, ``hvdrun-torch
    --check-build``, and ``hvd-doctor-torch --json`` over 16c's dumps
    (``doctor_16c``, ``phase_telemetry``'s report)."""
    import os
    print("== phase 19c: python -m horovod_tpu_torch.analysis.cli and "
          "python -m horovod_tpu_torch.telemetry.trend in a subprocess; "
          "bin/hvd-lint-torch, bin/hvdrun-torch and bin/hvd-doctor-torch "
          "with jax and horovod_tpu unimportable")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    t = time.perf_counter()
    scripts = {
        "lint": start_script("hvd-lint-torch", [
            "--root", str(ROOT), *(LINT_TARGETS or [])]),
        "check": start_script("hvdrun-torch", ["--check-build"]),
        "doctor": start_script("hvd-doctor-torch",
                               [doctor_16c["dir"], "--json"])}
    try:
        rv = subprocess.run(
            [sys.executable, "-c", _TOOLS_PROBE, str(ROOT),
             *(LINT_TARGETS or [])], cwd=ROOT, env=env, capture_output=True,
            text=True, timeout=300)
        done = {k: (*p.communicate(timeout=300), p.returncode)
                for k, p in scripts.items()}
    finally:
        for p in scripts.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    secs = time.perf_counter() - t
    if rv.returncode != 0:
        raise AssertionError(f"19c: the tools' subprocess exited "
                             f"{rv.returncode}:\n{rv.stderr[-4000:]}")
    res = json.loads(rv.stdout.strip().splitlines()[-1])
    print(f"  19c hvd-lint-torch exit {res['lint_rc']}: {res['lint_tail']}")
    print(f"  19c trend exit {res['trend_rc']}: {res['rows']} rows over "
          f"{res['rounds']} rounds; no jax or horovod_tpu imported; "
          f"{secs:.1f} s")
    if res["lint_rc"] != 0:
        raise AssertionError(f"19c: hvd-lint-torch exited {res['lint_rc']}:"
                             f" {res['lint_tail']}\n{res['lint_err']}")
    if res["trend_rc"] not in (0, 1) or not res["rows"]:
        raise AssertionError(f"19c: the trend tool exited {res['trend_rc']} "
                             f"with {res['rows']} rows: {res['trend_err']}")
    out, err, rc = done["lint"]
    print(f"  19c bin/hvd-lint-torch exit {rc}: {_tail(out)}")
    if (rc, _tail(out)) != (res["lint_rc"], res["lint_tail"]):
        raise AssertionError(f"19c: bin/hvd-lint-torch exited {rc} with "
                             f"{_tail(out)!r}; python -m exited "
                             f"{res['lint_rc']} with {res['lint_tail']!r}"
                             f"\n{err[-2000:]}")
    out, err, rc = done["check"]
    core = "[X] TCP (native host core)"
    print(f"  19c bin/hvdrun-torch --check-build exit {rc}: "
          f"{core if core in out else 'no native core listed'}")
    if rc != 0 or core not in out:
        raise AssertionError(f"19c: bin/hvdrun-torch --check-build exited "
                             f"{rc}:\n{out}\n{err[-2000:]}")
    out, err, rc = done["doctor"]
    report = json.loads(out) if rc == 0 else {}
    ev = (report.get("per_rank", {}).get("0") or {}).get("last_event")
    want = json.loads(json.dumps(doctor_16c["last_event"], sort_keys=True,
                                 default=str))
    print(f"  19c bin/hvd-doctor-torch over 16c's dumps exit {rc}: "
          f"{report.get('classification')}, last event {ev}")
    if report.get("classification") != doctor_16c["classification"] or \
            ev != want:
        raise AssertionError(f"19c: bin/hvd-doctor-torch exited {rc}, says "
                             f"{report.get('classification')} at {ev}; 16c "
                             f"said {doctor_16c['classification']} at {want}"
                             f"\n{err[-2000:]}")


def _grad_norm_check(name, torch, step, opt):
    """The step's last ``hvd_grad_norm`` against an fp64 norm of the
    gradients it left in ``.grad``: with plain data parallelism those
    are the reduced global-mean gradients the norm is defined over. fp32
    sums over 134 M elements in another order: rtol 1e-5."""
    got = step.instruments.grad_norm.value
    want = float(torch.linalg.vector_norm(torch.cat(
        [p.grad.detach().double().reshape(-1) for p in opt.params])))
    print(f"  {name} hvd_grad_norm {got:.6f}, fp64 norm of the reduced "
          f"gradients {want:.6f}")
    if not abs(got - want) <= 1e-5 * want:
        raise AssertionError(f"{name}: hvd_grad_norm {got} against the "
                             f"reduced gradients' norm {want}")


def _launched_in(trace, ranges):
    """The correlation ids of the work launched on the host inside a
    profiler range named in ``ranges`` (``{range name: layer}``), or by
    the backward of an op run inside one: ``{correlation: layer}``. A
    launch is inside a range when it falls in the range's interval on the
    same host thread."""
    events = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    spans = [(e["tid"], e["ts"], e["ts"] + e["dur"], ranges[e["name"]])
             for e in events if e.get("cat") == "user_annotation"
             and e.get("name") in ranges]

    def seq(e):
        return e.get("args", {}).get("Sequence number")

    # an op run inside a range is the range's in backward too: the
    # autograd engine's evaluate_function event carries its sequence
    # number, on the engine's thread
    layer_of = {}
    for e in events:
        if e.get("cat") == "cpu_op" and seq(e) is not None:
            for tid, lo, hi, layer in spans:
                if e["tid"] == tid and lo <= e["ts"] <= hi:
                    layer_of[seq(e)] = layer
                    break
    spans += [(e["tid"], e["ts"], e["ts"] + e["dur"], layer_of[seq(e)])
              for e in events if e.get("cat") == "cpu_op"
              and e.get("name", "").startswith(
                  "autograd::engine::evaluate_function")
              and seq(e) in layer_of]
    out = {}
    for e in events:
        # cuBLAS launches through the driver API, the rest the runtime's
        if e.get("cat") not in ("cuda_runtime", "cuda_driver"):
            continue
        for tid, lo, hi, layer in spans:
            if e["tid"] == tid and lo <= e["ts"] <= hi:
                out[e.get("args", {}).get("correlation")] = layer
                break
    return out


def _union_ms(work):
    """Milliseconds covered by the union of ``work``'s intervals (tuples
    starting ``(ts, dur)`` in microseconds, sorted by ``ts``): overlaps
    counted once."""
    busy, end = 0.0, -math.inf
    for ts, dur, *_ in work:
        busy += max(0.0, ts + dur - max(ts, end))
        end = max(end, ts + dur)
    return busy / 1e3


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
    busy = _union_ms(work)
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


def phase_zero_mesh(hvd, fa, torch, bench, losses_6b):
    """20a: 6b's configuration (2 microbatches, the overlapped pipeline,
    ZeRO-1) built with ``DistributedOptimizer(axes=("data",),
    sharded_update=True)`` on a (data 1, model 1) mesh, in turns with 6b
    itself on ``init()``'s mesh: every turn's losses bit for bit phase
    6's 6b, K1-K3 once a layer, microbatch and step; the last turn's
    state saved and restored into a fresh model, optimizer and step,
    whose next loss is the unbroken run's bit for bit. Returns the 20a
    turns' launches."""
    import gc
    import tempfile
    from horovod_tpu_torch import basics, ckpt, convert, training
    from horovod_tpu_torch.parallel import mesh as mesh_lib
    print("== phase 20a: 6b's LM with ZeRO-1 over ('data',) on a "
          "(data 1, model 1) mesh, in turns with 6b")
    hvd.init()
    flat = basics._state.mesh  # init()'s 1-D mesh
    part = mesh_lib.build_mesh((1, 1), ("data", "model"))
    layers, seq = LM["layers"], LM["seq_len"]
    turns = {"6b": [], "20a": []}
    launches = {"fwd": 0, "dq": 0, "dkv": 0}
    order = ("6b", "20a", "6b", "20a")
    for n, label in enumerate(order):
        gc.collect()
        torch.cuda.empty_cache()
        on_part = label == "20a"
        mesh_lib.set_mesh(part if on_part else flat)
        # the bench's own LM step is dropped at once: it holds the model,
        # which would outlive the turn into the next one's peak
        _, model, opt, tokens = _lm_bench(
            bench, torch, seq_len=seq + 1, sharded_update=True,
            mesh=part if on_part else None)
        del _
        rows = opt.zero_state.plan.schedule
        if on_part and (opt.axes != ("data",) or rows.world != 1):
            raise AssertionError(f"20a: the optimizer reduces over "
                                 f"{opt.axes}, rows of world {rows.world}")
        step = training.make_train_step(model, opt, accum_steps=2,
                                        overlap_grads=True)
        batch = (tokens[:, :seq], tokens[:, 1:seq + 1])
        got, counted, step_ms = _drive(
            f"20a turn {n + 1} ({label})", hvd, fa, torch, bench, step,
            batch, 2 * layers * STEPS, LM["batch"] * seq,
            lambda: (f"ZeRO-1 over {opt.axes or 'the data axes'} on "
                     f"{mesh_lib.get_mesh().axis_names}; "
                     f"{_schedule_line(step.schedule)}"))
        peak = torch.cuda.max_memory_allocated()
        if got != losses_6b:
            raise AssertionError(f"20a turn {n + 1} ({label}): losses {got} "
                                 f"against 6b's {losses_6b}")
        turns[label].append((step_ms, peak))
        if on_part:
            for k in launches:
                launches[k] += counted[k]
        if n == len(order) - 1:
            with tempfile.TemporaryDirectory() as root:
                ckpt.save_sharded(root, STEPS, convert.train_state_to_flat(
                    model, opt, step.state))
                want = float(step(*batch))
                del step, model, opt
                gc.collect()
                torch.cuda.empty_cache()
                _, model, opt, _ = _lm_bench(bench, torch, seq_len=seq + 1,
                                             sharded_update=True, mesh=part)
                del _
                step = training.make_train_step(model, opt, accum_steps=2,
                                                overlap_grads=True)
                _, restored, _ = ckpt.restore_sharded(
                    root, convert.train_state_to_flat(model, opt,
                                                      step.state))
                convert.train_state_from_flat(model, opt, step.state,
                                              restored)
                got_next = float(step(*batch))
            if got_next != want:
                raise AssertionError(f"20a: the restored state's next loss "
                                     f"{got_next}, the unbroken run's {want}")
            print(f"  20a saved at step {STEPS}, restored into a fresh "
                  f"model, optimizer and step: next loss {got_next!r} bit "
                  "for bit the unbroken run's")
        del step, model, opt, tokens, batch
    ntok = LM["batch"] * seq
    for label, runs in turns.items():
        ms = [t for t, _ in runs]
        print(f"  20a {label} turns: step ms {[round(t, 2) for t in ms]}, "
              f"tokens/s {[round(ntok / t * 1e3) for t in ms]}, peak "
              f"{[round(p / 2**30, 3) for _, p in runs]} GiB")
    ratio = np.median([t for t, _ in turns["20a"]]) / np.median(
        [t for t, _ in turns["6b"]])
    print(f"  20a against 6b in turns: step time {ratio:.4f}x; losses bit "
          f"for bit 6b's in every turn")
    hvd.shutdown()
    return launches


def serve_rank(path):
    """One rank of 20b (``chip_smoke.py --serve-rank CONFIG``): ``init()``
    over gloo, phase 18's LM loaded params-only from its manifest onto
    the configured device, one ``ServeEngine`` over the 2 ranks (8
    slots, 4 a rank). Rank 0 drives 8 of 18a's requests (the shared
    prefix, the fork, one sampled) and stops the engine; rank 1 follows.
    Each writes its streams, its decode rows, a digest of its pool and
    its block tables, and rank 0 its figures, to ``rank<r>.json``."""
    import hashlib
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.transformer import (Transformer,
                                                      TransformerConfig)
    from horovod_tpu_torch.serve import engine as engine_lib
    from horovod_tpu_torch.serve import kvcache, loader
    from horovod_tpu_torch.serve.sampling import SamplingParams
    from horovod_tpu_torch.telemetry.registry import MetricsRegistry
    with open(path) as f:
        c = json.load(f)
    # the caller's settings, which _serve_requests reads too
    SERVE.update(c["serve"])
    LM.update(c["lm"])
    s, lm = SERVE, LM
    hvd.init(device="cpu")
    dev = torch.device(c["device"])
    cfg = TransformerConfig(vocab_size=lm["vocab"], num_layers=lm["layers"],
                            num_heads=lm["heads"], d_model=lm["d_model"],
                            d_ff=4 * lm["d_model"], dtype=torch.bfloat16,
                            flash_attention=True)
    model = Transformer(cfg, device=dev)
    t0 = time.perf_counter()
    loaded, params, _ = loader.load_params(c["root"],
                                           loader.abstract_params(model))
    t_load = time.perf_counter() - t0
    kv = kvcache.KVCacheConfig(
        num_blocks=s["blocks"], block_size=s["block"],
        num_layers=cfg.num_layers, num_heads=cfg.num_heads,
        head_dim=cfg.d_model // cfg.num_heads,
        max_blocks_per_seq=-(-s["max_seq_len"] // s["block"]),
        dtype=cfg.dtype)
    eng = engine_lib.ServeEngine(
        model, params, kv, mesh=hvd.mesh(), device=dev,
        max_slots=s["slots"], prefill_chunk=s["chunk"],
        registry=MetricsRegistry(), weights_version=loaded)
    out = {"rank": hvd.rank(), "rows": [eng._rows.start, eng._rows.stop],
           "load_s": t_load}
    if hvd.rank() == 0:
        specs = _serve_requests(np.random.default_rng(18), cfg.vocab_size)

        def request(i, **kw):
            p, skw = specs[i]
            return engine_lib.Request(
                p, s["new"], request_id=i,
                sampling=SamplingParams(**skw) if skw else None, **kw)

        first = eng.submit(request(0))
        t_start = first.arrival
        while first.state not in ("decode", "done"):
            eng.step()
        reqs = [first, eng.submit(request(1)),
                eng.submit(engine_lib.Request(specs[0][0], s["new"],
                                              request_id="fork")),
                eng.submit(request(2))]
        reqs += [eng.submit(request(i)) for i in range(4, 8)]
        _drive_engine(eng, reqs)
        wall = eng._clock() - t_start
        eng.stop()
        parts = eng.time_breakdown
        itl = [b - a for r in reqs for a, b in zip(r.token_times,
                                                   r.token_times[1:])]
        out.update(
            wall=wall, decode_steps=eng.dispatches["decode"],
            forks=eng.dispatches["fork"],
            decode_tok_s=sum(len(r.generated) - 1 for r in reqs)
            / parts["decode"],
            itl_p50_ms=1e3 * _pct(itl, 50), itl_p99_ms=1e3 * _pct(itl, 99),
            exchange_share=eng.exchange_seconds / parts["decode"],
            sampled=[r.id for r in reqs if r.sampling.temperature > 0],
            cached=reqs[1].cached_prompt_tokens)
    else:
        reqs = []
        eng.follow(on_request=reqs.append)
        out["exchange_s"] = eng.exchange_seconds
    out["streams"] = {str(r.id): r.generated for r in reqs}
    out["prompts"] = {str(r.id): r.prompt for r in reqs}
    if dev.type == "cuda":
        torch.cuda.synchronize()
    digest = hashlib.sha256()
    for name in ("k", "v"):
        digest.update(eng._pool[name].contiguous().view(torch.uint8)
                      .cpu().numpy().tobytes())
    out["pool"] = digest.hexdigest()
    out["tables"] = eng._tables.tolist()
    with open(os.path.join(c["out"], f"rank{hvd.rank()}.json"), "w") as f:
        json.dump(out, f)
    hvd.shutdown()
    return 0


def phase_serve_mesh(torch, root, streams18, metrics18, card,
                     device="cuda:0"):
    """20b: the serve engine over 2 gloo ranks sharing the card
    (``serve_rank``), against 18a's one-rank engine: the ranks' streams,
    pools and tables equal; each greedy token the teacher-forced
    oracle's argmax or within one bf16 step of its top; the sampled
    stream bit for bit 18a's. Reports decode tokens/s, inter-token p50
    and p99 and the exchange's share of the decode time beside 18a's."""
    import shutil
    import socket
    import tempfile
    from horovod_tpu_torch import convert
    from horovod_tpu_torch.models.transformer import (Transformer,
                                                      TransformerConfig)
    from horovod_tpu_torch.serve import loader
    print("== phase 20b: the serve engine over 2 gloo ranks on the card "
          "(4 + 4 slots, the pool replicated)")
    print(f"  {card}")
    work = tempfile.mkdtemp(prefix="serve_mesh_")
    try:
        config = os.path.join(work, "config.json")
        with open(config, "w") as f:
            json.dump(dict(root=root, device=device, serve=SERVE, lm=LM,
                           out=work), f)
        with socket.socket() as sk:
            sk.bind(("127.0.0.1", 0))
            port = sk.getsockname()[1]
        t0 = time.perf_counter()
        procs = []
        for r in range(2):
            env = dict(os.environ, HOROVOD_RANK=str(r), HOROVOD_SIZE="2",
                       HOROVOD_LOCAL_RANK=str(r), HOROVOD_LOCAL_SIZE="2",
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                       # the host's cores shared by two ranks
                       OMP_NUM_THREADS=str(max(1, (os.cpu_count() or 2)
                                               // 2)))
            log = open(os.path.join(work, f"rank{r}.log"), "w")
            procs.append((subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"),
                 "--serve-rank", config], env=env, stdout=log,
                stderr=subprocess.STDOUT, cwd=str(ROOT)), log))
        try:
            for r, (p, log) in enumerate(procs):
                rc = p.wait(timeout=400)
                log.close()
                if rc:
                    with open(os.path.join(work, f"rank{r}.log")) as f:
                        tail = f.read()[-3000:]
                    raise AssertionError(f"20b: rank {r} exited {rc}:\n{tail}")
        finally:
            for p, log in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
                log.close()
        took = time.perf_counter() - t0
        outs = []
        for r in range(2):
            with open(os.path.join(work, f"rank{r}.json")) as f:
                outs.append(json.load(f))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    lead, other = outs
    print(f"  20b two worker processes in {took:.1f} s (start, params-only "
          f"load {lead['load_s']:.2f} / {other['load_s']:.2f} s, drive); "
          f"decode rows {lead['rows']} and {other['rows']}")
    if lead["streams"] != other["streams"]:
        raise AssertionError("20b: the ranks' streams differ")
    if lead["pool"] != other["pool"] or lead["tables"] != other["tables"]:
        raise AssertionError("20b: the ranks' pools or block tables differ")
    if lead["forks"] < 1 or lead["cached"] != SERVE["prefix"]:
        raise AssertionError(f"20b: {lead['forks']} forks, the prefix pair "
                             f"cached {lead['cached']} tokens")
    print(f"  20b the ranks' {len(lead['streams'])} streams equal token for "
          f"token; pools and block tables equal bit for bit (sha256 "
          f"{lead['pool'][:16]}); {lead['forks']} fork(s), the prefix pair "
          f"cached {lead['cached']} tokens")
    for i in lead["sampled"]:
        if lead["streams"][str(i)] != streams18[i]:
            raise AssertionError(f"20b: sampled request {i} "
                                 f"{lead['streams'][str(i)]}, 18a's "
                                 f"{streams18[i]}")
    print(f"  20b sampled request(s) {lead['sampled']} bit for bit 18a's "
          "one-rank stream")
    cfg = TransformerConfig(vocab_size=LM["vocab"], num_layers=LM["layers"],
                            num_heads=LM["heads"], d_model=LM["d_model"],
                            d_ff=4 * LM["d_model"], dtype=torch.bfloat16,
                            flash_attention=True)
    dev = torch.device(device)
    model = Transformer(cfg, device=dev)
    _, params, _ = loader.load_params(root, loader.abstract_params(model))
    model.load_state_dict(convert.params_from_flax(params, model))
    exact = tolerated = 0
    worst = 0.0
    for key, gen in lead["streams"].items():
        if key in {str(i) for i in lead["sampled"]}:
            continue
        e, t, w = _teacher_forced(torch, model, lead["prompts"][key], gen,
                                  label="20b")
        exact, tolerated, worst = exact + e, tolerated + t, max(worst, w)
    same = sum(lead["streams"][k] == streams18.get(
        int(k) if k.isdigit() else k) for k in lead["streams"])
    print(f"  20b greedy tokens against the teacher-forced oracle: {exact} "
          f"its argmax, {tolerated} within one bf16 step of its top "
          f"(largest gap {worst:.3g} of max|logit|); {same} of "
          f"{len(lead['streams'])} streams equal 18a's")
    print(f"  20b decode {lead['decode_tok_s']:.1f} tokens/s (18a "
          f"{metrics18['decode_tok_s']:.1f}), inter-token p50 "
          f"{lead['itl_p50_ms']:.2f} ms p99 {lead['itl_p99_ms']:.2f} ms "
          f"(18a {metrics18['itl_p50_ms']:.2f}, "
          f"{metrics18['itl_p99_ms']:.2f}); the token and K/V exchange "
          f"{100 * lead['exchange_share']:.1f} % of rank 0's decode time "
          f"({lead['decode_steps']} decode steps, wall "
          f"{lead['wall']:.3f} s)")
    print(f"  {card}")
    del model, params
    _free(torch)


def _native_batch(torch, rank, dev):
    """Rank ``rank``'s ``NATIVE["batch"]`` sequences, drawn from the seed
    plus the rank as phase 5's are."""
    rng = np.random.default_rng(rank)
    return torch.from_numpy(rng.integers(
        0, LM["vocab"], size=(NATIVE["batch"], LM["seq_len"])).astype(
            np.int64)).to(dev)


def _native_loss(model, tokens):
    from horovod_tpu_torch import training
    return training.softmax_cross_entropy(model(tokens)[:, :-1],
                                          tokens[:, 1:])


def _native_collectives(torch, hvd, core, rank, dev):
    """21b's host collectives over the 2 ranks on seeded arrays, card
    tensors through the classic API and host arrays through the core,
    each result held to numpy's bytes (Adasum to numpy's within its
    tolerance). Returns the checks' names."""
    done = []

    def same(label, got, want, on=dev):
        if torch.is_tensor(got):
            if got.device != on:
                raise AssertionError(f"21b rank {rank}: {label} came back "
                                     f"on {got.device}")
            got = got.cpu().numpy()
        if got.shape != want.shape or got.tobytes() != want.tobytes():
            raise AssertionError(f"21b rank {rank}: {label} differs from "
                                 "numpy")
        done.append(label)

    xs = [np.random.default_rng(2100 + k).standard_normal((5, 3)).astype(
        np.float32) for k in range(2)]
    x = torch.from_numpy(xs[rank]).to(dev)
    total = xs[0] + xs[1]
    same("allreduce sum", hvd.allreduce(x, average=False, name="n.sum"),
         total)
    same("allreduce average", hvd.allreduce(x, name="n.avg"),
         total * np.float32(0.5))
    same("allreduce min", hvd.allreduce(x, op=hvd.Min, name="n.min"),
         np.minimum(*xs))
    same("allreduce max", hvd.allreduce(x, op=hvd.Max, name="n.max"),
         np.maximum(*xs))
    y = x.clone()
    hvd.allreduce_(y, name="n.avg_")
    same("allreduce in place", y, total * np.float32(0.5))
    same("allreduce on the host", hvd.allreduce(x.cpu(), name="n.cpu"),
         total * np.float32(0.5), on=torch.device("cpu"))
    rows = [np.full((k + 1, 3), k + 0.5, np.float32) for k in range(2)]
    same("allgather of unequal rows", hvd.allgather(
        torch.from_numpy(rows[rank]).to(dev), name="n.ag"),
        np.concatenate(rows))
    # Adasum's combination of the 2 ranks' vectors, held as the core's own
    # tests hold it (tests/native_worker.py: rtol 1e-4, atol 1e-5): the
    # core's dot products run in another order than numpy's
    a, b = (v.ravel().astype(np.float64) for v in xs)
    dot, na, nb = a @ b, a @ a, b @ b
    want = ((1 - dot / (2 * na)) * a + (1 - dot / (2 * nb)) * b).reshape(
        xs[0].shape)
    got = hvd.allreduce(x, op=hvd.Adasum, name="n.adasum").cpu().numpy()
    if not np.allclose(got, want, rtol=1e-4, atol=1e-5):
        raise AssertionError(f"21b rank {rank}: Adasum off numpy's by "
                             f"{float(np.abs(got - want).max())}")
    done.append("Adasum (rtol 1e-4, atol 1e-5)")
    same("broadcast", hvd.broadcast(x, 1, name="n.bc"), xs[1])
    b = x.clone()
    hvd.broadcast_(b, 1, name="n.bc_")
    same("broadcast in place", b, xs[1])
    a2a = [np.arange(8, dtype=np.int64).reshape(4, 2) + 100 * k
           for k in range(2)]
    same("alltoall", hvd.alltoall(torch.from_numpy(a2a[rank]).to(dev),
                                  name="n.a2a"),
         np.concatenate([a[2 * rank:2 * rank + 2] for a in a2a]))
    rs = [np.random.default_rng(2200 + k).standard_normal((3, 4)).astype(
        np.float32) for k in range(2)]
    mine = slice(0, 2) if rank == 0 else slice(2, 3)  # 3 rows: 2 and 1
    same("reducescatter with a remainder",
         core.reducescatter(rs[rank], "n.rs", op="sum"),
         (rs[0] + rs[1])[mine])
    core.barrier()
    done.append("barrier")
    return done


def native_rank(path):
    """One rank of 21b (``chip_smoke.py --native-rank CONFIG`` under
    ``python -m horovod_tpu_torch.run -np 2``): ``init()`` (gloo on the
    host; no native core yet), the first collective, which starts the
    core, the host collectives, then the LM through the classic torch API
    on the configured card: rank 1 perturbed, the startup broadcasts,
    ``NATIVE["steps"]`` steps of ``DistributedOptimizer(AdamW)`` with
    ``broadcast_optimizer_state`` of rank 0's AdamW state over rank 1's
    drifted one after the first, an uneven Join. Writes its parameters to
    ``rank<r>.pt`` and its figures to ``rank<r>.json``."""
    import torch

    import horovod_tpu_torch.torch as hvd
    from horovod_tpu_torch import _core
    from horovod_tpu_torch.ops import flash_attention as fa
    with open(path) as f:
        c = json.load(f)
    LM.update(c["lm"])
    NATIVE.update(c["native"])
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    hvd.init(device="cpu")
    rank = hvd.rank()
    dev = torch.device(c["device"])
    out = {"rank": rank, "size": hvd.size(),
           "init_s": time.perf_counter() - t0,
           "started_s": time.time() - c["launched"]}
    if _core.is_initialized():
        raise AssertionError("21b: init() started the native core; the "
                             "first collective starts it")
    first = torch.zeros(1, device=dev)  # the card's context, untimed
    t0 = time.perf_counter()
    hvd.allreduce(first, name="n.first")
    out["core_start_s"] = time.perf_counter() - t0
    out["collectives"] = _native_collectives(torch, hvd, _core, rank, dev)
    model = _lm_full(torch, dev, layers=NATIVE["layers"])[1]
    if rank == 1:
        with torch.no_grad():
            for p in model.parameters():
                p.add_(1e-3)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    inner = _lm_adamw(torch, model.parameters())
    opt = hvd.DistributedOptimizer(inner,
                                   named_parameters=model.named_parameters())
    hvd.broadcast_optimizer_state(opt, root_rank=0)
    tokens = _native_batch(torch, rank, dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    # the host exchange's time: the hooks' staging and enqueues, and
    # step()'s wait and copies back (its inner AdamW step taken out)
    spent = {"hooks": 0.0, "inner": 0.0}
    fire, inner_step = opt._fire_allreduce, inner.step

    def timed_fire(p):
        t = time.perf_counter()
        handle = fire(p)
        spent["hooks"] += time.perf_counter() - t
        return handle

    def timed_inner(*a, **k):
        t = time.perf_counter()
        value = inner_step(*a, **k)
        sync()
        spent["inner"] += time.perf_counter() - t
        return value

    opt._fire_allreduce, inner.step = timed_fire, timed_inner
    fa.reset_launches()
    losses, steps = [], []
    for i in range(NATIVE["steps"]):
        if i == 1:
            # rank 1's AdamW state drifts; broadcast_optimizer_state
            # brings rank 0's back over the card's state
            if rank == 1:
                with torch.no_grad():
                    for st in inner.state.values():
                        for v in st.values():
                            v.add_(1.0)
            sync()
            t = time.perf_counter()
            hvd.broadcast_optimizer_state(opt, root_rank=0)
            sync()
            out["bos_ms"] = 1e3 * (time.perf_counter() - t)
            out["bos_mb"] = sum(v.numel() * v.element_size()
                                for st in inner.state.values()
                                for v in st.values()) / 1e6
        spent.update(hooks=0.0, inner=0.0)
        sync()
        t = time.perf_counter()
        opt.zero_grad()
        loss = _native_loss(model, tokens)
        loss.backward()
        t_step = time.perf_counter()
        opt.step()
        sync()
        end = time.perf_counter()
        losses.append(loss.item())
        steps.append(dict(ms=1e3 * (end - t), hooks_ms=1e3 * spent["hooks"],
                          wait_ms=1e3 * (end - t_step - spent["inner"])))
    out.update(launches=dict(fa.LAUNCHES), losses=losses, steps=steps)
    torch.save({k: v.detach().cpu() for k, v in model.named_parameters()},
               os.path.join(c["out"], f"rank{rank}.pt"))
    if rank == 1:
        # hvd-lint: disable=HVD-DESYNC -- an uneven Join: rank 0 joins while rank 1 reduces once more
        hvd.allreduce(torch.ones(4, device=dev), name="n.late")
    out["join"] = hvd.join()
    _core.barrier()
    with open(os.path.join(c["out"], f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    hvd.shutdown()
    return 0


def start_core_build():
    """Start building the native host core (``_core.build``, one ``g++``
    a source) on a thread, beside the kernels' build; returns a function
    that waits for it and returns ``(library, seconds, was_cached)``, or
    raises the build's error."""
    from horovod_tpu_torch import _core
    done = {}

    def build():
        t = time.perf_counter()
        done["cached"] = _core.library_path().exists()
        try:
            done["lib"] = _core.build()
        # hvd-lint: disable=HVD-EXCEPT -- kept for wait(), which re-raises it on the main thread
        except Exception as e:
            done["error"] = e
        done["s"] = time.perf_counter() - t

    thread = threading.Thread(target=build, name="core_build")
    thread.start()

    def wait():
        thread.join()
        if "error" in done:
            raise done["error"]
        return done["lib"], done["s"], done["cached"]
    return wait


def _native_reference(torch, device):
    """21b's one-process run on the card: both ranks' gradients with the
    same kernels, averaged as the 2-rank ring does (one fp32 add, then a
    halving), through the same AdamW. Returns its parameters (on the
    host) and each rank's losses."""
    dev = torch.device(device)
    model = _lm_full(torch, dev, layers=NATIVE["layers"])[1]
    opt = _lm_adamw(torch, model.parameters())
    batches = [_native_batch(torch, r, dev) for r in range(2)]
    losses = [[], []]
    for _ in range(NATIVE["steps"]):
        grads = []
        for r, tokens in enumerate(batches):
            model.zero_grad(set_to_none=True)
            loss = _native_loss(model, tokens)
            loss.backward()
            losses[r].append(loss.item())
            grads.append([p.grad for p in model.parameters()])
        for p, g0, g1 in zip(model.parameters(), *grads):
            p.grad = (g0 + g1) / 2
        opt.step()
    return ({k: v.detach().cpu() for k, v in model.named_parameters()},
            losses)


def _mapped_cores():
    """The native host cores' libraries this process maps."""
    with open("/proc/self/maps") as f:
        return sorted({line.split()[-1] for line in f
                       if "libhvdcore" in line})


def phase_native_core(torch, card, device="cuda:0", core_build=None):
    """21a: the native host core's build (``core_build``, from
    ``start_core_build``; started here if not given), ``--check-build``
    and the library this process maps. 21b: the classic torch API over 2
    ranks sharing the card (``native_rank``) against a one-process run
    that averages both ranks' gradients, computed while the ranks start.
    Returns the ranks' K1-K3 launches."""
    import shutil
    import tempfile

    from horovod_tpu_torch import _core
    print("== phase 21a: the native host core (cxx/ built by g++)")
    lib, secs, cached = (core_build or start_core_build())()
    print(f"  {'loaded a cached build' if cached else 'built'} in "
          f"{secs:.1f} s (beside the kernels' build) -> {lib}")
    rv, _ = _hvdrun_ok("21a --check-build", ["--check-build"], 300)
    for want in ("[X] TCP (native host core)",
                 "[X] host ring collectives (allreduce/allgatherv/broadcast/"
                 "alltoall/reducescatter/Adasum)"):
        if want not in rv.stdout:
            raise AssertionError(f"21a: --check-build lacks {want!r}:\n"
                                 f"{rv.stdout}")
        print(f"  --check-build: {want}")
    if not _core.core_available():
        raise AssertionError("21a: the native core is not available")
    mapped = _mapped_cores()
    if mapped != [str(lib)]:
        raise AssertionError(f"21a: mapped {mapped}, want only {lib}")
    print(f"  this process maps {mapped[0]}")

    print(f"== phase 21b: the classic torch API over 2 ranks on the card "
          f"(phase 5's LM at {NATIVE['layers']} layers, {NATIVE['batch']} "
          f"sequences a rank, {NATIVE['steps']} steps)")
    print(f"  {card}")
    work = tempfile.mkdtemp(prefix="native_core_")
    try:
        config = os.path.join(work, "config.json")
        with open(config, "w") as f:
            json.dump(dict(lm=LM, native=NATIVE, device=device, out=work,
                           launched=time.time()), f)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(
                os.pathsep) if p])
        t0 = time.perf_counter()
        with open(os.path.join(work, "hvdrun.log"), "w+") as log:
            proc = subprocess.Popen(
                [sys.executable, "-m", "horovod_tpu_torch.run", "-np", "2",
                 sys.executable, str(ROOT / "chip_smoke.py"),
                 "--native-rank", config], cwd=ROOT, env=env, stdout=log,
                stderr=subprocess.STDOUT)
            try:
                ref, ref_losses = _native_reference(torch, device)
                rc = proc.wait(timeout=400)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            took = time.perf_counter() - t0
            log.seek(0)
            if rc != 0:
                raise AssertionError(f"21b: hvdrun exited {rc}:\n"
                                     f"{log.read()[-6000:]}")
        outs, params = [], []
        for r in range(2):
            with open(os.path.join(work, f"rank{r}.json")) as f:
                outs.append(json.load(f))
            params.append(torch.load(os.path.join(work, f"rank{r}.pt")))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for o in outs:
        print(f"  21b rank {o['rank']}: started {o['started_s']:.1f} s after "
              f"the launch (init() {o['init_s']:.2f} s, the core's start at "
              f"the first collective {o['core_start_s']:.2f} s); "
              f"{len(o['collectives'])} host collectives equal numpy, bit "
              f"for bit but Adasum ({', '.join(o['collectives'])})")
    if {o["join"] for o in outs} != {1}:
        raise AssertionError(f"21b: join returned {[o['join'] for o in outs]}"
                             ", want the last rank, 1, on both")
    print(f"  21b uneven join: both ranks returned the last rank, 1; the "
          f"launch took {took:.1f} s")
    for o in outs:
        if o["losses"] != ref_losses[o["rank"]]:
            raise AssertionError(f"21b: rank {o['rank']}'s losses "
                                 f"{o['losses']}, the reference's "
                                 f"{ref_losses[o['rank']]}")
    for k in ref:
        if not torch.equal(params[0][k].view(torch.int32),
                           params[1][k].view(torch.int32)):
            raise AssertionError(f"21b: the ranks' {k} differ")
    gaps = {k: float(((params[0][k] - ref[k]).abs()
                      / ref[k].abs().clamp_min(1e-30)).max()) for k in ref
            if not torch.equal(params[0][k].view(torch.int32),
                               ref[k].view(torch.int32))}
    n = sum(v.numel() for v in ref.values())
    if gaps:
        worst = max(gaps, key=gaps.get)
        print(f"  21b NOT bit for bit the one-process average in "
              f"{len(gaps)} of {len(ref)} tensors; largest relative gap "
              f"{gaps[worst]:.3g} in {worst}")
        if gaps[worst] > NATIVE_RTOL:
            raise AssertionError(f"21b: {worst} off the one-process average "
                                 f"by {gaps[worst]:.3g} > {NATIVE_RTOL}")
    else:
        print(f"  21b both ranks' {len(ref)} parameter tensors ({n / 1e6:.2f}"
              f" M values) bit for bit equal, and bit for bit the "
              "one-process run averaging (g0 + g1) / 2; losses equal the "
              "reference's")
    for o in outs:
        print(f"  21b rank {o['rank']}: broadcast_optimizer_state after step "
              f"1, {o['bos_mb']:.1f} MB of AdamW state, {o['bos_ms']:.1f} ms")
        print(f"  21b rank {o['rank']} losses {[round(x, 5) for x in o['losses']]}")
        for i, st in enumerate(o["steps"]):
            share = (st["hooks_ms"] + st["wait_ms"]) / st["ms"]
            print(f"  21b rank {o['rank']} step {i + 1}: {st['ms']:.1f} ms, "
                  f"the host exchange {st['hooks_ms'] + st['wait_ms']:.1f} ms"
                  f" ({100 * share:.1f} %: hooks' staging and enqueues "
                  f"{st['hooks_ms']:.1f} ms, step()'s wait and copies back "
                  f"{st['wait_ms']:.1f} ms)")
    launches = {k: sum(o["launches"][k] for o in outs)
                for k in ("fwd", "dq", "dkv")}
    for o in outs:
        _worker_launches(f"21b rank {o['rank']}", o["launches"],
                         NATIVE["layers"] * NATIVE["steps"])
    print(f"  21b launches (both ranks): {launches}")
    print(f"  {card}")
    return launches


def _driver(label, module, argv):
    """``module.main(argv)`` in this process, its lines printed under
    ``label``. Returns what ``main`` returns and its output."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ret = module.main(argv)
    for line in out.getvalue().splitlines():
        print(f"  {label} | {line}")
    return ret, out.getvalue()


def _finite(label, losses):
    if not losses or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{label}: losses {losses}")


def phase_examples(hvd, fa, torch, card, device=None):
    """22a: ``examples/imagenet_resnet50`` at full width (``EXAMPLES``),
    one epoch, then a second run to 2 epochs that resumes the first's
    checkpoint; 22b ``examples/synthetic_benchmark``, its step read again
    through ``timed_throughput``; 22c the classic
    ``pytorch_synthetic_benchmark`` and ``pytorch_mnist`` over
    ``horovod_tpu_torch.torch``, their tensors on the card. Each driver's
    ``main`` runs here at world 1 (its ``init()`` returns at once); no
    flash kernel runs on this path."""
    import shutil
    import tempfile

    from horovod_tpu_torch.examples import (imagenet_resnet50,
                                            pytorch_mnist,
                                            pytorch_synthetic_benchmark,
                                            synthetic_benchmark)
    from horovod_tpu_torch.utils import benchmarks as bench
    ex = EXAMPLES
    hvd.init(device=device)
    dev = hvd.device()
    on = ["--device", str(dev)]
    fa.reset_launches()
    print(f"== phase 22a: examples/imagenet_resnet50, ResNet-{ex['depth']}"
          f" at {ex['num_filters']} filters, {ex['image_size']}x"
          f"{ex['image_size']}, {ex['num_classes']} classes, batch "
          f"{ex['batch']}, {ex['examples']} synthetic examples; --epochs 1,"
          " then --epochs 2 from its checkpoint")
    print(f"  {card}")
    root = tempfile.mkdtemp(prefix="examples_ckpt_")
    argv = ["--depth", str(ex["depth"]), "--num-filters",
            str(ex["num_filters"]), "--image-size", str(ex["image_size"]),
            "--num-classes", str(ex["num_classes"]), "--num-examples",
            str(ex["examples"]), "--batch-size", str(ex["batch"]),
            "--ckpt-dir", root] + on
    try:
        leg1, out1 = _driver("22a leg 1", imagenet_resnet50,
                             argv + ["--epochs", "1"])
        torch.cuda.reset_peak_memory_stats()
        leg2, out2 = _driver("22a leg 2", imagenet_resnet50,
                             argv + ["--epochs", "2"])
        peak = torch.cuda.max_memory_allocated()
        mb = os.path.getsize(os.path.join(root, "ckpt-2.msgpack")) / 1e6
    finally:
        shutil.rmtree(root, ignore_errors=True)
    _finite("22a", leg1["losses"] + leg2["losses"])
    shard = f"({ex['examples']} examples/epoch across 1 ranks)"
    if shard not in out1 or shard not in out2:
        raise AssertionError(f"22a: no {shard!r} line")
    if leg2["start"] != 1 or "resuming from epoch 1" not in out2:
        raise AssertionError("22a: the second run did not resume epoch 1")
    step_s = float(np.median(leg2["step_s"]))
    print(f"  22a leg 2 step ms {[round(1e3 * x, 2) for x in leg2['step_s']]}"
          f" (the loader's batch, its copy to the card, forward, backward, "
          f"the allreduce, SGD and the loss read back): median "
          f"{1e3 * step_s:.2f} ms, {ex['batch'] / step_s:.1f} img/s; peak "
          f"device memory {peak / 2**30:.2f} GiB")
    print(f"  22a checkpoint writes (params and SGD momentum, "
          f"{mb:.1f} MB a file): "
          f"{[round(x, 1) for x in leg1['save_ms'] + leg2['save_ms']]} ms")

    print(f"== phase 22b: examples/synthetic_benchmark --model "
          f"{ex['synth_model']} --batch-size {ex['batch']}, "
          f"{ex['synth_warmup']} warm-up batches, {ex['synth_iters']} "
          f"iterations of {ex['synth_per_iter']}")
    print(f"  {card}")
    synth, out = _driver("22b", synthetic_benchmark, [
        "--model", ex["synth_model"], "--batch-size", str(ex["batch"]),
        "--image-size", str(ex["image_size"]), "--num-warmup-batches",
        str(ex["synth_warmup"]), "--num-iters", str(ex["synth_iters"]),
        "--num-batches-per-iter", str(ex["synth_per_iter"])] + on)
    rates = synth["img_secs"]
    if "Total img/sec on 1 chip(s)" not in out or not all(
            math.isfinite(r) and r > 0 for r in rates):
        raise AssertionError(f"22b: rates {rates}")
    macs = _conv_macs(torch, synth.pop("model"), ex["image_size"])
    rate = float(np.mean(rates))
    print(f"  22b {rate:.1f} img/s (iterations {[round(r, 1) for r in rates]}"
          f"); {macs / 1e9:.3f} G multiply-adds an image forward, "
          f"{6 * macs * rate / 1e12:.1f} TFLOP/s, "
          f"{100 * 6 * macs * rate / PEAK_FLOPS['bfloat16']:.2f} % of the "
          "bf16 peak (MFU)")
    step, (images, labels) = synth.pop("step"), synth.pop("batch")
    timed, dt = bench.timed_throughput(step, None, images, labels, warmup=0,
                                       iters=ex["synth_per_iter"])
    print(f"  22b the driver's step through utils.benchmarks."
          f"timed_throughput, one window of {ex['synth_per_iter']}: "
          f"{timed:.1f} img/s (upper_bound {dt.upper_bound}, asymmetric "
          f"{dt.asymmetric}) beside the driver's {rate:.1f}")
    if not (math.isfinite(timed) and timed > 0):
        raise AssertionError(f"22b: timed_throughput read {timed} img/s")
    del step, images, labels, synth

    print("== phase 22c: examples/pytorch_synthetic_benchmark and "
          "examples/pytorch_mnist over horovod_tpu_torch.torch, tensors on "
          "the card")
    print(f"  {card}")
    classic, out = _driver("22c pytorch_synthetic_benchmark",
                           pytorch_synthetic_benchmark, on)
    if "Total img/sec on 1 processes" not in out or not all(
            math.isfinite(r) and r > 0 for r in classic["img_secs"]):
        raise AssertionError(f"22c: rates {classic['img_secs']}")
    mnist, out = _driver("22c pytorch_mnist", pytorch_mnist, on)
    _finite("22c pytorch_mnist", mnist["epoch_losses"])
    print(f"  22c {float(np.mean(classic['img_secs'])):.1f} img/s through "
          f"the classic optimizer; MNIST learned: epoch losses "
          f"{[round(x, 4) for x in mnist['epoch_losses']]}")
    if any(fa.LAUNCHES.values()):
        raise AssertionError(f"22: flash kernels launched {fa.LAUNCHES}")
    hvd.shutdown()


def _positions_batch(torch):
    """23's batch: ``POSITIONS_BATCH``, or the largest power of 2 up to
    phase 5's whose step fits the free device memory: the dense
    attention's fp32 softmax output and bf16 probabilities saved in
    every layer, two layers' more for the transients, and the fp32
    logits three times (the logits, their log-softmax and its
    gradient)."""
    if POSITIONS_BATCH is not None:
        return POSITIONS_BATCH
    s, h = LM["seq_len"], LM["heads"]
    per_seq = ((LM["layers"] + 2) * h * s * s * (4 + 2)
               + 3 * s * LM["vocab"] * 4)
    free, _ = torch.cuda.mem_get_info()
    b = LM["batch"]
    while b > 1 and b * per_seq > free:
        b //= 2
    return b


def _plain_attention(torch, positions, calls):
    """The script's own dense attention, all in fp32, masked by
    ``positions`` (``[B, S]``, made by the script) whatever the model
    passes on; each call is counted in ``calls``."""
    def attend(q, k, v, *, causal, q_positions, kv_positions):
        calls.append(1)
        scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        scores = scores / math.sqrt(q.shape[-1])
        seen = positions[:, None, :, None] >= positions[:, None, None, :]
        probs = torch.softmax(scores.masked_fill(~seen, float("-inf")), -1)
        return torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(q.dtype)
    return attend


def _plain_logits(torch, model, tokens, positions):
    """The model's logits at ``positions`` with its dense attention
    swapped for ``_plain_attention``, which every layer must call."""
    from horovod_tpu_torch.models import transformer
    calls, real = [], transformer.dense_attention
    transformer.dense_attention = _plain_attention(torch, positions, calls)
    try:
        with torch.no_grad():
            logits = model(tokens, positions)
    finally:
        transformer.dense_attention = real
    if len(calls) != LM["layers"]:
        raise AssertionError(f"23: the plain attention ran {len(calls)} "
                             f"times, not once in each of {LM['layers']} "
                             "layers")
    return logits


def phase_positions(hvd, fa, torch, phase5_losses, device=None):
    """23a-23c (module docstring): phase 5's LM at explicit positions,
    the dense path, held against the plain reference;
    ``allgather(tiled=False)`` over NCCL."""
    from horovod_tpu_torch import training
    from horovod_tpu_torch.ops import collective

    hvd.init(device=device)
    dev = hvd.device()
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    b = _positions_batch(torch)
    cfg, model, tokens = _lm_full(torch, dev)
    tokens = tokens[:b]
    s = LM["seq_len"]
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    print(f"== phase 23: phase 5's LM ({LM['layers']} x {LM['d_model']}, "
          f"{LM['heads']} heads, S {s}, bf16 on fp32 parameters, AdamW) at "
          f"explicit positions, batch {b} (phase 5's {LM['batch']}): dense "
          "attention, no flash kernel")

    def train(positions, steps):
        model.load_state_dict(start)
        opt = _lm_adamw(torch, model.parameters())
        losses = []
        for _ in range(steps):
            opt.zero_grad(set_to_none=True)
            logits = model(tokens, positions)
            loss = training.softmax_cross_entropy(logits[:, :-1],
                                                  tokens[:, 1:])
            loss.backward()
            opt.step()
            losses.append(float(loss.detach()))
        return losses

    contiguous = torch.arange(s, device=dev).expand(b, s)
    half = torch.arange(s // 2, device=dev)
    packed = torch.cat([half, torch.arange(s - s // 2, device=dev)]).expand(
        b, s)
    want_c = _plain_logits(torch, model, tokens, contiguous)
    want_p = _plain_logits(torch, model, tokens, packed)
    seen = _err(want_c, want_p) / float(want_p.abs().max())

    fa.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    with torch.no_grad():
        err_a = _err(model(tokens, contiguous), want_c) / float(
            want_c.abs().max())
        err_b = _err(model(tokens, packed), want_p) / float(
            want_p.abs().max())
    del want_c, want_p
    (first,) = train(contiguous, 1)
    step_s = time.perf_counter() - t
    launches = dict(fa.LAUNCHES)
    gap = abs(first - phase5_losses[0]) / abs(phase5_losses[0])
    print(f"  23a one step at positions = arange({s}) given: the forward's "
          f"logits {err_a:.3e} of max|want| from the plain fp32 reference "
          f"(bound {POSITIONS_LOGITS}); loss {first:.6f} against phase 5's "
          f"first {phase5_losses[0]:.6f}, relative gap {gap:.3e} (bound "
          f"{POSITIONS_RTOL}); {1e3 * step_s:.1f} ms for two forwards and "
          "the step with their first-call costs; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
          f"{launches}")
    print(f"  23b the forward at packed positions (two documents of "
          f"{s // 2}): logits {err_b:.3e} of max|want| from the plain fp32 "
          f"reference (bound {POSITIONS_LOGITS}); the reference at arange "
          f"lies {seen:.3e} from it ({seen / POSITIONS_LOGITS:.1f} bounds, "
          f"at least {POSITIONS_SEEN} wanted)")
    if any(launches.values()):
        raise AssertionError(f"23a: flash kernels launched {launches}")
    if not err_a <= POSITIONS_LOGITS:
        raise AssertionError(f"23a: logits {err_a} of max|want| from the "
                             "plain reference")
    if not (math.isfinite(first) and gap <= POSITIONS_RTOL):
        raise AssertionError(f"23a: loss {first} against phase 5's "
                             f"{phase5_losses[0]}: gap {gap}")
    if not err_b <= POSITIONS_LOGITS:
        raise AssertionError(f"23b: logits {err_b} of max|want| from the "
                             "plain reference")
    if not seen >= POSITIONS_SEEN * POSITIONS_LOGITS:
        raise AssertionError(f"23b: the arange reference is only {seen} "
                             "from the packed one: the check cannot see "
                             "the mask")
    runs = [train(packed, 3) for _ in range(2)]
    print(f"  23b three steps at packed positions: losses {runs[0]}, "
          f"repeated {runs[1]}")
    _finite("23b", runs[0])
    if runs[0] != runs[1]:
        raise AssertionError(f"23b: the repeat differs: {runs}")
    if any(fa.LAUNCHES.values()):
        raise AssertionError(f"23: flash kernels launched {fa.LAUNCHES}")

    x = torch.randn(4, 5, device=dev)
    y = collective.allgather(x, tiled=False)
    print(f"  23c allgather(tiled=False) over "
          f"{torch.distributed.get_backend()} at world {hvd.size()}: "
          f"shape {tuple(y.shape)}")
    if tuple(y.shape) != (1, 4, 5) or not torch.equal(y[0], x):
        raise AssertionError(f"23c: {tuple(y.shape)} / values differ")
    del model, start
    hvd.shutdown()
    print(f"== phase 23 took {time.perf_counter() - t0:.1f} s")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tune", action="store_true",
                    help="time the tile configurations, then stop")
    ap.add_argument("--serve-rank", metavar="CONFIG",
                    help="run one rank of phase 20b (the script starts "
                         "them itself)")
    ap.add_argument("--native-rank", metavar="CONFIG",
                    help="run one rank of phase 21b (the script starts "
                         "them itself)")
    args = ap.parse_args(argv)
    if not (ROOT / "horovod_tpu_torch" / "__init__.py").is_file():
        print("chip_smoke: horovod_tpu_torch is not beside this script",
              file=sys.stderr)
        return 2
    if args.serve_rank:
        sys.path.insert(0, str(ROOT))
        return serve_rank(args.serve_rank)
    if args.native_rank:
        sys.path.insert(0, str(ROOT))
        return native_rank(args.native_rank)
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

    print("== phase 2: kernel build (the native core's beside it)")
    core_build = None if args.tune else start_core_build()
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
    losses_6a, peak_6a, losses_6b = phase_exchange_full(hvd, fa, torch,
                                                        bench, losses)
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
    torch.cuda.empty_cache()
    t12 = time.perf_counter()
    phase_tp_block(fa, torch, dev, bench)
    launches_12 = [phase_tp_lm(hvd, fa, torch, bench, losses, phase5_tok_s)]
    torch.cuda.empty_cache()
    launches_12.append(phase_moe_lm(hvd, fa, torch, bench, phase5_tok_s))
    torch.cuda.empty_cache()
    phase_moe_layer(torch, dev, bench)
    print(f"== phase 12 took {time.perf_counter() - t12:.1f} s")
    torch.cuda.empty_cache()
    t13 = time.perf_counter()
    launches_13, f1b_s2 = phase_pipeline(fa, torch, dev)
    launches_13 += phase_pipeline_shards(fa, torch, dev, f1b_s2)
    del f1b_s2
    print(f"== phase 13 took {time.perf_counter() - t13:.1f} s")
    torch.cuda.empty_cache()
    t14 = time.perf_counter()
    launches_14 = [phase_tp_resume(fa, torch, dev, bench)]
    phase_ep_resume(fa, torch, dev, bench)
    phase_multi_steps_resume(hvd, fa, torch, dev, bench)
    print(f"== phase 14 took {time.perf_counter() - t14:.1f} s")
    torch.cuda.empty_cache()
    t15 = time.perf_counter()
    launches_15 = phase_spmd(hvd, fa, torch, bench, losses, phase5_tok_s,
                             losses_6a, peak_6a)
    print(f"== phase 15 took {time.perf_counter() - t15:.1f} s")
    torch.cuda.empty_cache()
    t16 = time.perf_counter()
    import shutil
    import tempfile
    flightrec_16c = tempfile.mkdtemp(prefix="flightrec_")  # kept for 19c
    launches_16, doctor_16c = phase_telemetry(
        hvd, fa, torch, bench, losses, losses_6b, phase5_tok_s, card,
        keep=flightrec_16c)
    print(f"== phase 16 took {time.perf_counter() - t16:.1f} s")
    t17 = time.perf_counter()
    launches_17 = phase_elastic(hvd, torch, losses)
    print(f"== phase 17 took {time.perf_counter() - t17:.1f} s")
    torch.cuda.empty_cache()
    t18 = time.perf_counter()
    serve_root = tempfile.mkdtemp(prefix="serve_ckpt_")  # kept for 20b
    streams18, metrics18 = phase_serve(hvd, fa, torch, bench, card,
                                       root=serve_root)
    print(f"== phase 18 took {time.perf_counter() - t18:.1f} s")
    torch.cuda.empty_cache()
    t19 = time.perf_counter()
    launches_19 = phase_timer_tuner(hvd, fa, torch, dev, bench, rows,
                                    phase5_tok_s)
    phase_tools(doctor_16c)
    shutil.rmtree(flightrec_16c, ignore_errors=True)
    print(f"== phase 19 took {time.perf_counter() - t19:.1f} s")
    torch.cuda.empty_cache()
    t20 = time.perf_counter()
    launches_20 = phase_zero_mesh(hvd, fa, torch, bench, losses_6b)
    torch.cuda.empty_cache()
    try:
        phase_serve_mesh(torch, serve_root, streams18, metrics18, card)
    finally:
        shutil.rmtree(serve_root, ignore_errors=True)
    print(f"== phase 20 took {time.perf_counter() - t20:.1f} s")
    torch.cuda.empty_cache()
    t21 = time.perf_counter()
    launches_21 = phase_native_core(torch, card, core_build=core_build)
    print(f"== phase 21 took {time.perf_counter() - t21:.1f} s")
    torch.cuda.empty_cache()
    t22 = time.perf_counter()
    phase_examples(hvd, fa, torch, card)
    print(f"== phase 22 took {time.perf_counter() - t22:.1f} s")
    torch.cuda.empty_cache()
    phase_positions(hvd, fa, torch, losses)

    kernels = []
    for kind_ in ("fwd", "dq", "dkv"):
        wrapper, replaces, source, design = KERNELS[kind_]
        main = [launches, launches_11b] + launches_12 + launches_13 + \
            launches_14 + [launches_15, launches_16, launches_17,
                           launches_19, launches_20, launches_21]
        kernels.append(dict(name=wrapper, route="cuda", source=source,
                            replaces=replaces, design=design,
                            launches=sum(n[kind_] for n in main),
                            **rows[kind_]))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
