"""The benchmark workloads, each built one way (the port of
``horovod_tpu/utils/benchmarks.py``'s ``model_registry``,
``compute_dtype``, ``make_model``, ``synthetic_batch``, ``make_lm_bench``,
``sync``, the slope-window
timer ``slope_window``/``repeat_step_windows`` and its throughput views
``repeat_throughput``/``timed_throughput``; ``make_resnet_bench``
builds ``bench.py``'s image-model step), and timing on the card with CUDA
events."""

import time
import warnings

import numpy as np
import torch


def model_registry():
    """The image models of ``bench.py --model`` and of the synthetic
    benchmark (``examples/synthetic_benchmark.py``), by name."""
    from horovod_tpu_torch.models import resnet, vgg
    return {"resnet18": resnet.ResNet18, "resnet34": resnet.ResNet34,
            "resnet50": resnet.ResNet50, "resnet101": resnet.ResNet101,
            "resnet152": resnet.ResNet152, "vgg16": vgg.VGG16}


def compute_dtype(device):
    """The compute dtype on ``device``: bf16 on a card (its tensor-core
    type), fp32 elsewhere (bf16 on the CPU is slow and proves nothing),
    as the JAX package's rule for the accelerator and the CPU."""
    return (torch.bfloat16 if torch.device(device).type == "cuda"
            else torch.float32)


def make_model(name, dtype=torch.bfloat16, num_classes=1000, seed=0,
               device=None, image_size=224, bn_cross_replica_axes=None):
    """Model ``name`` of the registry at compute ``dtype`` (bf16 by
    default, the card's tensor-core type), weights from ``seed``. VGG-16's
    first fully connected layer is sized for ``image_size``; a ResNet's
    BatchNorm is synchronized over ``bn_cross_replica_axes`` when
    given."""
    kw = dict(num_classes=num_classes, dtype=dtype, device=device,
              generator=torch.Generator().manual_seed(seed))
    if name == "vgg16":
        kw["image_size"] = image_size
    if bn_cross_replica_axes is not None:
        kw["bn_cross_replica_axes"] = bn_cross_replica_axes
    return model_registry()[name](**kw)


def synthetic_batch(global_batch, image_size, seed=0, num_classes=1000,
                    device=None):
    """The JAX package's synthetic batch: the same
    ``np.random.default_rng(seed)`` draws of NHWC images and int labels,
    the images permuted to NCHW, in fp32 (the model casts them to its
    compute dtype). Returns ``(images, labels)``."""
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((global_batch, image_size, image_size, 3))
    labels = rng.integers(0, num_classes, size=(global_batch,))
    images = torch.from_numpy(images).float().permute(0, 3, 1, 2)
    return (images.contiguous().to(device),
            torch.from_numpy(labels).long().to(device))


def sync(x=None):
    """Wait until the card has finished all queued work: ``x``'s card
    when ``x`` is a tensor there (the JAX ``sync(x)`` waits for ``x``),
    else the current one."""
    if torch.is_tensor(x) and x.is_cuda:
        torch.cuda.synchronize(x.device)
    elif torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class WindowTime(float):
    """A ``slope_window`` duration. ``upper_bound`` is True when the
    inverted-window fallback reported the full window time (fixed costs
    included) instead of a slope difference: a conservative bound, not a
    measurement. ``asymmetric`` is True when the per-iteration rates that
    the two window segments imply disagree beyond tolerance: a fixed cost
    attached itself to some window lengths but not others, so the slope
    may be deflated or inflated rather than clean."""

    upper_bound = False
    asymmetric = False

    def __new__(cls, value, upper_bound=False, asymmetric=False):
        obj = super().__new__(cls, value)
        obj.upper_bound = upper_bound
        obj.asymmetric = asymmetric
        return obj


def _median(xs):
    xs = sorted(xs)
    n = len(xs)
    mid = n // 2
    return xs[mid] if n % 2 else 0.5 * (xs[mid - 1] + xs[mid])


def slope_window(step_once, state, iters, base_iters=2, rounds=3,
                 rate_tolerance=0.5, agree=None):
    """Time ``iters`` iterations by the slope method over interleaved
    windows (the JAX package's timer, ``utils/benchmarks.py:99``).

    Each of ``rounds`` rounds runs a base window (``base_iters``
    iterations), a mid window (``base_iters + h``, ``h = iters // 2``) and
    a full window (``base_iters + iters``), each ended by ``sync()``.
    Every (shorter, longer) pair of windows in a round gives a slope, a
    time per iteration; the result is the median slope times ``iters``.
    A fixed cost of a window (the sync, a launch queue draining) cancels
    in each difference, and the median keeps one polluted window from
    owning the result.

    With three window lengths the rate is implied twice, over disjoint
    segments: ``(t_mid - t_base) / h`` and ``(t_full - t_mid) / (iters -
    h)``. When their medians part by more than ``rate_tolerance`` times
    the rate, and by more than 1e-4 s over ``iters`` iterations, the
    result is flagged ``asymmetric`` and a warning names both rates.

    ``step_once(state) -> (state, out)`` advances one iteration and
    threads its state, so that no two calls see the same inputs. One
    untimed iteration runs and is synced first, so that work left queued
    by earlier code lands outside every window. A median slope at or
    below 0 (fixed-cost noise above the work) reruns the set once; a
    second inversion returns the median full-window time, flagged
    ``upper_bound``. Returns ``(WindowTime, state)``.

    ``agree(slope) -> slope`` makes both inversion tests joint across
    processes whose ``step_once`` runs collectives: each tests the slope
    it returns (the minimum over the ranks, say), so that every rank
    reruns a set, and returns a bound, alike, and their windows pair up
    collective for collective. The result keeps this rank's own slope.
    None (one process) tests the slope as it is."""

    def window(k, st):
        t0 = time.perf_counter()
        for _ in range(k):
            st, _ = step_once(st)
        sync()
        return time.perf_counter() - t0, st

    h = iters // 2
    lengths = ([base_iters, base_iters + h, base_iters + iters]
               if 0 < h < iters else [base_iters, base_iters + iters])

    def measure(st):
        slopes, seg_lo, seg_hi, fulls = [], [], [], []
        for _ in range(max(1, rounds)):
            times = []
            for k in lengths:
                t, st = window(k, st)
                times.append(t)
            fulls.append(times[-1])
            for i in range(len(lengths)):
                for j in range(i + 1, len(lengths)):
                    slopes.append((times[j] - times[i])
                                  / (lengths[j] - lengths[i]))
            if len(lengths) == 3:
                seg_lo.append((times[1] - times[0]) / h)
                seg_hi.append((times[2] - times[1]) / (iters - h))
        return slopes, seg_lo, seg_hi, fulls, st

    def inverted(slope):
        return (slope if agree is None else agree(slope)) <= 0

    _, state = window(1, state)  # untimed flush
    slopes, seg_lo, seg_hi, fulls, state = measure(state)
    per_iter = _median(slopes)
    if inverted(per_iter):
        slopes, seg_lo, seg_hi, fulls, state = measure(state)
        per_iter = _median(slopes)
        if inverted(per_iter):
            bound = _median(fulls)
            warnings.warn(
                f"slope window inverted twice (median pairwise slope "
                f"{per_iter:.6f}s/iter over {iters} iters); reporting "
                f"the full-window upper bound — increase iters for a "
                f"real measurement", stacklevel=2)
            return WindowTime(bound, upper_bound=True), state
    asymmetric = False
    if seg_lo and seg_hi:
        lo, hi = _median(seg_lo), _median(seg_hi)
        if (abs(hi - lo) > rate_tolerance * max(per_iter, 1e-12)
                and abs(hi - lo) * iters > 1e-4):
            asymmetric = True
            warnings.warn(
                f"slope window segments imply different per-iteration "
                f"rates ({lo:.6f}s vs {hi:.6f}s per iter, median "
                f"{per_iter:.6f}s): a fixed cost is attaching "
                f"asymmetrically to window lengths; treat this sample "
                f"as suspect", stacklevel=2)
    return WindowTime(per_iter * iters, asymmetric=asymmetric), state


def repeat_step_windows(step_once, state, warmup, iters, repeats,
                        base_iters=2):
    """``warmup`` synced calls of ``step_once``, then ``repeats`` slope
    windows over the state it threads. Returns ``(list of WindowTime,
    state)``; each keeps its ``upper_bound`` and ``asymmetric``
    flags."""
    for _ in range(warmup):
        state, _ = step_once(state)
        sync()
    runs = []
    for _ in range(repeats):
        dt, state = slope_window(step_once, state, iters,
                                 base_iters=base_iters)
        runs.append(dt)
    return runs, state


def repeat_throughput(step, state, images, labels, warmup, iters,
                      repeats, base_iters=2):
    """``repeats`` slope windows of a classification step
    ``step(state, images, labels) -> (state, out)``: a list of
    ``(images per second, WindowTime)``, the rate
    ``images.shape[0] * iters / dt``. The (images, labels) view of
    :func:`repeat_step_windows`, which keeps the one copy of the timing
    discipline; each ``WindowTime`` keeps its ``upper_bound`` and
    ``asymmetric`` flags."""
    dts, _ = repeat_step_windows(
        lambda st: step(st, images, labels), state, warmup, iters,
        repeats, base_iters=base_iters)
    return [(images.shape[0] * iters / dt, dt) for dt in dts]


def timed_throughput(step, state, images, labels, warmup, iters):
    """``(images per second, WindowTime)`` of ``step`` over one slope
    window: :func:`repeat_throughput` at one repeat."""
    return repeat_throughput(step, state, images, labels, warmup, iters,
                             repeats=1)[0]


def make_lm_bench(*, batch, seq_len, layers, d_model, heads, vocab, flash,
                  dtype=torch.bfloat16, lr=3e-4, weight_decay=1e-4, seed=0,
                  sharded_update=False, mesh=None, seq_axis=None,
                  op="average", hierarchical=None, model_axis=None,
                  expert_axis=None, moe_every=0, num_experts=8, moe_top_k=1,
                  moe_capacity_factor=2.0, moe_num_groups=1, spmd=False,
                  compression=None, telemetry=None):
    """The LM benchmark: the transformer LM at the given widths, AdamW
    through ``DistributedOptimizer`` (its buckets packed in the flax leaf
    order; ZeRO-1 with ``sharded_update``; ``op`` and ``hierarchical``
    passed on), and a seeded batch. ``init()`` must have run. Returns
    ``(step, model, optimizer, tokens)``; ``step(tokens)`` returns the
    averaged loss.

    Without ``mesh``: data-parallel over the world, ``batch`` sequences a
    rank drawn at the seed plus the rank. With ``mesh`` (the installed
    mesh of ``parallel.mesh.build_mesh``: (data, seq), or (dcn, data))
    the JAX package's form: a global batch of ``batch`` sequences a
    batch index, drawn once at the seed and cut by this rank's
    coordinates on the data axes (``mesh.data_axis_names``), the
    gradients averaged over those and ``seq_axis``, and with
    ``seq_axis`` the sequence sharded over that axis (ring
    attention).

    With ``model_axis``, ``expert_axis`` or ``moe_every`` (the MoE fields
    are ``TransformerConfig``'s) the model is this rank's shard over
    those axes of ``mesh`` (``parallel.tensor.shard_lm_state``), trained
    by ``make_tp_lm_train_step`` with a plain AdamW over the ``data``
    axis, as the JAX package's tensor-parallel and MoE examples do.

    ``spmd`` builds the GSPMD step (``make_lm_train_step(spmd=True)``),
    whose ``tokens`` are the global batch: every rank's batch of the
    data-parallel form, in rank order, so each rank's rows are the ones
    it trains on there. ``compression`` is ``DistributedOptimizer``'s,
    ``telemetry`` ``make_lm_train_step``'s."""
    from horovod_tpu_torch import basics, convert, hvd_torch, training
    from horovod_tpu_torch.models.transformer import (Transformer,
                                                      TransformerConfig)
    from horovod_tpu_torch.ops import collective
    from horovod_tpu_torch.parallel import mesh as mesh_lib
    from horovod_tpu_torch.parallel import tensor

    device = basics.device()
    cfg = TransformerConfig(vocab_size=vocab, num_layers=layers,
                            num_heads=heads, d_model=d_model,
                            d_ff=4 * d_model, dtype=dtype,
                            flash_attention=flash, sequence_axis=seq_axis,
                            moe_every=moe_every, num_experts=num_experts,
                            moe_top_k=moe_top_k,
                            moe_capacity_factor=moe_capacity_factor,
                            moe_num_groups=moe_num_groups,
                            expert_axis=expert_axis or "expert")
    generator = torch.Generator().manual_seed(seed)
    batch_axes = mesh_lib.data_axis_names(mesh)

    def global_batch():
        rng = np.random.default_rng(seed)
        return training.shard_lm_batch(
            torch.from_numpy(rng.integers(
                0, vocab, size=(batch * collective.mesh_size(batch_axes),
                                seq_len))),
            batch_axes, seq_axis).contiguous().to(device)

    if model_axis or expert_axis or moe_every:
        model = tensor.shard_lm_state(cfg, mesh, model_axis=model_axis,
                                      expert_axis=expert_axis,
                                      batch_axis="data", generator=generator)
        opt = torch.optim.AdamW(model.parameters(), lr=lr,
                                betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=weight_decay)
        step = tensor.make_tp_lm_train_step(
            model, opt, mesh, model_axis=model_axis, batch_axis="data",
            expert_axis=expert_axis)
        return step, model, opt, global_batch()
    model = Transformer(cfg, generator=generator, device=device)
    # optax.adamw's defaults, with the decay stated (torch's is 1e-2)
    inner = torch.optim.AdamW(model.parameters(), lr=lr,
                              betas=(0.9, 0.999), eps=1e-8,
                              weight_decay=weight_decay)
    axes = None if mesh is None else batch_axes + (
        (seq_axis,) if seq_axis else ())
    opt = hvd_torch.DistributedOptimizer(
        inner, named_parameters=convert.flax_named_parameters(model),
        sharded_update=sharded_update, axes=axes, op=op,
        hierarchical=hierarchical, compression=compression)
    training.create_train_state(model, opt)
    if mesh is None:
        ranks = range(basics.size()) if spmd else [basics.rank()]
        tokens = torch.cat([torch.from_numpy(
            np.random.default_rng(seed + r).integers(
                0, vocab, size=(batch, seq_len)).astype(np.int64))
            for r in ranks]).to(device)
    else:
        tokens = global_batch()
    step = training.make_lm_train_step(model, opt, mesh=mesh,
                                       batch_axis=batch_axes,
                                       seq_axis=seq_axis, spmd=spmd,
                                       telemetry=telemetry)
    return step, model, opt, tokens


def make_resnet_bench(*, model="resnet101", batch=256, image_size=224,
                      optimizer="sgd", accum_steps=1, overlap_grads=False,
                      sharded_update=False, compression=None, seed=0,
                      bn_cross_replica_axes=None):
    """``bench.py``'s image-model step on this rank: ``model`` (1000
    classes) in bf16 on fp32 parameters, ``DistributedOptimizer`` over
    ``optimizer`` (``"sgd"``: SGD(0.01, momentum 0.9), the headline's;
    ``"adamw"``: AdamW(1e-3) with optax's decay 1e-4, the ``--overlap``
    matrix's) with the buckets packed in the flax leaf order, and
    ``make_train_step`` with ``accum_steps`` and ``overlap_grads``. The
    batch is ``synthetic_batch`` of ``batch`` images at the seed plus this
    rank. ``bn_cross_replica_axes`` synchronizes a ResNet's BatchNorm
    over those mesh axes. ``init()`` must have run. Returns ``(step,
    model, optimizer, (images, labels))``."""
    from horovod_tpu_torch import basics, convert, hvd_torch, training

    device = basics.device()
    net = make_model(model, seed=seed, device=device, image_size=image_size,
                     bn_cross_replica_axes=bn_cross_replica_axes)
    if optimizer == "sgd":
        inner = torch.optim.SGD(net.parameters(), lr=0.01, momentum=0.9)
    elif optimizer == "adamw":
        inner = torch.optim.AdamW(net.parameters(), lr=1e-3,
                                  betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=1e-4)
    else:
        raise ValueError(f"unknown optimizer {optimizer!r}")
    opt = hvd_torch.DistributedOptimizer(
        inner, named_parameters=convert.flax_named_parameters(net),
        sharded_update=sharded_update, compression=compression)
    training.create_train_state(net, opt)
    step = training.make_train_step(net, opt, accum_steps=accum_steps,
                                    overlap_grads=overlap_grads)
    batch = synthetic_batch(batch, image_size, seed=seed + basics.rank(),
                            device=device)
    return step, net, opt, batch


def cuda_time_ms(fn, iters=10, warmup=2):
    """Milliseconds of one ``fn()`` on the card: the median over 3 rounds
    of the time of ``iters`` calls made back to back between one pair of
    CUDA events, over ``iters``. The host enqueues ahead of the card, so
    a call's launch overhead on the host is hidden whenever the call
    takes longer on the card than on the host."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return float(np.median(times))
