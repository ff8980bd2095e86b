"""The benchmark workloads, each built one way (the port of
``horovod_tpu/utils/benchmarks.py``'s ``model_registry``, ``make_model``,
``synthetic_batch``, ``make_lm_bench`` and ``sync``; ``make_resnet_bench``
builds ``bench.py``'s image-model step), and timing on the card with CUDA
events."""

import numpy as np
import torch


def model_registry():
    """The image models of ``bench.py --model``, by name."""
    from horovod_tpu_torch.models import resnet, vgg
    return {"resnet18": resnet.ResNet18, "resnet50": resnet.ResNet50,
            "resnet101": resnet.ResNet101, "vgg16": vgg.VGG16}


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


def sync():
    """Wait until the card has finished all queued work."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def make_lm_bench(*, batch, seq_len, layers, d_model, heads, vocab, flash,
                  dtype=torch.bfloat16, lr=3e-4, weight_decay=1e-4, seed=0,
                  sharded_update=False, mesh=None, seq_axis=None,
                  op="average", hierarchical=None, model_axis=None,
                  expert_axis=None, moe_every=0, num_experts=8, moe_top_k=1,
                  moe_capacity_factor=2.0, moe_num_groups=1):
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
    axis, as the JAX package's tensor-parallel and MoE examples do."""
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
        hierarchical=hierarchical)
    training.create_train_state(model, opt)
    if mesh is None:
        rng = np.random.default_rng(seed + basics.rank())
        tokens = torch.from_numpy(rng.integers(
            0, vocab, size=(batch, seq_len)).astype(np.int64)).to(device)
    else:
        tokens = global_batch()
    step = training.make_lm_train_step(model, opt, mesh=mesh,
                                       batch_axis=batch_axes,
                                       seq_axis=seq_axis)
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
