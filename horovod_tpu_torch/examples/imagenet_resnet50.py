"""ImageNet-class ResNet-50 training with per-rank dataset sharding: the
port of ``examples/jax_imagenet_resnet50.py`` (the reference's flagship
real-data example, ``examples/pytorch_imagenet_resnet50.py``), at its
flags and defaults. Every rank

* takes a DISJOINT shard of the dataset each epoch through the data
  plane's ``PrefetchLoader``: a background thread assembles the next
  batch while the current step computes, and the epoch-keyed shuffle
  stays deterministic per rank (the
  ``torch.utils.data.distributed.DistributedSampler`` role),
* computes gradients locally, averages them across ranks with the fused
  allreduce and steps a plain SGD with momentum at ``lr x size``,
* follows the checkpoint and resume discipline (rank-0 atomic writes,
  broadcast restore, ``examples/keras_imagenet_resnet50.py:85-103``),
  moving the loader's cursor to the resume epoch.

A checkpoint holds the parameters and the optimizer state only, in the
JAX package's file (``optax.sgd``'s trace), so either package resumes the
other's. The BatchNorm statistics are not saved, as the JAX example does
not save them: a resumed run starts them afresh. Training-mode BatchNorm
normalizes with the batch's own statistics, so the losses do not depend
on them. The model computes in bf16 (the ResNet's default, as the flax
model's), on fp32 parameters.

Real data: ``--data-dir DIR`` with ``train.npz`` holding ``images``
(N, H, W, 3) uint8 or float and ``labels`` (N,) int. Without it, a
deterministic synthetic ImageNet-shaped set is made, so the example runs
hermetically.

On the card:  python -m horovod_tpu_torch.examples.imagenet_resnet50
On the CPU:   python -m horovod_tpu_torch.run -np 2 \\
                  python -m horovod_tpu_torch.examples.imagenet_resnet50 \\
                  --device cpu --depth 18 --num-filters 4 --image-size 32 \\
                  --epochs 2

``main`` returns each epoch's averaged loss, this rank's loss and seconds
at each step and the milliseconds of each checkpoint's write.
"""

import argparse
import os
import time

import numpy as np


def load_or_synthesize(args, rank):
    path = os.path.join(args.data_dir or "", "train.npz")
    if args.data_dir and os.path.exists(path):
        with np.load(path) as z:
            images = np.asarray(z["images"], np.float32)
            if images.max() > 2.0:  # uint8-scaled
                images = images / 127.5 - 1.0
            return images, np.asarray(z["labels"], np.int64)
    if rank == 0:
        print("no --data-dir; using synthetic ImageNet-shaped data")
    rng = np.random.default_rng(1234)  # same data on every rank
    images = rng.standard_normal(
        (args.num_examples, args.image_size, args.image_size, 3)
    ).astype(np.float32)
    labels = rng.integers(0, args.num_classes, size=(args.num_examples,))
    return images, labels


def build_model(args, device):
    """The ResNet of ``--depth``, its weights from the port's seed."""
    from horovod_tpu_torch import models
    arch = {18: models.ResNet18, 50: models.ResNet50,
            101: models.ResNet101}[args.depth]
    return arch(num_classes=args.num_classes, num_filters=args.num_filters,
                device=device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--ckpt-dir", default="/tmp/hvd_tpu_imagenet_ckpt")
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--batch-size", type=int, default=8,
                    help="PER-RANK batch size")
    ap.add_argument("--lr", type=float, default=0.0125,
                    help="per-worker base LR; scaled by world size like "
                         "the reference (linear scaling rule)")
    ap.add_argument("--depth", type=int, default=50, choices=[18, 50, 101])
    ap.add_argument("--num-filters", type=int, default=64)
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--num-classes", type=int, default=1000)
    ap.add_argument("--num-examples", type=int, default=64,
                    help="synthetic-fallback dataset size")
    ap.add_argument("--device", default=None,
                    help="cpu, or a card (default: this rank's card)")
    args = ap.parse_args(argv)

    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import checkpoint, data, training

    hvd.init(device=args.device)
    rank, size, dev = hvd.rank(), hvd.size(), hvd.device()
    images, labels = load_or_synthesize(args, rank)

    model = build_model(args, dev)
    params = list(model.parameters())
    opt = torch.optim.SGD(params, lr=args.lr * size, momentum=0.9)

    # resume discipline: rank 0 restores the newest checkpoint, the
    # start epoch, parameters and optimizer state broadcast to everyone
    start, _meta = checkpoint.restore_or_init(args.ckpt_dir, model, opt)
    if rank == 0 and start > 0:
        print(f"resuming from epoch {start}")

    # the data plane: per-rank disjoint shards, epoch-keyed reshuffle,
    # and the NEXT batch assembled on a background thread while this one
    # trains. The cursor moves the stream to the resume epoch.
    loader = data.PrefetchLoader(
        data.ArraySource([images, labels]), args.batch_size,
        rank=rank, world=size, epochs=args.epochs)
    if start:
        cur = loader.cursor()
        cur["epoch"] = start
        loader.set_cursor(cur)
    epoch_losses, step_losses, step_s, save_ms = [], [], [], []
    for epoch in range(start, args.epochs):
        losses, seen = [], 0
        for _ in range(loader.batches_remaining_in_epoch()):
            t0 = time.perf_counter()
            bx, by = next(loader)
            x = torch.from_numpy(bx).to(dev).permute(0, 3, 1, 2)
            model.train()
            opt.zero_grad()
            loss = training.softmax_cross_entropy(
                model(x), torch.from_numpy(by).to(dev))
            loss.backward()
            # fused cross-rank gradient average (each rank's BatchNorm
            # statistics stay its own, as in the reference's torch
            # example)
            hvd.fused_allreduce_([p.grad for p in params], op=hvd.Average)
            opt.step()
            losses.append(loss.item())
            step_s.append(time.perf_counter() - t0)
            seen += len(bx)
        step_losses += losses
        mean_loss = float(hvd.allreduce(
            torch.tensor(np.float32(np.mean(losses)), device=dev),
            op=hvd.Average))
        epoch_losses.append(mean_loss)
        t0 = time.perf_counter()
        checkpoint.save_checkpoint(args.ckpt_dir, epoch + 1, model, opt,
                                   meta={"epoch": epoch + 1}, keep=3)
        save_ms.append(1e3 * (time.perf_counter() - t0))
        if rank == 0:
            print(f"epoch {epoch + 1}: loss {mean_loss:.4f} "
                  f"({seen * size} examples/epoch across {size} ranks)")
    loader.close()
    print(f"rank {rank} done")
    return {"start": start, "epoch_losses": epoch_losses,
            "losses": step_losses, "step_s": step_s, "save_ms": save_ms}


if __name__ == "__main__":
    main()
