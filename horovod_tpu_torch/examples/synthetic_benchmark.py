"""Synthetic throughput benchmark: the port of
``examples/jax_synthetic_benchmark.py`` (reference:
``examples/pytorch_synthetic_benchmark.py``), at its flags and defaults:
timed batches after warmup, img/sec through ``DistributedOptimizer``'s
fused allreduce and ``training.make_train_step``.

The model computes in bf16 on the card and in fp32 on the CPU
(``utils.benchmarks.compute_dtype``, the JAX example's rule); weights
from the port's seed. Each rank takes its row block of the global batch
of ``--batch-size`` images a card, drawn as the JAX example draws it.
Each iteration is timed by the slope-window timer
(``utils.benchmarks.slope_window``, base 1 and ``--num-batches-per-iter``
steps); over several ranks each window's inversion test reads the
least slope of any rank, so the ranks' windows pair up. Rank 0 prints.

On the card:
    python -m horovod_tpu_torch.examples.synthetic_benchmark \\
        --model resnet50 --batch-size 64 --num-iters 10
On the CPU:
    python -m horovod_tpu_torch.run -np 2 \\
        python -m horovod_tpu_torch.examples.synthetic_benchmark \\
        --device cpu --model resnet18 --batch-size 2 --image-size 32

``main`` returns the rates of the iterations (img/sec over all ranks),
the model it timed, its step in ``utils.benchmarks``' form
``step(state, images, labels) -> (state, loss)`` and this rank's
``(images, labels)``, so that a caller can time it again.
"""

import argparse

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model", default="resnet50",
                   choices=["resnet18", "resnet34", "resnet50", "resnet101",
                            "resnet152", "vgg16"])
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--num-warmup-batches", type=int, default=3)
    p.add_argument("--num-batches-per-iter", type=int, default=10)
    p.add_argument("--num-iters", type=int, default=5)
    p.add_argument("--fp16-allreduce", action="store_true",
                   help="bf16 wire compression for gradient allreduce")
    p.add_argument("--device", default=None,
                   help="cpu, or a card (default: this rank's card)")
    args = p.parse_args(argv)

    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import training
    from horovod_tpu_torch.utils import benchmarks as bench

    hvd.init(device=args.device)
    ndev, rank, dev = hvd.size(), hvd.rank(), hvd.device()
    dtype = bench.compute_dtype(dev)
    model = bench.make_model(args.model, dtype=dtype, num_classes=1000,
                             device=dev, image_size=args.image_size)
    compression = hvd.Compression.bf16 if args.fp16_allreduce else None
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9),
        compression=compression)

    gb = args.batch_size * ndev
    rng = np.random.default_rng(0)
    images = rng.standard_normal((gb, args.image_size, args.image_size, 3))
    labels = rng.integers(0, 1000, size=(gb,))
    mine = slice(rank * args.batch_size, (rank + 1) * args.batch_size)
    images = torch.from_numpy(images[mine]).to(dtype).permute(
        0, 3, 1, 2).contiguous().to(dev)
    labels = torch.from_numpy(labels[mine]).to(dev)

    training.create_train_state(model, opt)
    step = training.make_train_step(model, opt)

    if rank == 0:
        print(f"Model: {args.model}, batch {args.batch_size}/chip x {ndev} "
              f"chips ({dev.type})")
    for _ in range(args.num_warmup_batches):
        step(images, labels)
        bench.sync()

    def least(slope):
        # every rank decides each window's inversion test alike
        t = torch.tensor([slope], dtype=torch.float64, device=dev)
        return float(hvd.allreduce(t, op=hvd.Min)) if ndev > 1 else slope

    def step_once(st):
        return st, step(images, labels)

    img_secs = []
    for i in range(args.num_iters):
        dt, _ = bench.slope_window(step_once, None,
                                   args.num_batches_per_iter, base_iters=1,
                                   agree=least)
        rate = gb * args.num_batches_per_iter / dt
        img_secs.append(rate)
        if rank == 0:
            print(f"Iter #{i}: {rate:.1f} img/sec total")
    if rank == 0:
        print(f"Img/sec per chip: {np.mean(img_secs) / ndev:.1f} "
              f"+- {1.96 * np.std(img_secs) / ndev:.1f}")
        print(f"Total img/sec on {ndev} chip(s): {np.mean(img_secs):.1f} "
              f"+- {1.96 * np.std(img_secs):.1f}")
    return {"img_secs": img_secs, "model": model,
            "step": lambda st, x, y: (st, step(x, y)),
            "batch": (images, labels)}


if __name__ == "__main__":
    main()
