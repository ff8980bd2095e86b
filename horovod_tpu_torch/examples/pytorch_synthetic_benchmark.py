"""Horovod's classic torch API under the synthetic-benchmark protocol:
the port of ``examples/pytorch_synthetic_benchmark.py`` (reference:
Horovod's ``examples/pytorch_synthetic_benchmark.py``, the script behind
its published numbers) over the port's own adapter,
``horovod_tpu_torch.torch``: timed batches after warmup, img/sec through
the adapter's ``DistributedOptimizer``. The model and the batch sit on
this rank's card unless ``--device cpu``; the adapter's collectives run
on the host (card tensors staged through pinned memory), so this
measures the classic API's surface. The port's main path on the card is
``synthetic_benchmark.py``.

    python -m horovod_tpu_torch.run -np 2 \\
        python -m horovod_tpu_torch.examples.pytorch_synthetic_benchmark \\
        --device cpu --num-iters 3

``main`` returns the iterations' img/sec of this process.
"""

import argparse
import time

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

import horovod_tpu_torch.torch as hvd
from horovod_tpu_torch import basics


class SmallNet(nn.Module):
    """A conv net sized so a benchmark of the host data plane finishes in
    seconds (the reference's ``--model resnet50`` comes through
    torchvision; this keeps the example free of it)."""

    def __init__(self, image_size=32):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 16, 3, padding=1)
        self.conv2 = nn.Conv2d(16, 32, 3, padding=1, stride=2)
        self.fc = nn.Linear(32 * ((image_size + 1) // 2) ** 2, 10)

    def forward(self, x):
        x = F.relu(self.conv1(x))
        x = F.relu(self.conv2(x))
        return self.fc(x.flatten(1))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--image-size", type=int, default=32)
    ap.add_argument("--num-warmup-batches", type=int, default=2)
    ap.add_argument("--num-batches-per-iter", type=int, default=5)
    ap.add_argument("--num-iters", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="cpu, or a card (default: this rank's card)")
    args = ap.parse_args(argv)

    hvd.init(device=args.device)
    dev = basics.device()  # init()'s choice
    torch.manual_seed(hvd.rank())
    model = SmallNet(image_size=args.image_size).to(dev)
    opt = torch.optim.SGD(model.parameters(), lr=0.01 * hvd.size(),
                          momentum=0.9)
    opt = hvd.DistributedOptimizer(
        opt, named_parameters=model.named_parameters())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(opt, root_rank=0)

    data = torch.randn(args.batch_size, 3, args.image_size,
                       args.image_size).to(dev)
    target = torch.randint(0, 10, (args.batch_size,)).to(dev)

    def benchmark_step():
        opt.zero_grad()
        loss = F.cross_entropy(model(data), target)
        loss.backward()
        opt.step()

    def synced():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    for _ in range(args.num_warmup_batches):
        benchmark_step()

    img_secs = []
    for i in range(args.num_iters):
        t0 = synced()
        for _ in range(args.num_batches_per_iter):
            benchmark_step()
        dt = synced() - t0
        rate = args.batch_size * args.num_batches_per_iter / dt
        img_secs.append(rate)
        if hvd.rank() == 0:
            print(f"Iter #{i}: {rate:.1f} img/sec per process")
    if hvd.rank() == 0:
        print(f"Img/sec per process: {np.mean(img_secs):.1f} "
              f"+- {1.96 * np.std(img_secs):.1f}")
        print(f"Total img/sec on {hvd.size()} processes: "
              f"{np.mean(img_secs) * hvd.size():.1f}")
    print("done")
    return {"img_secs": img_secs}


if __name__ == "__main__":
    main()
