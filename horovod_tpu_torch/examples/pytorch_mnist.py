"""Horovod's classic torch API on a small MNIST net: the port of
``examples/pytorch_mnist.py`` (reference: Horovod's
``examples/pytorch_mnist.py``) over the port's own adapter,
``horovod_tpu_torch.torch``: per-rank data shards,
``DistributedOptimizer``, the startup broadcasts. The model and the
batches sit on this rank's card unless ``--device cpu``; the adapter's
collectives stage card tensors through pinned host memory.

    python -m horovod_tpu_torch.run -np 2 \\
        python -m horovod_tpu_torch.examples.pytorch_mnist --device cpu

``main`` returns each epoch's averaged loss.
"""

import argparse

import numpy as np
import torch
import torch.nn.functional as F

import horovod_tpu_torch.torch as hvd
from horovod_tpu_torch import basics


class Net(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc1 = torch.nn.Linear(784, 128)
        self.fc2 = torch.nn.Linear(128, 10)

    def forward(self, x):
        x = F.relu(self.fc1(x.reshape(x.shape[0], -1)))
        return F.log_softmax(self.fc2(x), dim=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cpu, or a card (default: this rank's card)")
    args = ap.parse_args(argv)
    hvd.init(device=args.device)
    dev = basics.device()  # init()'s choice
    torch.manual_seed(42 + hvd.rank())

    rng = np.random.default_rng(0)
    n = 2048
    labels = rng.integers(0, 10, size=(n,))
    # synthetic digits: a bright column at 2*label over noise
    images = (rng.standard_normal((n, 28, 28)) * 0.1).astype(np.float32)
    images[np.arange(n), :, labels * 2] += 1.0
    # shard by rank (the DistributedSampler pattern)
    Xl = torch.from_numpy(images[hvd.rank()::hvd.size()]).to(dev)
    yl = torch.from_numpy(labels[hvd.rank()::hvd.size()]).to(dev)

    model = Net().to(dev)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.05, momentum=0.9),
        named_parameters=model.named_parameters())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(opt, root_rank=0)

    first = None
    epochs = []
    for epoch in range(4):
        losses = []
        for i in range(0, len(Xl), 64):
            xb, yb = Xl[i:i + 64], yl[i:i + 64]
            opt.zero_grad()
            loss = F.nll_loss(model(xb), yb)
            loss.backward()
            opt.step()
            losses.append(loss.item())
        avg = float(np.asarray(hvd.allreduce(
            torch.tensor(np.mean(losses)), name=f"loss.{epoch}")))
        epochs.append(avg)
        if hvd.rank() == 0:
            print(f"epoch {epoch}: loss {avg:.4f}")
        if first is None:
            first = avg
    assert avg < first * 0.6, (first, avg)
    if hvd.rank() == 0:
        print("done")
    return {"epoch_losses": epochs}


if __name__ == "__main__":
    main()
