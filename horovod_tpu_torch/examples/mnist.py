"""MNIST-scale training: the port of ``examples/jax_mnist.py`` (reference:
``examples/tensorflow2_mnist.py``): wrap the optimizer, broadcast the
initial state, shard the batch. Synthetic data, so it runs hermetically.

The JAX example drives ``ndev`` devices from one process over a global
batch of ``16 * ndev``; here each rank drives one card, draws the same
global batch from the same seed and takes its row block, as JAX's step
shards the batch over its devices, so the averaged gradients are the
global batch's mean. Rank 0 prints.

On the card:   python -m horovod_tpu_torch.examples.mnist
On the CPU:    python -m horovod_tpu_torch.run -np 2 \\
                   python -m horovod_tpu_torch.examples.mnist --device cpu

``main`` returns each epoch's mean loss.
"""

import argparse

import numpy as np


def build_model(device):
    """The ``MNISTConvNet``, its weights from the port's seed."""
    from horovod_tpu_torch.models import MNISTConvNet
    return MNISTConvNet(device=device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cpu, or a card (default: this rank's card)")
    args = ap.parse_args(argv)

    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import convert, training

    hvd.init(device=args.device)
    ndev, rank, dev = hvd.size(), hvd.rank(), hvd.device()
    rng = np.random.default_rng(0)

    # synthetic "MNIST": a bright column at 2*label over noise
    n = 128 * ndev
    labels = rng.integers(0, 10, size=(n,))
    images = (rng.standard_normal((n, 28, 28, 1)) * 0.1).astype(np.float32)
    images[np.arange(n), :, labels * 2, 0] += 1.0

    model = build_model(dev)
    opt = hvd.DistributedOptimizer(
        torch.optim.Adam(model.parameters(), lr=3e-3),
        named_parameters=convert.flax_named_parameters(model))
    training.create_train_state(model, opt)
    step = training.make_train_step(model, opt)

    per_rank = 16
    batch = per_rank * ndev
    mine = slice(rank * per_rank, (rank + 1) * per_rank)
    first_epoch_loss = None
    epochs = []
    for epoch in range(6):
        perm = rng.permutation(n)
        epoch_loss = []
        for i in range(0, n, batch):
            idx = perm[i:i + batch]
            if len(idx) < batch:
                break
            idx = idx[mine]
            loss = step(torch.from_numpy(images[idx]),
                        torch.from_numpy(labels[idx]))
            epoch_loss.append(float(loss))
        epochs.append(float(np.mean(epoch_loss)))
        if rank == 0:
            print(f"epoch {epoch}: loss {np.mean(epoch_loss):.4f}")
        if first_epoch_loss is None:
            first_epoch_loss = np.mean(epoch_loss)
    assert np.mean(epoch_loss) < first_epoch_loss * 0.6, "did not learn"
    if rank == 0:
        print("done")
    return {"epoch_losses": epochs}


if __name__ == "__main__":
    main()
