"""Horovod's Gluon recipe on an MNIST-shaped task: the port of
``examples/mxnet_mnist.py`` (reference: Horovod's
``examples/mxnet_mnist.py``) over the port's own adapter,
``horovod_tpu_torch.mxnet``: ``DistributedTrainer``, the parameter
broadcast, the learning rate scaled by the world's size. MXNet runs on
the CPU, as in the JAX package's example; the collectives go through the
native host core. It needs mxnet, which this image lacks (the tests run
it over a stand-in).

    python -m horovod_tpu_torch.run -np 2 \\
        python -m horovod_tpu_torch.examples.mxnet_mnist --epochs 2

Synthetic MNIST-shaped data keeps it network-free. ``main`` returns the
epochs' losses.
"""

import argparse

import numpy as np

import horovod_tpu_torch.mxnet as hvd


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--samples", type=int, default=256)
    ap.add_argument("--lr", type=float, default=0.01)
    args = ap.parse_args(argv)

    import mxnet as mx
    from mxnet import autograd, gluon

    hvd.init(device="cpu")
    ctx = mx.cpu()

    rng = np.random.default_rng(hvd.rank())
    images = mx.nd.array(
        rng.normal(size=(args.samples, 1, 28, 28)).astype(np.float32))
    labels = mx.nd.array(
        rng.integers(0, 10, size=(args.samples,)).astype(np.float32))

    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Conv2D(channels=8, kernel_size=3, activation="relu"),
            gluon.nn.MaxPool2D(pool_size=2),
            gluon.nn.Flatten(),
            gluon.nn.Dense(32, activation="relu"),
            gluon.nn.Dense(10))
    net.initialize(mx.init.Xavier(), ctx=ctx)
    net.hybridize()

    params = net.collect_params()
    # reference recipe: broadcast initial params, scale lr by world size
    hvd.broadcast_parameters(params, root_rank=0)
    trainer = hvd.DistributedTrainer(
        params, "sgd",
        {"learning_rate": args.lr * hvd.size(), "momentum": 0.9})
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()

    n_batches = args.samples // args.batch_size
    epochs = []
    for epoch in range(args.epochs):
        total = 0.0
        for b in range(n_batches):
            lo = b * args.batch_size
            x = images[lo:lo + args.batch_size].as_in_context(ctx)
            y = labels[lo:lo + args.batch_size].as_in_context(ctx)
            with autograd.record():
                out = net(x)
                loss = loss_fn(out, y)
            loss.backward()
            trainer.step(args.batch_size)
            total += float(loss.mean().asscalar())
        epochs.append(total / n_batches)
        if hvd.rank() == 0:
            print(f"epoch {epoch} loss {total / n_batches:.4f}")
    print("done")
    return {"losses": epochs}


if __name__ == "__main__":
    main()
