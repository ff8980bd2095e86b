"""Horovod's Keras recipe on an MNIST-shaped task: the port of
``examples/tensorflow2_keras_mnist.py`` (reference: Horovod's
``examples/tensorflow2_keras_mnist.py``) over the port's own adapter,
``horovod_tpu_torch.tensorflow``: the ``DistributedOptimizer`` wrap, the
learning rate scaled by the world's size, the broadcast and
metric-average callbacks, and rank-0-only checkpoints with a broadcast
resume epoch. TensorFlow runs on the CPU, as in the JAX package's
example; the collectives go through the native host core.

    python -m horovod_tpu_torch.run -np 2 \\
        python -m horovod_tpu_torch.examples.tensorflow2_keras_mnist \\
        --epochs 2

Synthetic MNIST-shaped data keeps it network-free; swap in
``tf.keras.datasets.mnist`` outside sandboxes. ``CKPT_DIR`` names the
checkpoint directory (a fresh temporary one by default). ``main``
returns the epochs' losses.
"""

import argparse
import os
import tempfile

import numpy as np
import tensorflow as tf

import horovod_tpu_torch.tensorflow as hvd
import horovod_tpu_torch.tensorflow.keras as hvd_keras
from horovod_tpu_torch.tensorflow.callbacks import (
    BroadcastGlobalVariablesCallback, MetricAverageCallback)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--samples", type=int, default=256)
    args = ap.parse_args(argv)

    hvd.init(device="cpu")

    # rank-disjoint synthetic data (each rank sees its own shard)
    rng = np.random.default_rng(hvd.rank())
    images = rng.normal(size=(args.samples, 28, 28, 1)).astype(np.float32)
    labels = rng.integers(0, 10, size=(args.samples,)).astype(np.int64)

    # resume conventions (reference keras_imagenet_resnet50.py:102-158):
    # rank 0 finds the newest checkpoint epoch on disk, the epoch number
    # is BROADCAST so every rank agrees, and rank 0's model state loads
    # from the file (BroadcastGlobalVariablesCallback then syncs the
    # weights to everyone)
    ckpt_dir = os.environ.get("CKPT_DIR", tempfile.mkdtemp())
    resume_from_epoch = 0
    if hvd.rank() == 0:
        for epoch in range(args.epochs, 0, -1):
            if os.path.exists(os.path.join(ckpt_dir,
                                           f"ckpt-{epoch}.keras")):
                resume_from_epoch = epoch
                break
    resume_from_epoch = int(hvd.broadcast(
        tf.constant(resume_from_epoch, tf.int64), root_rank=0,
        name="resume_from_epoch").numpy())

    if resume_from_epoch > 0 and hvd.rank() == 0:
        model = hvd_keras.load_model(
            os.path.join(ckpt_dir, f"ckpt-{resume_from_epoch}.keras"))
        print(f"resuming from epoch {resume_from_epoch}")
    else:
        model = tf.keras.Sequential([
            tf.keras.Input(shape=(28, 28, 1)),
            tf.keras.layers.Conv2D(8, [3, 3], activation="relu"),
            tf.keras.layers.MaxPooling2D(pool_size=(2, 2)),
            tf.keras.layers.Flatten(),
            tf.keras.layers.Dense(32, activation="relu"),
            tf.keras.layers.Dense(10, activation="softmax"),
        ])
        # reference recipe: scale lr by world size, wrap the optimizer
        opt = hvd_keras.DistributedOptimizer(
            tf.keras.optimizers.SGD(learning_rate=0.01 * hvd.size(),
                                    momentum=0.9))
        model.compile(optimizer=opt,
                      loss="sparse_categorical_crossentropy",
                      metrics=["accuracy"])

    callbacks = [BroadcastGlobalVariablesCallback(0),
                 MetricAverageCallback()]
    # rank-0-only checkpointing
    if hvd.rank() == 0:
        callbacks.append(tf.keras.callbacks.ModelCheckpoint(
            os.path.join(ckpt_dir, "ckpt-{epoch}.keras")))

    hist = model.fit(images, labels, batch_size=args.batch_size,
                     epochs=args.epochs,
                     initial_epoch=resume_from_epoch,
                     verbose=1 if hvd.rank() == 0 else 0,
                     callbacks=callbacks)
    losses = hist.history.get("loss", [])
    final = losses[-1] if losses else float("nan")
    print(f"rank {hvd.rank()} final loss {final:.4f}")
    if hvd.rank() == 0:
        saved = sorted(os.listdir(ckpt_dir))
        assert saved, "rank-0 checkpoints missing"
        print(f"checkpoints: {saved}")
    print("done")
    return {"losses": [float(x) for x in losses]}


if __name__ == "__main__":
    main()
