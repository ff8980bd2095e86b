"""Horovod's TF2 custom training loop on an MNIST-shaped task: the port of
``examples/tensorflow2_mnist.py`` (reference: Horovod's
``examples/tensorflow2_mnist.py``) over the port's own adapter,
``horovod_tpu_torch.tensorflow``: ``DistributedGradientTape`` around a
plain ``tf.GradientTape``, the variables broadcast from rank 0 after the
first step, a rank-0-only checkpoint, and a check that every rank holds
the same weights. TensorFlow runs on the CPU, as in the JAX package's
example.

    python -m horovod_tpu_torch.run -np 2 \\
        python -m horovod_tpu_torch.examples.tensorflow2_mnist --steps 20

Synthetic MNIST-shaped data keeps it network-free. ``CKPT_DIR`` names
the checkpoint directory (a fresh temporary one by default). ``main``
returns the losses of the steps it printed.
"""

import argparse
import os
import tempfile

import numpy as np
import tensorflow as tf

import horovod_tpu_torch.tensorflow as hvd


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch-size", type=int, default=32)
    args = ap.parse_args(argv)

    hvd.init(device="cpu")
    rng = np.random.default_rng(hvd.rank())  # rank-disjoint data

    model = tf.keras.Sequential([
        tf.keras.Input(shape=(28, 28, 1)),
        tf.keras.layers.Conv2D(8, [3, 3], activation="relu"),
        tf.keras.layers.Flatten(),
        tf.keras.layers.Dense(10),
    ])
    loss_fn = tf.keras.losses.SparseCategoricalCrossentropy(
        from_logits=True)
    # reference recipe: lr scaled by world size
    opt = tf.keras.optimizers.SGD(learning_rate=0.01 * hvd.size())

    @tf.function
    def train_step(images, labels):
        with tf.GradientTape() as tape:
            logits = model(images, training=True)
            loss = loss_fn(labels, logits)
        # DistributedGradientTape averages gradients across ranks
        tape = hvd.DistributedGradientTape(tape)
        grads = tape.gradient(loss, model.trainable_variables)
        opt.apply_gradients(zip(grads, model.trainable_variables))
        return loss

    printed = []
    for step in range(args.steps):
        images = tf.constant(rng.normal(
            size=(args.batch_size, 28, 28, 1)).astype(np.float32))
        labels = tf.constant(rng.integers(
            0, 10, size=(args.batch_size,)).astype(np.int64))
        loss = train_step(images, labels)
        if step == 0:
            # reference: broadcast variables after the first step so
            # late-created slot variables sync too
            hvd.broadcast_variables(model.variables, root_rank=0)
            # Keras 3 exposes .variables as a property; legacy Keras 2
            # optimizers as a method
            opt_vars = opt.variables() if callable(opt.variables) \
                else opt.variables
            hvd.broadcast_variables(opt_vars, root_rank=0)
        if step % 10 == 0 and hvd.rank() == 0:
            printed.append(float(loss))
            print(f"step {step} loss {float(loss):.4f}")

    # rank-0-only checkpoint
    if hvd.rank() == 0:
        ckpt_dir = os.environ.get("CKPT_DIR", tempfile.mkdtemp())
        path = os.path.join(ckpt_dir, "model.weights.h5")
        model.save_weights(path)
        print(f"checkpoint: {os.path.basename(path)}")
    # prove sync: weights must be identical across ranks
    flat = np.concatenate([v.numpy().ravel()
                           for v in model.trainable_variables])
    digest = float(np.sum(flat ** 2))
    gathered = hvd.allgather(
        tf.constant([digest], tf.float64), name="digest").numpy()
    assert np.allclose(gathered, gathered[0]), gathered
    print("done")
    return {"losses": printed}


if __name__ == "__main__":
    main()
