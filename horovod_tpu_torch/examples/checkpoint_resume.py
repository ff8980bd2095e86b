"""Checkpoint and resume: the port of ``examples/jax_checkpoint_resume.py``
(reference pattern: ``examples/keras_imagenet_resnet50.py:85-103,156-158``),
at its flags and defaults.

The distributed checkpoint discipline:

* only rank 0 writes checkpoints (other workers would corrupt them),
* the resume step is found on rank 0 and broadcast,
* the parameters and the optimizer state are broadcast from rank 0 after
  the restore, so every worker starts identical.

The file is the JAX package's (``checkpoint.py``: the flax tree of the
parameters ``{"w"}`` and of ``optax.adam``'s state under the JAX
``DistributedOptimizer``), so a run of either package resumes the
other's. The weights start at zero in both.

Run, stop it midway (Ctrl-C), run it again: it resumes where it stopped.
On the CPU, two ranks over gloo:

    python -m horovod_tpu_torch.run -np 2 \\
        python -m horovod_tpu_torch.examples.checkpoint_resume \\
        --device cpu --epochs 20

``main`` returns each epoch's averaged loss and the final error.
"""

import argparse

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt-dir", default="/tmp/hvd_tpu_ckpt")
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--device", default=None,
                    help="cpu, or a card (default: this rank's card)")
    args = ap.parse_args(argv)

    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import checkpoint, convert

    hvd.init(device=args.device)
    rank, size, dev = hvd.rank(), hvd.size(), hvd.device()

    # deterministic synthetic regression task, sharded by rank
    rng = np.random.RandomState(42)
    X = rng.randn(256, 8).astype(np.float32)
    W_true = rng.randn(8, 1).astype(np.float32)
    Y = X @ W_true
    xs = torch.from_numpy(X[rank::size]).to(dev)
    ys = torch.from_numpy(Y[rank::size]).to(dev)

    model = torch.nn.Module()  # the parameters {"w"}
    model.w = torch.nn.Parameter(torch.zeros(8, 1, device=dev))
    opt = hvd.DistributedOptimizer(
        torch.optim.Adam(model.parameters(), lr=args.lr),
        named_parameters=convert.flax_named_parameters(model))

    # the whole resume convention in one call: rank 0 restores the newest
    # checkpoint (if any), everyone gets the broadcast step, parameters
    # and optimizer state
    start, meta = checkpoint.restore_or_init(args.ckpt_dir, model, opt)
    if rank == 0 and start > 0:
        print(f"resuming from step {start} (meta={meta})")

    losses = []
    for epoch in range(start, args.epochs):
        opt.zero_grad()
        loss = torch.mean((xs @ model.w - ys) ** 2)
        loss.backward()
        opt.step()
        # average the metric across workers before logging
        mean_loss = float(hvd.allreduce(loss.detach(), op=hvd.Average))
        losses.append(mean_loss)
        # rank-0-only write; keep the 3 newest
        checkpoint.save_checkpoint(args.ckpt_dir, epoch + 1, model, opt,
                                   meta={"epoch": epoch + 1}, keep=3)
        if rank == 0:
            print(f"epoch {epoch + 1}: loss {mean_loss:.6f}")

    err = float(np.max(np.abs(model.w.detach().cpu().numpy() - W_true)))
    if rank == 0:
        print(f"done; max |w - w_true| = {err:.4f}")
    return {"start": start, "losses": losses, "err": err}


if __name__ == "__main__":
    main()
