"""Hierarchical (intra-host x cross-host) data-parallel training: the port
of ``examples/jax_hierarchical_allreduce.py`` (the reference's
NCCLHierarchicalAllreduce, ``nccl_operations.cc:150``), at its flags and
defaults.

A job over several hosts of equal rank counts runs on ``init()``'s
``(dcn, data)`` mesh (``HOROVOD_CROSS_SIZE`` hosts of
``HOROVOD_LOCAL_SIZE`` ranks), and gradient reduction runs reduce-scatter
over the ranks of a host, allreduce of the 1/k shard across hosts, then
all-gather within the host, paying the slow link only 1/k of the bytes
(``DistributedOptimizer(axes=..., hierarchical=True)``). ``--slices``
must equal the job's hosts (the mesh's ``dcn`` size).

A ResNet-18 in fp32 over ``--batch-per-chip`` images of 32x32 a rank,
each rank its row block of the global batch, weights from the port's
seed. Rank 0 prints. Two hosts of two ranks on one machine, over gloo:

    for r in 0 1 2 3; do
      HOROVOD_RANK=$r HOROVOD_SIZE=4 HOROVOD_LOCAL_RANK=$((r % 2)) \\
      HOROVOD_LOCAL_SIZE=2 HOROVOD_CROSS_RANK=$((r / 2)) \\
      HOROVOD_CROSS_SIZE=2 MASTER_ADDR=127.0.0.1 MASTER_PORT=29500 \\
      python -m horovod_tpu_torch.examples.hierarchical_allreduce \\
          --device cpu --slices 2 &
    done; wait

``main`` returns each step's loss.
"""

import argparse

import numpy as np


def build_model(device):
    """The ResNet-18, its weights from the port's seed."""
    import torch

    from horovod_tpu_torch import models
    return models.ResNet18(num_classes=10, dtype=torch.float32,
                           device=device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--slices", type=int, default=2,
                    help="DCN axis size (number of slices), >= 2")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch-per-chip", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="cpu, or a card (default: this rank's card)")
    args = ap.parse_args(argv)
    if args.slices < 2:
        raise SystemExit("--slices must be >= 2: with one slice there is "
                         "no DCN axis and nothing hierarchical to show")
    if args.steps < 1:
        raise SystemExit("--steps must be >= 1")

    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import training
    from horovod_tpu_torch.parallel import mesh as mesh_lib

    hvd.init(device=args.device)
    mesh = hvd.mesh()
    shape = dict(zip(mesh.axis_names, mesh.shape))
    if shape.get("dcn", 1) != args.slices:
        raise SystemExit(
            f"--slices {args.slices} needs a job over {args.slices} hosts "
            f"of equal rank counts; init()'s mesh is {shape} "
            "(HOROVOD_CROSS_SIZE sets the hosts)")
    axes = mesh_lib.data_axis_names(mesh)
    ndev = mesh.size
    if hvd.rank() == 0:
        print(f"mesh axes {shape} -> reduce-scatter over "
              f"{axes[-1]!r} (ICI), allreduce over {axes[0]!r} (DCN)")

    model = build_model(hvd.device())
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.05, momentum=0.9),
        axes=axes, hierarchical=True)

    rng = np.random.default_rng(0)
    n = args.batch_per_chip * ndev
    images = rng.standard_normal((n, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, 10, size=(n,))
    # the row block of this rank's place in the mesh (JAX's batch shard)
    r = hvd.mesh_rank(axes)
    mine = slice(r * args.batch_per_chip, (r + 1) * args.batch_per_chip)
    images = torch.from_numpy(images[mine]).permute(0, 3, 1, 2)
    labels = torch.from_numpy(labels[mine])

    training.create_train_state(model, opt)
    step = training.make_train_step(model, opt)
    losses = []
    for _ in range(args.steps):
        losses.append(float(step(images, labels)))
    if hvd.rank() == 0:
        print(f"done: loss {losses[0]:.4f} -> {losses[-1]:.4f} over "
              f"{shape}")
    return {"losses": losses}


if __name__ == "__main__":
    main()
