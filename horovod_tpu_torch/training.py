"""Training-step builders: the Horovod programming model in PyTorch.

The port of ``horovod_tpu/training.py``'s ``softmax_cross_entropy``,
``create_train_state``, ``make_train_step`` (the explicit path, with its
microbatch loop and overlapped reduce-scatter pipeline) and
``make_lm_train_step`` (the data-parallel path without sequence
sharding). The JAX step is a pure function returning a new
``TrainState``; here the step runs eagerly on this process's shard of
the batch and updates the model's parameters and the optimizer's state
in place.
"""

import hashlib
import inspect

import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch import hvd_torch
from horovod_tpu_torch.ops import collective, fusion
from horovod_tpu_torch.ops.reduction import Average, Sum
from horovod_tpu_torch.parallel import mesh as mesh_lib
from horovod_tpu_torch.parallel import zero


def softmax_cross_entropy(logits, labels):
    """Mean cross-entropy with integer labels (fp32 log-softmax)."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels[..., None])[..., 0].mean()


def create_train_state(model, optimizer, root_rank=0):
    """Make every rank's replica start from ``root_rank``'s parameters and
    optimizer state (in place)."""
    hvd_torch.broadcast_parameters(model.state_dict(), root_rank=root_rank)
    hvd_torch.broadcast_optimizer_state(optimizer, root_rank=root_rank)


def _dropout_generator(device, *ints):
    """A generator on ``device`` seeded from ``ints`` (seed, step, rank,
    microbatch): one independent stream for each, as the JAX step folds
    them into its dropout key."""
    digest = hashlib.blake2b(repr(ints).encode(), digest_size=8).digest()
    gen = torch.Generator(device=device)
    gen.manual_seed(int.from_bytes(digest, "little") >> 1)
    return gen


def make_train_step(model, optimizer, loss_fn=softmax_cross_entropy,
                    dropout_seed=0, accum_steps=1, overlap_grads=False):
    """Build a classification train step over the data axis.
    ``step(inputs, labels)`` takes this rank's shard of the batch, puts
    the model in training mode, runs forward, backward and the optimizer
    step, and returns the loss averaged over ranks (an fp32 scalar tensor
    on the device).

    ``accum_steps=K`` splits the shard into K equal microbatches and
    accumulates their gradients (one optimizer step per call). Without
    ``overlap_grads`` they add up in ``.grad``, are scaled by 1/K, and
    ``optimizer.step()`` exchanges them. With ``overlap_grads=True`` the
    exchange is the bucketed reduce-scatter pipeline: as soon as a
    microbatch's backward ends, every bucket of the reverse-order
    schedule is packed and reduce-scattered asynchronously, in schedule
    order, so the next microbatch computes while they run (on the card,
    on NCCL's stream). The reduced shards are summed over microbatches and
    scaled by 1/K, then feed either the ZeRO-1 update
    (``DistributedOptimizer(sharded_update=True)``) or one all-gather per
    bucket and the inner optimizer. ``accum_steps > 1`` and
    ``overlap_grads`` need a ``DistributedOptimizer``; a model with
    BatchNorm layers is not supported yet (its statistics would need
    averaging across ranks). The overlapped pipeline resolves the wire
    format here, once, as the JAX step does: a compressed
    ``HOROVOD_WIRE_DTYPE`` default raises.

    A model whose ``forward`` takes ``dropout_generator`` (such as
    ``models.simple.MNISTConvNet``) is given a generator seeded from
    ``dropout_seed``, the step count, this rank and the microbatch index,
    so every rank and microbatch draws its own masks."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    pipelined = overlap_grads or accum_steps > 1
    is_hvd = isinstance(optimizer, hvd_torch.DistributedOptimizer)
    if pipelined:
        if not is_hvd:
            raise ValueError(
                "accum_steps>1 / overlap_grads=True need the optimizer "
                "built by DistributedOptimizer(...): the pipeline takes "
                "over its gradient reduction")
        if optimizer.backward_passes_per_step > 1:
            raise ValueError(
                "accum_steps and backward_passes_per_step are two "
                "accumulators for the same thing; use accum_steps")
    if any(isinstance(m, nn.modules.batchnorm._BatchNorm)
           for m in model.modules()):
        raise NotImplementedError(
            "make_train_step does not average BatchNorm statistics across "
            "ranks yet (ROADMAP Queue 1 item 7)")
    mesh = mesh_lib.get_mesh()
    if overlap_grads:
        optimizer.check_uncompressed()
    takes_rng = "dropout_generator" in inspect.signature(
        model.forward).parameters
    sharded = is_hvd and optimizer.sharded_update
    schedule = None
    if sharded:
        schedule = optimizer.zero_state.plan.schedule
    elif overlap_grads:
        schedule = fusion.bucket_schedule(
            optimizer.params, mesh.size,
            threshold_bytes=optimizer.threshold_bytes)
    params = optimizer.params if is_hvd else None
    rs_op = optimizer.zero_state.plan.op if sharded else (
        optimizer.op if is_hvd else None)
    inv_k = 1.0 / accum_steps
    steps_done = 0

    def forward(x, k):
        if not takes_rng:
            return model(x)
        return model(x, dropout_generator=_dropout_generator(
            mesh.device, dropout_seed, steps_done, mesh.rank, k))

    def reduce_scatter():
        """Issue every bucket of this microbatch's gradients, in schedule
        order, then drop the gradients: the packed copies carry them."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        issued = [fusion.reduce_scatter_bucket(schedule, i, grads, op=rs_op,
                                               async_op=True)
                  for i in range(len(schedule.buckets))]
        for p in params:
            p.grad = None
        return issued

    def step(inputs, labels):
        nonlocal steps_done
        model.train()
        inputs, labels = inputs.to(mesh.device), labels.to(mesh.device)
        if inputs.shape[0] % accum_steps:
            raise ValueError(
                f"per-rank batch {inputs.shape[0]} does not divide into "
                f"accum_steps={accum_steps} microbatches")
        micro = inputs.shape[0] // accum_steps
        optimizer.zero_grad(set_to_none=True)
        loss_sum, shards, pending = 0.0, None, None
        for k in range(accum_steps):
            part = slice(k * micro, (k + 1) * micro)
            loss_k = loss_fn(forward(inputs[part], k), labels[part])
            loss_k.backward()
            loss_sum = loss_sum + loss_k.detach()
            if overlap_grads:
                issued = reduce_scatter()
                if pending is not None:
                    shards = _add_waited(shards, pending)
                pending = issued
        with torch.no_grad():
            if overlap_grads:
                shards = [s * inv_k for s in _add_waited(shards, pending)]
                if sharded:
                    zero.apply_shards(optimizer.zero_state, shards)
                else:
                    for i, s in enumerate(shards):
                        flat = fusion.all_gather_bucket(schedule, i, s)
                        for j, g in fusion.unpack_bucket(
                                schedule, i, flat, params).items():
                            params[j].grad = g
                    optimizer.update_preaveraged()
            else:
                if pipelined:
                    for p in params:
                        if p.grad is not None:
                            p.grad.mul_(inv_k)
                optimizer.step()
            steps_done += 1
            return collective.allreduce_(loss_sum * inv_k, op=Average)

    step.schedule = schedule
    return step


def _add_waited(acc, pending):
    """Wait for one microbatch's reduce-scatters, in schedule order, and
    add their shards to ``acc`` (None for the first microbatch)."""
    shards = [p.wait() for p in pending]
    return shards if acc is None else [a + s for a, s in zip(acc, shards)]


def make_lm_train_step(model, optimizer):
    """Build a language-model train step (next-token loss) over the data
    axis. ``optimizer`` is a ``DistributedOptimizer`` (any exchange:
    fused allreduce, ZeRO-1, ``backward_passes_per_step``);
    ``step(tokens)`` takes this rank's ``[B_local, S]`` int tokens, runs
    forward, backward and the optimizer step, and returns the loss
    averaged over ranks (an fp32 scalar tensor on the device).

    The loss is normalized by the GLOBAL target count: the local sum is
    scaled by ``world / global_count``, so that averaging the per-rank
    losses and gradients gives the exact global-mean loss and gradient
    even when ranks hold different numbers of targets."""
    if not isinstance(optimizer, hvd_torch.DistributedOptimizer):
        raise TypeError("make_lm_train_step needs a DistributedOptimizer")
    mesh = mesh_lib.get_mesh()

    def step(tokens):
        tokens = tokens.to(mesh.device)
        targets = tokens[:, 1:]
        optimizer.zero_grad(set_to_none=True)
        local_count = torch.tensor(float(targets.numel()), device=mesh.device)
        global_count = collective.allreduce_(local_count.clone(), op=Sum)
        local_mean = softmax_cross_entropy(model(tokens)[:, :-1], targets)
        loss = local_mean * local_count * mesh.size / global_count
        loss.backward()
        optimizer.step()  # reduces the gradients first
        return collective.allreduce_(loss.detach(), op=Average)

    return step
