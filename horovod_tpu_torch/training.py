"""Training-step builders: the Horovod programming model in PyTorch.

The port of ``horovod_tpu/training.py``'s ``softmax_cross_entropy``,
``create_train_state``, ``make_train_step`` (the explicit path, with its
microbatch loop and overlapped reduce-scatter pipeline) and
``make_lm_train_step`` (data-parallel, and sequence-parallel over a
``seq_axis``). The JAX step is a pure function returning a new
``TrainState``; here the step runs eagerly on this process's shard of
the batch and updates the model's parameters, its BatchNorm statistics
and the optimizer's state in place, and counts its calls in a
``StepState``, the counterpart of ``TrainState.step`` that a checkpoint
saves with them (``convert.train_state_to_flat``).
"""

import dataclasses
import hashlib
import inspect
import warnings

import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch import data, hvd_torch
from horovod_tpu_torch.ops import collective, fusion
from horovod_tpu_torch.ops.reduction import Average, Sum
from horovod_tpu_torch.parallel import mesh as mesh_lib
from horovod_tpu_torch.parallel import zero


@dataclasses.dataclass
class StepState:
    """The step count of a training run: the JAX ``TrainState.step``.
    A step builder adds one per call and keys the dropout masks by it,
    and a checkpoint saves and restores it with the model and the
    optimizer, so a restored run draws the masks an unbroken one
    would."""

    step: int = 0


def softmax_cross_entropy(logits, labels):
    """Mean cross-entropy with integer labels (fp32 log-softmax)."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels[..., None].long())[..., 0].mean()


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


def _batch_stats(model):
    """The floating running-statistics buffers of the model's BatchNorm
    layers, in module order (integer counters such as
    ``num_batches_tracked`` are left out)."""
    return [b for m in model.modules()
            if isinstance(m, nn.modules.batchnorm._BatchNorm)
            for b in (m.running_mean, m.running_var)
            if b is not None and b.is_floating_point()]


def make_train_step(model, optimizer, loss_fn=softmax_cross_entropy,
                    dropout_seed=0, accum_steps=1, overlap_grads=False,
                    error_feedback=True, loader=None):
    """Build a classification train step over the data axis.
    ``step(inputs, labels)`` takes this rank's shard of the batch, puts
    the model in training mode, runs forward, backward and the optimizer
    step, and returns the loss averaged over ranks (an fp32 scalar tensor
    on the device). ``step.state``, a ``StepState``, counts the calls
    that succeed.

    ``loader`` (a ``data.PrefetchLoader``) feeds the step: its producer
    thread stages each batch onto this rank's device
    (``data.device_placement``) while the previous step runs, and
    ``step()`` with no batch pulls ``(inputs, labels)`` from it; a loader
    whose batches are not pairs raises ``TypeError``, as does ``step()``
    without one.

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
    ``overlap_grads`` need a ``DistributedOptimizer``.

    The schedule of the overlapped pipeline scatters over the
    optimizer's axes, ICI-first when ``optimizer.hierarchical_resolved()``
    and the mesh has a ``dcn`` axis (``fusion.bucket_schedule``); it
    reduce-scatters, so it takes Sum and Average only.

    BatchNorm: each microbatch's forward updates the running statistics
    in place, in microbatch order; after the optimizer step every
    floating statistics buffer is averaged over ranks (each rank
    normalizes over its own sub-batch, as Horovod's ranks do, unless the
    model synchronizes its BatchNorm: ``models.resnet.ResNet(
    bn_cross_replica_axes=...)``). torch's ``nn.SyncBatchNorm`` is
    refused.

    Wire compression (``DistributedOptimizer(compression=...)`` or
    ``HOROVOD_WIRE_DTYPE``) in the overlapped pipeline narrows every
    bucket collective: the reduce-scatter of gradient rows and the
    all-gather of gradient shards or of ZeRO-1's parameter deltas. The
    format is resolved here, once; if ``optimizer.compression`` later
    resolves to another, the step warns once and keeps its own. With
    ``error_feedback=True`` one fp32 residual per bucket and direction
    carries each exchange's quantization error into the next: allocated
    at the first step, kept outside the optimizer state, dropped by
    ``step.reset_error_feedback()`` (call it after restoring an earlier
    state) and by a step that raises. Without overlap, ``optimizer.step()``
    compresses statelessly.

    A model whose ``forward`` takes ``dropout_generator`` (such as
    ``models.simple.MNISTConvNet``) is given a generator seeded from
    ``dropout_seed``, ``state.step``, this rank and the microbatch index,
    so every rank and microbatch draws its own masks, and a run restored
    with its ``StepState`` draws the masks of the unbroken run."""
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
        if overlap_grads:
            hvd_torch.require_whole_mesh(optimizer.axes,
                                         "overlap_grads=True")
            if not optimizer.sharded_update and \
                    optimizer.op not in (Sum, Average):
                # the pipeline reduce-scatters, as the JAX one does
                raise ValueError(
                    f"overlap_grads=True reduce-scatters its buckets, and "
                    f"reducescatter supports Sum or Average, got "
                    f"{optimizer.op!r}")
    if any(isinstance(m, nn.SyncBatchNorm) for m in model.modules()):
        raise NotImplementedError(
            "torch's nn.SyncBatchNorm keeps an unbiased running variance "
            "and synchronizes over its own process group; synchronize "
            "BatchNorm as the JAX package does with "
            "models.resnet.ResNet(bn_cross_replica_axes=('data',))")
    mesh = mesh_lib.get_mesh()
    # the wire format of the overlapped pipeline's bucket collectives,
    # resolved once; the other paths compress inside optimizer.step()
    wire = optimizer.compression if (is_hvd and overlap_grads) else None
    use_ef = wire is not None and error_feedback
    takes_rng = "dropout_generator" in inspect.signature(
        model.forward).parameters
    sharded = is_hvd and optimizer.sharded_update
    schedule = None
    if sharded:
        schedule = optimizer.zero_state.plan.schedule
    elif overlap_grads:
        # the flax dim orders only where the quantizer's chunks read them
        chunked = wire is not None and wire.chunked
        schedule = fusion.bucket_schedule(
            optimizer.params, mesh.size,
            threshold_bytes=optimizer.threshold_bytes,
            perms=optimizer.perms if chunked else None,
            axes=optimizer.axes,
            hierarchical=optimizer.hierarchical_resolved())
    params = optimizer.params if is_hvd else None
    rs_op = optimizer.zero_state.plan.op if sharded else (
        optimizer.op if is_hvd else None)
    inv_k = 1.0 / accum_steps
    state = StepState()
    residuals = None  # {"rs": [...], "ag": [...]}, allocated lazily
    drift_warned = False

    def check_wire_drift():
        nonlocal drift_warned
        if not overlap_grads or drift_warned:
            return
        now = optimizer.compression
        if now is not wire:
            drift_warned = True
            warnings.warn(
                f"optimizer.compression resolves to "
                f"{getattr(now, 'name', None)!r} but this train step was "
                f"built with {getattr(wire, 'name', None)!r}: the wire "
                "format is fixed when make_train_step runs. Rebuild the "
                "step for the new format to take effect.", stacklevel=3)

    def new_residuals():
        """Zero fp32 residuals: ``rs`` the padded bucket (every
        ``[world, shard]`` row this rank encodes), ``ag`` the shard; a
        non-float bucket, never quantized, gets a zero-width one."""
        def zeros(i, n):
            floating = schedule.buckets[i].dtype.is_floating_point
            return torch.zeros(n if floating else 0, dtype=torch.float32,
                               device=mesh.device)
        return {"rs": [zeros(i, n)
                       for i, n in enumerate(schedule.padded_sizes)],
                "ag": [zeros(i, n)
                       for i, n in enumerate(schedule.shard_sizes)]}

    def forward(x, k):
        if not takes_rng:
            return model(x)
        return model(x, dropout_generator=_dropout_generator(
            mesh.device, dropout_seed, state.step, mesh.rank, k))

    def reduce_scatter(res):
        """Issue every bucket of this microbatch's gradients, in schedule
        order, then drop the gradients: the packed copies carry them.
        Each encode reads the residual the previous one wrote, on this
        stream, before its collective is issued."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        issued = []
        for i in range(len(schedule.buckets)):
            if wire is None:
                issued.append(fusion.reduce_scatter_bucket(
                    schedule, i, grads, op=rs_op, async_op=True))
                continue
            pending, new_r = fusion.reduce_scatter_bucket_compressed(
                schedule, i, grads, wire, op=rs_op,
                residual=res["rs"][i] if res else None, async_op=True)
            if res:
                res["rs"][i] = new_r
            issued.append(pending)
        for p in params:
            p.grad = None
        return issued

    def all_gather(shards, res):
        """One all-gather per bucket into the gradients, then the inner
        optimizer (the replicated tail of the overlapped pipeline)."""
        for i, s in enumerate(shards):
            if wire is None:
                flat = fusion.all_gather_bucket(schedule, i, s)
            else:
                flat, new_r = fusion.all_gather_bucket_compressed(
                    schedule, i, s, wire,
                    residual=res["ag"][i] if res else None)
                if res:
                    res["ag"][i] = new_r
            for j, g in fusion.unpack_bucket(schedule, i, flat,
                                             params).items():
                params[j].grad = g
        optimizer.update_preaveraged()

    def run(inputs, labels, res):
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
                issued = reduce_scatter(res)
                if pending is not None:
                    shards = _add_waited(shards, pending)
                pending = issued
        with torch.no_grad():
            if overlap_grads:
                shards = [s * inv_k for s in _add_waited(shards, pending)]
                if sharded:
                    new_ag = zero.apply_shards(
                        optimizer.zero_state, shards, wire=wire,
                        ag_residuals=res["ag"] if res else None)
                    if res:
                        res["ag"] = new_ag
                else:
                    all_gather(shards, res)
            else:
                if pipelined:
                    for p in params:
                        if p.grad is not None:
                            p.grad.mul_(inv_k)
                optimizer.step()
            stats = _batch_stats(model)
            if stats:
                fusion.fused_allreduce_(stats, op=Average)
            return collective.allreduce_(loss_sum * inv_k, op=Average)

    if loader is not None:
        loader.attach_placement(data.device_placement(mesh.device),
                                spec=mesh.device)

    def loader_batch():
        if loader is None:
            raise TypeError(
                "step() with no batch needs a loader: build the step with "
                "make_train_step(..., loader=...) or pass (inputs, labels)")
        batch = next(loader)
        if not (isinstance(batch, (tuple, list)) and len(batch) == 2):
            raise TypeError(
                "the loader's source must yield (inputs, labels) batches "
                f"for this step; got {type(batch).__name__} of "
                f"{len(batch) if hasattr(batch, '__len__') else '?'}")
        return data.ready(batch)

    def step(inputs=None, labels=None):
        nonlocal residuals
        if inputs is None and labels is None:
            inputs, labels = loader_batch()
        elif inputs is None or labels is None:
            raise TypeError("step() takes (inputs, labels), or nothing "
                            "when a loader feeds it")
        check_wire_drift()
        if use_ef and residuals is None:
            residuals = new_residuals()
        try:
            loss = run(inputs, labels, residuals)
        except BaseException:
            # a failed step may have consumed some residuals and not
            # others: restart the compensation from zeros
            residuals = None
            raise
        state.step += 1
        return loss

    def reset_error_feedback():
        """Drop the carried residuals; the next step starts from zeros."""
        nonlocal residuals
        residuals = None

    step.schedule = schedule
    step.state = state
    step.wire = wire
    step.reset_error_feedback = reset_error_feedback
    step.residuals = lambda: residuals
    return step


def _add_waited(acc, pending):
    """Wait for one microbatch's reduce-scatters, in schedule order, and
    add their shards to ``acc`` (None for the first microbatch)."""
    shards = [p.wait() for p in pending]
    return shards if acc is None else [a + s for a, s in zip(acc, shards)]


def make_lm_train_step(model, optimizer, mesh=None, batch_axis=None,
                       seq_axis=None):
    """Build a language-model train step (next-token loss).
    ``optimizer`` is a ``DistributedOptimizer`` (any exchange: fused
    allreduce, ZeRO-1, ``backward_passes_per_step``) whose axes are the
    step's: ``(batch_axis,)``, or ``(batch_axis, seq_axis)``.
    ``step(tokens)`` takes this rank's block of the batch,
    ``[B_local, S_local]`` int tokens (``shard_lm_batch`` cuts it from the
    global batch), runs forward, backward and the optimizer step, and
    returns the loss averaged over those axes (an fp32 scalar tensor on
    the device). ``batch_axis`` may be a tuple; None is the mesh's data
    axes (``mesh.data_axis_names``: ``("data",)``, or ``("dcn",
    "data")`` on ``init()``'s mesh of a job across hosts), which a
    default ``DistributedOptimizer`` reduces over when the mesh has no
    ``seq_axis``. ``step.state`` counts the steps, as in
    ``make_train_step``. ``mesh`` is the installed mesh (``init()``'s, or
    ``parallel.mesh.build_mesh``'s), the default.

    With ``seq_axis`` the sequence is sharded over that axis, and the
    model's attention is ring attention over it
    (``TransformerConfig.sequence_axis``). The loss is still exact: each
    shard's last position is scored against the next shard's first token
    (one ``ppermute`` over ``seq_axis``), only the global last position
    is masked (on the last rank of the axis), and the sum is normalized
    by the global target count, so averaging the per-shard losses and
    gradients over both axes gives the full-sequence mean loss and
    gradient. The normalization is the same without ``seq_axis``: the
    local sum is scaled by ``n_shards / global_count``, exact even when
    ranks hold different numbers of targets."""
    if not isinstance(optimizer, hvd_torch.DistributedOptimizer):
        raise TypeError("make_lm_train_step needs a DistributedOptimizer")
    installed = mesh_lib.get_mesh()
    if mesh is not None and mesh is not installed:
        raise ValueError("make_lm_train_step(mesh=...) must be the installed "
                         "mesh: parallel.mesh.build_mesh installs the mesh "
                         "it builds")
    mesh = installed
    if batch_axis is None:
        batch_axis = mesh_lib.data_axis_names(mesh)
    batch_axes = ((batch_axis,) if isinstance(batch_axis, str)
                  else tuple(batch_axis))
    grad_axes = batch_axes + ((seq_axis,) if seq_axis else ())
    if mesh.group_of(grad_axes)[1] != mesh.group_of(optimizer.axes)[1]:
        raise ValueError(
            f"the optimizer reduces over {optimizer.axes!r}, the step over "
            f"{grad_axes}: build DistributedOptimizer(axes={grad_axes})")
    cfg_axis = getattr(getattr(model, "cfg", None), "sequence_axis", None)
    if cfg_axis is not None and cfg_axis != seq_axis:
        raise ValueError(f"the model's sequence_axis is {cfg_axis!r}, the "
                         f"step's seq_axis {seq_axis!r}")
    n_shards = collective.mesh_size(grad_axes)
    n_seq = mesh.axis_size(seq_axis) if seq_axis else 1
    # shard i's last target is shard i+1's first token
    next_first = [((i + 1) % n_seq, i) for i in range(n_seq)]
    state = StepState()

    def sharded_loss(tokens):
        nxt = collective.ppermute(tokens[:, :1], seq_axis, next_first)
        targets = torch.cat([tokens[:, 1:], nxt], dim=1)
        mask = torch.ones(targets.shape, device=mesh.device)
        if mesh.axis_index(seq_axis) == n_seq - 1:
            mask[:, -1] = 0.0  # the global last position
        global_count = collective.allreduce_(mask.sum(), op=Sum,
                                             axes=grad_axes)
        logp = F.log_softmax(model(tokens).float(), dim=-1)
        nll = -logp.gather(-1, targets[..., None])[..., 0]
        return (nll * mask).sum() * n_shards / global_count

    def loss_fn(tokens):
        if n_seq > 1:
            return sharded_loss(tokens)
        targets = tokens[:, 1:]
        local_count = torch.tensor(float(targets.numel()), device=mesh.device)
        global_count = collective.allreduce_(local_count.clone(), op=Sum,
                                             axes=grad_axes)
        local_mean = softmax_cross_entropy(model(tokens)[:, :-1], targets)
        return local_mean * local_count * n_shards / global_count

    def step(tokens):
        tokens = tokens.to(mesh.device)
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(tokens)
        loss.backward()
        optimizer.step()  # reduces the gradients first
        state.step += 1
        return collective.allreduce_(loss.detach(), op=Average,
                                     axes=grad_axes)

    step.state = state
    return step


def shard_lm_batch(tokens, batch_axis=None, seq_axis=None):
    """This rank's block of a global ``[B, S]`` batch: dim 0 cut by its
    coordinate on ``batch_axis``, dim 1 by its coordinate on ``seq_axis``
    (when given), the counterpart of the JAX step's
    ``PartitionSpec(batch_axis, seq_axis)``. A tuple ``batch_axis`` cuts
    dim 0 by this rank's row-major index over its axes; None is the
    installed mesh's data axes, as in ``make_lm_train_step``."""
    if batch_axis is None:
        batch_axis = mesh_lib.data_axis_names()
    for dim, axis in ((0, batch_axis), (1, seq_axis)):
        if axis is None:
            continue
        n, i = collective.mesh_size(axis), collective.mesh_rank(axis)
        if tokens.shape[dim] % n:
            raise ValueError(f"dim {dim} of the batch ({tokens.shape[dim]})"
                             f" does not divide by the {axis!r} axis ({n})")
        size = tokens.shape[dim] // n
        tokens = tokens.narrow(dim, i * size, size)
    return tokens
