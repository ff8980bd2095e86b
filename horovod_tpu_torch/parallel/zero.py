"""ZeRO stage-1: reduce-scattered gradients, sharded optimizer state.

The port of ``horovod_tpu/parallel/zero.py`` (Rajbhandari et al., 2020,
"ZeRO: Memory Optimizations Toward Training Trillion Parameter Models").
The exchange keeps the bytes of a bandwidth-optimal allreduce, a
reduce-scatter plus an all-gather, and runs the optimizer between the
halves: reduce-scatter the gradients, update only this rank's 1/N of the
optimizer state, all-gather the parameter deltas. Parameters stay
replicated.

The partition is ``ops.fusion.BucketSchedule``: rank ``r`` owns flat
chunk ``r`` of every padded bucket. Torch keys optimizer state by tensor
identity, so this rank's chunk of every bucket is a persistent tensor (a
"row"), and an inner optimizer of the user's class and hyperparameters
owns the rows. Each step follows the reference's ``_local_param_rows`` and
``apply_shards``: copy this rank's slice of the packed parameters into
the rows, give the rows the reduced gradient shards, step the inner
optimizer, all-gather the deltas (rows after - rows before) per bucket,
and add them to the parameters.

Works with any elementwise optimizer (SGD, Adam, AdamW: the update of
element ``i`` reads only element ``i`` of the gradient, parameter and
state). An optimizer that reads norms across parameters would see only
this rank's chunk.
"""

import dataclasses
import inspect

import torch

from horovod_tpu_torch.ops import collective, fusion
from horovod_tpu_torch.ops.reduction import Average, Sum
from horovod_tpu_torch.parallel import mesh as mesh_lib


@dataclasses.dataclass(frozen=True)
class ZeroPlan:
    """The optimizer-state partition: the bucket schedule (which flat
    ranges exist and which rank owns which chunk) and the reduction op."""

    schedule: fusion.BucketSchedule
    op: str = Average


def make_plan(params, op=Average, threshold_bytes=None, perms=None):
    """The ZeRO partition of ``params`` (a list, in the order the buckets
    pack it) over the data axis; ``perms`` (``fusion.plan_buckets``)
    packs each parameter as its flax array flattens, so row ``r`` holds
    the elements the JAX package's row ``r`` holds."""
    if op not in (Sum, Average):
        raise ValueError(f"ZeRO-1 supports Sum or Average, got {op!r}")
    if not params:
        raise ValueError("ZeRO-1 needs a non-empty parameter list")
    world = mesh_lib.get_mesh().size
    return ZeroPlan(schedule=fusion.bucket_schedule(
        params, world, threshold_bytes=threshold_bytes, perms=perms),
        op=op)


class ZeroState:
    """One rank's ZeRO-1 state: the plan, the parameters it updates, the
    rows (this rank's chunk of every bucket), the inner optimizer over
    them and the user's optimizer, whose hyperparameters the inner one
    takes at every step (a learning-rate schedule may change them)."""

    def __init__(self, plan, params, rows, inner, outer):
        self.plan, self.params, self.rows = plan, params, rows
        self.inner, self.outer = inner, outer

    def __repr__(self):
        return f"ZeroState(buckets={len(self.plan.schedule.buckets)})"


def _hyper(optimizer):
    return {k: v for k, v in optimizer.param_groups[0].items()
            if k != "params"}


def init(optimizer, params, plan):
    """Build the rows and an inner optimizer of ``optimizer``'s class and
    hyperparameters over them. ``optimizer``'s own state stays empty."""
    if len(optimizer.param_groups) != 1:
        raise ValueError(
            "ZeRO-1 needs an optimizer with one param group: a flat row "
            f"carries one set of hyperparameters, got "
            f"{len(optimizer.param_groups)} groups")
    rows = [row.clone() for row in _local_param_rows(plan.schedule, params)]
    cls = type(optimizer)
    hyper = _hyper(optimizer)
    accepted = inspect.signature(cls.__init__).parameters
    inner = cls(rows, **{k: v for k, v in hyper.items() if k in accepted})
    inner.param_groups[0].update(hyper)
    return ZeroState(plan, list(params), rows, inner, optimizer)


@torch.no_grad()
def _local_param_rows(schedule, params):
    """This rank's slice of every bucket's packed parameters (views of
    the packed copies; no communication)."""
    rank = collective.mesh_rank()
    rows = []
    for i, shard in enumerate(schedule.shard_sizes):
        flat = fusion.pack_padded(schedule, i, params)
        rows.append(flat[rank * shard:(rank + 1) * shard])
    return rows


@torch.no_grad()
def apply_shards(zstate, grad_shards, wire=None, ag_residuals=None):
    """The sharded-update tail: step the inner optimizer on this rank's
    reduced gradient shards (one per bucket, in schedule order), then
    all-gather the parameter deltas and add them to the parameters in
    place.

    ``wire`` (an ``ops.compression`` compressor) narrows the delta
    all-gather; ``ag_residuals`` (one fp32 shard-sized tensor per bucket)
    turns on its error feedback: this rank's quantization error of each
    delta shard is carried into the next step's. Returns the new
    residuals (None without ``ag_residuals``)."""
    schedule = zstate.plan.schedule
    if len(grad_shards) != len(schedule.buckets):
        raise ValueError(f"{len(grad_shards)} gradient shards for "
                         f"{len(schedule.buckets)} buckets")
    zstate.inner.param_groups[0].update(_hyper(zstate.outer))
    before = _local_param_rows(schedule, zstate.params)
    for row, start, grad in zip(zstate.rows, before, grad_shards):
        row.copy_(start)
        row.grad = grad.to(row.dtype)
    zstate.inner.step()
    new_residuals = (list(ag_residuals) if ag_residuals is not None
                     else None)
    for i, (row, start) in enumerate(zip(zstate.rows, before)):
        row.grad = None
        if wire is None:
            flat = fusion.all_gather_bucket(schedule, i, row - start)
        else:
            flat, res = fusion.all_gather_bucket_compressed(
                schedule, i, row - start, wire,
                residual=None if ag_residuals is None else ag_residuals[i])
            if new_residuals is not None:
                new_residuals[i] = res
        for j, delta in fusion.unpack_bucket(schedule, i, flat,
                                             zstate.params).items():
            zstate.params[j].add_(delta)
    return new_residuals


@torch.no_grad()
def sharded_update(zstate, grads, wire=None):
    """The full ZeRO-1 exchange for one accumulated gradient list (in the
    order of ``zstate.params``): per-bucket reduce-scatter, then
    ``apply_shards``. ``wire`` compresses both halves statelessly: this
    entry point has no step-to-step carry, so no error feedback
    (``training.make_train_step``'s pipeline threads the residuals)."""
    schedule = zstate.plan.schedule
    shards = []
    for i in range(len(schedule.buckets)):
        if wire is None:
            shard = fusion.reduce_scatter_bucket(schedule, i, grads,
                                                 op=zstate.plan.op)
        else:
            shard, _ = fusion.reduce_scatter_bucket_compressed(
                schedule, i, grads, wire, op=zstate.plan.op)
        shards.append(shard)
    apply_shards(zstate, shards, wire=wire)


def local_state_bytes(zstate):
    """Bytes of optimizer state this rank holds: the inner optimizer's
    state tensors, each over this rank's chunk of a bucket (about 1/N of
    the replicated footprint), plus its per-row scalars."""
    return sum(v.numel() * v.element_size()
               for state in zstate.inner.state.values()
               for v in state.values() if torch.is_tensor(v))
