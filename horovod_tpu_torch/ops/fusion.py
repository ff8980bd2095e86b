"""Tensor fusion: pack many small tensors into few big collectives.

The port of the uncompressed, single-level branch of
``horovod_tpu/ops/fusion.py``: tensors are grouped by dtype and packed in
order into flat buckets of at most ``fusion_threshold`` bytes (default
64 MB), one collective per bucket. The plan is the same greedy packing as
the JAX package's ``plan_buckets``, so the same leaves give the same
buckets.

Two exchanges use it:

* ``fused_allreduce_``: forward-order buckets, one allreduce each;
* the bucketed reduce-scatter pipeline: a ``BucketSchedule`` of
  reverse-order buckets (backward produces the last layers' gradients
  first), each zero-padded to a multiple of the world size, so rank ``r``
  owns flat chunk ``r`` of every bucket. ``reduce_scatter_bucket`` deposits
  that chunk's reduced gradient on it, ``all_gather_bucket`` inverts it.
  ZeRO-1 (``parallel/zero.py``) partitions the optimizer state by the same
  chunks.
"""

import dataclasses

import torch

from horovod_tpu_torch import basics
from horovod_tpu_torch.ops import collective


@dataclasses.dataclass(frozen=True)
class _Bucket:
    """One fusion buffer: which tensors it packs and where."""
    dtype: torch.dtype
    leaf_indices: tuple  # indices into the tensor list
    sizes: tuple         # element count per packed tensor
    shapes: tuple        # original shape per packed tensor

    @property
    def nbytes(self):
        return sum(self.sizes) * self.dtype.itemsize


def plan_buckets(leaves, threshold_bytes, reverse=False):
    """Greedy packing of ``leaves`` into dtype-homogeneous buckets of at
    most ``threshold_bytes`` (a single tensor larger than the threshold
    gets its own bucket). ``reverse=True`` packs in reverse order, the
    order in which backward makes the gradients ready."""
    by_dtype = {}
    order = range(len(leaves) - 1, -1, -1) if reverse else range(len(leaves))
    for i in order:
        by_dtype.setdefault(leaves[i].dtype, []).append(i)
    buckets = []
    for dtype, idxs in by_dtype.items():
        cur, cur_bytes = [], 0
        for i in idxs:
            nbytes = leaves[i].numel() * dtype.itemsize
            if cur and cur_bytes + nbytes > threshold_bytes:
                buckets.append(_make_bucket(dtype, cur, leaves))
                cur, cur_bytes = [], 0
            cur.append(i)
            cur_bytes += nbytes
        if cur:
            buckets.append(_make_bucket(dtype, cur, leaves))
    return buckets


def _make_bucket(dtype, idxs, leaves):
    return _Bucket(dtype=dtype, leaf_indices=tuple(idxs),
                   sizes=tuple(leaves[i].numel() for i in idxs),
                   shapes=tuple(tuple(leaves[i].shape) for i in idxs))


def _threshold(threshold_bytes):
    if threshold_bytes is not None:
        return threshold_bytes
    return basics.fusion_threshold()


def _pack(bucket, tensors, pad=0):
    parts = [tensors[i].reshape(-1) for i in bucket.leaf_indices]
    if pad:
        parts.append(parts[0].new_zeros(pad))
    return torch.cat(parts)


def _unpack(bucket, flat):
    """``{leaf index: view of flat}`` (the padding tail ignored)."""
    out, offset = {}, 0
    for i, size, shape in zip(bucket.leaf_indices, bucket.sizes,
                              bucket.shapes):
        out[i] = flat[offset:offset + size].view(shape)
        offset += size
    return out


def fused_allreduce_(tensors, op=collective.Average, threshold_bytes=None):
    """Allreduce every tensor of the list in place through fused flat
    buckets: pack, one collective per bucket, unpack. Returns the
    buckets, so a caller can account what went over the wire."""
    buckets = plan_buckets(tensors, _threshold(threshold_bytes))
    for bucket in buckets:
        flat = _pack(bucket, tensors)
        collective.allreduce_(flat, op=op)
        for i, part in _unpack(bucket, flat).items():
            tensors[i].copy_(part)
    return buckets


@dataclasses.dataclass(frozen=True)
class BucketSchedule:
    """Static plan of the bucketed exchange: the buckets in
    reverse (backward-ready) order, each padded to a multiple of
    ``world``; rank ``r`` owns chunk ``r`` (``shard_sizes[i]`` elements)
    of bucket ``i``. Every collective of the pipeline walks the buckets
    in this order on every rank."""

    buckets: tuple       # _Bucket, reverse order
    padded_sizes: tuple  # per-bucket element count, multiple of world
    world: int

    @property
    def shard_sizes(self):
        return tuple(p // self.world for p in self.padded_sizes)


def bucket_schedule(leaves, world, threshold_bytes=None):
    """Plan the bucketed exchange for ``leaves`` (one plan, reused by
    every microbatch and every step)."""
    buckets = tuple(plan_buckets(leaves, _threshold(threshold_bytes),
                                 reverse=True))
    padded = tuple(sum(b.sizes) + (-sum(b.sizes)) % world for b in buckets)
    return BucketSchedule(buckets=buckets, padded_sizes=padded, world=world)


def pack_padded(schedule, idx, leaves):
    """Bucket ``idx`` packed flat and zero-padded to its scheduled size."""
    bucket = schedule.buckets[idx]
    return _pack(bucket, leaves, schedule.padded_sizes[idx] - sum(
        bucket.sizes))


def reduce_scatter_bucket(schedule, idx, leaves, op=collective.Average,
                          async_op=False):
    """Pack bucket ``idx`` of ``leaves``, pad it, and reduce-scatter it:
    returns this rank's reduced shard (``shard_sizes[idx]`` elements), or
    with ``async_op`` a ``collective.Pending`` whose ``wait()`` does."""
    return collective.reducescatter(pack_padded(schedule, idx, leaves),
                                    op=op, async_op=async_op)


def all_gather_bucket(schedule, idx, shard):
    """Inverse of ``reduce_scatter_bucket``: gather every rank's shard of
    bucket ``idx`` into the full padded flat bucket, chunk ``r`` from
    rank ``r``: one all-gather. It takes the schedule and the index, as
    the JAX package's does (there they also label the bucket's telemetry
    record, which is not ported), and holds the shard to the schedule."""
    if shard.numel() != schedule.shard_sizes[idx]:
        raise ValueError(f"bucket {idx}: shard of {shard.numel()} elements, "
                         f"scheduled {schedule.shard_sizes[idx]}")
    return collective.allgather(shard)


def unpack_bucket(schedule, idx, flat, leaves):
    """Scatter the flat bucket back into leaf positions: ``{leaf index:
    tensor}``, each cast to its leaf's dtype (padding tail ignored)."""
    return {i: part.to(leaves[i].dtype)
            for i, part in _unpack(schedule.buckets[idx], flat).items()}
