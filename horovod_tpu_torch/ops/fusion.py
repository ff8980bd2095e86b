"""Tensor fusion: pack many small tensors into few big collectives.

The port of ``horovod_tpu/ops/fusion.py``, wire compression and the
two-level reduction included: tensors are grouped by dtype and packed in
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
  chunks. ``reduce_scatter_bucket_compressed`` and
  ``all_gather_bucket_compressed`` are the same exchange at a wire format
  of ``ops/compression.py``, with an optional error-feedback residual.

Every exchange takes ``axes``, the mesh axes it reduces over
(``ops/collective.py``; None: the whole mesh). A ``BucketSchedule``
carries its own: the scatter order, walked axis by axis, which
``hierarchical=True`` makes ICI-first (``("data", "dcn")`` on a
``(dcn, data)`` mesh) so the cross-host stage moves 1/ici_size of the
bytes; chunk ownership is then row-major over that order.
"""

import dataclasses
import warnings

import torch

from horovod_tpu_torch import basics
from horovod_tpu_torch.ops import collective
from horovod_tpu_torch.ops import compression as compression_lib
from horovod_tpu_torch.parallel import hierarchical as hier_lib
from horovod_tpu_torch.parallel import mesh as mesh_lib


@dataclasses.dataclass(frozen=True)
class _Bucket:
    """One fusion buffer: which tensors it packs and where."""
    dtype: torch.dtype
    leaf_indices: tuple  # indices into the tensor list
    sizes: tuple         # element count per packed tensor
    shapes: tuple        # original shape per packed tensor
    perms: tuple         # per packed tensor: its flax dim order, or None

    @property
    def nbytes(self):
        return sum(self.sizes) * self.dtype.itemsize


def _check_perms(leaves, perms):
    if perms is None:
        return [None] * len(leaves)
    if len(perms) != len(leaves):
        raise ValueError(f"{len(perms)} dim orders for {len(leaves)} leaves")
    for leaf, perm in zip(leaves, perms):
        if perm is not None and sorted(perm) != list(range(leaf.dim())):
            raise ValueError(f"dim order {perm} of a leaf of shape "
                             f"{tuple(leaf.shape)}")
    return list(perms)


def plan_buckets(leaves, threshold_bytes, reverse=False, perms=None):
    """Greedy packing of ``leaves`` into dtype-homogeneous buckets of at
    most ``threshold_bytes`` (a single tensor larger than the threshold
    gets its own bucket). ``reverse=True`` packs in reverse order, the
    order in which backward makes the gradients ready. ``perms`` (per
    leaf, the order of its dims in the packed array, or None for its
    own) packs each leaf as that array flattens: the port passes a
    leaf's flax layout (``convert.flax_perm``) where the order inside a
    bucket changes a result, ZeRO-1's rows and a quantizer's chunks."""
    perms = _check_perms(leaves, perms)
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
                buckets.append(_make_bucket(dtype, cur, leaves, perms))
                cur, cur_bytes = [], 0
            cur.append(i)
            cur_bytes += nbytes
        if cur:
            buckets.append(_make_bucket(dtype, cur, leaves, perms))
    return buckets


def _make_bucket(dtype, idxs, leaves, perms):
    return _Bucket(dtype=dtype, leaf_indices=tuple(idxs),
                   sizes=tuple(leaves[i].numel() for i in idxs),
                   shapes=tuple(tuple(leaves[i].shape) for i in idxs),
                   perms=tuple(perms[i] for i in idxs))


def _threshold(threshold_bytes):
    if threshold_bytes is not None:
        return threshold_bytes
    return basics.fusion_threshold()


def hierarchical_default(hierarchical):
    """``hierarchical``, or with None ``HOROVOD_HIERARCHICAL_ALLREDUCE``
    (False before ``init()``)."""
    if hierarchical is not None:
        return hierarchical
    cfg = basics._state.config
    return cfg.hierarchical_allreduce if cfg is not None else False


def _two_level(hierarchical, axes):
    """True when ``axes`` (resolved) hold ``dcn`` and one more axis and the
    two-level path is asked for."""
    return bool(hierarchical) and mesh_lib.DCN_AXIS in axes and len(axes) > 1


def _flax_strides(shape, perm):
    """The strides, in torch's dim order, of a leaf of torch shape
    ``shape`` stored as its flax array (dims in ``perm`` order),
    contiguous."""
    strides, step = [0] * len(shape), 1
    for d in reversed(perm):
        strides[d] = step
        step *= shape[d]
    return strides


def _pack(bucket, tensors, pad=0):
    """The bucket's tensors flat, in order, then ``pad`` zeros: one copy.
    A run of leaves in torch's own layout is one ``torch.cat``; a leaf
    with a flax layout is copied into the bucket through a view of its
    slot in torch's dim order with the flax array's strides."""
    if not any(bucket.perms):
        parts = [tensors[i].reshape(-1) for i in bucket.leaf_indices]
        if pad:
            parts.append(parts[0].new_zeros(pad))
        return torch.cat(parts)
    first = tensors[bucket.leaf_indices[0]]
    out = first.new_empty(sum(bucket.sizes) + pad)
    offset, run, run_start = 0, [], 0
    for i, size, shape, perm in zip(bucket.leaf_indices, bucket.sizes,
                                    bucket.shapes, bucket.perms):
        if perm is None:
            if not run:
                run_start = offset
            run.append(tensors[i].reshape(-1))
        else:
            if run:
                torch.cat(run, out=out[run_start:offset])
                run = []
            out.as_strided(shape, _flax_strides(shape, perm),
                           offset).copy_(tensors[i])
        offset += size
    if run:
        torch.cat(run, out=out[run_start:offset])
    if pad:
        out[offset:].zero_()
    return out


def _unpack(bucket, flat):
    """``{leaf index: view of flat}`` in each leaf's torch shape (a leaf
    with a flax layout as a view with its flax strides; the padding tail
    ignored)."""
    out, offset, base = {}, 0, flat.storage_offset()
    for i, size, shape, perm in zip(bucket.leaf_indices, bucket.sizes,
                                    bucket.shapes, bucket.perms):
        if perm is None:
            out[i] = flat[offset:offset + size].view(shape)
        else:
            out[i] = flat.as_strided(shape, _flax_strides(shape, perm),
                                     base + offset)
        offset += size
    return out


def fused_allreduce_(tensors, op=collective.Average, threshold_bytes=None,
                     compression=None, perms=None, axes=None,
                     hierarchical=None):
    """Allreduce every tensor of the list in place through fused flat
    buckets: pack, one collective per bucket, unpack. Returns the
    buckets, so a caller can account what went over the wire.

    ``hierarchical`` (None: ``HOROVOD_HIERARCHICAL_ALLREDUCE``) reduces
    Sum and Average in two levels (``parallel/hierarchical.py``) when the
    axes hold ``dcn`` and one more axis; any other op takes
    ``collective.allreduce_``, where Adasum runs its own two-level
    composite.

    ``compression`` is a compressor or a wire name (``ops/compression.py``).
    A cast wire narrows each float bucket and reduces at the wire dtype,
    at any world size. A chunked quantizer (fp8, int8) sends each float
    bucket through the compressed reduce-scatter and all-gather pair,
    statelessly (no error feedback); it composes with Sum and Average
    only, and at world 1, where there is no wire, it is dropped.
    Non-float buckets always take the exact path. ``perms`` orders each
    tensor's elements in the buckets (``plan_buckets``) under a chunked
    quantizer, whose chunks they decide; an exact or cast reduction is
    elementwise, so it packs each tensor as it lies. A chunked wire is
    single-level: it ignores ``hierarchical``, with a warning where the
    two-level path would have run."""
    hierarchical = hierarchical_default(hierarchical)
    axes = mesh_lib.get_mesh().resolve(axes)
    compression = compression_lib.resolve(compression)
    chunked = compression is not None and compression.chunked
    if chunked:
        if op not in (collective.Sum, collective.Average):
            raise ValueError(
                f"chunked wire format {compression.name!r} only composes "
                f"with Sum/Average (got {op!r}): Adasum/Min/Max reductions "
                "have no exchange-then-reduce form")
        world = collective.mesh_size(axes)
        if world == 1:
            compression, chunked = None, False  # no wire to compress
        elif _two_level(hierarchical, axes):
            warnings.warn(
                f"hierarchical allreduce is ignored for the chunked wire "
                f"format {compression.name!r}: the quantized exchange is "
                "single-level, so the dcn axis carries the (narrowed) "
                "per-rank volume without the ICI-first reduction. Use "
                "bf16 cast compression if the two-level path matters more "
                "than the 4x narrowing.", stacklevel=2)
    two_level = (op in (collective.Sum, collective.Average)
                 and _two_level(hierarchical, axes))
    buckets = plan_buckets(tensors, _threshold(threshold_bytes),
                           perms=perms if chunked else None)
    for bucket in buckets:
        if chunked and bucket.dtype.is_floating_point:
            size = sum(bucket.sizes)
            sched1 = BucketSchedule(buckets=(bucket,),
                                    padded_sizes=(size + (-size) % world,),
                                    world=world, axes=axes)
            shard, _ = reduce_scatter_bucket_compressed(
                sched1, 0, tensors, compression, op=op)
            flat, _ = all_gather_bucket_compressed(sched1, 0, shard,
                                                   compression)
        else:
            flat = _pack(bucket, tensors)
            if compression is not None:
                flat, ctx = compression.compress(flat)
            if two_level:
                if op == collective.Average and \
                        not flat.is_floating_point():
                    raise TypeError("Average needs a floating tensor, got "
                                    f"{flat.dtype}")
                flat = hier_lib.hierarchical_allreduce(
                    flat, ici_axes=tuple(a for a in axes
                                         if a != mesh_lib.DCN_AXIS),
                    dcn_axis=mesh_lib.DCN_AXIS, op=op)
            else:
                collective.allreduce_(flat, op=op, axes=axes)
            if compression is not None:
                flat = compression.decompress(flat, ctx)
        for i, part in _unpack(bucket, flat).items():
            tensors[i].copy_(part)
    return buckets


def fused_allreduce(tensors, op=collective.Average, axes=None,
                    compression=None, threshold_bytes=None,
                    hierarchical=None):
    """Out-of-place ``fused_allreduce_``: the reduced copies of
    ``tensors`` (a list), which are left as they are."""
    out = [t.clone() for t in tensors]
    fused_allreduce_(out, op=op, threshold_bytes=threshold_bytes,
                     compression=compression, axes=axes,
                     hierarchical=hierarchical)
    return out


@dataclasses.dataclass(frozen=True)
class BucketSchedule:
    """Static plan of the bucketed exchange: the buckets in
    reverse (backward-ready) order, each padded to a multiple of
    ``world``. ``axes`` is the scatter order (None: the whole mesh, one
    collective): the reduce-scatter walks it first to last, the
    all-gather inverts it, and the rank whose
    ``collective.mesh_rank(axes)`` is ``r`` owns chunk ``r``
    (``shard_sizes[i]`` elements) of bucket ``i``. Every collective of
    the pipeline walks the buckets in this order on every rank."""

    buckets: tuple       # _Bucket, reverse order
    padded_sizes: tuple  # per-bucket element count, multiple of world
    world: int
    axes: tuple = None

    @property
    def shard_sizes(self):
        return tuple(p // self.world for p in self.padded_sizes)


def bucket_schedule(leaves, world, threshold_bytes=None, perms=None,
                    axes=None, hierarchical=False):
    """Plan the bucketed exchange for ``leaves`` (one plan, reused by
    every microbatch and every step); ``perms`` as in
    ``plan_buckets``. With ``hierarchical`` and a ``dcn`` axis among
    ``axes`` (None: the installed mesh's), the scatter order is made
    ICI-first, ``dcn`` last."""
    if hierarchical:
        axes = mesh_lib.get_mesh().axis_names if axes is None else axes
    if axes is not None:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if _two_level(hierarchical, axes):
            axes = tuple(a for a in axes if a != mesh_lib.DCN_AXIS) + (
                mesh_lib.DCN_AXIS,)
    buckets = tuple(plan_buckets(leaves, _threshold(threshold_bytes),
                                 reverse=True, perms=perms))
    padded = tuple(sum(b.sizes) + (-sum(b.sizes)) % world for b in buckets)
    return BucketSchedule(buckets=buckets, padded_sizes=padded, world=world,
                          axes=axes)


def pack_padded(schedule, idx, leaves):
    """Bucket ``idx`` packed flat and zero-padded to its scheduled size."""
    bucket = schedule.buckets[idx]
    return _pack(bucket, leaves, schedule.padded_sizes[idx] - sum(
        bucket.sizes))


def _reduce_scatter(flat, op, axes, async_op=False):
    """Reduce-scatter ``flat`` over ``axes``: one collective over one axis
    or the whole mesh (None), else the two-level stages of
    ``parallel/hierarchical.py`` in the order of ``axes``."""
    if op not in (collective.Sum, collective.Average):
        raise ValueError("reducescatter supports Sum or Average")
    if axes is None or len(axes) == 1:
        return collective.reducescatter(flat, op=op, async_op=async_op,
                                        axes=axes)
    return hier_lib.staged_reducescatter(flat, axes, op, async_op=async_op)


def _all_gather(shard, axes):
    """Inverse of ``_reduce_scatter``."""
    if axes is None or len(axes) == 1:
        return collective.allgather(shard, axes=axes)
    return hier_lib.staged_allgather(shard, axes)


def reduce_scatter_bucket(schedule, idx, leaves, op=collective.Average,
                          async_op=False, axes=None):
    """Pack bucket ``idx`` of ``leaves``, pad it, and reduce-scatter it
    over the schedule's axes (``axes`` overrides them): returns this
    rank's reduced shard (``shard_sizes[idx]`` elements), or with
    ``async_op`` a ``collective.Pending`` whose ``wait()`` does."""
    return _reduce_scatter(pack_padded(schedule, idx, leaves), op,
                           schedule.axes if axes is None else axes,
                           async_op=async_op)


def all_gather_bucket(schedule, idx, shard, axes=None):
    """Inverse of ``reduce_scatter_bucket``: gather every rank's shard of
    bucket ``idx`` into the full padded flat bucket, chunk ``r`` from the
    rank whose ``mesh_rank(schedule.axes)`` is ``r``. It takes the
    schedule and the index, as the JAX package's does (there they also
    label the bucket's telemetry record, which is not ported), and holds
    the shard to the schedule."""
    if shard.numel() != schedule.shard_sizes[idx]:
        raise ValueError(f"bucket {idx}: shard of {shard.numel()} elements, "
                         f"scheduled {schedule.shard_sizes[idx]}")
    return _all_gather(shard, schedule.axes if axes is None else axes)


def reduce_scatter_bucket_compressed(schedule, idx, leaves, wire,
                                     op=collective.Average, residual=None,
                                     async_op=False, axes=None):
    """``reduce_scatter_bucket`` at ``wire``'s width. Returns ``(shard,
    new_residual)``, or with ``async_op`` ``(Pending, new_residual)``:
    the residual is ready at once, the shard at ``wait()``.

    * A cast wire (bf16, float16) narrows the bucket and reduce-scatters
      it at the wire dtype.
    * A chunked quantizer (fp8, int8) quantizes the ``[world, shard]``
      rows with ``wire.for_length(shard)`` (no chunk straddles two rows),
      all-to-alls the rows and their scales, so each rank receives every
      rank's contribution to its own shard, and decodes and sums them in
      fp32 after ``wait()``.

    ``residual`` (fp32, the padded bucket's size) is the error-feedback
    carry: it is added to the bucket in fp32 before encoding, and the new
    quantization error ``values - decode(encode(values))`` is returned.
    With ``residual=None`` the exchange is stateless and ``new_residual``
    is None. A non-float bucket takes the exact path and passes the
    residual through unchanged."""
    axes = schedule.axes if axes is None else axes
    if not schedule.buckets[idx].dtype.is_floating_point:
        return reduce_scatter_bucket(schedule, idx, leaves, op=op,
                                     async_op=async_op, axes=axes), residual
    flat = pack_padded(schedule, idx, leaves)
    grad_dtype = flat.dtype
    world, shard = schedule.world, schedule.shard_sizes[idx]
    if residual is not None:
        # in fp32: at a bf16 gradient's width the carry, at or below its
        # ulp, would round away
        flat = flat.float() + residual.reshape(flat.shape)
    if wire.chunked:
        q = wire.for_length(shard)
        rows = flat.reshape(world, shard)
        if residual is not None:
            wire_rows, scales, deq = q.roundtrip(rows)
            new_residual = (rows - deq).reshape(flat.shape)
        else:
            wire_rows, scales = q.compress_flat(rows)
            new_residual = None
        # row r of what arrives is rank r's contribution to this shard
        recv_rows = collective.alltoall(wire_rows, async_op=True,
                                        axes=axes)
        recv_scales = collective.alltoall(scales, async_op=True, axes=axes)

        def finish():
            vals = q.decompress_flat(recv_rows.wait(), recv_scales.wait(),
                                     torch.float32, n=shard)
            out = vals.sum(dim=0)
            if op == collective.Average:
                out = out / world
            return out.to(grad_dtype)

        pending = collective.Pending((), finish)
    else:
        if residual is not None:
            wire_flat, _, deq = wire.roundtrip(flat)
            new_residual = flat - deq
        else:
            wire_flat, _ = wire.compress_flat(flat)
            new_residual = None
        reduced = _reduce_scatter(wire_flat, op, axes, async_op=True)
        pending = collective.Pending(
            (), lambda: reduced.wait().to(grad_dtype))
    return (pending if async_op else pending.wait()), new_residual


def all_gather_bucket_compressed(schedule, idx, shard_vals, wire,
                                 residual=None, axes=None):
    """``all_gather_bucket`` at ``wire``'s width: this rank narrows its
    shard of bucket ``idx`` (cast, or chunked-quantized with its scales
    riding along), all-gathers the payload and decodes every rank's part
    into the full padded flat bucket. Returns ``(flat, new_residual)``.

    ``residual`` (fp32, the shard's size) is this direction's
    error-feedback carry: added before encoding, the new quantization
    error returned. In ZeRO-1 the gathered payload is the parameter delta,
    so every rank applies the same decoded delta and the residual makes
    the applied deltas add up to the exact ones. A non-float shard takes
    the exact path."""
    axes = schedule.axes if axes is None else axes
    if not shard_vals.dtype.is_floating_point:
        return all_gather_bucket(schedule, idx, shard_vals,
                                 axes=axes), residual
    world, shard = schedule.world, schedule.shard_sizes[idx]
    if shard_vals.numel() != shard:
        raise ValueError(f"bucket {idx}: shard of {shard_vals.numel()} "
                         f"elements, scheduled {shard}")
    out_dtype = shard_vals.dtype
    x = shard_vals
    if residual is not None:
        x = x.float() + residual.reshape(x.shape)
    if wire.chunked:
        q = wire.for_length(shard)
        if residual is not None:
            wire_shard, scales, deq = q.roundtrip(x)
            new_residual = x - deq
        else:
            wire_shard, scales = q.compress_flat(x)
            new_residual = None
        gathered = collective.allgather(wire_shard, axes=axes)
        g_scales = collective.allgather(scales, axes=axes)
        flat = q.decompress_flat(
            gathered.reshape(world, -1), g_scales.reshape(world, -1),
            out_dtype, n=shard).reshape(world * shard)
    else:
        if residual is not None:
            wire_shard, _, deq = wire.roundtrip(x)
            new_residual = x - deq
        else:
            wire_shard, _ = wire.compress_flat(x)
            new_residual = None
        flat = _all_gather(wire_shard, axes).to(out_dtype)
    return flat, new_residual


def unpack_bucket(schedule, idx, flat, leaves):
    """Scatter the flat bucket back into leaf positions: ``{leaf index:
    tensor}``, each cast to its leaf's dtype (padding tail ignored)."""
    return {i: part.to(leaves[i].dtype)
            for i, part in _unpack(schedule.buckets[idx], flat).items()}
