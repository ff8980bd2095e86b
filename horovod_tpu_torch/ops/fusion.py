"""Tensor fusion: pack many small tensors into few big collectives.

The port of the uncompressed, single-level branch of
``horovod_tpu/ops/fusion.py``: tensors are grouped by dtype and packed in
order into flat buckets of at most ``fusion_threshold`` bytes (default
64 MB), one collective per bucket. The plan is the same greedy packing as
the JAX package's ``plan_buckets``, so the same leaves give the same
buckets.
"""

import dataclasses

import torch

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


def plan_buckets(leaves, threshold_bytes):
    """Greedy packing of ``leaves``, in order, into dtype-homogeneous
    buckets of at most ``threshold_bytes`` (a single tensor larger than
    the threshold gets its own bucket)."""
    by_dtype = {}
    for i in range(len(leaves)):
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


def fused_allreduce_(tensors, op=collective.Average, threshold_bytes=None):
    """Allreduce every tensor of the list in place through fused flat
    buckets: pack, one collective per bucket, unpack. Returns the
    buckets, so a caller can account what went over the wire."""
    if threshold_bytes is None:
        from horovod_tpu_torch import basics
        threshold_bytes = basics.fusion_threshold()
    buckets = plan_buckets(tensors, threshold_bytes)
    for bucket in buckets:
        flat = torch.cat([tensors[i].reshape(-1)
                          for i in bucket.leaf_indices])
        collective.allreduce_(flat, op=op)
        for i, part in zip(bucket.leaf_indices,
                           flat.split(list(bucket.sizes))):
            tensors[i].copy_(part.view(tensors[i].shape))
    return buckets
