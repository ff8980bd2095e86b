"""Adasum: scale-insensitive gradient combination (Maleki et al., 2021).

The port of ``horovod_tpu/ops/adasum.py``. The pairwise operator for
gradients a, b is::

    combined = a * (1 - dot(a, b) / (2 ||a||^2))
             + b * (1 - dot(a, b) / (2 ||b||^2))

applied over a binary tree of ranks (a power of 2 of them, as in the
reference): at level l each rank exchanges its whole vector with the rank
whose index is its own XOR 2^l, and both combine the pair with the lower
rank's vector first, so both hold the same result. The dot product and
the norms are taken in fp32 whatever the wire dtype. Over a mesh with a
``dcn`` axis the two-level composite runs: a sum reduce-scatter over the
intra-host axes, the tree per chunk across ``dcn``, an all-gather, and
the division by the intra-host size (``hierarchical_adasum_allreduce``).

The algorithms are written once over the axis objects of
``parallel/axis.py``: ``adasum_allreduce`` and
``hierarchical_adasum_allreduce`` run on the installed mesh's process
groups; ``_adasum_tree`` and ``_hierarchical_adasum`` take lists of
shards and ``LocalAxis`` objects as well.

``adasum_combine_np``, ``adasum_tree_np`` and ``hierarchical_adasum_np``
are the operator's numpy references, the JAX package's oracles
(``horovod_tpu/ops/adasum.py:140-190``) written again here, so that a
check on the card has an oracle that shares no code with the port.
"""

import numpy as np
import torch

from horovod_tpu_torch.parallel import hierarchical
from horovod_tpu_torch.parallel.axis import GroupAxis
from horovod_tpu_torch.parallel.mesh import DCN_AXIS


def adasum_combine(a, b, eps=0.0):
    """The pairwise operator, in fp32: ``a`` and ``b`` flat in fp32, their
    dot product and squared norms, and ``a * ca + b * cb`` cast back to
    ``a``'s dtype. An operand of squared norm at most ``eps`` keeps a
    coefficient of 1, so with a zero operand the result is the sum."""
    af = a.float().reshape(-1)
    bf = b.float().reshape(-1)
    dot = torch.dot(af, bf)
    na2 = torch.dot(af, af)
    nb2 = torch.dot(bf, bf)
    one = torch.ones((), dtype=torch.float32, device=af.device)
    ca = torch.where(na2 > eps,
                     1.0 - dot / (2.0 * torch.where(na2 > eps, na2, one)),
                     one)
    cb = torch.where(nb2 > eps,
                     1.0 - dot / (2.0 * torch.where(nb2 > eps, nb2, one)),
                     one)
    out = af * ca + bf * cb
    return out.reshape(a.shape).to(a.dtype)


def _adasum_tree(xs, axis):
    """The XOR tree over ``axis`` (an axis object), one vector a shard."""
    n = axis.n
    if n & (n - 1):
        raise ValueError(f"Adasum requires a power-of-2 number of shards, "
                         f"got {n} (same constraint as the reference, "
                         "adasum.h)")
    out, d = list(xs), 1
    while d < n:
        other = axis.exchange(out, d)
        # the lower rank's vector first, so both partners get the same bits
        out = [adasum_combine(o, t) if (i & d) == 0 else adasum_combine(t, o)
               for o, t, i in zip(out, other, axis.indices)]
        d <<= 1
    return out


def adasum_allreduce(x, axes):
    """Adasum-reduce ``x`` across the ranks of ``axes`` (a name or a
    tuple of the installed mesh's axes). Over one axis, the XOR tree
    (``ValueError`` unless its size is a power of 2); over several, the
    two-level composite across the ``dcn`` axis, found by name (else the
    first axis plays its part), with the others as the intra-host
    axes."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    if len(axes) > 1:
        dcn = DCN_AXIS if DCN_AXIS in axes else axes[0]
        return hierarchical_adasum_allreduce(
            x, ici_axes=tuple(a for a in axes if a != dcn), dcn_axis=dcn)
    return _adasum_tree([x], GroupAxis(axes[0]))[0]


def hierarchical_adasum_allreduce(x, ici_axes, dcn_axis,
                                  divide_by_local_size=True):
    """The reference's two-level Adasum: a sum reduce-scatter over the
    intra-host axes (zero-padded to equal chunks), the XOR tree across
    ``dcn_axis`` on each chunk independently (each chunk gets its own
    coefficients), an all-gather, and the division by the intra-host
    size (in fp32 for 16-bit inputs). ``dcn_axis`` needs a power of 2 of
    ranks."""
    ici_axes = (ici_axes,) if isinstance(ici_axes, str) else tuple(ici_axes)
    return _hierarchical_adasum([x], [GroupAxis(a) for a in ici_axes],
                                GroupAxis(dcn_axis), divide_by_local_size)[0]


def _hierarchical_adasum(xs, ici, dcn, divide_by_local_size=True):
    shape, dtype = xs[0].shape, xs[0].dtype
    flat, n, ici_size = hierarchical._pad_flat(xs, ici)
    if ici_size == 1:
        return [o.reshape(shape) for o in _adasum_tree(flat, dcn)]
    shard = _adasum_tree(hierarchical._reducescatter(flat, ici), dcn)
    out = [o[:n].reshape(shape)
           for o in hierarchical._allgather(shard, ici)]
    if divide_by_local_size:
        if torch.finfo(dtype).bits >= 32:
            out = [o / ici_size for o in out]
        else:  # 16-bit: divide in fp32, as every other accumulation
            out = [(o.float() / ici_size).to(dtype) for o in out]
    return out


def adasum_combine_np(a, b):
    """NumPy reference of the pairwise operator, in fp32, formula for
    formula: the dot product and squared norms as Python floats, a
    coefficient of 1 for an operand of norm 0."""
    af = a.astype(np.float32).ravel()
    bf = b.astype(np.float32).ravel()
    dot = float(np.dot(af, bf))
    na2 = float(np.dot(af, af))
    nb2 = float(np.dot(bf, bf))
    ca = 1.0 - dot / (2.0 * na2) if na2 > 0 else 1.0
    cb = 1.0 - dot / (2.0 * nb2) if nb2 > 0 else 1.0
    return (af * ca + bf * cb).reshape(a.shape)


def adasum_tree_np(vectors):
    """NumPy reference of the whole tree over a power-of-2 list of
    vectors: at level l each index combines with its XOR 2^l partner,
    the lower index first."""
    vecs = [np.asarray(v, dtype=np.float32) for v in vectors]
    size = len(vecs)
    if size & (size - 1):
        raise ValueError(f"Adasum needs a power of 2 of vectors, got {size}")
    level = 0
    while (1 << level) < size:
        d = 1 << level
        nxt = list(vecs)
        for i in range(size):
            j = i ^ d
            a, b = (vecs[i], vecs[j]) if i < j else (vecs[j], vecs[i])
            nxt[i] = adasum_combine_np(a, b)
        vecs = nxt
        level += 1
    return vecs[0]


def hierarchical_adasum_np(grid):
    """NumPy reference of the two-level composite: ``grid`` is
    ``[n_nodes, local_size, n]`` per-rank gradients. Node sums, the
    zero-padded equal-chunk scatter, the tree per chunk across nodes,
    the chunks concatenated, divided by ``local_size``; in fp32."""
    grid = np.asarray(grid, np.float32)
    n_nodes, local_size, n = grid.shape
    node_sums = grid.sum(axis=1)
    pad = (-n) % local_size
    padded = np.pad(node_sums, ((0, 0), (0, pad)))
    chunks = padded.reshape(n_nodes, local_size, -1)
    out = np.concatenate([
        adasum_tree_np([chunks[c, i] for c in range(n_nodes)])
        for i in range(local_size)])
    return out[:n] / local_size
