"""Sequence parallelism: ring attention and Ulysses all-to-all.

The port of ``horovod_tpu/parallel/ring.py``. Each rank of a mesh axis
holds one contiguous block of the sequence, ``[B, S_local, H, D]``, and
causality is enforced by absolute positions, rank ``i`` holding
positions ``i * S_local ...``:

* ``ring_attention``: Q stays on its rank while the K/V blocks rotate
  around the axis (``collective.ppermute``), each step folded in by the
  online softmax in fp32. With ``use_flash`` each step is the flash
  kernel K1 with its lse rows, merged by log-sum-exp, and the backward a
  second ring pass of K2 and K3 with fp32 outputs against the merged
  lse, the fp32 dK/dV accumulators travelling with their K/V block:
  ``flash_fwd_block`` and ``flash_bwd_block`` (``ops/flash_attention``)
  on the [BH, S_local, D] layout the ring keeps from step to step.
* ``ulysses_attention``: an all-to-all from sequence-sharded to
  head-sharded, dense attention over the whole sequence, and back.

The block loops are written once, against an axis object that holds the
shards this process computes and moves them between ranks: ``_GroupAxis``
is this rank's one shard on a named axis of the installed mesh, moved by
the collectives of its process group; ``_LocalAxis`` is every shard of
an axis of ``n`` ranks, held in one process and moved by reindexing (the
counterpart of the JAX tests' virtual CPU mesh; the tests and
``chip_smoke.py`` drive the loops through it).
"""

import torch

from horovod_tpu_torch.ops import collective
from horovod_tpu_torch.ops import flash_attention as fa
from horovod_tpu_torch.parallel import mesh as mesh_lib

NEG_INF = fa.NEG_INF


def default_positions(axis_name, batch, seq_local, device=None):
    """Absolute token positions of a sequence-sharded ``[B, S_local]``
    block: this rank's offset on ``axis_name`` plus the local arange (0
    without an axis). The one formula causal masking and rotary
    embeddings use."""
    index = mesh_lib.axis_index(axis_name) if axis_name else 0
    return _positions_at(index, batch, seq_local, device)


def _positions_at(index, batch, seq_local, device):
    pos = index * seq_local + torch.arange(seq_local, device=device)
    return pos.expand(batch, seq_local)


class _GroupAxis:
    """This rank's shard on ``axis`` of the installed mesh: lists of one
    tensor, moved by the axis's process group."""

    def __init__(self, axis):
        mesh = mesh_lib.get_mesh()
        self.axis = axis
        self.n = mesh.axis_size(axis)
        self.indices = [mesh.axis_index(axis)]

    def shift(self, xs):
        """Each rank's tensor to the next rank of the ring."""
        if self.n == 1:
            return xs
        perm = [(j, (j + 1) % self.n) for j in range(self.n)]
        return [collective.ppermute(xs[0], self.axis, perm)]

    def all_to_all(self, xs, split_dim, concat_dim):
        return [collective.alltoall(xs[0], axes=self.axis,
                                    split_dim=split_dim,
                                    concat_dim=concat_dim)]

    def all_gather(self, xs, dim):
        x = xs[0].movedim(dim, 0)
        return [collective.allgather(x, axes=self.axis).movedim(0, dim)]


class _LocalAxis:
    """Every shard of an axis of ``n`` ranks in this process: lists of
    ``n`` tensors, shard ``j`` on rank ``j``. A rotated tensor is a view,
    so autograd sums its gradient in the order the group rotation's
    backward does and the two give the same bits."""

    def __init__(self, n):
        self.n = n
        self.indices = list(range(n))

    def shift(self, xs):
        return [xs[(j - 1) % self.n].view_as(xs[j]) for j in range(self.n)]

    def all_to_all(self, xs, split_dim, concat_dim):
        parts = [x.chunk(self.n, dim=split_dim) for x in xs]
        return [torch.cat([p[j] for p in parts], dim=concat_dim)
                for j in range(self.n)]

    def all_gather(self, xs, dim):
        return [torch.cat(xs, dim=dim)] * self.n


def _block_update(q, k, v, q_pos, kv_pos, m, l, o, causal, scale):
    """One online-softmax step against a K/V block, in fp32.

    q: [B,Sq,H,D]; k, v: [B,Sk,H,D]; m, l: [B,H,Sq]; o: [B,H,Sq,D]."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if causal:
        mask = q_pos[:, None, :, None] >= kv_pos[:, None, None, :]
        s = torch.where(mask, s, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    # a row masked whole has m_new == NEG_INF, where exp(s - m_new) is 1:
    # its probabilities are zeroed explicitly
    p = torch.exp(s - m_new[..., None])
    p = torch.where(s <= NEG_INF, 0.0, p)
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1)
    o_new = o * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p,
                                               v.float())
    return m_new, l_new, o_new


def ring_attention(q, k, v, axis_name, causal=True, q_positions=None,
                   kv_positions=None, use_flash=False):
    """Ring attention over the mesh axis ``axis_name``. Per rank: q, k, v
    ``[B, S_local, H, D]``; positions ``[B, S_local]`` absolute (default
    ``default_positions``). Returns ``[B, S_local, H, D]`` in q's dtype.

    ``use_flash`` runs each block through the flash kernels and merges
    the blocks by log-sum-exp; it needs the default contiguous positions
    and shapes the kernels take (``fa.kernel_supported``), and otherwise
    takes the dense ring, as the JAX package does."""
    return _ring_attention(_GroupAxis(axis_name), [q], [k], [v], causal,
                           _one(q_positions), _one(kv_positions),
                           use_flash)[0]


def _one(x):
    return None if x is None else [x]


def _ring_attention(axis, qs, ks, vs, causal=True, q_positions=None,
                    kv_positions=None, use_flash=False):
    """``ring_attention`` over the shards of ``axis`` (lists, one entry
    per shard of ``axis.indices``)."""
    b, sq, h, d = qs[0].shape
    if use_flash and q_positions is None and kv_positions is None and \
            fa.kernel_supported(sq, sq, d):
        outs = _RingFlash.apply(axis, causal, 1.0 / float(d) ** 0.5,
                                *(fa._to_bh(x) for x in qs + ks + vs))
        return [fa._from_bh(o, b, h) for o in outs]
    n, scale = axis.n, 1.0 / float(d) ** 0.5
    if q_positions is None:
        q_positions = [_positions_at(i, b, sq, qs[0].device)
                       for i in axis.indices]
    if kv_positions is None:
        kv_positions = q_positions
    dev = qs[0].device
    state = [(torch.full((b, h, sq), NEG_INF, device=dev),
              torch.zeros((b, h, sq), device=dev),
              torch.zeros((b, h, sq, d), device=dev)) for _ in qs]
    k_blk, v_blk, kv_pos = list(ks), list(vs), list(kv_positions)
    for t in range(n):
        state = [_block_update(q, kb, vb, qp, kp, *st, causal, scale)
                 for q, kb, vb, qp, kp, st in zip(qs, k_blk, v_blk,
                                                  q_positions, kv_pos, state)]
        if t < n - 1:  # the blocks' last move, home, is not needed
            k_blk, v_blk = axis.shift(k_blk), axis.shift(v_blk)
            kv_pos = axis.shift(kv_pos)
    outs = []
    for q, (_, l, o) in zip(qs, state):
        l = torch.where(l == 0.0, 1.0, l)
        outs.append((o / l[..., None]).to(q.dtype).permute(0, 2, 1, 3))
    return outs


def _merge(o_run, lse_run, o_j, lse_j):
    """Fold block j's ``(o_j, lse_j)`` into the running fp32 ``(o, lse)``
    by log-sum-exp. A row whose lse is the ``NEG_INF`` sentinel weighs
    0; a row that no block has seen keeps the sentinel and a zero
    output."""
    m = torch.maximum(lse_run, lse_j)
    m_safe = torch.where(m <= NEG_INF / 2, 0.0, m)
    w_run = torch.where(lse_run <= NEG_INF / 2, 0.0,
                        torch.exp(lse_run - m_safe))
    w_j = torch.where(lse_j <= NEG_INF / 2, 0.0, torch.exp(lse_j - m_safe))
    tot = w_run + w_j
    tot_safe = torch.where(tot == 0.0, 1.0, tot)
    o_run = ((o_run * w_run[..., None] + o_j.float() * w_j[..., None])
             / tot_safe[..., None])
    lse_run = torch.where(tot == 0.0, NEG_INF, m_safe + torch.log(tot_safe))
    return o_run, lse_run


def _flash_ring_forward(axis, qs, ks, vs, causal, sm_scale):
    """The flash ring's forward over the shards of ``axis``, [BH, S_local,
    D] each: ``(outs, lses)``, the outputs in q's dtype and the merged
    fp32 lse rows. Offsets are host ints: at step ``t`` the rank at index
    ``r`` holds the K/V block of rank ``(r - t) mod n``, at
    ``((r - t) mod n) * S_local``."""
    n, s = axis.n, qs[0].shape[1]
    ks, vs = list(ks), list(vs)
    run = [None] * len(qs)  # (o fp32, lse) per shard
    for t in range(n):
        for j, r in enumerate(axis.indices):
            o_j, lse_j = fa.flash_fwd_block(
                qs[j], ks[j], vs[j], causal=causal, sm_scale=sm_scale,
                q_offset=r * s, kv_offset=(r - t) % n * s)
            run[j] = ((o_j.float(), lse_j) if run[j] is None
                      else _merge(*run[j], o_j, lse_j))
        if t < n - 1:
            ks, vs = axis.shift(ks), axis.shift(vs)
    # fp32 across the ring, one cast at the end: re-rounding to bf16 at
    # every step would compound
    return ([o.to(q.dtype) for q, (o, _) in zip(qs, run)],
            [lse for _, lse in run])


def _flash_ring_backward(axis, qs, ks, vs, outs, lses, gs, causal,
                         sm_scale):
    """The flash ring's backward: ``(dqs, dks, dvs)`` in the primal
    dtypes, from the forward's cast outputs and merged lse rows and the
    upstream ``gs``. Each step runs K2 and K3 with fp32 outputs against
    the merged lse; dK and dV travel with their block, so after n moves
    they are home holding every rank's contribution."""
    n, s = axis.n, qs[0].shape[1]
    ks, vs = list(ks), list(vs)
    # the softmax-jacobian row correction against the merged output
    deltas = [(g.float() * o.float()).sum(dim=-1) for g, o in zip(gs, outs)]
    m = len(qs)
    dq, dk, dv = [None] * m, [None] * m, [None] * m
    for t in range(n):
        for j, r in enumerate(axis.indices):
            dq_p, dk_p, dv_p = fa.flash_bwd_block(
                qs[j], ks[j], vs[j], gs[j], lses[j], deltas[j],
                causal=causal, sm_scale=sm_scale, q_offset=r * s,
                kv_offset=(r - t) % n * s)
            if t == 0:
                dq[j], dk[j], dv[j] = dq_p, dk_p, dv_p
            else:
                dq[j], dk[j], dv[j] = (dq[j] + dq_p, dk[j] + dk_p,
                                       dv[j] + dv_p)
        dk, dv = axis.shift(dk), axis.shift(dv)
        if t < n - 1:
            ks, vs = axis.shift(ks), axis.shift(vs)
    return ([x.to(q.dtype) for x, q in zip(dq, qs)],
            [x.to(q.dtype) for x, q in zip(dk, qs)],
            [x.to(q.dtype) for x, q in zip(dv, qs)])


class _RingFlash(torch.autograd.Function):
    """Flash ring attention on [BH, S_local, D] shards: the arguments
    after ``(axis, causal, sm_scale)`` are every shard's q, then k, then
    v; the outputs every shard's attention."""

    @staticmethod
    def forward(ctx, axis, causal, sm_scale, *qkv):
        m = len(qkv) // 3
        outs, lses = _flash_ring_forward(axis, qkv[:m], qkv[m:2 * m],
                                         qkv[2 * m:], causal, sm_scale)
        ctx.args, ctx.m = (axis, causal, sm_scale), m
        ctx.save_for_backward(*qkv, *outs, *lses)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        (axis, causal, sm_scale), m = ctx.args, ctx.m
        t = ctx.saved_tensors
        dq, dk, dv = _flash_ring_backward(
            axis, t[:m], t[m:2 * m], t[2 * m:3 * m], t[3 * m:4 * m],
            t[4 * m:], [g.contiguous() for g in gs], causal, sm_scale)
        return (None, None, None, *dq, *dk, *dv)


def ulysses_attention(q, k, v, axis_name, causal=True, q_positions=None,
                      kv_positions=None):
    """Ulysses sequence parallelism over the mesh axis ``axis_name``: an
    all-to-all from sequence-sharded to head-sharded, dense attention over
    the whole sequence, and the reverse all-to-all. Needs ``num_heads %
    axis_size == 0``."""
    return _ulysses_attention(_GroupAxis(axis_name), [q], [k], [v], causal,
                              _one(q_positions), _one(kv_positions))[0]


def _ulysses_attention(axis, qs, ks, vs, causal=True, q_positions=None,
                       kv_positions=None):
    from horovod_tpu_torch.models.transformer import dense_attention

    b, sq, h, _ = qs[0].shape
    if h % axis.n:
        raise ValueError(f"num_heads {h} not divisible by axis size "
                         f"{axis.n}")
    if q_positions is None:
        q_positions = [_positions_at(i, b, sq, qs[0].device)
                       for i in axis.indices]
    if kv_positions is None:
        kv_positions = q_positions
    # [B, S/n, H, D] -> [B, S, H/n, D]
    qg, kg, vg = (axis.all_to_all(x, 2, 1) for x in (qs, ks, vs))
    q_pos = axis.all_gather(q_positions, 1)
    kv_pos = axis.all_gather(kv_positions, 1)
    outs = [dense_attention(a, b_, c, causal=causal, q_positions=p,
                            kv_positions=kp)
            for a, b_, c, p, kp in zip(qg, kg, vg, q_pos, kv_pos)]
    return axis.all_to_all(outs, 1, 2)  # back to [B, S/n, H, D]
