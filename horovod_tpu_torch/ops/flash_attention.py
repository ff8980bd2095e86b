"""Fused flash attention: three hand-written CUDA kernels for Hopper.

The attention hot path of the transformer (models/transformer.py). The
kernels live in ``csrc/`` and are built at first use (``_build.py``):

* ``flash_fwd`` (K1): out and the fp32 log-sum-exp rows, the S x S score
  matrix never stored; bf16 in ``flash_fwd_sm90.cu`` (wgmma and TMA),
  fp32 in ``flash_attention.cu``;
* ``flash_dq`` (K2): dQ, recomputing P from (q, k, lse); bf16 in
  ``flash_dq_sm90.cu`` (wgmma and TMA), fp32 in ``flash_attention.cu``;
* ``flash_dkv`` (K3): dK and dV, the same recompute; bf16 in
  ``flash_dkv_sm90.cu`` (wgmma and TMA), fp32 in ``flash_attention.cu``.

Each wrapper launches its kernel for tensors on the card, counts the
launch in ``LAUNCHES`` and raises if the launch fails; tensors on the CPU
take the plain PyTorch version of the same function beside it
(``*_plain``), which is also what the card's kernels are held against.

Semantics: ``q_offset``/``kv_offset`` are the absolute positions of the
first query/key, the causal mask is ``q_offset + i >= kv_offset + j``,
and a query row that sees no key outputs zeros with lse ``NEG_INF``. The
products take the inputs' dtype with fp32 accumulation; P is cast to V's
dtype before P.V and dS to K's dtype before dS.K. Layout of the kernels'
tensors is [BH, S, D]; ``flash_attention``/``attention`` take the
transformer's [B, S, H, D]. The blockwise primitives of ring attention
are ``flash_fwd_block`` (K1's out and lse rows, no autograd) and
``flash_bwd_block`` (K2 and K3 with fp32 outputs) on [BH, S, D], at host
int offsets; ``flash_attention_with_lse`` and
``flash_attention_bwd_block`` are the same on [B, S, H, D].
"""

import torch

from horovod_tpu_torch import _build

NEG_INF = -1e30
MAX_HEAD_DIM = 128
LAUNCHES = {"fwd": 0, "dq": 0, "dkv": 0}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches():
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def kernel_supported(sq, skv, d):
    """True when the kernels take these shapes: any sequence length above
    1 (ragged tails are masked in the kernel) and a head dim that is a
    multiple of 8 up to ``MAX_HEAD_DIM``. Decode shapes (one query or one
    key) go to the dense path by an explicit gate: that is the contract
    the serving loop depends on."""
    if sq == 1 or skv == 1:
        return False
    return d % 8 == 0 and 0 < d <= MAX_HEAD_DIM


def _visible(sq, skv, q_offset, kv_offset, device):
    qp = q_offset + torch.arange(sq, device=device)[:, None]
    kp = kv_offset + torch.arange(skv, device=device)[None, :]
    return qp >= kp


def _scores(q, k, causal, sm_scale, q_offset, kv_offset):
    """fp32 Q.K^T * scale with masked entries at NEG_INF."""
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * sm_scale
    if causal:
        vis = _visible(q.shape[1], k.shape[1], q_offset, kv_offset, q.device)
        s = s.masked_fill(~vis, NEG_INF)
    return s


def flash_fwd_plain(q, k, v, *, causal, sm_scale, q_offset=0, kv_offset=0):
    """Plain version of K1 on [BH, S, D]: ``(out, lse)`` with lse fp32
    [BH, Sq]."""
    s = _scores(q, k, causal, sm_scale, q_offset, kv_offset)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(m <= NEG_INF / 2, 0.0, torch.exp(s - m))
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0, 1.0, l)
    out = torch.matmul(p.to(v.dtype).float(), v.float()) / l_safe
    lse = torch.where(l == 0, NEG_INF, m + torch.log(l_safe))
    return out.to(q.dtype), lse[..., 0]


def _p_ds(q, k, v, g, lse, delta, causal, sm_scale, q_offset, kv_offset):
    s = _scores(q, k, causal, sm_scale, q_offset, kv_offset)
    lse = lse[..., None]
    p = torch.where(lse <= NEG_INF / 2, 0.0, torch.exp(s - lse))
    dp = torch.matmul(g.float(), v.float().transpose(1, 2))
    return p, p * (dp - delta[..., None]) * sm_scale


def flash_dq_plain(q, k, v, g, lse, delta, *, causal, sm_scale, q_offset=0,
                   kv_offset=0, out_dtype=None):
    """Plain version of K2: dQ from the upstream ``g`` = dO, the forward's
    ``lse`` [BH, Sq] and ``delta`` = rowsum(dO * O) [BH, Sq]."""
    _, ds = _p_ds(q, k, v, g, lse, delta, causal, sm_scale, q_offset,
                  kv_offset)
    dq = torch.matmul(ds.to(k.dtype).float(), k.float())
    return dq.to(out_dtype or q.dtype)


def flash_dkv_plain(q, k, v, g, lse, delta, *, causal, sm_scale, q_offset=0,
                    kv_offset=0, out_dtype=None):
    """Plain version of K3: ``(dk, dv)``."""
    p, ds = _p_ds(q, k, v, g, lse, delta, causal, sm_scale, q_offset,
                  kv_offset)
    dv = torch.matmul(p.to(g.dtype).float().transpose(1, 2), g.float())
    dk = torch.matmul(ds.to(q.dtype).float().transpose(1, 2), q.float())
    return dk.to(out_dtype or k.dtype), dv.to(out_dtype or v.dtype)


def _on_card(name, *tensors):
    """True when the kernel should run: every tensor on one CUDA device,
    in a dtype and layout the kernel takes. False when all lie on the
    CPU. Anything else raises."""
    devices = {t.device for t in tensors}
    if devices == {torch.device("cpu")}:
        return False
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"flash {name}: tensors must all be on one CUDA "
                         f"device or all on the CPU, got {devices}")
    for t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash {name}: tensors must be contiguous "
                             "and 16-byte aligned")
    return True


def _check_qkv(name, q, k, v, g=None):
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash {name}: dtype {q.dtype} is not supported "
                        "(bfloat16 or float32)")
    for t in (k, v) + ((g,) if g is not None else ()):
        if t.dtype != q.dtype:
            raise TypeError(f"flash {name}: mixed dtypes {q.dtype} and "
                            f"{t.dtype}")
    if q.dim() != 3 or k.shape != v.shape or k.dim() != 3 or \
            q.shape[0] != k.shape[0] or q.shape[2] != k.shape[2]:
        raise ValueError(f"flash {name}: expected q [BH,Sq,D] and k, v "
                         f"[BH,Skv,D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if g is not None and g.shape != q.shape:
        raise ValueError(f"flash {name}: dO shape {tuple(g.shape)} != q "
                         f"shape {tuple(q.shape)}")
    bh, sq, d = q.shape
    if not kernel_supported(sq, k.shape[1], d) or bh > 65535:
        raise ValueError(f"flash {name}: shapes outside the kernel's "
                         f"limits (bh={bh}, sq={sq}, skv={k.shape[1]}, "
                         f"d={d}); use attention() for automatic routing")


def _check_rows(name, q, *rows):
    for r in rows:
        if r.dtype != torch.float32 or r.shape != q.shape[:2]:
            raise ValueError(f"flash {name}: lse/delta must be fp32 "
                             f"[BH, Sq], got {r.dtype} {tuple(r.shape)}")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_fwd(q, k, v, *, causal, sm_scale, q_offset=0, kv_offset=0):
    """K1 on [BH, S, D]: ``(out, lse)``; the kernel on the card, the plain
    version on the CPU."""
    if not _on_card("fwd", q, k, v):
        return flash_fwd_plain(q, k, v, causal=causal, sm_scale=sm_scale,
                               q_offset=q_offset, kv_offset=kv_offset)
    _check_qkv("fwd", q, k, v)
    bh, sq, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    lib = _build.load()
    with torch.cuda.device(q.device):
        rc = lib.hvd_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), bh, sq, k.shape[1], d, int(q_offset),
            int(kv_offset), int(bool(causal)), float(sm_scale),
            _DTYPE_CODE[q.dtype], _stream(q))
    _build.check(lib, rc, "flash fwd")
    LAUNCHES["fwd"] += 1
    return out, lse


def flash_dq(q, k, v, g, lse, delta, *, causal, sm_scale, q_offset=0,
             kv_offset=0, out_dtype=None):
    """K2: dQ in ``out_dtype`` (default q's dtype; float32 for partials
    that a caller accumulates)."""
    if not _on_card("dq", q, k, v, g, lse, delta):
        return flash_dq_plain(q, k, v, g, lse, delta, causal=causal,
                              sm_scale=sm_scale, q_offset=q_offset,
                              kv_offset=kv_offset, out_dtype=out_dtype)
    _check_qkv("dq", q, k, v, g)
    _check_rows("dq", q, lse, delta)
    bh, sq, d = q.shape
    out_f32 = out_dtype == torch.float32
    dq = torch.empty(q.shape, dtype=torch.float32 if out_f32 else q.dtype,
                     device=q.device)
    lib = _build.load()
    with torch.cuda.device(q.device):
        rc = lib.hvd_flash_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), int(out_f32),
            bh, sq, k.shape[1], d, int(q_offset), int(kv_offset),
            int(bool(causal)), float(sm_scale), _DTYPE_CODE[q.dtype],
            _stream(q))
    _build.check(lib, rc, "flash dq")
    LAUNCHES["dq"] += 1
    return dq


def flash_dkv(q, k, v, g, lse, delta, *, causal, sm_scale, q_offset=0,
              kv_offset=0, out_dtype=None):
    """K3: ``(dk, dv)`` in ``out_dtype`` (default the primal dtypes)."""
    if not _on_card("dkv", q, k, v, g, lse, delta):
        return flash_dkv_plain(q, k, v, g, lse, delta, causal=causal,
                               sm_scale=sm_scale, q_offset=q_offset,
                               kv_offset=kv_offset, out_dtype=out_dtype)
    _check_qkv("dkv", q, k, v, g)
    _check_rows("dkv", q, lse, delta)
    bh, sq, d = q.shape
    out_f32 = out_dtype == torch.float32
    odt = torch.float32 if out_f32 else k.dtype
    dk = torch.empty(k.shape, dtype=odt, device=k.device)
    dv = torch.empty(v.shape, dtype=odt, device=v.device)
    lib = _build.load()
    with torch.cuda.device(q.device):
        rc = lib.hvd_flash_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            int(out_f32), bh, sq, k.shape[1], d, int(q_offset),
            int(kv_offset), int(bool(causal)), float(sm_scale),
            _DTYPE_CODE[q.dtype], _stream(q))
    _build.check(lib, rc, "flash dkv")
    LAUNCHES["dkv"] += 1
    return dk, dv


class _FlashAttention(torch.autograd.Function):
    """Attention on [BH, S, D] whose forward is K1 and whose backward is
    K2 then K3; (q, k, v, out, lse) are saved, so the backward, like the
    forward, never holds an S x S matrix. Gradients take the primal
    dtypes."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, q_offset, kv_offset):
        out, lse = flash_fwd(q, k, v, causal=causal, sm_scale=sm_scale,
                             q_offset=q_offset, kv_offset=kv_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = dict(causal=causal, sm_scale=sm_scale,
                        q_offset=q_offset, kv_offset=kv_offset)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        g = g.contiguous()
        # delta_i = sum_d dO * O: the softmax-jacobian row correction
        delta = (g.float() * out.float()).sum(dim=-1)
        dq = flash_dq(q, k, v, g, lse, delta, **ctx.args)
        dk, dv = flash_dkv(q, k, v, g, lse, delta, **ctx.args)
        return dq, dk, dv, None, None, None, None


def _to_bh(x):
    b, s, h, d = x.shape
    return x.transpose(1, 2).reshape(b * h, s, d).contiguous()


def _from_bh(x, b, h):
    bh, s, d = x.shape
    return x.reshape(b, h, s, d).transpose(1, 2)


def flash_attention(q, k, v, *, causal=True, sm_scale=None, q_offset=0,
                    kv_offset=0):
    """Fused attention on [B, S, H, D] tensors (the transformer layout),
    differentiable through the flash backward kernels. Batch-sharded
    DTensors (the GSPMD step's) run the kernels on each rank's rows, as
    an island (``parallel.gspmd.local_attention``): the kernels take raw
    pointers and have no DTensor sharding rule."""
    if type(q) is not torch.Tensor:
        from horovod_tpu_torch.parallel import gspmd
        if gspmd.is_dtensor(q):
            return gspmd.local_attention(
                flash_attention, q, k, v, causal=causal, sm_scale=sm_scale,
                q_offset=q_offset, kv_offset=kv_offset)
    b, sq, h, d = q.shape
    if not kernel_supported(sq, k.shape[1], d):
        raise ValueError(
            f"flash_attention needs sq > 1, skv > 1 and d % 8 == 0 with "
            f"d <= {MAX_HEAD_DIM} (sq={sq}, skv={k.shape[1]}, d={d}); use "
            "attention() for automatic routing")
    sm_scale = sm_scale if sm_scale is not None else 1.0 / float(d) ** 0.5
    out = _FlashAttention.apply(_to_bh(q), _to_bh(k), _to_bh(v), causal,
                                sm_scale, q_offset, kv_offset)
    return _from_bh(out, b, h)


def _host_offsets(q_offset, kv_offset):
    if torch.is_tensor(q_offset) or torch.is_tensor(kv_offset):
        raise TypeError("flash offsets are host ints: reading a device "
                        "tensor would synchronize on every block")
    return int(q_offset), int(kv_offset)


def _rows_bh(x):  # [B, S, H] -> [BH, S]
    b, s, h = x.shape
    return x.transpose(1, 2).reshape(b * h, s).contiguous()


def flash_fwd_block(q, k, v, *, causal, sm_scale, q_offset, kv_offset):
    """K1 on [BH, S, D] for blockwise composition: ``(out, lse)``, the
    lse rows ``NEG_INF``, with a zero output row, where a row sees no
    key. Ring attention runs it per rotated K/V block and merges the
    blocks by lse (``parallel/ring.py``). Offsets are host ints."""
    q_offset, kv_offset = _host_offsets(q_offset, kv_offset)
    return flash_fwd(q, k, v, causal=causal, sm_scale=sm_scale,
                     q_offset=q_offset, kv_offset=kv_offset)


def flash_bwd_block(q, k, v, g, lse, delta, *, causal, sm_scale, q_offset,
                    kv_offset):
    """One block's backward on [BH, S, D]: this rank's queries ``q``, one
    K/V block, the upstream ``g`` = dO, the globally merged ``lse`` and
    ``delta`` = sum_d dO * O over the final output, both [BH, Sq]. Runs
    K2 and K3 with fp32 outputs and returns the fp32 partials ``(dq, dk,
    dv)`` of exactly this block: p = exp(s - LSE) factorizes per block
    once LSE is global, so the partials summed over the blocks are the
    exact gradient. Offsets are host ints."""
    q_offset, kv_offset = _host_offsets(q_offset, kv_offset)
    kw = dict(causal=causal, sm_scale=sm_scale, q_offset=q_offset,
              kv_offset=kv_offset, out_dtype=torch.float32)
    dq = flash_dq(q, k, v, g, lse, delta, **kw)
    dk, dv = flash_dkv(q, k, v, g, lse, delta, **kw)
    return dq, dk, dv


@torch.no_grad()
def flash_attention_with_lse(q, k, v, *, causal=True, sm_scale=None,
                             q_offset=0, kv_offset=0):
    """``flash_fwd_block`` on [B, S, H, D]: ``(out, lse[B, S, H])``.
    Forward only, with no autograd: the ring differentiates at its own
    level."""
    b, sq, h, d = q.shape
    sm_scale = sm_scale if sm_scale is not None else 1.0 / float(d) ** 0.5
    out, lse = flash_fwd_block(_to_bh(q), _to_bh(k), _to_bh(v),
                               causal=causal, sm_scale=sm_scale,
                               q_offset=q_offset, kv_offset=kv_offset)
    return _from_bh(out, b, h), lse.reshape(b, h, sq).transpose(1, 2)


@torch.no_grad()
def flash_attention_bwd_block(q, k, v, g, lse, delta, *, causal=True,
                              sm_scale=None, q_offset=0, kv_offset=0):
    """``flash_bwd_block`` on [B, S, H, D], with ``lse`` and ``delta``
    [B, Sq, H]: the fp32 partials ``(dq, dk, dv)`` of one block."""
    b, sq, h, d = q.shape
    sm_scale = sm_scale if sm_scale is not None else 1.0 / float(d) ** 0.5
    grads = flash_bwd_block(_to_bh(q), _to_bh(k), _to_bh(v), _to_bh(g),
                            _rows_bh(lse), _rows_bh(delta), causal=causal,
                            sm_scale=sm_scale, q_offset=q_offset,
                            kv_offset=kv_offset)
    return tuple(_from_bh(x, b, h) for x in grads)


def attention(q, k, v, *, causal=True, q_offset=0, kv_offset=0):
    """``flash_attention`` where the kernels take the shapes, else K1's
    plain version (differentiable PyTorch): both compute the same
    function, so the result does not depend on the route. Batch-sharded
    DTensors take the same route on each rank's rows
    (``flash_attention``'s island)."""
    if type(q) is not torch.Tensor:
        from horovod_tpu_torch.parallel import gspmd
        if gspmd.is_dtensor(q):
            return gspmd.local_attention(attention, q, k, v, causal=causal,
                                         q_offset=q_offset,
                                         kv_offset=kv_offset)
    b, sq, h, d = q.shape
    if kernel_supported(sq, k.shape[1], d):
        return flash_attention(q, k, v, causal=causal, q_offset=q_offset,
                               kv_offset=kv_offset)
    out, _ = flash_fwd_plain(_to_bh(q), _to_bh(k), _to_bh(v), causal=causal,
                             sm_scale=1.0 / float(d) ** 0.5,
                             q_offset=q_offset, kv_offset=kv_offset)
    return _from_bh(out, b, h)
