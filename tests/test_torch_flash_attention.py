"""The port's flash attention (horovod_tpu_torch/ops/flash_attention.py)
against the JAX package's Pallas kernels, run in interpret mode on the
CPU. On the CPU the port's wrappers take their plain PyTorch versions,
the same functions the CUDA kernels are held against on the card.

Inputs are made with numpy from a seed and handed to both sides.
Tolerances: fp32 sides agree to summation order (1e-5 on values of order
1); bf16 sides differ by where P is rounded to bf16 (per kv block of the
online softmax in the kernel, once for the whole row in the plain
version), a few bf16 ulps of the output."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops import flash_attention as jfa
from horovod_tpu_torch.ops import flash_attention as tfa

BLOCK = 16  # Pallas block: S = 48 runs three q blocks and three kv blocks

_DT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# (out atol, lse atol) per dtype
_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 1e-4)}


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _both(x, dtype):
    jdt, tdt = _DT[dtype]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


CASES = [  # (causal, q_offset, kv_offset)
    (True, 0, 0),
    (False, 0, 0),
    (True, 0, 16),   # kv shifted right: the first 16 query rows see nothing
    (True, 32, 0),   # a later query shard against the first kv block
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,q_off,kv_off", CASES)
def test_forward_matches_pallas(dtype, causal, q_off, kv_off):
    bh, s, d = 3, 48, 16
    qn, kn, vn = _arrays(0, (bh, s, d), (bh, s, d), (bh, s, d))
    (jq, tq), (jk, tk), (jv, tv) = (_both(x, dtype) for x in (qn, kn, vn))
    scale = 1.0 / d ** 0.5
    offsets = jnp.asarray([q_off, kv_off], jnp.int32)
    j_out, j_lse = jfa._flash_fwd_impl(jq, jk, jv, offsets, causal, scale,
                                       BLOCK, BLOCK, True, with_lse=True)
    t_out, t_lse = tfa.flash_fwd(tq, tk, tv, causal=causal, sm_scale=scale,
                                 q_offset=q_off, kv_offset=kv_off)
    assert t_out.dtype == tq.dtype and t_lse.dtype == torch.float32
    atol_out, atol_lse = _TOL[dtype]
    np.testing.assert_allclose(_np(t_out), _np(j_out), atol=atol_out)
    np.testing.assert_allclose(_np(t_lse), _np(j_lse)[..., 0], atol=atol_lse,
                               rtol=1e-6)
    dead = q_off + np.arange(s) < kv_off  # rows that see no key
    if causal and dead.any():  # zeros and the NEG_INF sentinel
        assert np.all(_np(t_out)[:, dead] == 0)
        assert np.all(_np(t_lse)[:, dead] == tfa.NEG_INF)
    if dtype == "float32":  # and the plain-XLA fp32 oracle
        ref = jfa._reference_attention(jq, jk, jv, offsets, causal, scale)
        np.testing.assert_allclose(_np(t_out), _np(ref), atol=1e-5)


@pytest.mark.parametrize("causal,q_off,kv_off", CASES)
def test_flash_gradients_match_pallas(causal, q_off, kv_off):
    """``_FlashAttention`` (through ``flash_attention`` on [B,S,H,D])
    against jax.grad through the Pallas custom VJP, fp32. Gradients are
    sums over 48 keys of values of order 1: 1e-4 absolute."""
    b, s, h, d = 2, 48, 2, 16
    qn, kn, vn, wn = _arrays(1, *[(b, s, h, d)] * 4)

    def jloss(q, k, v):
        out = jfa.flash_attention(q, k, v, causal=causal, q_offset=q_off,
                                  kv_offset=kv_off, block_q=BLOCK,
                                  block_k=BLOCK, interpret=True)
        return jnp.sum(out * jnp.asarray(wn))

    jg = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (qn, kn, vn))
    out = tfa.flash_attention(tq, tk, tv, causal=causal, q_offset=q_off,
                              kv_offset=kv_off)
    (out * torch.from_numpy(wn)).sum().backward()
    for t, j in zip((tq, tk, tv), jg):
        assert t.grad.dtype == torch.float32
        np.testing.assert_allclose(_np(t.grad), _np(j), atol=1e-4)


def test_bf16_gradients_take_primal_dtype():
    b, s, h, d = 1, 32, 2, 16
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
                  for x in _arrays(2, *[(b, s, h, d)] * 3))
    tfa.flash_attention(tq, tk, tv).float().sum().backward()
    assert all(t.grad.dtype == torch.bfloat16 for t in (tq, tk, tv))


@pytest.mark.parametrize("causal,q_off,kv_off", CASES)
def test_fp32_backward_partials_match_bwd_block(causal, q_off, kv_off):
    """K2/K3 with ``out_dtype=float32`` against
    ``flash_attention_bwd_block`` (the ring attention primitive) on bf16
    inputs with a given lse and delta. The bf16 casts of dS and P sit at
    the same points on both sides; 2e-3 covers their rounding flips."""
    b, s, h, d = 2, 48, 2, 16
    qn, kn, vn, gn = _arrays(3, *[(b, s, h, d)] * 4)
    jq, jk, jv, jg = (jnp.asarray(x, jnp.bfloat16) for x in (qn, kn, vn, gn))
    out, lse = jfa.flash_attention_with_lse(
        jq, jk, jv, causal=causal, q_offset=q_off, kv_offset=kv_off,
        block_q=BLOCK, block_k=BLOCK, interpret=True)
    delta = jnp.sum(jg.astype(jnp.float32) * out.astype(jnp.float32), -1)
    j_dq, j_dk, j_dv = jfa.flash_attention_bwd_block(
        jq, jk, jv, jg, lse, delta, causal=causal, q_offset=q_off,
        kv_offset=kv_off, block_q=BLOCK, block_k=BLOCK, interpret=True)

    def bh(x):  # [B,S,H,D] -> [BH,S,D]
        return torch.from_numpy(np.array(x, np.float32)).to(
            torch.bfloat16).transpose(1, 2).reshape(b * h, s, d).contiguous()

    def rows(x):  # [B,S,H] -> [BH,S]
        return torch.from_numpy(np.array(x, np.float32)).transpose(
            1, 2).reshape(b * h, s).contiguous()

    args = (bh(jq), bh(jk), bh(jv), bh(jg), rows(lse), rows(delta))
    kw = dict(causal=causal, sm_scale=1.0 / d ** 0.5, q_offset=q_off,
              kv_offset=kv_off, out_dtype=torch.float32)
    t_dq = tfa.flash_dq(*args, **kw)
    t_dk, t_dv = tfa.flash_dkv(*args, **kw)
    for t, j in ((t_dq, j_dq), (t_dk, j_dk), (t_dv, j_dv)):
        assert t.dtype == torch.float32
        got = t.reshape(b, h, s, d).transpose(1, 2).numpy()
        np.testing.assert_allclose(got, np.asarray(j), atol=2e-3, rtol=1e-2)


def test_kernel_supported_is_the_kernels_own_limits():
    # the explicit decode gate: one query or one key goes to the dense path
    assert not tfa.kernel_supported(1, 2048, 64)
    assert not tfa.kernel_supported(2048, 1, 64)
    assert tfa.kernel_supported(2, 2, 64)
    # ragged tails are masked in the kernel: no divisor-block rule
    assert tfa.kernel_supported(200, 200, 64)
    assert tfa.kernel_supported(1048, 1048, 64)
    assert tfa.kernel_supported(16, 16, 16)
    assert tfa.kernel_supported(64, 64, 128)
    assert not tfa.kernel_supported(64, 64, 12)   # d % 8
    assert not tfa.kernel_supported(64, 64, 136)  # d > 128
    with pytest.raises(ValueError):
        tfa.flash_attention(*[torch.zeros(1, 1, 2, 16)] * 3)


def test_attention_routes_decode_shapes_to_reference():
    b, h, d = 2, 2, 16
    qn, = _arrays(4, (b, 1, h, d))
    kn, vn = _arrays(5, (b, 40, h, d), (b, 40, h, d))
    tfa.reset_launches()
    out = tfa.attention(torch.from_numpy(qn), torch.from_numpy(kn),
                        torch.from_numpy(vn), causal=True, q_offset=39)
    j = jfa.attention(jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn),
                      causal=True, q_offset=39)
    np.testing.assert_allclose(out.numpy(), np.asarray(j), atol=1e-5)
    assert tfa.LAUNCHES == {"fwd": 0, "dq": 0, "dkv": 0}


def test_cpu_takes_plain_version_and_other_devices_raise():
    q = torch.zeros(2, 16, 16)
    tfa.reset_launches()
    out, lse = tfa.flash_fwd(q, q, q, causal=True, sm_scale=0.25)
    assert tfa.LAUNCHES["fwd"] == 0 and out.shape == q.shape
    assert lse.shape == (2, 16)
    meta = torch.zeros(2, 16, 16, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        tfa.flash_fwd(meta, meta, meta, causal=True, sm_scale=0.25)
    with pytest.raises(ValueError, match="CUDA device"):
        tfa.flash_fwd(q, meta, meta, causal=True, sm_scale=0.25)
