"""Decoder-only Transformer: the port of ``horovod_tpu/models/transformer.py``
(the non-cache, dense-MLP branch).

Pre-RMSNorm blocks, rotary position embeddings, a tanh-GELU MLP and fp32
logits. Parameters are fp32 and every layer casts them to
``cfg.dtype`` at use (the flax ``dtype=`` contract), so an optimizer
updates fp32 masters. Attention runs through the flash kernels
(``ops/flash_attention.py``) or the dense path, by ``cfg.flash_attention``;
with ``cfg.sequence_axis`` the sequence is sharded over that mesh axis
and attention is ring attention (``parallel/ring.py``).
Parameter layouts are PyTorch's (``nn.Linear`` weights are [out, in]);
``convert.py`` maps them to and from the flax tree.
"""

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import skip_init

from horovod_tpu_torch.ops import flash_attention as fa
from horovod_tpu_torch.parallel import ring

RMS_EPS = 1e-6  # flax nn.RMSNorm default


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    num_layers: int = 4
    num_heads: int = 8
    d_model: int = 512
    d_ff: int = 2048
    dtype: torch.dtype = torch.bfloat16
    causal: bool = True
    # attention through the flash kernels (ops/flash_attention.py) when
    # True, else dense_attention
    flash_attention: bool = False
    # mesh axis the sequence is sharded over (ring attention), or None
    sequence_axis: Optional[str] = None


def _rotary(x, positions):
    """Rotary position embedding; x [B, S, H, D], positions [B, S]. The
    angles are fp32, cos/sin are cast to x's dtype before the products."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (10000.0 ** (torch.arange(0, half, dtype=torch.float32,
                                            device=x.device) / half))
    angles = positions[..., None].float() * freqs  # [B, S, half]
    cos = torch.cos(angles)[:, :, None, :].to(x.dtype)
    sin = torch.sin(angles)[:, :, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def dense_attention(q, k, v, *, causal, q_positions, kv_positions):
    """softmax(QK^T/sqrt(d)) V with the causal mask by absolute position;
    scores in q's dtype, softmax in fp32, probabilities cast back."""
    d = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / float(d) ** 0.5
    if causal:
        mask = q_positions[:, None, :, None] >= kv_positions[:, None, None, :]
        scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _trunc_normal_(w, std, generator):
    """Normal(0, std) truncated to two standard deviations, by inverse
    CDF (the sampler behind flax's ``lecun_normal``)."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    hi = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))
    with torch.no_grad():
        w.uniform_(2 * lo - 1, 2 * hi - 1, generator=generator)
        w.erfinv_().mul_(std * math.sqrt(2.0))
    return w


def lecun_normal_(w, fan_in, generator):
    """flax's default kernel initializer: truncated normal with variance
    1/fan_in (std corrected for the truncation)."""
    return _trunc_normal_(w, math.sqrt(1.0 / fan_in) / .87962566103423978,
                          generator)


def _lecun_linear(in_features, out_features, generator):
    """``nn.Linear`` without bias, drawn like flax's default Dense /
    DenseGeneral kernel."""
    lin = skip_init(nn.Linear, in_features, out_features, bias=False)
    lecun_normal_(lin.weight, in_features, generator)
    return lin


class RMSNorm(nn.Module):
    """flax ``nn.RMSNorm``: statistics and scaling in fp32, output cast to
    ``dtype``."""

    def __init__(self, dim, dtype):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        xf = x.float()
        var = xf.pow(2).mean(dim=-1, keepdim=True)
        return (xf * (torch.rsqrt(var + RMS_EPS) * self.weight)).to(self.dtype)


class Attention(nn.Module):
    def __init__(self, cfg, generator):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        self.query = _lecun_linear(d, d, generator)
        self.key = _lecun_linear(d, d, generator)
        self.value = _lecun_linear(d, d, generator)
        self.out = _lecun_linear(d, d, generator)

    def forward(self, x, positions):
        cfg = self.cfg
        b, s, _ = x.shape
        h = cfg.num_heads
        dt = cfg.dtype

        def proj(lin):
            return F.linear(x, lin.weight.to(dt)).view(b, s, h, -1)

        q = _rotary(proj(self.query), positions)
        k = _rotary(proj(self.key), positions)
        v = proj(self.value)
        if cfg.sequence_axis is not None and cfg.flash_attention:
            # the kernels per rotated K/V block, merged by lse; they mask
            # by the contiguous positions the ring computes
            out = ring.ring_attention(q, k, v, cfg.sequence_axis,
                                      causal=cfg.causal, use_flash=True)
        elif cfg.sequence_axis is not None:
            out = ring.ring_attention(q, k, v, cfg.sequence_axis,
                                      causal=cfg.causal, q_positions=positions,
                                      kv_positions=positions)
        elif cfg.flash_attention:
            out = fa.attention(q, k, v, causal=cfg.causal)
        else:
            out = dense_attention(q, k, v, causal=cfg.causal,
                                  q_positions=positions,
                                  kv_positions=positions)
        return F.linear(out.reshape(b, s, -1), self.out.weight.to(dt))


class Block(nn.Module):
    def __init__(self, cfg, generator):
        super().__init__()
        self.cfg = cfg
        self.norm1 = RMSNorm(cfg.d_model, cfg.dtype)
        self.attn = Attention(cfg, generator)
        self.norm2 = RMSNorm(cfg.d_model, cfg.dtype)
        self.mlp_in = _lecun_linear(cfg.d_model, cfg.d_ff, generator)
        self.mlp_out = _lecun_linear(cfg.d_ff, cfg.d_model, generator)

    def forward(self, x, positions):
        dt = self.cfg.dtype
        x = x + self.attn(self.norm1(x), positions)
        y = F.linear(self.norm2(x), self.mlp_in.weight.to(dt))
        y = F.gelu(y, approximate="tanh")  # flax nn.gelu is tanh-approximate
        y = F.linear(y, self.mlp_out.weight.to(dt))
        return x + y


class Transformer(nn.Module):
    """tokens [B, S] -> fp32 logits [B, S, vocab].

    With ``cfg.sequence_axis`` the tokens are this rank's block of the
    sequence, ``[B, S_local]``, and the default positions are absolute:
    this rank's offset on the axis plus the local arange
    (``ring.default_positions``), so the rotary embeddings see the
    positions the whole sequence has.

    Weights are drawn on the CPU from ``generator`` (a seeded
    ``torch.Generator``; flax's initializer distributions, not its bits)
    and then moved to ``device``."""

    def __init__(self, cfg, generator=None, device=None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.cfg = cfg
        self.embed = skip_init(nn.Embedding, cfg.vocab_size, cfg.d_model)
        with torch.no_grad():  # flax Embed: normal with variance 1/d_model
            self.embed.weight.normal_(0.0, math.sqrt(1.0 / cfg.d_model),
                                      generator=generator)
        self.blocks = nn.ModuleList(Block(cfg, generator)
                                    for _ in range(cfg.num_layers))
        self.norm = RMSNorm(cfg.d_model, cfg.dtype)
        self.lm_head = _lecun_linear(cfg.d_model, cfg.vocab_size, generator)
        if device is not None:
            self.to(device)

    def forward(self, tokens):
        cfg = self.cfg
        positions = ring.default_positions(cfg.sequence_axis, tokens.shape[0],
                                           tokens.shape[1], device=tokens.device)
        x = F.embedding(tokens, self.embed.weight).to(cfg.dtype)
        for block in self.blocks:
            x = block(x, positions)
        x = self.norm(x)
        return F.linear(x, self.lm_head.weight.to(cfg.dtype)).float()
