"""Decoder-only Transformer: the port of ``horovod_tpu/models/transformer.py``,
with its MoE blocks, its incremental-decode branch (``kv_cache=``, the
serving plane's) and the tensor- and expert-parallel layouts of
``horovod_tpu/parallel/tensor.py``.

Pre-RMSNorm blocks, rotary position embeddings, a tanh-GELU MLP (or, in
every ``moe_every``-th block, 1-based, a top-k mixture of experts,
``models/moe.py``) and fp32 logits. Parameters are fp32 and every layer
casts them to ``cfg.dtype`` at use (the flax ``dtype=`` contract), so an
optimizer updates fp32 masters. Attention runs through the flash kernels
(``ops/flash_attention.py``) or the dense path, by ``cfg.flash_attention``;
with ``cfg.sequence_axis`` the sequence is sharded over that mesh axis
and attention is ring attention (``parallel/ring.py``).

A module built with a ``parallel.tensor.Shard`` holds one shard of the
weights, cut by the JAX package's rules (``tensor.transformer_param_specs``)
over a model axis of R ranks and an expert axis of N: the query, key and
value projections and the attention output by contiguous blocks of heads
(``H / R`` a shard), the MLP's hidden dim (``d_ff / R``), the vocabulary of
``lm_head`` (``vocab / R``), and the experts (``E / N``). The JAX package
gets the collectives from GSPMD; here they are Megatron's schedule,
written once over ``parallel/axis.py``'s operators (``block_shards``,
``forward_shards``): a replicated activation enters each sharded
projection through ``copy_to`` and the row-parallel partial results leave
through ``reduce_from``, so ``forward`` returns this shard's block of the
vocabulary's logits. On axes of one rank every operator is the identity
and the computation is the unsharded one.

**Explicit positions** (``Transformer.forward(tokens, positions)``): as
in the JAX package, positions the caller gives are taken as arbitrary
(packed documents, offsets), even when they equal ``arange``, so
attention runs dense over them (the dense ring under a sequence axis) and
never through the flash kernels, which mask by contiguous positions.

**Incremental decode** (``Transformer.forward(tokens, positions=,
kv_cache=)``, ``horovod_tpu_torch/serve/``): the fed tokens at their
absolute positions attend densely over the cached context ++ themselves,
and their (post-rotary) K/V come back for the caller's paged pool. Pad
context slots carry a position past every real one, so the
absolute-position causal mask gives them scores of exactly -inf and
probabilities of exactly 0. Training's ``forward(tokens)`` is untouched by
the branch. One set of parameters serves both modes.

Parameter layouts are PyTorch's (``nn.Linear`` weights are [out, in]; the
MoE's expert weights keep flax's ``[E, d, f]``); ``convert.py`` maps them
to and from the flax tree.
"""

import dataclasses
import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import skip_init

from horovod_tpu_torch.ops import flash_attention as fa
from horovod_tpu_torch.parallel import axis as axis_lib
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
    # sparse-FFN blocks: every `moe_every`-th block (1-based; 0 = dense
    # everywhere) replaces its MLP with a top-k MoE of `num_experts`
    # experts (models/moe.py); a module built with a parallel.tensor.Shard
    # cuts the experts over the mesh axis `expert_axis`
    moe_every: int = 0
    num_experts: int = 8
    # routing fanout: 1 = Switch, 2 = GShard top-2; raise
    # moe_capacity_factor with it (top-k needs ~k slots a token)
    moe_top_k: int = 1
    moe_capacity_factor: float = 2.0
    expert_axis: str = "expert"
    # GShard grouped dispatch: the global B*S tokens split into (at most)
    # `moe_num_groups` groups, dispatch memory O(T^2/G). `moe_group_axis`
    # is the JAX layer's sharding of the group dim; the port keeps the
    # groups whole on the data rank that holds their tokens wherever they
    # divide over the data axis, whatever it names
    moe_num_groups: int = 1
    moe_group_axis: Optional[str] = None

    def use_moe(self, i):
        """Whether block ``i`` (0-based) is a MoE block."""
        return self.moe_every > 0 and (i + 1) % self.moe_every == 0


class Axes(NamedTuple):
    """The axis objects (``parallel/axis.py``) a sharded forward moves its
    shards over: the model axis (heads, d_ff, vocab), the expert axis, and
    the axis the batch is sharded over (the MoE's token groups)."""
    model: object
    expert: object
    batch: object


def single_axes(width=1):
    """Axes of one rank each, over ``width`` shards: the unsharded model."""
    one = axis_lib.single_axis(width)
    return Axes(one, one, one)


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
    """flax ``nn.RMSNorm``: statistics and scaling in fp32 (fp64 for an
    fp64 input, as flax promotes), output cast to ``dtype``."""

    def __init__(self, dim, dtype):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        var = xf.pow(2).mean(dim=-1, keepdim=True)
        return (xf * (torch.rsqrt(var + RMS_EPS) * self.weight)).to(self.dtype)


class Attention(nn.Module):
    """Self-attention over the heads this module holds (all of them, or a
    model shard's ``H / R``); with a shard, ``forward`` returns the partial
    output projection of its heads."""

    def __init__(self, cfg, generator):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        self.query = _lecun_linear(d, d, generator)
        self.key = _lecun_linear(d, d, generator)
        self.value = _lecun_linear(d, d, generator)
        self.out = _lecun_linear(d, d, generator)

    def forward(self, x, positions, contiguous_positions=False, cache=None):
        """``contiguous_positions`` says that ``positions`` are the default
        ones (``ring.default_positions``): only then may the flash kernels,
        which mask by contiguous positions, run; other positions take the
        dense path (the dense ring under a sequence axis).

        With ``cache=(ck, cv, ctx_positions)`` (the context's K/V,
        ``[B, S_ctx, H, D]``, and its absolute positions ``[B, S_ctx]``)
        the decode step: returns ``(out, (k, v))``, the fed tokens' K/V
        after the rotary embedding. Always the dense path: a decode step
        feeds one token or one prefill chunk (``fa.kernel_supported``
        routes one query out of the kernels too)."""
        cfg = self.cfg
        b, s, _ = x.shape
        h = self.query.weight.shape[0] // (cfg.d_model // cfg.num_heads)
        dt = cfg.dtype

        def proj(lin):
            return F.linear(x, lin.weight.to(dt)).view(b, s, h, -1)

        q = _rotary(proj(self.query), positions)
        k = _rotary(proj(self.key), positions)
        v = proj(self.value)
        if cache is not None:
            ck, cv, ctx_positions = cache
            out = dense_attention(
                q, torch.cat([ck.to(k.dtype), k], dim=1),
                torch.cat([cv.to(v.dtype), v], dim=1), causal=cfg.causal,
                q_positions=positions,
                kv_positions=torch.cat(
                    [ctx_positions.to(positions.dtype), positions], dim=1))
            return F.linear(out.reshape(b, s, -1), self.out.weight.to(dt)), \
                (k, v)
        use_flash = cfg.flash_attention and contiguous_positions
        if cfg.sequence_axis is not None and use_flash:
            # the kernels per rotated K/V block, merged by lse; they mask
            # by the contiguous positions the ring computes
            out = ring.ring_attention(q, k, v, cfg.sequence_axis,
                                      causal=cfg.causal, use_flash=True)
        elif cfg.sequence_axis is not None:
            out = ring.ring_attention(q, k, v, cfg.sequence_axis,
                                      causal=cfg.causal, q_positions=positions,
                                      kv_positions=positions)
        elif use_flash:
            out = fa.attention(q, k, v, causal=cfg.causal)
        else:
            out = dense_attention(q, k, v, causal=cfg.causal,
                                  q_positions=positions,
                                  kv_positions=positions)
        return F.linear(out.reshape(b, s, -1), self.out.weight.to(dt))


class Block(nn.Module):
    """One pre-norm block: attention, then the MLP, or with ``use_moe``
    the MoE layer (``moe``). ``forward`` runs ``block_shards`` on this
    module alone over the mesh axes of its ``shard``."""

    def __init__(self, cfg, generator, use_moe=False):
        super().__init__()
        self.cfg = cfg
        self.use_moe = use_moe
        self.shard = None
        self.norm1 = RMSNorm(cfg.d_model, cfg.dtype)
        self.attn = Attention(cfg, generator)
        self.norm2 = RMSNorm(cfg.d_model, cfg.dtype)
        if use_moe:
            from horovod_tpu_torch.models.moe import MoE
            self.moe = MoE(cfg.num_experts, cfg.d_model, cfg.d_ff,
                           capacity_factor=cfg.moe_capacity_factor,
                           num_groups=cfg.moe_num_groups, top_k=cfg.moe_top_k,
                           dtype=cfg.dtype, generator=generator)
        else:
            self.mlp_in = _lecun_linear(cfg.d_model, cfg.d_ff, generator)
            self.mlp_out = _lecun_linear(cfg.d_ff, cfg.d_model, generator)

    def mlp(self, y):
        dt = self.cfg.dtype
        y = F.linear(y, self.mlp_in.weight.to(dt))
        y = F.gelu(y, approximate="tanh")  # flax nn.gelu is tanh-approximate
        return F.linear(y, self.mlp_out.weight.to(dt))

    def forward(self, x, positions, contiguous_positions=False, cache=None):
        """The block at ``positions`` (see ``Attention.forward``); with
        ``cache`` the decode step of an unsharded block, which returns
        ``(out, (k, v))``."""
        if cache is None:
            return block_shards([self], [x], positions, _axes_of(self),
                                contiguous_positions)[0]
        attn, new_kv = self.attn(self.norm1(x), positions, cache=cache)
        x = x + attn
        y = self.norm2(x)
        if self.use_moe:
            from horovod_tpu_torch.models.moe import moe_shards
            axes = single_axes()
            y = moe_shards([self.moe], [y.reshape(-1, y.shape[-1])],
                           axes.expert, axes.batch)[0].reshape(y.shape)
        else:
            y = self.mlp(y)
        return x + y, new_kv


def block_shards(blocks, xs, positions, axes, contiguous_positions=False):
    """The block over shards: ``blocks`` each shard's block, ``xs`` each
    shard's residual stream (replicated over the model and expert axes),
    ``axes`` an ``Axes``, ``positions`` and ``contiguous_positions`` as in
    ``Attention.forward``. Attention and the MLP are column-parallel in
    and row-parallel out; the MoE routes every token of the shard's
    batch and runs the shard's experts."""
    ys = axes.model.copy_to([b.norm1(x) for b, x in zip(blocks, xs)])
    attn = axes.model.reduce_from([b.attn(y, positions, contiguous_positions)
                                   for b, y in zip(blocks, ys)])
    xs = [x + a for x, a in zip(xs, attn)]
    ys = [b.norm2(x) for b, x in zip(blocks, xs)]
    if blocks[0].use_moe:
        from horovod_tpu_torch.models.moe import moe_shards
        shape = ys[0].shape
        ys = moe_shards([b.moe for b in blocks],
                        [y.reshape(-1, shape[-1]) for y in ys],
                        axes.expert, axes.batch)
        ys = [y.reshape(shape) for y in ys]
    else:
        hs = axes.model.copy_to(ys)
        ys = axes.model.reduce_from([b.mlp(h) for b, h in zip(blocks, hs)])
    return [x + y for x, y in zip(xs, ys)]


class _StageShards(nn.Module):
    """One stage's shards of a block, as one module: ``forward`` runs
    ``block_shards`` on them at the given positions, or at the default
    (contiguous) ones."""

    def __init__(self, blocks, axes, positions=None):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.axes = axes
        self.positions = positions

    def forward(self, xs):
        positions = self.positions
        if positions is None:
            b, s = xs[0].shape[:2]
            positions = ring.default_positions(None, b, s,
                                               device=xs[0].device)
        return block_shards(list(self.blocks), xs, positions, self.axes,
                            self.positions is None)


def stage_block_fn(blocks, axes, positions=None):
    """``block_fn`` of ``parallel/pipeline.py`` for the transformer's
    blocks: one layer on one stage's shards. ``blocks`` holds one
    ``Block`` a shard of the stage, each with the layout of that shard
    (its cut, ``parallel.tensor.Shard``), ``axes`` the ``Axes`` over them.
    Each call runs ``block_shards`` with the layer's parameters (each
    shard's ``{name: tensor}``, the names of ``Block.named_parameters``)
    in place of the blocks' own (``torch.func.functional_call``).
    ``positions`` (``[B_micro, S]``, every microbatch's) are explicit
    positions: attention then runs dense over them, as the JAX
    ``Block`` does; None is the default contiguous ones."""
    shards = _StageShards(blocks, axes, positions)

    def block_fn(layer_params, xs):
        params = {f"blocks.{i}.{k}": v for i, p in enumerate(layer_params)
                  for k, v in p.items()}
        return torch.func.functional_call(shards, params, (xs,))
    return block_fn


def _axes_of(module):
    """The group axes of a module's shard (axes of one rank without)."""
    return single_axes() if module.shard is None else module.shard.axes()


class Transformer(nn.Module):
    """tokens [B, S] -> fp32 logits [B, S, vocab] (with a shard: this
    shard's block of the vocabulary, ``[B, S, vocab / R]``).

    With ``cfg.sequence_axis`` the tokens are this rank's block of the
    sequence, ``[B, S_local]``, and the default positions are absolute:
    this rank's offset on the axis plus the local arange
    (``ring.default_positions``), so the rotary embeddings see the
    positions the whole sequence has.

    Weights are drawn on the CPU from ``generator`` (a seeded
    ``torch.Generator``; flax's initializer distributions, not its bits),
    all of them, then cut to ``shard`` (a ``parallel.tensor.Shard``: this
    rank's coordinates on the model and expert axes) when one is given,
    and moved to ``device``: every shard of a seed is a block of the
    unsharded model of that seed."""

    def __init__(self, cfg, generator=None, device=None, shard=None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.cfg = cfg
        self.shard = None
        self.embed = skip_init(nn.Embedding, cfg.vocab_size, cfg.d_model)
        with torch.no_grad():  # flax Embed: normal with variance 1/d_model
            self.embed.weight.normal_(0.0, math.sqrt(1.0 / cfg.d_model),
                                      generator=generator)
        self.blocks = nn.ModuleList(Block(cfg, generator, cfg.use_moe(i))
                                    for i in range(cfg.num_layers))
        self.norm = RMSNorm(cfg.d_model, cfg.dtype)
        self.lm_head = _lecun_linear(cfg.d_model, cfg.vocab_size, generator)
        if shard is not None:
            from horovod_tpu_torch.parallel import tensor
            tensor.cut_transformer(self, shard)
        if device is not None:
            self.to(device)

    def forward(self, tokens, positions=None, train=True, kv_cache=None):
        """Training's forward: ``tokens`` -> fp32 logits, at the default
        positions or at the given ``positions`` ``[B, S]`` (dense
        attention over them, module docstring). ``train`` is the JAX
        signature's and changes nothing: the family has no dropout. With
        ``kv_cache`` the incremental decode step (``decode_forward``)."""
        del train
        if kv_cache is not None:
            return decode_forward(self, tokens, positions, kv_cache)
        return forward_shards([self], [tokens], _axes_of(self),
                              positions)[0]


def decode_forward(model, tokens, positions, kv_cache):
    """The incremental decode step of the JAX ``Transformer(...,
    kv_cache=)``: ``tokens`` ``[B, S_q]`` at the absolute ``positions``
    ``[B, S_q]``; ``kv_cache`` is ``(ctx_k, ctx_v, ctx_positions)``, where
    ``ctx_k[i]``/``ctx_v[i]`` is layer ``i``'s context ``[B, S_ctx, H, D]``
    (a stacked ``[L, B, S_ctx, H, D]`` tensor, or any object indexed by
    layer: the engine gathers each layer from the paged pool as the loop
    reaches it) and ``ctx_positions`` ``[B, S_ctx]`` their positions (pad
    slots past every real one). Returns ``(fp32 logits [B, S_q, vocab],
    (new_k, new_v))``, the fed tokens' K/V stacked ``[L, B, S_q, H, D]``
    for the caller's cache writes."""
    cfg = model.cfg
    if cfg.sequence_axis is not None:
        raise ValueError(
            "incremental decode composes with a paged cache, not ring "
            "attention — build the serving model with sequence_axis=None")
    if not cfg.causal:
        raise ValueError("incremental decode requires causal attention "
                         "(cfg.causal=True)")
    if positions is None:
        raise ValueError("incremental decode needs explicit absolute "
                         "positions for the fed tokens")
    if model.shard is not None:
        raise NotImplementedError("incremental decode runs the unsharded "
                                  "model")
    ctx_k, ctx_v, ctx_positions = kv_cache
    x = F.embedding(tokens, model.embed.weight).to(cfg.dtype)
    new_ks, new_vs = [], []
    for i, blk in enumerate(model.blocks):
        x, (k, v) = blk(x, positions,
                        cache=(ctx_k[i], ctx_v[i], ctx_positions))
        new_ks.append(k)
        new_vs.append(v)
    logits = F.linear(model.norm(x), model.lm_head.weight.to(cfg.dtype))
    return logits.float(), (torch.stack(new_ks), torch.stack(new_vs))


def forward_shards(models, tokens, axes, positions=None):
    """The transformer over shards: ``models`` each shard's module,
    ``tokens`` each shard's ``[B, S]`` batch, ``axes`` an ``Axes``,
    ``positions`` the batch's explicit ``[B, S]`` positions (every
    shard's; None: the default ones). Returns each shard's fp32 logits,
    its block of the vocabulary."""
    cfg = models[0].cfg
    contiguous = positions is None  # the default positions are 0..S-1
    if contiguous:
        b, s = tokens[0].shape
        positions = ring.default_positions(cfg.sequence_axis, b, s,
                                           device=tokens[0].device)
    xs = [F.embedding(t, m.embed.weight).to(cfg.dtype)
          for m, t in zip(models, tokens)]
    for i in range(cfg.num_layers):
        xs = block_shards([m.blocks[i] for m in models], xs, positions, axes,
                          contiguous)
    hs = axes.model.copy_to([m.norm(x) for m, x in zip(models, xs)])
    return [F.linear(h, m.lm_head.weight.to(cfg.dtype)).float()
            for m, h in zip(models, hs)]
