"""ResNet v1.5 family: the port of ``horovod_tpu/models/resnet.py``.

The benchmark model of Horovod's headline numbers (upstream's
``examples/pytorch_synthetic_benchmark.py`` trains torchvision's
ResNet-50). v1.5: the stride of a bottleneck sits on its 3x3.

Torch's idiom, with the flax model's numbers:

* NCHW tensors; on the card they are kept in ``torch.channels_last``
  (NHWC in memory, cuDNN's fast layout). Convolutions are cuDNN's
  (``F.conv2d``), as the JAX package's are XLA's.
* fp32 parameters cast to ``dtype`` at use (bf16 by default), fp32
  logits.
* flax's ``padding="SAME"``, which is asymmetric for a stride of 2 (the
  7x7/2 stem pads (2, 3) at 224, a 3x3/2 on an even input (0, 1), the
  3x3/2 max-pool (0, 1) with -inf): ``Conv`` and ``max_pool_same`` pad
  as SAME computes it. Torch's ``padding=k // 2`` would shift the window
  by one pixel.
* flax's ``BatchNorm(momentum=0.9, epsilon=1e-5)``: normalization over the
  batch statistics in fp32, and running averages ``0.9 ra + 0.1 batch``
  of the mean and the BIASED variance (``nn.BatchNorm2d`` averages the
  unbiased one). The last BatchNorm of each block starts with scale 0.
* ``bn_cross_replica_axes``: flax's ``BatchNorm(axis_name=...)``,
  synchronized BatchNorm over those mesh axes. The batch statistics are
  flax's ``_compute_stats``: the fp32 mean and mean of squares per
  channel, averaged over the axes' group in one collective, and the
  variance ``max(0, E[x^2] - E[x]^2)``. The backward averages the
  statistics' cotangents over the group in one collective, as ``pmean``'s
  transpose does. None keeps per-rank statistics (``F.batch_norm``).

Weights are drawn on the CPU from a seeded ``torch.Generator`` with flax's
initializer distributions (not its bits) and then moved to ``device``;
``convert.py`` carries them to and from the flax trees, statistics
included.
"""

import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch.models.simple import _dense
from horovod_tpu_torch.ops import collective
from horovod_tpu_torch.ops.reduction import Average
from horovod_tpu_torch.models.transformer import lecun_normal_
from horovod_tpu_torch.parallel import gspmd


def same_pads(n, kernel, stride):
    """(before, after) padding of one spatial axis of length ``n`` under
    flax's ``padding="SAME"``: ``ceil(n / stride)`` outputs, the odd pixel
    of the padding after."""
    out = -(-n // stride)
    total = max((out - 1) * stride + kernel - n, 0)
    return total // 2, total - total // 2


def _pad_same(x, kernel, stride, value=0.0):
    """``x`` padded as SAME needs it, and the symmetric padding left for
    the op itself: ``(x, (pad_h, pad_w))``."""
    (t, b), (l, r) = (same_pads(x.shape[2], kernel, stride),
                      same_pads(x.shape[3], kernel, stride))
    if t == b and l == r:
        return x, (t, l)
    return F.pad(x, (l, r, t, b), value=value), (0, 0)


def _on_card_layout(x):
    return x.contiguous(memory_format=torch.channels_last) if x.is_cuda \
        else x


class Conv(nn.Module):
    """flax ``nn.Conv(features, (k, k), strides, padding="SAME")``: a
    lecun-normal kernel, optional zero bias, computed at the input's
    dtype."""

    def __init__(self, in_channels, out_channels, kernel, stride=1,
                 bias=False, generator=None):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels,
                                               kernel, kernel))
        lecun_normal_(self.weight, in_channels * kernel * kernel, generator)
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None

    def forward(self, x):
        w = self.weight.to(x.dtype)
        if x.is_cuda:
            w = w.contiguous(memory_format=torch.channels_last)
        b = None if self.bias is None else self.bias.to(x.dtype)
        x, pad = _pad_same(x, self.weight.shape[-1], self.stride)
        return F.conv2d(x, w, b, self.stride, pad)


# the profiler range of synchronized BatchNorm's forward and backward
SYNC_BN_RANGE = "horovod_tpu_torch.sync_batch_norm"


def _channel(t, x):
    """A per-channel ``[C]`` tensor shaped to broadcast against ``x``."""
    return t.view((1, -1) + (1,) * (x.dim() - 2))


class _SyncBatchNorm(torch.autograd.Function):
    """flax's synchronized BatchNorm over the group of ``axes``: ``(y,
    mean, var)``, the output at ``x``'s dtype and the averaged fp32
    statistics. One allreduce each way: the stacked ``[2, C]`` local
    means of x and x^2 forward, their cotangents backward (an average,
    the transpose of ``pmean``). ``x`` is saved at its own dtype and
    read again in fp32 by the backward. Both directions run under the
    profiler range ``SYNC_BN_RANGE``, so a trace can attribute their
    kernels."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, axes):
        with torch.profiler.record_function(SYNC_BN_RANGE):
            return _SyncBatchNorm._forward(ctx, x, weight, bias, eps, axes)

    @staticmethod
    def _forward(ctx, x, weight, bias, eps, axes):
        dims = [0] + list(range(2, x.dim()))
        xf = x.float()
        stats = torch.stack([xf.mean(dims), (xf * xf).mean(dims)])
        collective.allreduce_(stats, op=Average, axes=axes)
        mean, meansq = stats[0], stats[1]
        spread = meansq - mean * mean
        var = torch.clamp_min(spread, 0.0)
        invstd = torch.rsqrt(var + eps)
        y = ((xf - _channel(mean, x)) * _channel(invstd * weight, x)
             + _channel(bias, x)).to(x.dtype)
        ctx.axes = axes
        ctx.save_for_backward(x, weight, mean, invstd, spread > 0)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        with torch.profiler.record_function(SYNC_BN_RANGE):
            return _SyncBatchNorm._backward(ctx, gy)

    @staticmethod
    def _backward(ctx, gy):
        x, weight, mean, invstd, positive = ctx.saved_tensors
        dims = [0] + list(range(2, x.dim()))
        xf, g = x.float(), gy.float()
        centered = xf - _channel(mean, x)
        sum_g = g.sum(dims)
        sum_gc = (g * centered).sum(dims)
        # y = (x - mean) * r * w + b, r = rsqrt(max(0, E[x^2] - mean^2)
        # + eps): the cotangents of the local E[x] and E[x^2], averaged
        ct_var = torch.where(positive, -0.5 * weight * sum_gc * invstd ** 3,
                             0.0)
        cts = torch.stack([-invstd * weight * sum_g - 2.0 * mean * ct_var,
                           ct_var])
        collective.allreduce_(cts, op=Average, axes=ctx.axes)
        m = x.numel() // x.shape[1]
        dx = (g * _channel(invstd * weight, x) + _channel(cts[0] / m, x)
              + xf * _channel(2.0 * cts[1] / m, x))
        return dx.to(x.dtype), sum_gc * invstd, sum_g, None, None


class BatchNorm(nn.BatchNorm2d):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over NCHW: in
    training, normalization by the batch's mean and biased variance
    (computed in fp32, the output at the input's dtype), and the running
    averages updated in place with the biased variance. ``momentum`` is
    torch's (the weight of the new batch): 0.1. In evaluation mode the
    running averages normalize. ``cross_replica_axes`` (None: per rank)
    synchronizes the batch statistics over those mesh axes
    (``_SyncBatchNorm``). A batch-sharded DTensor input (the GSPMD step's)
    is normalized over the global batch whatever ``cross_replica_axes``
    says: ``_SyncBatchNorm`` over the axes it is sharded over, as an
    island (``parallel.gspmd.sync_batch_norm``)."""

    def __init__(self, num_features, zero_scale=False,
                 cross_replica_axes=None):
        super().__init__(num_features, eps=1e-5, momentum=0.1)
        self.cross_replica_axes = cross_replica_axes
        if zero_scale:
            nn.init.zeros_(self.weight)

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        sharded = gspmd.is_dtensor(x)
        if sharded or self.cross_replica_axes is not None:
            if sharded:
                y, mean, var = gspmd.sync_batch_norm(x, self.weight,
                                                     self.bias, self.eps)
            else:
                y, mean, var = _SyncBatchNorm.apply(
                    x, self.weight, self.bias, self.eps,
                    self.cross_replica_axes)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
                self.running_var.mul_(1.0 - m).add_(var, alpha=m)
                self.num_batches_tracked.add_(1)
            return y
        # one fused call normalizes and, at momentum 1, leaves the batch
        # mean and the unbiased variance in its two scratch buffers
        mean = torch.zeros_like(self.running_mean)
        var = torch.ones_like(self.running_var)
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True, 1.0,
                         self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():  # autograd keeps the scratch buffers
            biased = var * ((n - 1) / n) if n > 1 else torch.zeros_like(var)
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            self.running_var.mul_(1.0 - m).add_(biased, alpha=m)
            self.num_batches_tracked.add_(1)
        return y


def max_pool_same(x, kernel=3, stride=2):
    """flax ``nn.max_pool(x, (k, k), (s, s), padding="SAME")``: padding
    with -inf."""
    x, pad = _pad_same(x, kernel, stride, value=float("-inf"))
    return F.max_pool2d(x, kernel, stride, pad)


class _Block(nn.Module):
    """A residual block: ``relu(x + residual_branch(x))``, with ``x``
    projected by a strided 1x1 convolution and BatchNorm where the branch
    changes its shape (flax's ``conv_proj`` and ``norm_proj``)."""

    expansion = 1

    def _project(self, in_channels, out, stride, generator):
        self.proj_conv = self.proj_bn = None
        if in_channels != out or stride != 1:
            self.proj_conv = Conv(in_channels, out, 1, stride,
                                  generator=generator)
            self.proj_bn = BatchNorm(out)

    def forward(self, x):
        y = self.residual_branch(x)
        if self.proj_conv is not None:
            x = self.proj_bn(self.proj_conv(x))
        return F.relu(x + y)


class BasicBlock(_Block):
    """3x3 + 3x3 residual block (ResNet-18/34)."""

    def __init__(self, in_channels, filters, stride=1, generator=None):
        super().__init__()
        self.conv1 = Conv(in_channels, filters, 3, stride, generator=generator)
        self.bn1 = BatchNorm(filters)
        self.conv2 = Conv(filters, filters, 3, generator=generator)
        self.bn2 = BatchNorm(filters, zero_scale=True)
        self._project(in_channels, filters, stride, generator)

    def residual_branch(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        return self.bn2(self.conv2(y))


class BottleneckBlock(_Block):
    """1x1 -> 3x3 (stride) -> 1x1 bottleneck (ResNet-50/101/152, v1.5)."""

    expansion = 4

    def __init__(self, in_channels, filters, stride=1, generator=None):
        super().__init__()
        out = filters * self.expansion
        self.conv1 = Conv(in_channels, filters, 1, generator=generator)
        self.bn1 = BatchNorm(filters)
        self.conv2 = Conv(filters, filters, 3, stride, generator=generator)
        self.bn2 = BatchNorm(filters)
        self.conv3 = Conv(filters, out, 1, generator=generator)
        self.bn3 = BatchNorm(out, zero_scale=True)
        self._project(in_channels, out, stride, generator)

    def residual_branch(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        return self.bn3(self.conv3(y))


class ResNet(nn.Module):
    """ResNet v1.5 over NCHW images: a 7x7/2 stem, BatchNorm, ReLU, a 3x3/2
    max-pool, the stages of ``block_cls`` (stage ``i`` at
    ``num_filters * 2**i`` filters, its first block strided from stage 1
    on), the mean over H and W, and ``head``. ``bn_cross_replica_axes``
    (a mesh axis name or a tuple of them) synchronizes every BatchNorm
    over those axes, as flax's ``BatchNorm(axis_name=...)``; None keeps
    per-rank statistics."""

    def __init__(self, stage_sizes, block_cls, num_classes=1000,
                 num_filters=64, dtype=torch.bfloat16, generator=None,
                 device=None, bn_cross_replica_axes=None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.stage_sizes = tuple(stage_sizes)
        self.block_cls = block_cls
        self.dtype = dtype
        self.conv_init = Conv(3, num_filters, 7, 2, generator=generator)
        self.bn_init = BatchNorm(num_filters)
        blocks, channels = [], num_filters
        for i, count in enumerate(self.stage_sizes):
            for j in range(count):
                stride = 2 if i > 0 and j == 0 else 1
                blocks.append(block_cls(channels, num_filters * 2 ** i,
                                        stride, generator=generator))
                channels = num_filters * 2 ** i * block_cls.expansion
        self.blocks = nn.Sequential(*blocks)
        self.head = _dense(channels, num_classes, generator)
        self.bn_cross_replica_axes = bn_cross_replica_axes
        for m in self.modules():
            if isinstance(m, BatchNorm):
                m.cross_replica_axes = bn_cross_replica_axes
        if device is not None:
            self.to(device)

    def forward(self, x):
        x = _on_card_layout(x.to(self.dtype))
        x = F.relu(self.bn_init(self.conv_init(x)))
        x = self.blocks(max_pool_same(x))
        x = x.mean(dim=(2, 3))
        x = F.linear(x, self.head.weight.to(self.dtype),
                     self.head.bias.to(self.dtype))
        return x.float()


def ResNet18(**kw):
    return ResNet((2, 2, 2, 2), BasicBlock, **kw)


def ResNet34(**kw):
    return ResNet((3, 4, 6, 3), BasicBlock, **kw)


def ResNet50(**kw):
    return ResNet((3, 4, 6, 3), BottleneckBlock, **kw)


def ResNet101(**kw):
    return ResNet((3, 4, 23, 3), BottleneckBlock, **kw)


def ResNet152(**kw):
    return ResNet((3, 8, 36, 3), BottleneckBlock, **kw)
