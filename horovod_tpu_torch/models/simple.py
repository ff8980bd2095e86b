"""Small example models: the port of ``horovod_tpu/models/simple.py``.

``MLP`` and ``MNISTConvNet`` take the same inputs as the flax models
(``MNISTConvNet`` reads NHWC images) and keep fp32 parameters cast to
``dtype`` at use, as flax's ``dtype=`` does. ``convert.py`` carries their
weights to and from the flax trees. Weights are drawn on the CPU from a
seeded ``torch.Generator`` with flax's initializer distributions (not
its bits) and then moved to ``device``.
"""

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import skip_init

from horovod_tpu_torch.models.transformer import lecun_normal_


def _dense(in_features, out_features, generator):
    """flax ``nn.Dense``: lecun-normal kernel, zero bias."""
    lin = skip_init(nn.Linear, in_features, out_features)
    lecun_normal_(lin.weight, in_features, generator)
    nn.init.zeros_(lin.bias)
    return lin


def _conv(in_channels, out_channels, generator):
    """flax ``nn.Conv(out, (3, 3))``: SAME padding, lecun-normal kernel,
    zero bias."""
    conv = skip_init(nn.Conv2d, in_channels, out_channels, 3, padding=1)
    lecun_normal_(conv.weight, 9 * in_channels, generator)
    nn.init.zeros_(conv.bias)
    return conv


def _apply(layer, x, dtype):
    w, b = layer.weight.to(dtype), layer.bias.to(dtype)
    if isinstance(layer, nn.Conv2d):
        return F.conv2d(x, w, b, padding=layer.padding)
    return F.linear(x, w, b)


class MLP(nn.Module):
    """Plain MLP: Dense layers of ``features`` widths with ReLU between
    them, on inputs flattened to ``[N, in_features]``."""

    def __init__(self, in_features, features=(128, 128, 10),
                 dtype=torch.float32, generator=None, device=None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.dtype = dtype
        widths = (in_features,) + tuple(features)
        self.layers = nn.ModuleList(_dense(a, b, generator)
                                    for a, b in zip(widths, widths[1:]))
        if device is not None:
            self.to(device)

    def forward(self, x):
        x = x.to(self.dtype).reshape(x.shape[0], -1)
        for i, layer in enumerate(self.layers):
            x = _apply(layer, x, self.dtype)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x.float()


class MNISTConvNet(nn.Module):
    """conv(32) -> pool -> conv(64) -> pool -> fc(128) -> dropout(0.5) ->
    fc(``num_classes``) on NHWC images of ``image_shape`` (H, W, C).

    In training mode (``model.train()``) dropout draws its masks from the
    caller's ``dropout_generator``, or torch's default generator when it
    is None. ``training.make_train_step`` passes one seeded from its
    ``dropout_seed``, the step, the rank and the microbatch, as the JAX
    step folds them into its key. The masks cannot equal the JAX model's,
    which come from threefry keys; the two agree in evaluation mode."""

    def __init__(self, num_classes=10, image_shape=(28, 28, 1),
                 dtype=torch.float32, generator=None, device=None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.dtype = dtype
        h, w, c = image_shape
        self.conv0 = _conv(c, 32, generator)
        self.conv1 = _conv(32, 64, generator)
        self.fc0 = _dense((h // 4) * (w // 4) * 64, 128, generator)
        self.fc1 = _dense(128, num_classes, generator)
        if device is not None:
            self.to(device)

    def forward(self, x, dropout_generator=None):
        dt = self.dtype
        x = x.to(dt).permute(0, 3, 1, 2)  # NHWC -> NCHW
        x = F.max_pool2d(F.relu(_apply(self.conv0, x, dt)), 2, 2)
        x = F.max_pool2d(F.relu(_apply(self.conv1, x, dt)), 2, 2)
        # flatten in NHWC order, as the flax model does
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = F.relu(_apply(self.fc0, x, dt))
        if self.training:
            x = dropout(x, 0.5, dropout_generator)
        return _apply(self.fc1, x, dt).float()


def dropout(x, rate, generator=None):
    """Zero each element with probability ``rate`` (uniforms drawn from
    ``generator``) and scale the rest by ``1 / (1 - rate)``."""
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))
