"""VGG-16: the port of ``horovod_tpu/models/vgg.py``.

The bandwidth-bound member of Horovod's benchmark trio: 138 M parameters,
most of them in the first fully connected layer, stress the gradient
exchange. 3x3 SAME convolutions with bias and ReLU, 2x2/2 max-pools, then
three fully connected layers with dropout between them. NCHW tensors,
``torch.channels_last`` on the card, fp32 parameters cast to ``dtype``
at use, fp32 logits.

The flax model flattens its NHWC activations as (h, w, c); this one
flattens in the same order (a view in ``channels_last``), so the first
fully connected layer's weight is the flax kernel transposed, with no
permutation of its rows.
"""

import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch.models.resnet import Conv, _on_card_layout
from horovod_tpu_torch.models.simple import _dense, dropout

# channels per conv stage; "M" marks a max-pool (the VGG-16 "D" config)
VGG16_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
             512, 512, 512, "M", 512, 512, 512, "M")


class VGG16(nn.Module):
    """VGG-16 (or a narrower ``cfg``) on ``image_size``-square images:
    the first fully connected layer's width follows from it, as the flax
    model's follows from its first input.

    In training mode dropout draws its masks from the caller's
    ``dropout_generator`` (``training.make_train_step`` passes one per
    step, rank and microbatch), or torch's default generator."""

    def __init__(self, num_classes=1000, dtype=torch.bfloat16,
                 cfg=VGG16_CFG, image_size=224, generator=None, device=None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.dtype = dtype
        self.cfg = tuple(cfg)
        convs, channels, size = [], 3, image_size
        for v in self.cfg:
            if v == "M":
                size //= 2
            else:
                convs.append(Conv(channels, v, 3, bias=True,
                                  generator=generator))
                channels = v
        self.convs = nn.ModuleList(convs)
        self.fc0 = _dense(size * size * channels, 4096, generator)
        self.fc1 = _dense(4096, 4096, generator)
        self.fc2 = _dense(4096, num_classes, generator)
        if device is not None:
            self.to(device)

    def _fc(self, layer, x):
        return F.linear(x, layer.weight.to(self.dtype),
                        layer.bias.to(self.dtype))

    def forward(self, x, dropout_generator=None):
        x = _on_card_layout(x.to(self.dtype))
        convs = iter(self.convs)
        for v in self.cfg:
            if v == "M":
                x = F.max_pool2d(x, 2, 2)
            else:
                x = F.relu(next(convs)(x))
        # flatten in NHWC order, as the flax model does
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        for layer in (self.fc0, self.fc1):
            x = F.relu(self._fc(layer, x))
            if self.training:
                x = dropout(x, 0.5, dropout_generator)
        return self._fc(self.fc2, x).float()
