"""models of the PyTorch/CUDA port: the transformer LM
(``transformer``) and its mixture-of-experts layer (``moe``), the MLP and
MNIST ConvNet (``simple``), the ResNet v1.5 family (``resnet``) and
VGG-16 (``vgg``)."""

from horovod_tpu_torch.models.moe import (MoE, aux_loss, expert_major_spec,
                                          moe_param_specs, shard_moe_params)
from horovod_tpu_torch.models.resnet import (ResNet, ResNet18, ResNet34,
                                             ResNet50, ResNet101, ResNet152)
from horovod_tpu_torch.models.simple import MLP, MNISTConvNet
from horovod_tpu_torch.models.transformer import Transformer, TransformerConfig
from horovod_tpu_torch.models.vgg import VGG16

__all__ = ["MoE", "aux_loss", "expert_major_spec", "moe_param_specs",
           "shard_moe_params", "ResNet", "ResNet18", "ResNet34", "ResNet50", "ResNet101",
           "ResNet152", "MLP", "MNISTConvNet", "Transformer",
           "TransformerConfig", "VGG16"]
