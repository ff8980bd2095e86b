"""models of the PyTorch/CUDA port: the transformer LM
(``transformer``), the MLP and MNIST ConvNet (``simple``), the ResNet v1.5
family (``resnet``) and VGG-16 (``vgg``)."""

from horovod_tpu_torch.models.resnet import (ResNet, ResNet18, ResNet34,
                                             ResNet50, ResNet101, ResNet152)
from horovod_tpu_torch.models.simple import MLP, MNISTConvNet
from horovod_tpu_torch.models.transformer import Transformer, TransformerConfig
from horovod_tpu_torch.models.vgg import VGG16

__all__ = ["ResNet", "ResNet18", "ResNet34", "ResNet50", "ResNet101",
           "ResNet152", "MLP", "MNISTConvNet", "Transformer",
           "TransformerConfig", "VGG16"]
