"""The models: the convnets of the main path and ResNet v1.5, functional
layers over dicts of tensors."""

from distlearn_tpu_torch.models.cifar_convnet import cifar_convnet
from distlearn_tpu_torch.models.core import Model, loss_fn, param_count
from distlearn_tpu_torch.models.mnist_cnn import mnist_cnn
from distlearn_tpu_torch.models.resnet import resnet, resnet50

__all__ = ["Model", "loss_fn", "param_count", "cifar_convnet", "mnist_cnn",
           "resnet", "resnet50"]
