"""Convnets of the main path: functional layers over dicts of tensors."""

from distlearn_tpu_torch.models.cifar_convnet import cifar_convnet
from distlearn_tpu_torch.models.core import Model, loss_fn, param_count
from distlearn_tpu_torch.models.mnist_cnn import mnist_cnn

__all__ = ["Model", "loss_fn", "param_count", "cifar_convnet", "mnist_cnn"]
