"""Partitioned datasets, samplers and device feeding — numpy copies of
``distlearn_tpu/data`` (both packages draw the same arrays from a seed),
with the device-resident dataset and the prefetch queue on the card."""

from distlearn_tpu_torch.data.dataset import (Dataset, load_npz,
                                              make_dataset,
                                              per_node_batch_size,
                                              synthetic_cifar10,
                                              synthetic_hard,
                                              synthetic_hard_cifar10,
                                              synthetic_imagenet,
                                              synthetic_mnist)
from distlearn_tpu_torch.data.device_dataset import DeviceDataset
from distlearn_tpu_torch.data.prefetch import (batch_iterator,
                                               prefetch_to_device)
from distlearn_tpu_torch.data.samplers import (LabelUniformSampler,
                                               PermutationSampler,
                                               make_sampler)

__all__ = ["Dataset", "make_dataset", "per_node_batch_size", "load_npz",
           "synthetic_cifar10", "synthetic_mnist", "synthetic_hard",
           "synthetic_hard_cifar10", "synthetic_imagenet",
           "LabelUniformSampler", "PermutationSampler", "make_sampler",
           "DeviceDataset", "batch_iterator", "prefetch_to_device"]
