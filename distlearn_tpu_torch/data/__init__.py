"""Partitioned in-memory datasets and batch samplers (numpy), copied from
``distlearn_tpu/data`` so both packages draw the same arrays from a seed."""

from distlearn_tpu_torch.data.dataset import (Dataset, make_dataset,
                                              per_node_batch_size,
                                              synthetic_cifar10,
                                              synthetic_mnist)
from distlearn_tpu_torch.data.samplers import (LabelUniformSampler,
                                               PermutationSampler,
                                               make_sampler)

__all__ = ["Dataset", "make_dataset", "per_node_batch_size",
           "synthetic_cifar10", "synthetic_mnist", "LabelUniformSampler",
           "PermutationSampler", "make_sampler"]
