"""MNIST CNN — counterpart of ``distlearn_tpu/models/mnist_cnn.py``
(examples/mnist.lua:53-81):

    conv5x5(1->16) -> tanh -> maxpool2x2 -> conv5x5(16->16) -> tanh
    -> maxpool2x2 -> flatten(5*5*16) -> linear(400->10) -> logSoftMax

Input NHWC ``[N, 32, 32, 1]``; no batchnorm, so the state is empty.
"""

from __future__ import annotations

import torch

from distlearn_tpu_torch.models import nn
from distlearn_tpu_torch.models.core import Model
from distlearn_tpu_torch.utils.platform import resolve_device


def mnist_cnn(dtype=torch.float32) -> Model:
    def init(seed: int = 0, device=None):
        device = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        params = {"conv1": nn.conv2d_init(gen, 1, 16, 5, 5, dtype),
                  "conv2": nn.conv2d_init(gen, 16, 16, 5, 5, dtype),
                  "linear": nn.dense_init(gen, 16 * 5 * 5, 10, dtype)}
        return {k: {n: v.to(device) for n, v in d.items()}
                for k, d in params.items()}, {}

    def apply(params, state, x, train=True, rng=None, tree=None,
              bn_weight=None):
        h = x.to(dtype).permute(0, 3, 1, 2)
        h = nn.max_pool2d(torch.tanh(nn.conv2d(params["conv1"], h)))
        h = nn.max_pool2d(torch.tanh(nn.conv2d(params["conv2"], h)))
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
        logits = nn.dense(params["linear"], h)
        return nn.log_softmax(logits.to(dtype)), state

    return Model(init=init, apply=apply, name="mnist_cnn",
                 input_shape=(32, 32, 1), num_classes=10)
