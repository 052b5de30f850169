"""CIFAR-10 convnet — counterpart of ``distlearn_tpu/models/cifar_convnet.py``
(the reference's VGG-ish net, examples/Model.lua:19-45):

    4 x [ conv5x5 pad2 (3->64->128->256->512) -> batchnorm(eps=1e-3) -> ReLU
          -> maxpool2x2 ]
    -> flatten(2*2*512) -> dropout(0.5) -> linear(2048->10) -> logSoftMax

4,328,970 parameters.  Input NHWC ``[N, 32, 32, 3]``; the flatten before the
linear layer takes (h, w, c) order, as the JAX model's NHWC reshape does, so
JAX weights load unchanged apart from their layout.
"""

from __future__ import annotations

import torch

from distlearn_tpu_torch.models import nn
from distlearn_tpu_torch.models.core import Model
from distlearn_tpu_torch.utils.platform import resolve_device

_CHANNELS = (64, 128, 256, 512)


def cifar_convnet(dtype=torch.float32, dropout_rate: float = 0.5) -> Model:
    def init(seed: int = 0, device=None):
        device = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        params, state = {}, {}
        in_ch = 3
        for i, ch in enumerate(_CHANNELS):
            params[f"conv{i + 1}"] = nn.conv2d_init(gen, in_ch, ch, 5, 5, dtype)
            params[f"bn{i + 1}"], state[f"bn{i + 1}"] = nn.batchnorm_init(
                ch, dtype)
            in_ch = ch
        params["linear"] = nn.dense_init(gen, 512 * 2 * 2, 10, dtype)
        move = lambda t: {k: {n: v.to(device) for n, v in d.items()}
                          for k, d in t.items()}
        return move(params), move(state)

    def apply(params, state, x, train=True, rng=None, tree=None,
              bn_weight=None):
        h = x.to(dtype).permute(0, 3, 1, 2)   # NHWC -> NCHW, channels-last memory
        new_state = {}
        for i in range(1, len(_CHANNELS) + 1):
            h = nn.conv2d(params[f"conv{i}"], h, padding=2)
            h, new_state[f"bn{i}"] = nn.batchnorm(
                params[f"bn{i}"], state[f"bn{i}"], h, train=train, eps=1e-3,
                tree=tree, weight=bn_weight)
            h = nn.max_pool2d(torch.relu(h))
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)   # (h, w, c) order
        if train and rng is not None and dropout_rate > 0:
            h = nn.dropout(rng, h, dropout_rate, train=True)
        logits = nn.dense(params["linear"], h)
        return nn.log_softmax(logits.to(dtype)), new_state

    return Model(init=init, apply=apply, name="cifar_convnet",
                 input_shape=(32, 32, 3), num_classes=10)
