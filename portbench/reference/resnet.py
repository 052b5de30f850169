"""ResNet v1.5 (He et al. 2016, arXiv:1512.03385; v1.5 as MLPerf Training's
image classification: the stride of a downsampling bottleneck on its 3x3
convolution), written from its equations in plain PyTorch, float32.

* Stem: 7x7 convolution, stride 2, pad 3, no bias; batchnorm; ReLU; 3x3
  max pool, stride 2, pad 1.
* Stages of bottlenecks, widths 64-128-256-512, expansion 4: 1x1, 3x3
  (stride 2 in the first block of stages 2-4), 1x1 convolutions without
  bias, each followed by batchnorm, ReLU after the first two and after the
  sum; the first block of each stage projects its input (1x1 convolution
  with the block's stride, batchnorm).
* Global average pool, a dense layer to the classes, softmax cross-entropy.
* Batchnorm: the configuration's ``eps`` and ``momentum``; running
  variance from the batch's biased variance.

Parameter names and layouts (convolutions ``[out, in, kh, kw]``, the dense
layer ``[out, in]``) are the ones the configuration states, so one set of
weights, made from the seed, serves the program and this model.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference.common import (activation, batchnorm, nll, product,
                                        set_path)


def _blocks(cfg: dict):
    """``(name, in_ch, width, stride, first)`` of every bottleneck."""
    in_ch = cfg["stem_width"]
    for si, (n, width) in enumerate(zip(cfg["blocks_per_stage"],
                                        cfg["widths"])):
        for bi in range(n):
            yield (f"stage{si + 1}_block{bi + 1}", in_ch, width,
                   2 if (bi == 0 and si > 0) else 1, bi == 0)
            in_ch = width * cfg["expansion"]


def _conv_spec(path, cin, cout, k):
    return (path + ("w",), (cout, cin, k, k), 0.0,
            math.sqrt(2.0 / (cout * k * k)))


def _bn_specs(path, ch):
    return [(path + ("bias",), (ch,), 0.0, 0.1),
            (path + ("scale",), (ch,), 1.0, 0.1)]


def param_specs(cfg: dict) -> list:
    """Every parameter: He-normal convolutions (fan-out), batchnorm scales
    about 1 and biases about 0, the dense layer at ``1/sqrt(fan_in)``."""
    stem = cfg["stem_width"]
    specs = [_conv_spec(("conv_stem",), cfg["in_channels"], stem, 7),
             *_bn_specs(("bn_stem",), stem)]
    for name, cin, width, _, first in _blocks(cfg):
        out = width * cfg["expansion"]
        specs += [_conv_spec((name, "conv1"), cin, width, 1),
                  *_bn_specs((name, "bn1"), width),
                  _conv_spec((name, "conv2"), width, width, 3),
                  *_bn_specs((name, "bn2"), width),
                  _conv_spec((name, "conv3"), width, out, 1),
                  *_bn_specs((name, "bn3"), out)]
        if first or cin != out:
            specs += [_conv_spec((name, "conv_proj"), cin, out, 1),
                      *_bn_specs((name, "bn_proj"), out)]
    feat = cfg["widths"][-1] * cfg["expansion"]
    std = 1.0 / math.sqrt(feat)
    specs += [(("fc", "b"), (cfg["num_classes"],), 0.0, std),
              (("fc", "w"), (cfg["num_classes"], feat), 0.0, std)]
    return specs


def state_init(cfg: dict, device) -> dict:
    """Running mean 0 and variance 1 for every batchnorm."""
    state = {}
    for path, shape, _, _ in param_specs(cfg):
        if path[-1] == "scale":
            set_path(state, path[:-1] + ("mean",),
                     torch.zeros(shape, device=device))
            set_path(state, path[:-1] + ("var",),
                     torch.ones(shape, device=device))
    return state


def loss(cfg: dict, params: dict, state: dict, x, y, gen=None,
         precision: str = "float32", terms: dict | None = None):
    """Mean cross-entropy of a training forward on NHWC images ``x``;
    returns ``(loss, new_state)``.  ``gen`` is unused (no dropout);
    ``terms`` goes to every batchnorm (:func:`~portbench.reference.common.
    batchnorm`)."""
    eps, mom = cfg["bn_eps"], cfg["bn_momentum"]
    new = {}

    def conv(p, h, stride=1, pad=0):
        return product(F.conv2d, h, p["w"], precision, stride=stride,
                       padding=pad)

    def bn(p, s, h):
        y, st = batchnorm(p, s, h, eps, mom, terms)
        return activation(y, precision), st

    h = x.permute(0, 3, 1, 2)
    h = conv(params["conv_stem"], h, 2, 3)
    h, new["bn_stem"] = bn(params["bn_stem"], state["bn_stem"], h)
    h = F.max_pool2d(F.relu(h), 3, 2, 1)
    for name, _, _, stride, _ in _blocks(cfg):
        p, s, ns = params[name], state[name], {}
        r, ns["bn1"] = bn(p["bn1"], s["bn1"], conv(p["conv1"], h))
        r, ns["bn2"] = bn(p["bn2"], s["bn2"],
                          conv(p["conv2"], F.relu(r), stride, 1))
        r, ns["bn3"] = bn(p["bn3"], s["bn3"], conv(p["conv3"], F.relu(r)))
        if "conv_proj" in p:
            sc, ns["bn_proj"] = bn(p["bn_proj"], s["bn_proj"],
                                   conv(p["conv_proj"], h, stride))
        else:
            sc = h
        h = activation(F.relu(r + sc), precision)
        new[name] = ns
    feat = activation(h.mean(dim=(2, 3)), precision)
    logits = product(F.linear, feat, params["fc"]["w"], precision) \
        + params["fc"]["b"]
    return nll(activation(logits, precision), y), new
