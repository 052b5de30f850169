"""ResNet v1.5 — counterpart of ``distlearn_tpu/models/resnet.py`` (the
ImageNet-scale model of the JAX package; the reference's largest is the
CIFAR convnet, examples/Model.lua:19-45).

* v1.5: the stride of a downsampling bottleneck sits on its 3x3 conv.
* The stem: a 7x7 conv with stride 2 and pad 3, then a 3x3 max pool with
  stride 2 and pad 1 (-inf pads).
* Kaiming-normal conv init (fan-out), each block's last batchnorm scale
  zero-initialised (torchvision's ``zero_init_residual``).
* Batchnorm with eps 1e-5 and momentum 0.1, sync statistics over ``tree``
  weighted by ``bn_weight``; ``norm="none"`` is the SkipInit variant (De &
  Smith 2020): biased convs, no batchnorm, and a scalar ``alpha`` leaf per
  block, zero-initialised, scaling the residual branch.
* Global average pool, the fc layer, ``log_softmax`` in the param dtype.

``resnet50()`` has 25,557,032 parameters in 161 leaves, the JAX model's
leaves in the same sorted-key order, so
:func:`~distlearn_tpu_torch.ops.flatten.make_bucket_spec` cuts the same
buckets and :func:`~distlearn_tpu_torch.models.convert.from_jax` carries
the JAX weights.  Input NHWC ``[N, S, S, 3]``; the activations are NCHW in
shape and channels-last in memory (the permuted NHWC input), so
``compute_dtype=torch.bfloat16`` on the card runs cuDNN's NHWC
tensor-core convolutions.
"""

from __future__ import annotations

import torch

from distlearn_tpu_torch.models import nn
from distlearn_tpu_torch.models.core import Model
from distlearn_tpu_torch.utils.platform import resolve_device
from distlearn_tpu_torch.utils.tree import tree_map

# depth -> blocks per stage; bottleneck expansion 4
_DEPTHS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}
_WIDTHS = (64, 128, 256, 512)
_EXPANSION = 4


def _bottleneck_init(gen, in_ch: int, width: int, dtype, downsample: bool,
                     norm: str):
    out_ch = width * _EXPANSION
    use_bn = norm == "batch"
    p, s = {}, {}

    def conv(cin, cout, k):
        return nn.conv2d_init(gen, cin, cout, k, k, dtype, bias=not use_bn,
                              init="he")
    p["conv1"] = conv(in_ch, width, 1)
    p["conv2"] = conv(width, width, 3)
    p["conv3"] = conv(width, out_ch, 1)
    if use_bn:
        p["bn1"], s["bn1"] = nn.batchnorm_init(width, dtype)
        p["bn2"], s["bn2"] = nn.batchnorm_init(width, dtype)
        p["bn3"], s["bn3"] = nn.batchnorm_init(out_ch, dtype)
        # each block starts as the identity
        p["bn3"]["scale"] = torch.zeros_like(p["bn3"]["scale"])
    else:
        p["alpha"] = torch.zeros((), dtype=dtype)
    if downsample or in_ch != out_ch:
        p["conv_proj"] = conv(in_ch, out_ch, 1)
        if use_bn:
            p["bn_proj"], s["bn_proj"] = nn.batchnorm_init(out_ch, dtype)
    return p, s


def _bottleneck_apply(p, s, x, stride, train, tree, bn_weight,
                      compute_dtype):
    ns = {}

    def bn(name, h):
        y, ns[name] = nn.batchnorm(p[name], s[name], h, train=train,
                                   eps=1e-5, momentum=0.1, tree=tree,
                                   weight=bn_weight)
        return y

    norm_free = "alpha" in p
    h = nn.conv2d(p["conv1"], x, compute_dtype=compute_dtype)
    h = torch.relu(h if norm_free else bn("bn1", h))
    h = nn.conv2d(p["conv2"], h, padding=1, stride=stride,
                  compute_dtype=compute_dtype)
    h = torch.relu(h if norm_free else bn("bn2", h))
    h = nn.conv2d(p["conv3"], h, compute_dtype=compute_dtype)
    if not norm_free:
        h = bn("bn3", h)
    if "conv_proj" in p:
        sc = nn.conv2d(p["conv_proj"], x, stride=stride,
                       compute_dtype=compute_dtype)
        if not norm_free:
            sc = bn("bn_proj", sc)
    else:
        sc = x.to(h.dtype)
    if norm_free:
        h = h * p["alpha"].to(h.dtype)
    return torch.relu(h + sc), ns


def resnet(depth: int = 50, num_classes: int = 1000, dtype=torch.float32,
           compute_dtype=None, image_size: int = 224,
           norm: str = "batch") -> Model:
    """``resnet(50)`` is ResNet-50 v1.5; ``norm="none"`` the norm-free
    SkipInit variant (no batch statistics, no cross-node stats sync)."""
    if depth not in _DEPTHS:
        raise ValueError(f"depth must be one of {sorted(_DEPTHS)}")
    if norm not in ("batch", "none"):
        raise ValueError(f"norm must be 'batch' or 'none', got {norm!r}")
    blocks = _DEPTHS[depth]
    use_bn = norm == "batch"

    def init(seed: int = 0, device=None):
        device = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        params, state = {}, {}
        params["conv_stem"] = nn.conv2d_init(gen, 3, 64, 7, 7, dtype,
                                             bias=not use_bn, init="he")
        if use_bn:
            params["bn_stem"], state["bn_stem"] = nn.batchnorm_init(64,
                                                                    dtype)
        in_ch = 64
        for si, (width, n_blocks) in enumerate(zip(_WIDTHS, blocks)):
            for bi in range(n_blocks):
                name = f"stage{si + 1}_block{bi + 1}"
                params[name], state[name] = _bottleneck_init(
                    gen, in_ch, width, dtype, bi == 0, norm)
                in_ch = width * _EXPANSION
        params["fc"] = nn.dense_init(gen, in_ch, num_classes, dtype)
        move = lambda t: t.to(device)      # noqa: E731
        return tree_map(move, params), tree_map(move, state)

    def apply(params, state, x, train=True, rng=None, tree=None,
              bn_weight=None):
        new_state = {}
        h = x.to(dtype).permute(0, 3, 1, 2)   # NHWC -> NCHW, channels-last
        h = nn.conv2d(params["conv_stem"], h, padding=3, stride=2,
                      compute_dtype=compute_dtype)
        if use_bn:
            h, new_state["bn_stem"] = nn.batchnorm(
                params["bn_stem"], state["bn_stem"], h, train=train,
                eps=1e-5, momentum=0.1, tree=tree, weight=bn_weight)
        h = nn.max_pool2d(torch.relu(h), window=(3, 3), stride=(2, 2),
                          padding=((1, 1), (1, 1)))
        for si, n_blocks in enumerate(blocks):
            for bi in range(n_blocks):
                name = f"stage{si + 1}_block{bi + 1}"
                h, new_state[name] = _bottleneck_apply(
                    params[name], state[name], h,
                    2 if (bi == 0 and si > 0) else 1, train, tree,
                    bn_weight, compute_dtype)
        h = h.mean(dim=(2, 3))                # global average pool
        logits = nn.dense(params["fc"], h, compute_dtype=compute_dtype)
        return nn.log_softmax(logits.to(dtype)), new_state

    return Model(init=init, apply=apply, name=f"resnet{depth}",
                 input_shape=(image_size, image_size, 3),
                 num_classes=num_classes)


def resnet50(num_classes: int = 1000, dtype=torch.float32,
             compute_dtype=None, image_size: int = 224,
             norm: str = "batch") -> Model:
    return resnet(50, num_classes, dtype, compute_dtype, image_size,
                  norm=norm)
