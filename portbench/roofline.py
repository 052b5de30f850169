"""The yardstick's arithmetic: the card's peaks, a model's operations
counted from its shapes, and the least time a kernel's bytes need.

Operations and bytes come from the configuration's shapes (the plain
model run on the ``meta`` device, which computes nothing), never from the
kernel under test, so any implementation of the same work reads the same
count.
"""

from __future__ import annotations

import math

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from portbench import reference
from portbench.reference.common import set_path

#: NVIDIA H100 SXM data sheet, dense: FLOP/s by the precision a
#: configuration computes in (float32 with TF32 off runs on the CUDA
#: cores), and HBM bytes/s
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
#: bytes a parameter of SGD's update moves: p and g read, p written
SGD_BYTES_PER_PARAM = 12
#: operations a parameter of SGD's update takes: a multiply and a subtract
SGD_FLOPS_PER_PARAM = 2

_aten = torch.ops.aten


class _MacCounter(TorchDispatchMode):
    """Counts the multiply-adds of convolutions and matrix products."""

    def __init__(self):
        super().__init__()
        self.macs = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is _aten.convolution.default:
            w = args[1]                 # [out, in / groups, kh, kw]
            self.macs += out.numel() * math.prod(w.shape[1:])
        elif func in (_aten.mm.default, _aten.addmm.default):
            a = args[-2]
            self.macs += out.numel() * a.shape[-1]
        elif func is _aten.bmm.default:
            self.macs += out.numel() * args[0].shape[-1]
        return out


def forward_macs(cfg: dict) -> int:
    """Multiply-adds of one sample's forward through the configuration's
    convolutions and dense layers."""
    mod = reference.model(cfg)
    params = {}
    for path, shape, _, _ in mod.param_specs(cfg):
        set_path(params, path, torch.empty(shape, device="meta"))
    state = mod.state_init(cfg, "meta")
    s = cfg["image_size"]
    x = torch.empty(2, s, s, cfg["in_channels"], device="meta")
    y = torch.zeros(2, dtype=torch.int64, device="meta")
    with _MacCounter() as counter:      # two samples: batchnorm needs them
        mod.loss(cfg, params, state, x, y)
    return counter.macs // 2


def train_flops_per_sample(cfg: dict) -> int:
    """Model FLOPs of one sample's training step: multiply-adds x 2, for
    the forward, the input gradients and the weight gradients (x 3),
    without normalisation or elementwise work."""
    return 6 * forward_macs(cfg)


def param_count(cfg: dict) -> int:
    mod = reference.model(cfg)
    return sum(math.prod(shape) for _, shape, _, _ in mod.param_specs(cfg))


def sgd_bound_s(params: int) -> float:
    """The least time SGD's update of ``params`` parameters takes: its
    bytes at the HBM rate against its operations at the float32 peak."""
    return max(SGD_BYTES_PER_PARAM * params / HBM_BYTES_PER_S,
               SGD_FLOPS_PER_PARAM * params / PEAK_FLOPS["float32"])
