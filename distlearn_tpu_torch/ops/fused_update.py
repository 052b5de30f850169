"""Fused optimizer updates over packed flat buckets — counterpart of
``distlearn_tpu/ops/fused_update.py``, whose two Pallas TPU kernels become
hand-written CUDA kernels for Hopper (``ops/csrc/fused_update.cu``):

* :func:`fused_sgd` — ``p' = p - lr * g`` over one packed bucket
  (replaces ``fused_sgd``/``_sgd_kernel``);
* :func:`fused_elastic` — the EASGD local move (lua/AllReduceEA.lua:35-39):
  ``delta = (p - c) * alpha; p' = p - delta``, both outputs in one pass
  (replaces ``fused_elastic``/``_elastic_kernel``).

Each wrapper dispatches on its tensors' device: a CUDA tensor launches the
kernel (or the wrapper raises), a CPU tensor takes the plain PyTorch version
beside it (:func:`sgd_plain`, :func:`elastic_plain`), which has the same
arithmetic and is the kernel's oracle.  There is no fallback from one to the
other.  Each wrapper counts its kernel launches in ``<wrapper>.launches``.

``lr`` and ``alpha`` are rounded to the parameter dtype first, as
``jnp.asarray(lr, p.dtype)`` does in the JAX kernels.
"""

from __future__ import annotations

import ctypes
from typing import Any

import torch
import torch.distributed as dist

from distlearn_tpu_torch.ops import _build
from distlearn_tpu_torch.ops import flatten as flatten_lib
from distlearn_tpu_torch.utils import flags

PyTree = Any

_SOURCE = "fused_update.cu"
_P = ctypes.c_void_p
_SIGNATURES = {
    "dl_fused_sgd_f32": (_P, _P, _P, ctypes.c_int64, ctypes.c_float, _P),
    "dl_fused_elastic_f32": (_P, _P, _P, _P, ctypes.c_int64, ctypes.c_float,
                             _P),
}


def fused_enabled(override: bool | None = None, device=None) -> bool:
    """Whether trainers take the fused-kernel path.  Priority: explicit
    ``override`` > ``DISTLEARN_TPU_TORCH_FUSED`` env (0/1) > on for a CUDA
    ``device``, off on the CPU."""
    if override is not None:
        return bool(override)
    env = flags.env_truthy("DISTLEARN_TPU_TORCH_FUSED")
    if env is not None:
        return env
    return device is not None and torch.device(device).type == "cuda"


def cast_scalar(x: float, dtype: torch.dtype) -> float:
    """``x`` rounded to ``dtype`` (exact as a Python float)."""
    return torch.tensor(x, dtype=dtype).item()


def _kernel(name: str):
    return _build.function(_SOURCE, name, _SIGNATURES[name])


def _check(name: str, *tensors: torch.Tensor) -> int:
    """The kernels take float32, contiguous, 1-D, same-length CUDA tensors
    on one device; anything else raises."""
    first = tensors[0]
    for t in tensors:
        if t.device.type != "cuda" or t.device != first.device:
            raise ValueError(f"{name}: all tensors must be on one CUDA device, "
                             f"got {[str(u.device) for u in tensors]}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: float32 only, got {t.dtype}")
        if t.dim() != 1 or t.shape != first.shape:
            raise ValueError(f"{name}: 1-D tensors of one length, got "
                             f"{[tuple(u.shape) for u in tensors]}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    return first.numel()


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")


# ---------------------------------------------------------------------------
# B1: fused SGD
# ---------------------------------------------------------------------------

def sgd_plain(p: torch.Tensor, g: torch.Tensor, lr: float) -> torch.Tensor:
    """``p - lr * g`` as two separately rounded ops, in p's dtype."""
    return p - cast_scalar(lr, p.dtype) * g.to(p.dtype)


def fused_sgd(p_flat: torch.Tensor, g_flat: torch.Tensor,
              lr: float) -> torch.Tensor:
    """One launch of ``p' = p - lr * g`` over a packed bucket; returns a new
    tensor (the inputs are not modified)."""
    if p_flat.device.type == "cpu":
        return sgd_plain(p_flat, g_flat, lr)
    n = _check("fused_sgd", p_flat, g_flat)
    out = torch.empty_like(p_flat)
    if n:
        rc = _kernel("dl_fused_sgd_f32")(
            out.data_ptr(), p_flat.data_ptr(), g_flat.data_ptr(), n,
            cast_scalar(lr, torch.float32),
            torch.cuda.current_stream(p_flat.device).cuda_stream)
        _raise_on(rc, "fused_sgd")
        fused_sgd.launches += 1
    return out


fused_sgd.launches = 0


# ---------------------------------------------------------------------------
# B2: fused elastic move
# ---------------------------------------------------------------------------

def elastic_plain(p: torch.Tensor, c: torch.Tensor, alpha: float
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """``delta = (p - c) * alpha; p' = p - delta``; returns ``(p', delta)``."""
    d = (p - c.to(p.dtype)) * cast_scalar(alpha, p.dtype)
    return p - d, d


def fused_elastic(p_flat: torch.Tensor, c_flat: torch.Tensor, alpha: float
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch of the elastic move: reads p and c once, writes
    ``(new_p, delta)`` once."""
    if p_flat.device.type == "cpu":
        return elastic_plain(p_flat, c_flat, alpha)
    n = _check("fused_elastic", p_flat, c_flat)
    new_p, delta = torch.empty_like(p_flat), torch.empty_like(p_flat)
    if n:
        rc = _kernel("dl_fused_elastic_f32")(
            new_p.data_ptr(), delta.data_ptr(), p_flat.data_ptr(),
            c_flat.data_ptr(), n, cast_scalar(alpha, torch.float32),
            torch.cuda.current_stream(p_flat.device).cuda_stream)
        _raise_on(rc, "fused_elastic")
        fused_elastic.launches += 1
    return new_p, delta


fused_elastic.launches = 0


# ---------------------------------------------------------------------------
# Pytree-level wrappers over bucketed flat buffers (the trainer's hot path)
# ---------------------------------------------------------------------------

def sgd_update_buckets(spec: flatten_lib.BucketSpec, params: PyTree,
                       grad_flats: list[torch.Tensor], lr: float) -> PyTree:
    """``p' = p - lr*g`` with the gradients already packed (after the
    allreduce): params are packed, updated by one kernel launch per bucket,
    and unpacked as views into the new buckets (ref examples/mnist.lua:112-116)."""
    p_flats = flatten_lib.pack_buckets(spec, params)
    new = [fused_sgd(p, g, lr) for p, g in zip(p_flats, grad_flats)]
    return flatten_lib.unpack_buckets(spec, new)


def elastic_round_buckets(params: PyTree, center: PyTree, alpha: float,
                          tree, max_bucket_bytes: int | None = None
                          ) -> tuple[PyTree, PyTree]:
    """The EASGD round (lua/AllReduceEA.lua:35-45) on flat buckets: one
    kernel launch gives ``(p', delta)`` per bucket, one allreduce per bucket
    sums the deltas over the nodes of ``tree`` (a
    :class:`~distlearn_tpu_torch.parallel.mesh.MeshTree`), and the center
    moves by the sum.  Returns ``(new_params, new_center)``."""
    spec = flatten_lib.make_bucket_spec(params, max_bucket_bytes)
    p_flats = flatten_lib.pack_buckets(spec, params)
    c_flats = flatten_lib.pack_buckets(spec, center)
    new_p, new_c = [], []
    for p, c in zip(p_flats, c_flats):
        np_, d = fused_elastic(p, c, alpha)
        dist.all_reduce(d, group=tree.group)
        new_p.append(np_)
        new_c.append(c + d)
    return (flatten_lib.unpack_buckets(spec, new_p),
            flatten_lib.unpack_buckets(spec, new_c))
