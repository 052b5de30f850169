"""The CUDA flash kernels' own code, run on the CPU.

``distlearn_tpu_torch/ops/csrc/flash_attention.cu`` compiles here with g++
as host C++ over ``tests/torch_cuda_emu.h``, which runs every thread of a
block as a thread and the warp collectives (shuffles, ``ldmatrix``,
``mma.sync``) through shared slots.  The source's PTX helpers
(:data:`PTX_HELPERS`) are taken out and the header's stand in; its dynamic
shared memory and its launch are mapped onto the header's.  So the
kernels' indexing, fragment layouts, masks, online softmax and cp.async
ring run as written: every bfloat16 kernel on its m16n8k16 tensor-core
path, the float32 kernels on their 3xTF32 m16n8k8 path (the header's
``cvt.rna.tf32.f32`` and TF32 ``mma.sync``) beside their fmaf-chain
scores.  They are held against their plain twins
(``ops/flash_attention.py``), which the card holds them against too
(``chip_smoke.py`` phases 9 and 11), at the same tolerances: float32
within 1e-5 (B5a) and rtol 2e-4, atol 2e-5 (B5b, B5c; dK's atol times the
factor on q, as phase 11's ``check_backward``); bfloat16 within rtol =
atol = 2e-2; m within 1e-5 times the factor on q, l within 1e-5
relative.  Float32 B5a's m is held bit for bit against the row max of
``__fmul_rn(s, scale)``, s the fmaf chain over d from 0 in order
(:data:`SCORE_ROW_MAX`, host C++ appended to the emulated source): the
scores that float32 B5b and B5c form again when they recompute P.  What
this cannot show: that the CUDA compiler takes the source, and the card's
speed.  Skipped where no g++ is."""

from __future__ import annotations

import ctypes
import math
import re
import shutil
import subprocess
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from distlearn_tpu_torch.ops import flash_attention as fa  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "distlearn_tpu_torch" / "ops" / "csrc" / "flash_attention.cu"
SHIM = Path(__file__).resolve().parent / "torch_cuda_emu.h"
#: device functions of the source written in PTX, replaced by the shim's
PTX_HELPERS = ("smem_u32", "cp_async16", "cp_async_commit",
               "cp_async_wait_all", "ldsm_x4", "ldsm_x4_trans", "mma_bf16",
               "to_tf32", "mma_tf32")


#: the reference for float32 B5a's m: for each (batch, head, query row) of
#: contiguous [B, L, H, D] q and k, the max over its keys (causal: up to the
#: row) of __fmul_rn(s, scale), s one fmaf chain over d from 0 in order
SCORE_ROW_MAX = r"""
extern "C" void emu_score_row_max(const float* q, const float* k, int B,
                                  int L, int H, int D, float scale,
                                  int causal, float* m) {
  for (int b = 0; b < B; ++b)
    for (int h = 0; h < H; ++h)
      for (int i = 0; i < L; ++i) {
        const float* qi = q + ((int64_t)(b * L + i) * H + h) * D;
        float mx = -INFINITY;
        for (int j = 0; j < (causal ? i + 1 : L); ++j) {
          const float* kj = k + ((int64_t)(b * L + j) * H + h) * D;
          float s = 0.f;
          for (int d = 0; d < D; ++d) s = std::fmaf(qi[d], kj[d], s);
          const float x = __fmul_rn(s, scale);
          mx = x > mx ? x : mx;
        }
        m[((int64_t)b * H + h) * L + i] = mx;
      }
}
"""


def _replace(text: str, old: str, new: str, count: int) -> str:
    assert text.count(old) == count, f"{old!r} found {text.count(old)} times"
    return text.replace(old, new)


def host_source(cu: str) -> str:
    """The CUDA source as host C++ over the shim."""
    out, skip, dropped = [], False, set()
    for line in cu.split("\n"):
        if skip:
            skip = line != "}"
            continue
        m = re.match(r"__device__ __forceinline__ [\w:]+ (\w+)\(", line)
        if m and m.group(1) in PTX_HELPERS:
            dropped.add(m.group(1))
            skip = True
            continue
        out.append(line)
    assert dropped == set(PTX_HELPERS), dropped
    text = "\n".join(out)
    text = _replace(text, "#include <cuda_bf16.h>",
                    f'#include "{SHIM.name}"', 1)
    text = _replace(text, "#include <cuda_runtime.h>", "", 1)
    text = _replace(text, "extern __shared__ __align__(16) unsigned char "
                    "smem_tc[];", "unsigned char* smem_tc = emu_smem;", 6)
    text = _replace(text, "kernel<<<dim3(L / kBM, H, B), threads, smem, "
                    "stream>>>(args...);", "emu_launch(kernel, dim3(L / kBM, "
                    "H, B), threads, args...);", 1)
    return text + ('\nextern "C" void emu_set_async_mode(int m) '
                   '{ emu_async_mode = m; }\n')


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the emulated kernels")
    d = tmp_path_factory.mktemp("flash_emu")
    src = d / "flash_emu.cpp"
    src.write_text(host_source(SOURCE.read_text()) + SCORE_ROW_MAX)
    so = d / "libflash_emu.so"
    subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC",
                    "-pthread", f"-I{SHIM.parent}", "-o", str(so), str(src)],
                   check=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    for name, sig in fa._SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = sig, ctypes.c_int
    lib.emu_set_async_mode.argtypes = (ctypes.c_int,)
    lib.emu_score_row_max.argtypes = (
        ctypes.c_void_p, ctypes.c_void_p, *(ctypes.c_int,) * 4,
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p)
    lib.emu_score_row_max.restype = None
    return lib


def _call(lib, name, q, pointers, strided, causal):
    """``name`` on CPU tensors, as ``ops/flash_attention.py::_launch``
    calls it on the card's."""
    B, L, H, D = q.shape
    rc = getattr(lib, name)(
        *(t.data_ptr() if t is not None else None for t in pointers),
        fa._DTYPE_CODES[q.dtype], B, L, H, D,
        *(s for t in strided for s in t.stride()[:3]),
        1.0 / math.sqrt(D), int(causal), None)
    assert rc == 1, f"{name} returned {rc}"


def _close(got, want, rtol, atol, what):
    assert torch.allclose(got.float(), want.float(), rtol=rtol, atol=atol), (
        f"{what}: max abs {(got.double() - want.double()).abs().max():.3g}")


#: (dtype, B, H, D, L, causal, q multiplier, cp.async mode): three tiles
#: with held-back copies, full attention, D = 32, D = 128 with large scores
#: (B5b's K and V from shared memory), a single diagonal tile; float32 (P V
#: and the backward's products in 3xTF32) at D = 64 and 128, then at
#: D = 32, with held-back copies over three tiles, and with q x 8 (scores
#: up to about +-50, P nearly one-hot) at D = 64 and 128
CASES = [("bfloat16", 1, 2, 64, 192, True, 1.0, 1),
         ("bfloat16", 1, 1, 64, 128, False, 1.0, 0),
         ("bfloat16", 1, 1, 32, 128, True, 1.0, 0),
         ("bfloat16", 1, 1, 128, 128, True, 8.0, 1),
         ("bfloat16", 2, 1, 64, 64, True, 1.0, 1),
         ("float32", 1, 1, 64, 128, True, 1.0, 0),
         ("float32", 1, 1, 128, 128, False, 1.0, 0),
         ("float32", 1, 1, 32, 128, True, 1.0, 0),
         ("float32", 1, 2, 64, 192, True, 1.0, 1),
         ("float32", 1, 1, 64, 128, True, 8.0, 1),
         ("float32", 1, 1, 128, 128, True, 8.0, 0)]


@pytest.mark.parametrize(
    "dtype,B,H,D,L,causal,mult,mode", CASES,
    ids=[f"{c[0]}-B{c[1]}H{c[2]}D{c[3]}L{c[4]}-"
         f"{'causal' if c[5] else 'full'}-q{c[6]:g}-"
         f"{'held' if c[7] else 'landed'}" for c in CASES])
def test_emulated_kernels_match_twins(lib, dtype, B, H, D, L, causal, mult,
                                      mode):
    lib.emu_set_async_mode(mode)
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(L + D)
    q, k, v, do = (torch.randn((B, L, H, D), generator=g) for _ in range(4))
    q, k, v, do = ((q * mult).to(dt), k.to(dt), v.to(dt), do.to(dt))
    bf16 = dt == torch.bfloat16
    fwd_tol = (2e-2, 2e-2) if bf16 else (0.0, 1e-5)
    bwd_tol = (2e-2, 2e-2) if bf16 else (2e-4, 2e-5)

    # B5a, with residuals and without (the serving path)
    o, m, l = (torch.empty_like(q), torch.empty((B, H, L)),
               torch.empty((B, H, L)))
    _call(lib, "dl_flash_fwd", q, (q, k, v, o, m, l), (q, k, v, o), causal)
    po, pm, pl = fa.flash_attention_fwd_plain(q, k, v, causal)
    _close(o, po, *fwd_tol, "o")
    assert (m - pm).abs().max() <= 1e-5 * mult
    assert ((l - pl).abs() / pl).max() <= 1e-5
    o2 = torch.empty_like(q)
    _call(lib, "dl_flash_fwd", q, (q, k, v, o2, None, None), (q, k, v, o2),
          causal)
    assert torch.equal(o, o2)

    # B5c (dq, di), then B5b (dk, dv) on the di it wrote
    dq, di = torch.empty_like(q), torch.empty((B, H, L))
    _call(lib, "dl_flash_bwd_dq", q, (q, k, v, o, do, m, l, dq, di),
          (q, k, v, o, do, dq), causal)
    pdi = fa.flash_attention_di_plain(o, do)
    assert (di - pdi).abs().max() <= 1e-3 * max(1.0, float(pdi.abs().max()))
    _close(dq, fa.flash_attention_dq_plain(q, k, v, do, m, l, pdi, causal),
           *bwd_tol, "dq")
    dk, dv = torch.empty_like(q), torch.empty_like(q)
    _call(lib, "dl_flash_bwd_dkv", q, (q, k, v, do, m, l, di, dk, dv),
          (q, k, v, do, dk, dv), causal)
    pdk, pdv = fa.flash_attention_dkv_plain(q, k, v, do, m, l, di, causal)
    # dK = dS^T Q: a rounding difference in dS moves dK by it times |q|,
    # which q x mult scales (phase 11's check_backward scales the float32
    # atol so; the bfloat16 cases keep 2e-2)
    dk_atol = bwd_tol[1] * (mult if not bf16 else 1.0)
    _close(dk, pdk, bwd_tol[0], dk_atol, "dk")
    _close(dv, pdv, *bwd_tol, "dv")
    # a second backward equal bit for bit: one owner per tile, no atomics
    dq2, di2 = torch.empty_like(q), torch.empty((B, H, L))
    _call(lib, "dl_flash_bwd_dq", q, (q, k, v, o, do, m, l, dq2, di2),
          (q, k, v, o, do, dq2), causal)
    dk2, dv2 = torch.empty_like(q), torch.empty_like(q)
    _call(lib, "dl_flash_bwd_dkv", q, (q, k, v, do, m, l, di2, dk2, dv2),
          (q, k, v, do, dk2, dv2), causal)
    assert all(torch.equal(a, b) for a, b in
               ((dq, dq2), (di, di2), (dk, dk2), (dv, dv2)))


def test_emulated_entry_points_refuse_what_the_kernels_do_not_take(lib):
    """An unbuilt head dim, a ragged length and a row stride that is not a
    multiple of 16 bytes return -cudaErrorInvalidValue, as on the card."""
    q = torch.zeros((1, 128, 1, 64), dtype=torch.bfloat16)
    o = torch.empty_like(q)
    args = (q.data_ptr(), q.data_ptr(), q.data_ptr(), o.data_ptr(), None,
            None)
    st = (64, 64, 64) * 4
    assert lib.dl_flash_fwd(*args, 1, 1, 128, 1, 48, *st, 0.125, 1,
                            None) == -1
    assert lib.dl_flash_fwd(*args, 1, 1, 96, 1, 64, *st, 0.125, 1,
                            None) == -1
    assert lib.dl_flash_fwd(*args, 1, 1, 128, 1, 64, *(68, 68, 68) * 4,
                            0.125, 1, None) == -1
    assert lib.dl_flash_fwd(*args, 1, 1, 128, 1, 64, *st, 0.125, 1,
                            None) == 1


#: (B, H, D, L, causal, q multiplier) for float32 B5a's m: three causal
#: tiles of two heads (4 warps), and q x 8 at D = 128 (8 warps, the two
#: halves' m merged at the end) and at D = 32 over full attention
M_CASES = [(1, 2, 64, 192, True, 1.0), (1, 1, 128, 128, True, 8.0),
           (1, 1, 32, 128, False, 8.0)]


@pytest.mark.parametrize(
    "B,H,D,L,causal,mult", M_CASES,
    ids=[f"B{c[0]}H{c[1]}D{c[2]}L{c[3]}-{'causal' if c[4] else 'full'}-"
         f"q{c[5]:g}" for c in M_CASES])
def test_emulated_b5a_m_is_the_row_max_of_the_fmaf_chain_scores(
        lib, B, H, D, L, causal, mult):
    """Float32 B5a's m equals, bit for bit, the row max of ``__fmul_rn(s,
    scale)`` with s the fmaf chain over d from 0 in order: the scores that
    float32 B5b and B5c form again, so their P = exp(s * scale - m) / l
    is normalised by the max of exactly the values it exponentiates."""
    lib.emu_set_async_mode(1)
    g = torch.Generator().manual_seed(L + D + 1)
    q, k, v = (torch.randn((B, L, H, D), generator=g) for _ in range(3))
    q = q * mult
    o, m, l = (torch.empty_like(q), torch.empty((B, H, L)),
               torch.empty((B, H, L)))
    _call(lib, "dl_flash_fwd", q, (q, k, v, o, m, l), (q, k, v, o), causal)
    want = torch.empty((B, H, L))
    lib.emu_score_row_max(q.data_ptr(), k.data_ptr(), B, L, H, D,
                          1.0 / math.sqrt(D), int(causal), want.data_ptr())
    assert torch.equal(m, want), (
        f"{int((m != want).sum())} rows differ, max "
        f"{float((m - want).abs().max()):.3g}")
