"""Times kernel B1's block shapes against each other on one card.

B1 (``ops/csrc/fused_update.cu::sgd_chunk``, ``p' = p - lr*g``) runs one
float4 a thread and 128 threads a block: one chunk of 512 elements a block,
both loads of a thread before its store.  This probe builds the same kernel
from its own copy of that body at (1, 2, 4) float4 a thread x (128, 256)
threads a block, checks each bit for bit against ``sgd_plain`` on the
full-width CIFAR-10 convnet's bucket, and prints the median time of each,
of the shipped ``fused_sgd``, of ``torch.add(p, g, alpha=-lr)`` and of a
device copy of the same 52 MB, over CUDA events after an L2 flush that
writes 256 MB (the cache left full of dirty lines, as ``chip_smoke.py``
times every kernel) and after one that reads them (left clean).  Nothing in
the port imports it.  Run on one card from the repo's root:

    python -m distlearn_tpu_torch.ops.b1_shapes
"""

from __future__ import annotations

import ctypes
import hashlib
import statistics
import subprocess

import torch

from distlearn_tpu_torch.ops import _build
from distlearn_tpu_torch.ops import fused_update as fu

BUCKET = 4_329_472
SHAPES = ((1, 128), (1, 256), (2, 128), (2, 256), (4, 128), (4, 256))
ITERS = 100

# B1's body with the shape a template parameter; 16-byte-aligned buffers
# and a length that is a multiple of 4 only (the bucket is both)
SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

template <int kVec, int kBlock>
__global__ void __launch_bounds__(kBlock)
    sgd_shape(float* __restrict__ out, const float* __restrict__ p,
              const float* __restrict__ g, int64_t n, float lr) {
  const int64_t begin = blockIdx.x * (int64_t)(4 * kVec * kBlock);
  float4 a[kVec], b[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) {  // every load before any store
    const int64_t e = begin + 4 * (threadIdx.x + (int64_t)i * kBlock);
    if (e < n) {
      a[i] = __ldcs(reinterpret_cast<const float4*>(p + e));
      b[i] = __ldcs(reinterpret_cast<const float4*>(g + e));
    }
  }
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const int64_t e = begin + 4 * (threadIdx.x + (int64_t)i * kBlock);
    if (e < n) {
      float4 r;
      r.x = __fsub_rn(a[i].x, __fmul_rn(lr, b[i].x));
      r.y = __fsub_rn(a[i].y, __fmul_rn(lr, b[i].y));
      r.z = __fsub_rn(a[i].z, __fmul_rn(lr, b[i].z));
      r.w = __fsub_rn(a[i].w, __fmul_rn(lr, b[i].w));
      __stcs(reinterpret_cast<float4*>(out + e), r);
    }
  }
}

template <int kVec, int kBlock>
int launch(float* out, const float* p, const float* g, int64_t n, float lr,
           cudaStream_t stream) {
  constexpr int64_t kChunk = 4 * kVec * kBlock;
  sgd_shape<kVec, kBlock><<<(unsigned)((n + kChunk - 1) / kChunk), kBlock,
                            0, stream>>>(out, p, g, n, lr);
  return (int)cudaGetLastError();
}

extern "C" int b1_shape(float* out, const float* p, const float* g,
                        int64_t n, float lr, int vec, int threads,
                        cudaStream_t stream) {
  if (vec == 1 && threads == 128) return launch<1, 128>(out, p, g, n, lr, stream);
  if (vec == 1 && threads == 256) return launch<1, 256>(out, p, g, n, lr, stream);
  if (vec == 2 && threads == 128) return launch<2, 128>(out, p, g, n, lr, stream);
  if (vec == 2 && threads == 256) return launch<2, 256>(out, p, g, n, lr, stream);
  if (vec == 4 && threads == 128) return launch<4, 128>(out, p, g, n, lr, stream);
  if (vec == 4 && threads == 256) return launch<4, 256>(out, p, g, n, lr, stream);
  return (int)cudaErrorInvalidValue;
}
"""


def build() -> ctypes.CDLL:
    """Compile :data:`SOURCE` with the port's nvcc flags into the build
    directory (once per source text) and load it."""
    digest = hashlib.sha256(SOURCE.encode()).hexdigest()[:16]
    lib = _build.BUILD_DIR / f"b1_shapes-{digest}.so"
    if not lib.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        src = lib.with_suffix(".cu")
        src.write_text(SOURCE)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                        str(src)], check=True, timeout=600)
    so = ctypes.CDLL(str(lib))
    p = ctypes.c_void_p
    so.b1_shape.argtypes = (p, p, p, ctypes.c_int64, ctypes.c_float,
                            ctypes.c_int, ctypes.c_int, p)
    so.b1_shape.restype = ctypes.c_int
    return so


def time_ms(fn, flush) -> float:
    """Median ms of one call of ``fn`` between two CUDA events over
    :data:`ITERS` calls, ``flush()`` before each."""
    for _ in range(5):
        fn()
    events = []
    for _ in range(ITERS):
        flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("b1_shapes: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    so = build()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    p = torch.randn(BUCKET, generator=gen, device=dev)
    g = torch.randn(BUCKET, generator=gen, device=dev)
    lr = 0.1
    out = torch.empty_like(p)
    stream = torch.cuda.current_stream().cuda_stream

    def shape(vec, threads):
        rc = so.b1_shape(out.data_ptr(), p.data_ptr(), g.data_ptr(), BUCKET,
                         lr, vec, threads, stream)
        if rc != 0:
            raise RuntimeError(f"B1 at ({vec}, {threads}): cudaError {rc}")

    ref = fu.sgd_plain(p, g, lr)
    for sh in SHAPES:
        out.fill_(float("nan"))
        shape(*sh)
        if not torch.equal(out, ref):
            raise SystemExit(f"B1 at {sh} differs from sgd_plain")
    src = torch.empty(BUCKET * 3 // 2, device=dev)   # 26 MB read, 26 written
    dst = torch.empty_like(src)
    fns = {"fused_sgd": lambda: fu.fused_sgd(p, g, lr),
           "torch.add": lambda: torch.add(p, g, alpha=-lr),
           "device copy": lambda: dst.copy_(src)}
    fns.update({f"shape {sh}": lambda sh=sh: shape(*sh) for sh in SHAPES})
    buf = torch.empty(256 << 20, dtype=torch.uint8, device=dev)  # > 50 MB L2
    for label, flush in (("written (L2 dirty)", buf.zero_),
                         ("read (L2 clean)", buf.max)):
        print(f"B1 over {BUCKET} float32 after a flush {label} (shape: "
              "float4 a thread, threads a block); median ms of "
              f"{ITERS}: " + ", ".join(f"{k} {time_ms(f, flush):.5f}"
                                       for k, f in fns.items()))


if __name__ == "__main__":
    main()
