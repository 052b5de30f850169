// Fused optimizer updates over packed flat parameter buckets, for Hopper
// (sm_90a).  Built by distlearn_tpu_torch/ops/_build.py with nvcc into a
// shared library with a plain C interface, loaded with ctypes.
//
// Replaces the Pallas TPU kernels of distlearn_tpu/ops/fused_update.py:
//   dl_fused_sgd_f32      <- fused_sgd / _sgd_kernel          p' = p - lr*g
//   dl_fused_elastic_f32  <- fused_elastic / _elastic_kernel  d = (p - c)*alpha
//                                                             p' = p - d
//
// Bound: both are elementwise passes with 2 float operations per element,
// far below the card's compute rate, so HBM bandwidth bounds them.  B1 moves
// 12 bytes per element (read p and g, write p'), 51.9 MB for the full-width
// CIFAR-10 convnet's 4,329,472-element bucket; B2 moves 16 bytes per element
// (read p and c, write p' and d), 69.3 MB.  At the H100 SXM's 3.35 TB/s that
// is 15.5 us and 20.7 us.
//
// Design: the TPU kernel walks (256, 128) VMEM blocks in a sequential grid.
// B1 (redesigned): each block of 128 threads owns one contiguous chunk of
// 512 elements and the grid is ceil(n / 512), no grid-stride round.  Each
// thread issues both its loads (one float4 of p and one of g, streaming
// hints: each byte is touched once) before it computes or stores; the
// grid-stride design before it waited out four or five DRAM round trips in
// sequence a thread, the last round almost empty.  This shape was the
// fastest of (1, 2, 4) float4 a thread x (128, 256) threads a block on the
// convnet's bucket (PERF.md keeps the others' times).  Buffers that are not
// 16-byte aligned, and the tail of a length that is not a multiple of 4,
// take a scalar loop in the same kernel: one launch per call whatever the
// alignment.  B2 keeps the first design: every thread owns 4 consecutive
// elements a round (float4) and a grid-stride loop covers any length.  The
// arithmetic uses __fmul_rn/__fsub_rn, which nvcc never contracts into an
// FMA, so each kernel equals its plain PyTorch version (two separate
// rounded ops) bit for bit.  Each function launches on the caller's
// stream, does not synchronise, and reports a refused launch
// (dl_fused_sgd_f32: the number of kernels launched, or -cudaError;
// dl_fused_elastic_f32: cudaGetLastError()).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float sgd1(float p, float g, float lr) {
  return __fsub_rn(p, __fmul_rn(lr, g));
}

constexpr int kSgdBlock = 128;
constexpr int64_t kSgdChunk = 4 * kSgdBlock;

// B1 over one chunk a block: [blockIdx.x * kSgdChunk, + kSgdChunk) cut at
// n.  vec: out, p and g are all 16-byte aligned (the host decides, for
// every block).
__global__ void __launch_bounds__(kSgdBlock)
    sgd_chunk(float* __restrict__ out, const float* __restrict__ p,
              const float* __restrict__ g, int64_t n, float lr, bool vec) {
  const int64_t begin = blockIdx.x * kSgdChunk;
  const int64_t end = begin + kSgdChunk < n ? begin + kSgdChunk : n;
  int64_t scalar = begin;
  if (vec) {
    const int64_t end4 = end & ~(int64_t)3;
    const int64_t e = begin + 4 * (int64_t)threadIdx.x;
    if (e < end4) {
      const float4 a = __ldcs(reinterpret_cast<const float4*>(p + e));
      const float4 b = __ldcs(reinterpret_cast<const float4*>(g + e));
      float4 r;
      r.x = sgd1(a.x, b.x, lr);
      r.y = sgd1(a.y, b.y, lr);
      r.z = sgd1(a.z, b.z, lr);
      r.w = sgd1(a.w, b.w, lr);
      __stcs(reinterpret_cast<float4*>(out + e), r);
    }
    scalar = end4;  // below end only in the last block
  }
  for (int64_t i = scalar + threadIdx.x; i < end; i += kSgdBlock)
    __stcs(out + i, sgd1(__ldcs(p + i), __ldcs(g + i), lr));
}

__device__ __forceinline__ void elastic1(float p, float c, float alpha,
                                         float* np, float* d) {
  float dd = __fmul_rn(__fsub_rn(p, c), alpha);
  *d = dd;
  *np = __fsub_rn(p, dd);
}

__global__ void elastic_vec4(float4* __restrict__ new_p,
                             float4* __restrict__ delta,
                             const float4* __restrict__ p,
                             const float4* __restrict__ c, int64_t n4,
                             float alpha) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n4;
       i += (int64_t)gridDim.x * blockDim.x) {
    float4 a = p[i], b = c[i], np, d;
    elastic1(a.x, b.x, alpha, &np.x, &d.x);
    elastic1(a.y, b.y, alpha, &np.y, &d.y);
    elastic1(a.z, b.z, alpha, &np.z, &d.z);
    elastic1(a.w, b.w, alpha, &np.w, &d.w);
    new_p[i] = np;
    delta[i] = d;
  }
}

__global__ void elastic_scalar(float* __restrict__ new_p,
                               float* __restrict__ delta,
                               const float* __restrict__ p,
                               const float* __restrict__ c, int64_t begin,
                               int64_t n, float alpha) {
  for (int64_t i = begin + blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
       i < n; i += (int64_t)gridDim.x * blockDim.x)
    elastic1(p[i], c[i], alpha, &new_p[i], &delta[i]);
}

// Enough blocks to fill every SM at full occupancy, no more: the grid-stride
// loop covers the rest.
int grid_for(int64_t work) {
  static int max_blocks = 0;
  if (max_blocks == 0) {
    int dev = 0, sms = 132;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    max_blocks = sms * (2048 / kThreads);
  }
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  return (int)(blocks < max_blocks ? blocks : max_blocks);
}

bool aligned16(const void* a, const void* b, const void* c,
               const void* d = nullptr) {
  uintptr_t bits = (uintptr_t)a | (uintptr_t)b | (uintptr_t)c | (uintptr_t)d;
  return (bits & 15) == 0;
}

}  // namespace

// B1: out = p - lr * g over n elements in one launch; returns the number
// of kernels launched (1, or 0 for n = 0) or -cudaError.
extern "C" int dl_fused_sgd_f32(float* out, const float* p, const float* g,
                                int64_t n, float lr, cudaStream_t stream) {
  if (n <= 0) return 0;
  sgd_chunk<<<(unsigned)((n + kSgdChunk - 1) / kSgdChunk), kSgdBlock, 0,
              stream>>>(out, p, g, n, lr, aligned16(out, p, g));
  const cudaError_t err = cudaGetLastError();
  return err == cudaSuccess ? 1 : -(int)err;
}

extern "C" int dl_fused_elastic_f32(float* new_p, float* delta, const float* p,
                                    const float* c, int64_t n, float alpha,
                                    cudaStream_t stream) {
  int64_t begin = 0;
  if (aligned16(new_p, delta, p, c)) {
    int64_t n4 = n / 4;
    if (n4 > 0)
      elastic_vec4<<<grid_for(n4), kThreads, 0, stream>>>(
          reinterpret_cast<float4*>(new_p), reinterpret_cast<float4*>(delta),
          reinterpret_cast<const float4*>(p),
          reinterpret_cast<const float4*>(c), n4, alpha);
    begin = n4 * 4;
  }
  if (begin < n)
    elastic_scalar<<<grid_for(n - begin), kThreads, 0, stream>>>(
        new_p, delta, p, c, begin, n, alpha);
  return (int)cudaGetLastError();
}
