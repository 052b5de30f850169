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
// Design: the TPU kernel walks (256, 128) VMEM blocks in a sequential grid;
// here every thread owns 4 consecutive elements and moves them with one
// 16-byte load or store per array (float4), and a grid-stride loop covers
// any length.  The tail of a length that is not a multiple of 4, and buffers
// that are not 16-byte aligned, take a scalar path.  The arithmetic uses
// __fmul_rn/__fsub_rn, which nvcc never contracts into an FMA, so each kernel
// equals its plain PyTorch version (two separate rounded ops) bit for bit.
// Each function launches on the caller's stream, does not synchronise, and
// returns cudaGetLastError() so a refused launch is reported.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float sgd1(float p, float g, float lr) {
  return __fsub_rn(p, __fmul_rn(lr, g));
}

__global__ void sgd_vec4(float4* __restrict__ out, const float4* __restrict__ p,
                         const float4* __restrict__ g, int64_t n4, float lr) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n4;
       i += (int64_t)gridDim.x * blockDim.x) {
    float4 a = p[i], b = g[i], r;
    r.x = sgd1(a.x, b.x, lr);
    r.y = sgd1(a.y, b.y, lr);
    r.z = sgd1(a.z, b.z, lr);
    r.w = sgd1(a.w, b.w, lr);
    out[i] = r;
  }
}

__global__ void sgd_scalar(float* __restrict__ out, const float* __restrict__ p,
                           const float* __restrict__ g, int64_t begin,
                           int64_t n, float lr) {
  for (int64_t i = begin + blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
       i < n; i += (int64_t)gridDim.x * blockDim.x)
    out[i] = sgd1(p[i], g[i], lr);
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

extern "C" int dl_fused_sgd_f32(float* out, const float* p, const float* g,
                                int64_t n, float lr, cudaStream_t stream) {
  int64_t begin = 0;
  if (aligned16(out, p, g)) {
    int64_t n4 = n / 4;
    if (n4 > 0)
      sgd_vec4<<<grid_for(n4), kThreads, 0, stream>>>(
          reinterpret_cast<float4*>(out), reinterpret_cast<const float4*>(p),
          reinterpret_cast<const float4*>(g), n4, lr);
    begin = n4 * 4;
  }
  if (begin < n)
    sgd_scalar<<<grid_for(n - begin), kThreads, 0, stream>>>(out, p, g, begin,
                                                             n, lr);
  return (int)cudaGetLastError();
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
