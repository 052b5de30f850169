// The int8 wire codec of the AsyncEA parameter server, for Hopper (sm_90a).
// Built by distlearn_tpu_torch/ops/_build.py with nvcc into a shared library
// with a plain C interface, loaded with ctypes.
//
// Replaces the Pallas TPU kernels of distlearn_tpu/ops/wire_kernels.py:
//   dl_amax_abs_f32   <- _amax_call (the max|x| reduction before the codec)
//   dl_quant_ef_f32   <- _quant_ef_call / _quant_ef_kernel
//                        q = rint(x / s) as int8, r = x - f32(q) * s
//   dl_dequant_add_f32 <- _dequant_add_call / _dequant_add_kernel
//                        out = c + f32(q) * s  (out may be c)
//
// Bound: all three are streams with a few float operations per element, far
// below the card's compute rate, so HBM bandwidth bounds them.  Over the
// full-width CIFAR-10 convnet's delta (4,328,970 floats, 18 leaves) the
// function reads x (17.3 MB) and writes q (4.3 MB) and r (17.3 MB): 39.0 MB,
// 11.6 us at the H100 SXM's 3.35 TB/s.  This design reads x twice (once in
// the amax, once in the quantize), 56.3 MB.  The dequantize-add reads c and
// q and writes c: 39.0 MB, 11.6 us.
//
// Design: the TPU kernels walk (256, 128) VMEM blocks padded to the int8
// (32, 128) tile; here each kernel is a grid-stride stream over one flat
// leaf, no padding, one launch per leaf.  Each thread moves 4 consecutive
// elements with one 16-byte float load or store (float4) and one 4-byte int8
// load or store (char4) when every pointer is aligned for that; any other
// leaf, and the tail of a length that is not a multiple of 4, takes a scalar
// loop in the same kernel.
//
// The amax reduces the bit patterns of |x| as unsigned integers: for
// non-negative floats the integer order is the float order, and every NaN
// (any payload, the sign cleared by fabsf) lies above +inf, so a NaN anywhere
// in the leaf makes the result NaN -- the propagation fmaxf would drop.  Max
// is exact and order-free, so per-block maxima combined by atomicMax give the
// same bits as any sequential reduction.  The host reads the result, raises
// on a non-finite value, and computes scale = amax / 127.0 in double exactly
// as the reference codec does, then rounds it to float for these kernels.
//
// Rounding: __fdiv_rn is the correctly rounded division (this file is never
// built with --use_fast_math), __float2int_rn rounds half to even like
// numpy's rint, and __fmul_rn/__fsub_rn/__fadd_rn are never contracted into
// an FMA, so q and r equal the plain PyTorch versions (one rounding per
// operation) bit for bit.  No clip is needed: |x| <= amax gives
// |x / s| <= 127 / (1 - 2^-24) < 127.5, so the rounded value lies in
// [-127, 127] (distlearn_tpu/ops/wire_kernels.py carries the proof).
//
// Each function launches on the caller's stream and does not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// ---------------------------------------------------------------------------
// amax of |x| as the unsigned bits of a non-negative float
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned int abs_bits(float x) {
  return __float_as_uint(fabsf(x));
}

__global__ void amax_abs(const float4* __restrict__ x, int64_t n4,
                         const float* __restrict__ xs, int64_t begin,
                         int64_t n, unsigned int* __restrict__ out) {
  unsigned int m = 0u;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  for (int64_t i = tid; i < n4; i += stride) {
    float4 v = x[i];
    m = max(m, max(max(abs_bits(v.x), abs_bits(v.y)),
                   max(abs_bits(v.z), abs_bits(v.w))));
  }
  for (int64_t i = begin + tid; i < n; i += stride) m = max(m, abs_bits(xs[i]));
  m = __reduce_max_sync(0xffffffffu, m);
  __shared__ unsigned int warp_max[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < kThreads / 32 ? warp_max[lane] : 0u;
    m = __reduce_max_sync(0xffffffffu, m);
    if (lane == 0) atomicMax(out, m);
  }
}

// ---------------------------------------------------------------------------
// quantize with error feedback
// ---------------------------------------------------------------------------

__device__ __forceinline__ signed char qef1(float x, float s, float* r) {
  int q = __float2int_rn(__fdiv_rn(x, s));
  *r = __fsub_rn(x, __fmul_rn((float)q, s));
  return (signed char)q;
}

// One launch per leaf: the vector body (n4 groups of 4, 0 when a pointer is
// not aligned for it) and then the scalar elements [begin, n).
__global__ void quant_ef(char4* __restrict__ q4, float4* __restrict__ r4,
                         const float4* __restrict__ x4, int64_t n4,
                         signed char* __restrict__ q, float* __restrict__ r,
                         const float* __restrict__ x, int64_t begin,
                         int64_t n, float s) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  for (int64_t i = tid; i < n4; i += stride) {
    float4 v = x4[i], rr;
    char4 qq;
    qq.x = qef1(v.x, s, &rr.x);
    qq.y = qef1(v.y, s, &rr.y);
    qq.z = qef1(v.z, s, &rr.z);
    qq.w = qef1(v.w, s, &rr.w);
    q4[i] = qq;
    r4[i] = rr;
  }
  for (int64_t i = begin + tid; i < n; i += stride) q[i] = qef1(x[i], s, &r[i]);
}

// ---------------------------------------------------------------------------
// dequantize and add
// ---------------------------------------------------------------------------

__device__ __forceinline__ float dqa1(float c, signed char q, float s) {
  return __fadd_rn(c, __fmul_rn((float)q, s));
}

// One launch per leaf, laid out as quant_ef.  out may alias c: each element
// is read and written by the same thread.
__global__ void dequant_add(float4* out4, const float4* c4,
                            const char4* __restrict__ q4, int64_t n4,
                            float* out, const float* c,
                            const signed char* __restrict__ q, int64_t begin,
                            int64_t n, float s) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  for (int64_t i = tid; i < n4; i += stride) {
    float4 a = c4[i], o;
    char4 b = q4[i];
    o.x = dqa1(a.x, b.x, s);
    o.y = dqa1(a.y, b.y, s);
    o.z = dqa1(a.z, b.z, s);
    o.w = dqa1(a.w, b.w, s);
    out4[i] = o;
  }
  for (int64_t i = begin + tid; i < n; i += stride)
    out[i] = dqa1(c[i], q[i], s);
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

bool aligned(const void* p, uintptr_t bytes) {
  return ((uintptr_t)p & (bytes - 1)) == 0;
}

// The entry points' return value: the number of kernels launched (each
// launches exactly one), or -cudaError when a launch was refused.
int launched(cudaError_t err) { return err == cudaSuccess ? 1 : -(int)err; }

}  // namespace

// out: one unsigned slot, zeroed here; afterwards it holds the bits of
// max|x| (NaN bits if x holds a NaN).  n > 0.
extern "C" int dl_amax_abs_f32(unsigned int* out, const float* x, int64_t n,
                               cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(unsigned int), stream);
  if (err != cudaSuccess) return -(int)err;
  int64_t n4 = aligned(x, 16) ? n / 4 : 0;
  amax_abs<<<grid_for(n4 > 0 ? n4 : n), kThreads, 0, stream>>>(
      reinterpret_cast<const float4*>(x), n4, x, n4 * 4, n, out);
  return launched(cudaGetLastError());
}

extern "C" int dl_quant_ef_f32(signed char* q, float* r, const float* x,
                               int64_t n, float s, cudaStream_t stream) {
  int64_t n4 = aligned(x, 16) && aligned(r, 16) && aligned(q, 4) ? n / 4 : 0;
  quant_ef<<<grid_for(n4 > 0 ? n4 : n), kThreads, 0, stream>>>(
      reinterpret_cast<char4*>(q), reinterpret_cast<float4*>(r),
      reinterpret_cast<const float4*>(x), n4, q, r, x, n4 * 4, n, s);
  return launched(cudaGetLastError());
}

extern "C" int dl_dequant_add_f32(float* out, const float* c,
                                  const signed char* q, int64_t n, float s,
                                  cudaStream_t stream) {
  int64_t n4 =
      aligned(out, 16) && aligned(c, 16) && aligned(q, 4) ? n / 4 : 0;
  dequant_add<<<grid_for(n4 > 0 ? n4 : n), kThreads, 0, stream>>>(
      reinterpret_cast<float4*>(out), reinterpret_cast<const float4*>(c),
      reinterpret_cast<const char4*>(q), n4, out, c, q, n4 * 4, n, s);
  return launched(cudaGetLastError());
}
