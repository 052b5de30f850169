// The int8 wire codec of the AsyncEA parameter server, for Hopper (sm_90a).
// Built by distlearn_tpu_torch/ops/_build.py with nvcc into a shared library
// with a plain C interface, loaded with ctypes.
//
// Replaces the Pallas TPU kernels of distlearn_tpu/ops/wire_kernels.py:
//   dl_amax_abs_f32   <- _amax_call (the max|x| reduction before the codec)
//   dl_quant_ef_f32   <- _quant_ef_call / _quant_ef_kernel
//                        q = rint(x / s) as int8, r = x - f32(q) * s
//   dl_dequant_add_leaves_f32 <- _dequant_add_call / _dequant_add_kernel
//                        out = c + f32(q) * s  (out may be c), every leaf
//                        of a delta in one launch; dl_dequant_add_f32 is
//                        its one-leaf case
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
// (32, 128) tile; here the amax and the quantize are grid-stride streams
// over one flat leaf, no padding, one launch per leaf, and the
// dequantize-add takes all the leaves of a delta in one launch (the server
// applies a delta in one call: the per-leaf launches cost 5x the kernels'
// busy time in host calls).  Each thread moves 4 consecutive elements with
// one 16-byte float load or store (float4) and one 4-byte int8 load or
// store (char4) when every pointer is aligned for that; any other leaf,
// and the tail of a length that is not a multiple of 4, takes a scalar
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
#include <limits.h>
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

__host__ __device__ __forceinline__ bool aligned(const void* p,
                                                 uintptr_t bytes) {
  return ((uintptr_t)p & (bytes - 1)) == 0;
}

__device__ __forceinline__ float dqa1(float c, signed char q, float s) {
  return __fadd_rn(c, __fmul_rn((float)q, s));
}

// Every leaf of a delta in one launch.  The table rides in the kernel's
// parameters (2.6 KB of the 4 KB they may hold) and gives each leaf a run
// of blocks: leaf i owns blocks first[i] .. first[i + 1] - 1 (a prefix sum
// the host computes), and each block takes kLeafChunk consecutive elements
// of its leaf.  A leaf whose pointers are aligned for it moves 4 elements a
// thread with one float4 and one char4 access, and its last block takes the
// tail of a length that is not a multiple of 4 one element at a time; any
// other leaf (the server's q leaves are views at arbitrary byte offsets of
// its staging frame) takes the scalar loop.  out may alias c: each element
// is read and written by the same thread.
constexpr int kLeafCap = 64;
constexpr int kLeafChunk = 4 * 4 * kThreads;  // 4 float4 a thread

struct LeafTable {
  float* out[kLeafCap];
  const float* c[kLeafCap];
  const signed char* q[kLeafCap];
  int64_t n[kLeafCap];
  float s[kLeafCap];
  int first[kLeafCap + 1];  // first[count]: the grid
  int count;
};

__global__ void __launch_bounds__(kThreads)
    dequant_add_leaves(const __grid_constant__ LeafTable t) {
  int leaf = 0, hi = t.count - 1;  // the last leaf whose first block <= ours
  while (leaf < hi) {
    const int mid = (leaf + hi + 1) >> 1;
    if (t.first[mid] <= (int)blockIdx.x)
      leaf = mid;
    else
      hi = mid - 1;
  }
  float* out = t.out[leaf];
  const float* c = t.c[leaf];
  const signed char* q = t.q[leaf];
  const float s = t.s[leaf];
  const int64_t n = t.n[leaf];
  const int64_t begin = (int64_t)(blockIdx.x - t.first[leaf]) * kLeafChunk;
  const int64_t end = begin + kLeafChunk < n ? begin + kLeafChunk : n;
  int64_t scalar = begin;
  if (aligned(out, 16) && aligned(c, 16) && aligned(q, 4)) {
    const int64_t end4 = end & ~(int64_t)3;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t e = begin + 4 * (threadIdx.x + (int64_t)i * kThreads);
      if (e < end4) {
        const float4 a = *reinterpret_cast<const float4*>(c + e);
        const char4 b = *reinterpret_cast<const char4*>(q + e);
        float4 o;
        o.x = dqa1(a.x, b.x, s);
        o.y = dqa1(a.y, b.y, s);
        o.z = dqa1(a.z, b.z, s);
        o.w = dqa1(a.w, b.w, s);
        *reinterpret_cast<float4*>(out + e) = o;
      }
    }
    scalar = end4;
  }
  for (int64_t i = scalar + threadIdx.x; i < end; i += kThreads)
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

// B4 over count leaves: out[i] = c[i] + f32(q[i]) * s[i] for every leaf i
// of n[i] elements (out[i] may be c[i]).  The arrays are the host's; one
// launch per table of up to kLeafCap non-empty leaves, none for a list of
// empty leaves.
extern "C" int dl_dequant_add_leaves_f32(float* const* out,
                                         const float* const* c,
                                         const signed char* const* q,
                                         const int64_t* n, const float* s,
                                         int count, cudaStream_t stream) {
  int launches = 0;
  LeafTable t;
  t.count = 0;
  int64_t blocks = 0;
  for (int i = 0; i <= count; ++i) {
    const int64_t b = i < count ? (n[i] + kLeafChunk - 1) / kLeafChunk : 0;
    if (t.count > 0 && (i == count || t.count == kLeafCap ||
                        blocks + b > INT_MAX)) {
      t.first[t.count] = (int)blocks;
      dequant_add_leaves<<<(int)blocks, kThreads, 0, stream>>>(t);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return -(int)err;
      ++launches;
      t.count = 0;
      blocks = 0;
    }
    if (b == 0) continue;
    t.out[t.count] = out[i];
    t.c[t.count] = c[i];
    t.q[t.count] = q[i];
    t.n[t.count] = n[i];
    t.s[t.count] = s[i];
    t.first[t.count++] = (int)blocks;
    blocks += b;
  }
  return launches;
}

// One leaf: the one-leaf table of dl_dequant_add_leaves_f32.
extern "C" int dl_dequant_add_f32(float* out, const float* c,
                                  const signed char* q, int64_t n, float s,
                                  cudaStream_t stream) {
  return dl_dequant_add_leaves_f32(&out, &c, &q, &n, &s, 1, stream);
}
