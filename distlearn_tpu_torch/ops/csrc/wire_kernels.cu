// The int8 wire codec of the AsyncEA parameter server, for Hopper (sm_90a).
// Built by distlearn_tpu_torch/ops/_build.py with nvcc into a shared library
// with a plain C interface, loaded with ctypes.
//
// Replaces the Pallas TPU kernels of distlearn_tpu/ops/wire_kernels.py:
//   dl_amax_leaves_f32    <- _amax_call (the max|x| reduction before the
//                            codec), every leaf of a delta in one launch
//   dl_quant_ef_leaves_f32 <- _quant_ef_call / _quant_ef_kernel
//                            q = rint(x / s) as int8, r = x - f32(q) * s,
//                            every leaf in one launch, s from the amax on
//                            the device (no host round trip between them)
//   dl_dequant_add_leaves_f32 <- _dequant_add_call / _dequant_add_kernel
//                        out = c + f32(q) * s  (out may be c), every leaf
//                        of a delta in one launch; dl_dequant_add_f32 is
//                        its one-leaf case
//
// Bound: all three are streams with a few float operations per element, far
// below the card's compute rate, so HBM bandwidth bounds them.  Over the
// full-width CIFAR-10 convnet's delta (4,328,970 floats, 18 leaves) B3 reads
// x (17.3 MB) and writes q (4.3 MB) and r (17.3 MB): 39.0 MB, 11.6 us at the
// H100 SXM's 3.35 TB/s.  This design reads x twice (once in the amax, once
// in the quantize); the second read finds x in the 50 MB L2.  The
// dequantize-add reads c and q and writes c: 39.0 MB, 11.6 us.
//
// Design: the TPU kernels walk (256, 128) VMEM blocks padded to the int8
// (32, 128) tile, one call per leaf; here each pass takes all the leaves of
// a delta in one launch (the per-leaf launches, and B3's host round trip
// for the scales between its two passes, cost 5x the kernels' busy time in
// host calls).  The client encodes a delta with one memset, two launches
// and one synchronize, which also brings the amax slots to the host with
// the frame; the server applies it with one launch.
//
// The amax reduces the bit patterns of |x| as unsigned integers: for
// non-negative floats the integer order is the float order, and every NaN
// (any payload, the sign cleared by fabsf) lies above +inf, so a NaN anywhere
// in the leaf makes the result NaN -- the propagation fmaxf would drop.  Max
// is exact and order-free, so per-block maxima combined by atomicMax give the
// same bits as any sequential reduction.  The quantize computes the scale
// from the slot as the reference codec does (amax / 127.0 in double), then
// rounds it to float; the host reads the slots, raises on a non-finite
// value and puts the same double scale in the manifest.
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

// Every kernel here takes the leaves of a delta from a table that rides in
// its parameters (__grid_constant__: no copy to local memory) and gives
// each leaf a run of blocks: leaf i owns blocks first[i] .. first[i + 1] - 1
// (a prefix sum the host computes), and each block takes kLeafChunk
// consecutive elements of its leaf, 4 float4 a thread (B3's passes issue
// all of a thread's loads before any compute).  A leaf whose pointers are aligned for it moves 4
// elements a thread with one float4 (and one char4) access, and its last
// block takes the tail of a length that is not a multiple of 4 one element
// at a time; any other leaf takes the scalar loop.  One launch per table of
// up to kLeafCap non-empty leaves.
constexpr int kLeafCap = 64;
constexpr int kLeafChunk = 4 * 4 * kThreads;  // 4 float4 a thread

struct AmaxTable {  // B3's first pass
  const float* x[kLeafCap];
  int64_t n[kLeafCap];
  int slot[kLeafCap];  // the leaf's index in the delta: its amax slot
  int first[kLeafCap + 1];  // first[count]: the grid
  int count;
};

struct QuantTable {  // B3's second pass
  signed char* q[kLeafCap];
  float* r[kLeafCap];
  const float* x[kLeafCap];
  int64_t n[kLeafCap];
  int slot[kLeafCap];
  int first[kLeafCap + 1];
  int count;
};

struct LeafTable {  // B4
  float* out[kLeafCap];
  const float* c[kLeafCap];
  const signed char* q[kLeafCap];
  int64_t n[kLeafCap];
  float s[kLeafCap];
  int first[kLeafCap + 1];
  int count;
};

__host__ __device__ __forceinline__ bool aligned(const void* p,
                                                 uintptr_t bytes) {
  return ((uintptr_t)p & (bytes - 1)) == 0;
}

// The last leaf whose first block is at or below this block.
__device__ __forceinline__ int leaf_of(const int* first, int count) {
  int leaf = 0, hi = count - 1;
  while (leaf < hi) {
    const int mid = (leaf + hi + 1) >> 1;
    if (first[mid] <= (int)blockIdx.x)
      leaf = mid;
    else
      hi = mid - 1;
  }
  return leaf;
}

// ---------------------------------------------------------------------------
// B3, first pass: amax of |x| as the unsigned bits of a non-negative float
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned int abs_bits(float x) {
  return __float_as_uint(fabsf(x));
}

// Plain loads: the quantize pass reads x again right after, from the L2.
__global__ void __launch_bounds__(kThreads)
    amax_leaves(const __grid_constant__ AmaxTable t,
                unsigned int* __restrict__ slots) {
  const int leaf = leaf_of(t.first, t.count);
  const float* x = t.x[leaf];
  const int64_t n = t.n[leaf];
  const int64_t begin = (int64_t)(blockIdx.x - t.first[leaf]) * kLeafChunk;
  const int64_t end = begin + kLeafChunk < n ? begin + kLeafChunk : n;
  unsigned int m = 0u;
  int64_t scalar = begin;
  if (aligned(x, 16)) {
    const int64_t end4 = end & ~(int64_t)3;
    float4 v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t e = begin + 4 * (threadIdx.x + (int64_t)i * kThreads);
      if (e < end4) v[i] = *reinterpret_cast<const float4*>(x + e);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t e = begin + 4 * (threadIdx.x + (int64_t)i * kThreads);
      if (e < end4)
        m = max(m, max(max(abs_bits(v[i].x), abs_bits(v[i].y)),
                       max(abs_bits(v[i].z), abs_bits(v[i].w))));
    }
    scalar = end4;
  }
  for (int64_t i = scalar + threadIdx.x; i < end; i += kThreads)
    m = max(m, abs_bits(x[i]));
  m = __reduce_max_sync(0xffffffffu, m);
  __shared__ unsigned int warp_max[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < kThreads / 32 ? warp_max[lane] : 0u;
    m = __reduce_max_sync(0xffffffffu, m);
    if (lane == 0) atomicMax(slots + t.slot[leaf], m);
  }
}

// ---------------------------------------------------------------------------
// B3, second pass: quantize with error feedback, the scale from the slots
// ---------------------------------------------------------------------------

__device__ __forceinline__ signed char qef1(float x, float s, bool zero,
                                            float* r) {
  if (zero) {  // q = 0 decodes to 0: the whole value carries, bit for bit
    *r = x;
    return 0;
  }
  int q = __float2int_rn(__fdiv_rn(x, s));
  *r = __fsub_rn(x, __fmul_rn((float)q, s));
  return (signed char)q;
}

__global__ void __launch_bounds__(kThreads)
    quant_ef_leaves(const __grid_constant__ QuantTable t,
                    const unsigned int* __restrict__ slots) {
  const int leaf = leaf_of(t.first, t.count);
  const int slot = t.slot[leaf];
  // The JAX route encodes leaf by leaf and stops at the first non-finite
  // one: a block writes only if no leaf of the delta up to its own has a
  // non-finite amax (bits at or above +inf's).
  int bad = 0;
  for (int j = threadIdx.x; j <= slot; j += kThreads)
    bad |= slots[j] >= 0x7f800000u;
  if (__syncthreads_or(bad)) return;
  const unsigned int bits = slots[slot];
  const bool zero = bits == 0u;
  // the host's f32(amax / 127.0): one division in double, one rounding
  const float s =
      __double2float_rn(__ddiv_rn((double)__uint_as_float(bits), 127.0));
  signed char* q = t.q[leaf];
  float* r = t.r[leaf];
  const float* x = t.x[leaf];
  const int64_t n = t.n[leaf];
  const int64_t begin = (int64_t)(blockIdx.x - t.first[leaf]) * kLeafChunk;
  const int64_t end = begin + kLeafChunk < n ? begin + kLeafChunk : n;
  int64_t scalar = begin;
  if (aligned(x, 16) && aligned(r, 16)) {
    const int64_t end4 = end & ~(int64_t)3;
    const bool q4 = aligned(q, 4);  // q windows sit at any byte offset
    float4 v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t e = begin + 4 * (threadIdx.x + (int64_t)i * kThreads);
      if (e < end4) v[i] = __ldcs(reinterpret_cast<const float4*>(x + e));
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t e = begin + 4 * (threadIdx.x + (int64_t)i * kThreads);
      if (e < end4) {
        float4 rr;
        char4 qq;
        qq.x = qef1(v[i].x, s, zero, &rr.x);
        qq.y = qef1(v[i].y, s, zero, &rr.y);
        qq.z = qef1(v[i].z, s, zero, &rr.z);
        qq.w = qef1(v[i].w, s, zero, &rr.w);
        __stcs(reinterpret_cast<float4*>(r + e), rr);
        if (q4) {
          *reinterpret_cast<char4*>(q + e) = qq;
        } else {
          q[e] = qq.x;
          q[e + 1] = qq.y;
          q[e + 2] = qq.z;
          q[e + 3] = qq.w;
        }
      }
    }
    scalar = end4;
  }
  for (int64_t i = scalar + threadIdx.x; i < end; i += kThreads)
    q[i] = qef1(x[i], s, zero, &r[i]);
}

// ---------------------------------------------------------------------------
// B4: dequantize and add.  out may alias c: each element is read and
// written by the same thread.
// ---------------------------------------------------------------------------

__device__ __forceinline__ float dqa1(float c, signed char q, float s) {
  return __fadd_rn(c, __fmul_rn((float)q, s));
}

__global__ void __launch_bounds__(kThreads)
    dequant_add_leaves(const __grid_constant__ LeafTable t) {
  const int leaf = leaf_of(t.first, t.count);
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

// Packs the count leaves of n[] into tables of up to kLeafCap non-empty
// leaves (fill(t, j, i) puts leaf i in row j) and launches each with
// launch(t, blocks).  Returns the number of kernels launched (none for a
// list of empty leaves), or -cudaError when a launch was refused.
template <typename Table, typename Fill, typename Launch>
int launch_tables(const int64_t* n, int count, Fill fill, Launch launch) {
  int launches = 0;
  Table t;
  t.count = 0;
  int64_t blocks = 0;
  for (int i = 0; i <= count; ++i) {
    const int64_t b = i < count ? (n[i] + kLeafChunk - 1) / kLeafChunk : 0;
    if (t.count > 0 && (i == count || t.count == kLeafCap ||
                        blocks + b > INT_MAX)) {
      t.first[t.count] = (int)blocks;
      launch(t, (int)blocks);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return -(int)err;
      ++launches;
      t.count = 0;
      blocks = 0;
    }
    if (b == 0) continue;
    fill(t, t.count, i);
    t.n[t.count] = n[i];
    t.first[t.count++] = (int)blocks;
    blocks += b;
  }
  return launches;
}

}  // namespace

// B3's first pass over count leaves: slots[i] = the bits of max|x[i]| (NaN
// bits if x[i] holds a NaN; 0 for an empty leaf).  The slots are zeroed
// here by one memset for all count leaves.
extern "C" int dl_amax_leaves_f32(unsigned int* slots, const float* const* x,
                                  const int64_t* n, int count,
                                  cudaStream_t stream) {
  if (count <= 0) return 0;
  const cudaError_t err =
      cudaMemsetAsync(slots, 0, sizeof(unsigned int) * count, stream);
  if (err != cudaSuccess) return -(int)err;
  return launch_tables<AmaxTable>(
      n, count,
      [&](AmaxTable& t, int j, int i) {
        t.x[j] = x[i];
        t.slot[j] = i;
      },
      [&](const AmaxTable& t, int blocks) {
        amax_leaves<<<blocks, kThreads, 0, stream>>>(t, slots);
      });
}

// B3's second pass over the same count leaves, after dl_amax_leaves_f32 on
// the same stream filled slots: q[i] = rint(x[i] / s_i) as int8 and r[i] =
// x[i] - f32(q[i]) * s_i with s_i = f32(amax_i / 127.0) computed here, q =
// 0 and r = x where amax_i = 0.  Leaves from the first one with a
// non-finite amax on are not written (the host raises).
extern "C" int dl_quant_ef_leaves_f32(signed char* const* q, float* const* r,
                                      const float* const* x, const int64_t* n,
                                      const unsigned int* slots, int count,
                                      cudaStream_t stream) {
  return launch_tables<QuantTable>(
      n, count,
      [&](QuantTable& t, int j, int i) {
        t.q[j] = q[i];
        t.r[j] = r[i];
        t.x[j] = x[i];
        t.slot[j] = i;
      },
      [&](const QuantTable& t, int blocks) {
        quant_ef_leaves<<<blocks, kThreads, 0, stream>>>(t, slots);
      });
}

// B4 over count leaves: out[i] = c[i] + f32(q[i]) * s[i] for every leaf i
// of n[i] elements (out[i] may be c[i]).
extern "C" int dl_dequant_add_leaves_f32(float* const* out,
                                         const float* const* c,
                                         const signed char* const* q,
                                         const int64_t* n, const float* s,
                                         int count, cudaStream_t stream) {
  return launch_tables<LeafTable>(
      n, count,
      [&](LeafTable& t, int j, int i) {
        t.out[j] = out[i];
        t.c[j] = c[i];
        t.q[j] = q[i];
        t.s[j] = s[i];
      },
      [&](const LeafTable& t, int blocks) {
        dequant_add_leaves<<<blocks, kThreads, 0, stream>>>(t);
      });
}

// One leaf: the one-leaf table of dl_dequant_add_leaves_f32.
extern "C" int dl_dequant_add_f32(float* out, const float* c,
                                  const signed char* q, int64_t n, float s,
                                  cudaStream_t stream) {
  return dl_dequant_add_leaves_f32(&out, &c, &q, &n, &s, 1, stream);
}
