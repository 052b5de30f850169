// Flash-attention forward for Hopper (sm_90a).  Built by
// distlearn_tpu_torch/ops/_build.py with nvcc into a shared library with a
// plain C interface, loaded with ctypes.
//
// Replaces the forward Pallas TPU kernel that the JAX package reaches from
// distlearn_tpu/parallel/sequence.py::local_attention(impl="flash"): the
// library kernel _flash_attention_kernel of
// jax/experimental/pallas/ops/tpu/flash_attention.py (its pallas_call in
// _flash_attention_impl).  Both compute
//
//   O = softmax(Q K^T * scale, causal) V
//
// blockwise with an online softmax: a running row max m, row sum l and
// output accumulator, all float32, so the [L, L] score matrix never exists
// in device memory.  As in the Pallas kernel, the scores are the float32 sum
// of products of the input-dtype operands, then scaled; for bfloat16 inputs
// the probabilities P are rounded to bfloat16 before the PV product (the
// Pallas kernel's p.astype(v.dtype)), while l sums the float32 P.  O is
// written in the input dtype.
//
// Layout: q, k, v and o are [B, L, H, D] (the port's layout at
// local_attention), read and written through their batch, row and head
// strides, with the D axis contiguous, so no transpose is launched.
//
// Bound: at the serving shape (B=1, H=16, D=64, L=1024) the function reads
// q, k, v once and writes o once (8.4 MB in bfloat16, 16.8 MB in float32)
// and does 2*B*H*L*L*D = 2.15 GFLOP of causal products: in bfloat16 HBM
// bounds it (2.5 us at 3.35 TB/s against 2.2 us at 989 TFLOP/s), in float32
// the CUDA cores do (32 us at 67 TFLOP/s).
//
// Design (first version: simple and right; wgmma, TMA and warp
// specialisation are later work).  One block of 256 threads per (64-row
// query tile, head, batch); the longest causal rows are scheduled first.
// The query tile stays in shared memory; the block walks 64-row key tiles
// only up to the diagonal (the causal skip), staging K, V and P in shared
// memory, all as float32.  Thread t owns query rows 4*(t/16) .. +3 and, of
// each 64-column tile, the columns t%16 + 16*c: the 16 threads of one row
// group are one half warp, so row max and row sum reduce by shuffles, and
// the same threads own the D/16 output columns t%16 + 16*e, so m and l
// never leave registers.  Head dims 32, 64 and 128 are built: those of the
// repo's LM configurations (dim // heads).  Products are float32 FMAs on the CUDA cores.  K and Q
// rows are padded by one float so that a half warp's column reads hit 16
// distinct banks.  Masked scores are -inf (the Pallas kernel adds
// -0.7*FLT_MAX): the first tile every row processes is key tile 0, whose
// column 0 it always sees, so the row max is finite from then on and a
// masked score gives P = exp(-inf) = 0 exactly, as the finite mask does.
//
// Rounding: expf and the division are the accurate ones (never built with
// --use_fast_math); nvcc may contract the scale and the rescaling into FMAs,
// so the result is held to a tolerance against the plain PyTorch version
// (ops/flash_attention.py), not bit for bit.
//
// The entry point launches on the caller's stream and does not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;        // query rows per block
constexpr int kBN = 64;        // key rows per tile
constexpr int kThreads = 256;  // 16 row groups x 16 column lanes
constexpr int kRows = 4;       // query rows per thread
constexpr int kSCols = 4;      // score columns per thread and tile

struct Strides {
  int64_t b, l, h;
};

// Four consecutive elements as float32 (16-byte or 8-byte aligned loads).
__device__ __forceinline__ void load4(const float* p, float* out) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  out[0] = x.x;
  out[1] = x.y;
  out[2] = x.z;
  out[3] = x.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* out) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  // a bfloat16 is the high half of a float32: widening is exact
  out[0] = __uint_as_float(raw.x << 16);
  out[1] = __uint_as_float(raw.x & 0xffff0000u);
  out[2] = __uint_as_float(raw.y << 16);
  out[3] = __uint_as_float(raw.y & 0xffff0000u);
}

__device__ __forceinline__ float round_p(float p, float) { return p; }
__device__ __forceinline__ float round_p(float p, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(p));
}

__device__ __forceinline__ void store(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float x) {
  *dst = __float2bfloat16_rn(x);
}

// rows x D elements from src (row stride row_stride) into dst (row stride
// ld floats).
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          int64_t row_stride, int rows) {
  constexpr int kVec = D / 4;
  for (int idx = threadIdx.x; idx < rows * kVec; idx += kThreads) {
    const int i = idx / kVec, d = (idx % kVec) * 4;
    float x[4];
    load4(src + i * row_stride + d, x);
    float* p = dst + i * ld + d;
    p[0] = x[0];
    p[1] = x[1];
    p[2] = x[2];
    p[3] = x[3];
  }
}

// max and sum over the 16 lanes of a half warp
__device__ __forceinline__ float max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D>
constexpr int smem_floats() {
  return kBM * (D + 1) + kBN * (D + 1) + kBN * D + kBM * (kBN + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o, int L, Strides sq,
              Strides sk, Strides sv, Strides so, float scale, int causal) {
  constexpr int kLdQK = D + 1;
  constexpr int kLdP = kBN + 1;
  constexpr int kOCols = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;               // [kBM][kLdQK]
  float* ks = qs + kBM * kLdQK;   // [kBN][kLdQK]
  float* vs = ks + kBN * kLdQK;   // [kBN][D]
  float* ps = vs + kBN * D;       // [kBM][kLdP]

  const int tile = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = tile * kBM;
  const int rg = threadIdx.x >> 4, lane = threadIdx.x & 15;
  const int row0 = rg * kRows;

  load_tile<T, D>(qs, kLdQK, q + b * sq.b + q0 * sq.l + h * sq.h, sq.l, kBM);

  float m[kRows], l[kRows], acc[kRows][kOCols];
#pragma unroll
  for (int a = 0; a < kRows; ++a) {
    m[a] = -INFINITY;
    l[a] = 0.f;
#pragma unroll
    for (int e = 0; e < kOCols; ++e) acc[a][e] = 0.f;
  }

  const int n_tiles = causal ? tile + 1 : L / kBN;  // kBM == kBN
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBN;
    __syncthreads();  // the previous tile's reads of K, V and P are done
    load_tile<T, D>(ks, kLdQK, k + b * sk.b + k0 * sk.l + h * sk.h, sk.l, kBN);
    load_tile<T, D>(vs, D, v + b * sv.b + k0 * sv.l + h * sv.h, sv.l, kBN);
    __syncthreads();

    float s[kRows][kSCols];
#pragma unroll
    for (int a = 0; a < kRows; ++a)
#pragma unroll
      for (int c = 0; c < kSCols; ++c) s[a][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[kRows], kv[kSCols];
#pragma unroll
      for (int a = 0; a < kRows; ++a) qv[a] = qs[(row0 + a) * kLdQK + d];
#pragma unroll
      for (int c = 0; c < kSCols; ++c) kv[c] = ks[(lane + 16 * c) * kLdQK + d];
#pragma unroll
      for (int a = 0; a < kRows; ++a)
#pragma unroll
        for (int c = 0; c < kSCols; ++c) s[a][c] = fmaf(qv[a], kv[c], s[a][c]);
    }

    const bool diag = causal && t == tile;
#pragma unroll
    for (int a = 0; a < kRows; ++a) {
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < kSCols; ++c) {
        float x = s[a][c] * scale;
        if (diag && lane + 16 * c > row0 + a) x = -INFINITY;
        s[a][c] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[a], max16(mx));
      const float alpha = expf(m[a] - m_new);  // 0 on the first tile
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < kSCols; ++c) {
        const float p = expf(s[a][c] - m_new);
        sum += p;
        ps[(row0 + a) * kLdP + lane + 16 * c] = round_p(p, T());
      }
      l[a] = l[a] * alpha + sum16(sum);
      m[a] = m_new;
#pragma unroll
      for (int e = 0; e < kOCols; ++e) acc[a][e] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBN; ++j) {
      float pv[kRows], vv[kOCols];
#pragma unroll
      for (int a = 0; a < kRows; ++a) pv[a] = ps[(row0 + a) * kLdP + j];
#pragma unroll
      for (int e = 0; e < kOCols; ++e) vv[e] = vs[j * D + lane + 16 * e];
#pragma unroll
      for (int a = 0; a < kRows; ++a)
#pragma unroll
        for (int e = 0; e < kOCols; ++e)
          acc[a][e] = fmaf(pv[a], vv[e], acc[a][e]);
    }
  }

#pragma unroll
  for (int a = 0; a < kRows; ++a) {
    T* out = o + b * so.b + (int64_t)(q0 + row0 + a) * so.l + h * so.h;
#pragma unroll
    for (int e = 0; e < kOCols; ++e)
      store(out + lane + 16 * e, acc[a][e] / l[a]);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int L,
           int H, Strides sq, Strides sk, Strides sv, Strides so, float scale,
           int causal, cudaStream_t stream) {
  const int smem = smem_floats<D>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return -(int)err;
  const dim3 grid(L / kBM, H, B);
  flash_fwd<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), L, sq, sk, sv, so, scale,
      causal);
  err = cudaGetLastError();
  return err == cudaSuccess ? 1 : -(int)err;
}

}  // namespace

// q, k, v, o: [B, L, H, D] with element strides (batch, row, head) given and
// the D axis contiguous; dtype 0 = float32, 1 = bfloat16; D in {32, 64,
// 128};
// L a multiple of 64; every pointer 16-byte aligned and every stride a
// multiple of 4 (the wrapper checks all of it).  Returns the number of
// kernels launched (1), or -cudaError when a launch was refused
// (-cudaErrorInvalidValue for an unsupported dtype or head dim).
extern "C" int dl_flash_fwd(const void* q, const void* k, const void* v,
                            void* o, int dtype, int B, int L, int H, int D,
                            int64_t qb, int64_t ql, int64_t qh, int64_t kb,
                            int64_t kl, int64_t kh, int64_t vb, int64_t vl,
                            int64_t vh, int64_t ob, int64_t ol, int64_t oh,
                            float scale, int causal, cudaStream_t stream) {
  if (B < 1 || H < 1 || L < kBM || L % kBM != 0)
    return -(int)cudaErrorInvalidValue;
  const Strides sq{qb, ql, qh}, sk{kb, kl, kh}, sv{vb, vl, vh}, so{ob, ol, oh};
#define DL_FLASH_CASE(T, CODE, DIM)                                          \
  if (dtype == CODE && D == DIM)                                             \
    return launch<T, DIM>(q, k, v, o, B, L, H, sq, sk, sv, so, scale, causal, \
                          stream);
  DL_FLASH_CASE(float, 0, 32)
  DL_FLASH_CASE(float, 0, 64)
  DL_FLASH_CASE(float, 0, 128)
  DL_FLASH_CASE(__nv_bfloat16, 1, 32)
  DL_FLASH_CASE(__nv_bfloat16, 1, 64)
  DL_FLASH_CASE(__nv_bfloat16, 1, 128)
#undef DL_FLASH_CASE
  return -(int)cudaErrorInvalidValue;
}
