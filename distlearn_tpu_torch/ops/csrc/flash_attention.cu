// Flash attention, forward and backward, for Hopper (sm_90a).  Built by
// distlearn_tpu_torch/ops/_build.py with nvcc into a shared library with a
// plain C interface, loaded with ctypes.
//
// Replaces the three Pallas TPU kernels that the JAX package reaches from
// distlearn_tpu/parallel/sequence.py::local_attention(impl="flash") and its
// gradient, the library kernels of
// jax/experimental/pallas/ops/tpu/flash_attention.py:
//
//   dl_flash_fwd     (B5a)  _flash_attention_kernel     (its pallas_call in
//                            _flash_attention_impl)
//   dl_flash_bwd_dkv (B5b)  _flash_attention_dkv_kernel (_flash_attention_bwd_dkv)
//   dl_flash_bwd_dq  (B5c)  _flash_attention_dq_kernel  (_flash_attention_bwd_dq)
//
// The forward computes O = softmax(S) V with S = Q K^T * scale (causal or
// not) blockwise with an online softmax: a running row max m, row sum l and
// output accumulator, all float32, so the [L, L] score matrix never exists
// in device memory.  When the caller passes them, it also writes m (the max
// of the row's scaled scores) and l (the sum of exp(s - m) over the row),
// float32 [B, H, L]: the library's residuals l, m without their 128-lane
// broadcast.  The backward recomputes P = exp(s - m) * (1/l) tile by tile
// from them, as the library's backward kernels do (a product with the
// reciprocal of l, not a division by a log-sum-exp), and with
// di = sum_d O * dO per row:
//
//   dS = (dO V^T - di) * P * scale
//   dV = P^T dO      (B5b)    dK = dS^T Q     (B5b)    dQ = dS K     (B5c)
//
// Roundings, as in the Pallas kernels: scores and dO V^T are float32 sums of
// products of the input-dtype operands; for bfloat16 inputs P is rounded to
// bfloat16 before the PV and P^T dO products and dS before the dS^T Q and
// dS K products, while l sums the float32 P; every accumulator is float32
// and the outputs are written in the input dtype.  di is folded into B5c's
// prologue (each B5c block owns its query rows, reads O and dO once and
// writes di for B5b), so B5c runs before B5b on the stream; the library
// computes di with a plain XLA reduction instead.
//
// Layout: q, k, v, o, dO and the gradients are [B, L, H, D] (the port's
// layout at local_attention), read and written through their batch, row and
// head strides with the D axis contiguous, so no transpose is launched.
//
// Work and bound.  With N causal (query, key) pairs (B*H*L*(L+1)/2; B*H*L*L
// without the mask), B5a does 4*D*N flops (two products), B5b 8*D*N (four:
// S, dO V^T, P^T dO, dS^T Q) and B5c 6*D*N (three: S, dO V^T, dS K) plus
// 2*B*H*L*D for di.  At the training shape (B=8, H=16, D=64, L=1024, N =
// 67.2M, bfloat16) that is 17.2, 34.4 and 25.8 GFLOP against 68, 102 and
// 86 MB of compulsory traffic: every kernel sits near the ridge of the
// card's bfloat16 tensor-core rate and its HBM rate, and in float32 the
// CUDA cores bound them (0.26, 0.51, 0.39 ms at 67 TFLOP/s).
//
// Design (first version: simple and right; mma.sync, wgmma, TMA and warp
// specialisation are later work).  Every block has 256 threads and owns one
// 64-row output tile of one (batch, head): a query tile for B5a and B5c, a
// key tile for B5b, as the TPU kernels' grids own theirs, so no two blocks
// write one element, there are no floating-point atomics, and every
// gradient is the same bit for bit from run to run.  A block walks the
// other operand's 64-row tiles itself (the loop that replaces the TPU's
// sequential grid axis): B5a and B5c the key tiles up to the diagonal, B5b
// the query tiles from the diagonal to the end (the causal skip, at tile
// level).  Tiles are staged in shared memory as float32.  For a 64x64 score
// tile, thread t owns rows 4*(t/16) .. +3 and columns t%16 + 16*c: the 16
// threads of one row group are one half warp, so row max and row sum reduce
// by shuffles.  For a 64xD output tile the same thread owns rows
// 4*(t/16) .. +3 and columns t%16 + 16*e.  Head dims 32, 64 and 128 are
// built: those of the repo's LM configurations (dim // heads).  Products
// are float32 FMAs on the CUDA cores.  Tiles read down a column are padded
// by one float so that a half warp's reads hit 16 distinct banks.
//
// Masking: masked scores are -inf in the forward and P = 0 in the backward
// (the Pallas kernels add -0.7*FLT_MAX): every row sees key column 0, so the
// row max is finite and exp of a masked score is exactly 0 either way.
//
// Rounding: expf and the divisions are the accurate ones (never built with
// --use_fast_math); nvcc may contract sums of products into FMAs and sums
// run in another order than the plain PyTorch versions'
// (ops/flash_attention.py), so each kernel is held to a tolerance against
// them, not bit for bit.
//
// The entry points launch on the caller's stream and do not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;        // rows of a block's own tile
constexpr int kBN = 64;        // rows of a tile it walks over
constexpr int kThreads = 256;  // 16 row groups x 16 column lanes
constexpr int kRows = 4;       // tile rows per thread
constexpr int kSCols = 4;      // score columns per thread and tile
constexpr int kLdS = kBN + 1;  // padded row of a 64x64 score tile

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

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// x rounded to the input dtype and widened back (P and dS before their
// products)
__device__ __forceinline__ float round_to(float x, float) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(x));
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

// The 64x64 tile products a (row) · b (column) over D, two at once: for
// this thread's rows row0 .. +3 and columns lane + 16*c, x = A1 B1^T and
// y = A2 B2^T (raw sums, unscaled).  A1, A2 are [64][ld] read along a row
// (a broadcast within the half warp), B1, B2 [64][ld] read down a column
// (ld = D + 1: 16 distinct banks).
template <int D>
__device__ __forceinline__ void tile_products2(
    const float* a1, const float* b1, const float* a2, const float* b2,
    int row0, int lane, float (&x)[kRows][kSCols],
    float (&y)[kRows][kSCols]) {
  constexpr int kLd = D + 1;
#pragma unroll
  for (int a = 0; a < kRows; ++a)
#pragma unroll
    for (int c = 0; c < kSCols; ++c) x[a][c] = y[a][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float av1[kRows], av2[kRows], bv1[kSCols], bv2[kSCols];
#pragma unroll
    for (int a = 0; a < kRows; ++a) {
      av1[a] = a1[(row0 + a) * kLd + d];
      av2[a] = a2[(row0 + a) * kLd + d];
    }
#pragma unroll
    for (int c = 0; c < kSCols; ++c) {
      bv1[c] = b1[(lane + 16 * c) * kLd + d];
      bv2[c] = b2[(lane + 16 * c) * kLd + d];
    }
#pragma unroll
    for (int a = 0; a < kRows; ++a)
#pragma unroll
      for (int c = 0; c < kSCols; ++c) {
        x[a][c] = fmaf(av1[a], bv1[c], x[a][c]);
        y[a][c] = fmaf(av2[a], bv2[c], y[a][c]);
      }
  }
}

// ---------------------------------------------------------------------------
// B5a: forward
// ---------------------------------------------------------------------------

template <int D>
constexpr int fwd_smem_floats() {
  return kBM * (D + 1) + kBN * (D + 1) + kBN * D + kBM * kLdS;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o,
              float* __restrict__ m_out, float* __restrict__ l_out, int L,
              Strides sq, Strides sk, Strides sv, Strides so, float scale,
              int causal) {
  constexpr int kLdQK = D + 1;
  constexpr int kOCols = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;               // [kBM][kLdQK]
  float* ks = qs + kBM * kLdQK;   // [kBN][kLdQK]
  float* vs = ks + kBN * kLdQK;   // [kBN][D]
  float* ps = vs + kBN * D;       // [kBM][kLdS]

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
        ps[(row0 + a) * kLdS + lane + 16 * c] = round_to(p, T());
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
      for (int a = 0; a < kRows; ++a) pv[a] = ps[(row0 + a) * kLdS + j];
#pragma unroll
      for (int e = 0; e < kOCols; ++e) vv[e] = vs[j * D + lane + 16 * e];
#pragma unroll
      for (int a = 0; a < kRows; ++a)
#pragma unroll
        for (int e = 0; e < kOCols; ++e)
          acc[a][e] = fmaf(pv[a], vv[e], acc[a][e]);
    }
  }

  const int64_t stat0 = ((int64_t)b * gridDim.y + h) * L + q0 + row0;
#pragma unroll
  for (int a = 0; a < kRows; ++a) {
    T* out = o + b * so.b + (int64_t)(q0 + row0 + a) * so.l + h * so.h;
#pragma unroll
    for (int e = 0; e < kOCols; ++e)
      store(out + lane + 16 * e, acc[a][e] / l[a]);
    if (m_out != nullptr && lane == 0) {
      m_out[stat0 + a] = m[a];
      l_out[stat0 + a] = l[a];
    }
  }
}

// ---------------------------------------------------------------------------
// B5c: dQ (and di), one block per query tile
// ---------------------------------------------------------------------------

template <int D>
constexpr int dq_smem_floats() {
  return 4 * kBM * (D + 1) + kBM * kLdS;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ o,
                 const T* __restrict__ dout, const float* __restrict__ m_in,
                 const float* __restrict__ l_in, T* __restrict__ dq,
                 float* __restrict__ di_out, int L, Strides sq, Strides sk,
                 Strides sv, Strides so, Strides sdo, Strides sdq, float scale,
                 int causal) {
  constexpr int kLd = D + 1;
  constexpr int kOCols = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;              // [kBM][kLd]
  float* dos = qs + kBM * kLd;   // [kBM][kLd]
  float* ks = dos + kBM * kLd;   // [kBN][kLd]
  float* vs = ks + kBN * kLd;    // [kBN][kLd]
  float* dss = vs + kBN * kLd;   // [kBM][kLdS]

  const int tile = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = tile * kBM;
  const int rg = threadIdx.x >> 4, lane = threadIdx.x & 15;
  const int row0 = rg * kRows;

  load_tile<T, D>(qs, kLd, q + b * sq.b + q0 * sq.l + h * sq.h, sq.l, kBM);
  load_tile<T, D>(dos, kLd, dout + b * sdo.b + q0 * sdo.l + h * sdo.h, sdo.l,
                  kBM);
  __syncthreads();

  // the prologue: di = sum_d O * dO of this thread's rows, and m, 1/l
  const int64_t stat0 = ((int64_t)b * gridDim.y + h) * L + q0 + row0;
  float mrow[kRows], inv_l[kRows], di[kRows];
#pragma unroll
  for (int a = 0; a < kRows; ++a) {
    const T* orow = o + b * so.b + (int64_t)(q0 + row0 + a) * so.l + h * so.h;
    float part = 0.f;
#pragma unroll
    for (int e = 0; e < kOCols; ++e)
      part = fmaf(to_float(orow[lane + 16 * e]),
                  dos[(row0 + a) * kLd + lane + 16 * e], part);
    di[a] = sum16(part);
    mrow[a] = m_in[stat0 + a];
    inv_l[a] = 1.f / l_in[stat0 + a];
    if (lane == 0) di_out[stat0 + a] = di[a];
  }

  float acc[kRows][kOCols];
#pragma unroll
  for (int a = 0; a < kRows; ++a)
#pragma unroll
    for (int e = 0; e < kOCols; ++e) acc[a][e] = 0.f;

  const int n_tiles = causal ? tile + 1 : L / kBN;  // kBM == kBN
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBN;
    __syncthreads();  // the previous tile's reads of K, V and dS are done
    load_tile<T, D>(ks, kLd, k + b * sk.b + k0 * sk.l + h * sk.h, sk.l, kBN);
    load_tile<T, D>(vs, kLd, v + b * sv.b + k0 * sv.l + h * sv.h, sv.l, kBN);
    __syncthreads();

    float s[kRows][kSCols], dp[kRows][kSCols];
    tile_products2<D>(qs, ks, dos, vs, row0, lane, s, dp);
    const bool diag = causal && t == tile;
#pragma unroll
    for (int a = 0; a < kRows; ++a)
#pragma unroll
      for (int c = 0; c < kSCols; ++c) {
        float ds = 0.f;
        if (!(diag && lane + 16 * c > row0 + a)) {
          const float p = expf(__fmul_rn(s[a][c], scale) - mrow[a]) * inv_l[a];
          ds = (dp[a][c] - di[a]) * p * scale;
        }
        dss[(row0 + a) * kLdS + lane + 16 * c] = round_to(ds, T());
      }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBN; ++j) {
      float dsv[kRows], kv[kOCols];
#pragma unroll
      for (int a = 0; a < kRows; ++a) dsv[a] = dss[(row0 + a) * kLdS + j];
#pragma unroll
      for (int e = 0; e < kOCols; ++e) kv[e] = ks[j * kLd + lane + 16 * e];
#pragma unroll
      for (int a = 0; a < kRows; ++a)
#pragma unroll
        for (int e = 0; e < kOCols; ++e)
          acc[a][e] = fmaf(dsv[a], kv[e], acc[a][e]);
    }
  }

#pragma unroll
  for (int a = 0; a < kRows; ++a) {
    T* out = dq + b * sdq.b + (int64_t)(q0 + row0 + a) * sdq.l + h * sdq.h;
#pragma unroll
    for (int e = 0; e < kOCols; ++e) store(out + lane + 16 * e, acc[a][e]);
  }
}

// ---------------------------------------------------------------------------
// B5b: dK and dV, one block per key tile
// ---------------------------------------------------------------------------

template <int D>
constexpr int dkv_smem_floats() {
  return 4 * kBM * (D + 1) + 2 * kBM * kLdS + 3 * kBM;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float* __restrict__ m_in,
                  const float* __restrict__ l_in,
                  const float* __restrict__ di_in, T* __restrict__ dk,
                  T* __restrict__ dv, int L, Strides sq, Strides sk,
                  Strides sv, Strides sdo, Strides sdk, Strides sdv,
                  float scale, int causal) {
  constexpr int kLd = D + 1;
  constexpr int kOCols = D / 16;
  extern __shared__ float smem[];
  float* ks = smem;              // [kBN][kLd]
  float* vs = ks + kBN * kLd;    // [kBN][kLd]
  float* qs = vs + kBN * kLd;    // [kBM][kLd]
  float* dos = qs + kBM * kLd;   // [kBM][kLd]
  float* ps = dos + kBM * kLd;   // [kBM][kLdS]: P[query][key]
  float* dss = ps + kBM * kLdS;  // [kBM][kLdS]: dS[query][key]
  float* ms = dss + kBM * kLdS;  // [kBM]: m of the query tile's rows
  float* ils = ms + kBM;         // [kBM]: 1/l
  float* dis = ils + kBM;        // [kBM]: di

  const int kt = blockIdx.x;  // key tile 0 walks the most query tiles
  const int h = blockIdx.y, b = blockIdx.z;
  const int k0 = kt * kBN;
  const int rg = threadIdx.x >> 4, lane = threadIdx.x & 15;
  const int row0 = rg * kRows;

  load_tile<T, D>(ks, kLd, k + b * sk.b + k0 * sk.l + h * sk.h, sk.l, kBN);
  load_tile<T, D>(vs, kLd, v + b * sv.b + k0 * sv.l + h * sv.h, sv.l, kBN);

  // dV and dK of key rows k0 + row0 .. +3, columns lane + 16*e
  float acc_dk[kRows][kOCols], acc_dv[kRows][kOCols];
#pragma unroll
  for (int a = 0; a < kRows; ++a)
#pragma unroll
    for (int e = 0; e < kOCols; ++e) acc_dk[a][e] = acc_dv[a][e] = 0.f;

  const int64_t stat_bh = ((int64_t)b * gridDim.y + h) * L;
  const int n_q = L / kBM;
  for (int j = causal ? kt : 0; j < n_q; ++j) {  // kBM == kBN
    const int q0 = j * kBM;
    __syncthreads();  // the previous tile's reads of Q, dO, P and dS are done
    load_tile<T, D>(qs, kLd, q + b * sq.b + q0 * sq.l + h * sq.h, sq.l, kBM);
    load_tile<T, D>(dos, kLd, dout + b * sdo.b + q0 * sdo.l + h * sdo.h,
                    sdo.l, kBM);
    if (threadIdx.x < kBM) {
      ms[threadIdx.x] = m_in[stat_bh + q0 + threadIdx.x];
      ils[threadIdx.x] = 1.f / l_in[stat_bh + q0 + threadIdx.x];
      dis[threadIdx.x] = di_in[stat_bh + q0 + threadIdx.x];
    }
    __syncthreads();

    // rows: this thread's query rows row0 .. +3; columns: keys lane + 16*c
    float s[kRows][kSCols], dp[kRows][kSCols];
    tile_products2<D>(qs, ks, dos, vs, row0, lane, s, dp);
    const bool diag = causal && j == kt;
#pragma unroll
    for (int a = 0; a < kRows; ++a)
#pragma unroll
      for (int c = 0; c < kSCols; ++c) {
        float p = 0.f, ds = 0.f;
        if (!(diag && lane + 16 * c > row0 + a)) {
          p = expf(__fmul_rn(s[a][c], scale) - ms[row0 + a]) * ils[row0 + a];
          ds = (dp[a][c] - dis[row0 + a]) * p * scale;
        }
        ps[(row0 + a) * kLdS + lane + 16 * c] = round_to(p, T());
        dss[(row0 + a) * kLdS + lane + 16 * c] = round_to(ds, T());
      }
    __syncthreads();

    // rows: this thread's key rows row0 .. +3; the sum runs over queries
#pragma unroll 4
    for (int i = 0; i < kBM; ++i) {
      float pv[kRows], dsv[kRows], dov[kOCols], qv[kOCols];
#pragma unroll
      for (int a = 0; a < kRows; ++a) {
        pv[a] = ps[i * kLdS + row0 + a];
        dsv[a] = dss[i * kLdS + row0 + a];
      }
#pragma unroll
      for (int e = 0; e < kOCols; ++e) {
        dov[e] = dos[i * kLd + lane + 16 * e];
        qv[e] = qs[i * kLd + lane + 16 * e];
      }
#pragma unroll
      for (int a = 0; a < kRows; ++a)
#pragma unroll
        for (int e = 0; e < kOCols; ++e) {
          acc_dv[a][e] = fmaf(pv[a], dov[e], acc_dv[a][e]);
          acc_dk[a][e] = fmaf(dsv[a], qv[e], acc_dk[a][e]);
        }
    }
  }

#pragma unroll
  for (int a = 0; a < kRows; ++a) {
    const int64_t row = k0 + row0 + a;
    T* out_k = dk + b * sdk.b + row * sdk.l + h * sdk.h;
    T* out_v = dv + b * sdv.b + row * sdv.l + h * sdv.h;
#pragma unroll
    for (int e = 0; e < kOCols; ++e) {
      store(out_k + lane + 16 * e, acc_dk[a][e]);
      store(out_v + lane + 16 * e, acc_dv[a][e]);
    }
  }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

// Sets the kernel's dynamic shared memory and launches it over
// (L / 64, H, B) blocks; returns 1 (kernels launched) or -cudaError.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, int smem_floats, int B, int L, int H,
           cudaStream_t stream, Args... args) {
  const int smem = smem_floats * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return -(int)err;
  kernel<<<dim3(L / kBM, H, B), kThreads, smem, stream>>>(args...);
  err = cudaGetLastError();
  return err == cudaSuccess ? 1 : -(int)err;
}

bool shape_ok(int B, int L, int H) {
  return B >= 1 && H >= 1 && L >= kBM && L % kBM == 0;
}

}  // namespace

#define DL_FLASH_DISPATCH(BODY)                          \
  if (dtype == 0 && D == 32) { BODY(float, 32) }         \
  if (dtype == 0 && D == 64) { BODY(float, 64) }         \
  if (dtype == 0 && D == 128) { BODY(float, 128) }       \
  if (dtype == 1 && D == 32) { BODY(__nv_bfloat16, 32) } \
  if (dtype == 1 && D == 64) { BODY(__nv_bfloat16, 64) } \
  if (dtype == 1 && D == 128) { BODY(__nv_bfloat16, 128) }

// Every entry point: tensors [B, L, H, D] with element strides (batch, row,
// head) given and the D axis contiguous; m, l and di float32 [B, H, L],
// contiguous; dtype 0 = float32, 1 = bfloat16; D in {32, 64, 128}; L a
// multiple of 64; every pointer 16-byte aligned and every stride a multiple
// of 4 (the wrapper checks all of it).  Each returns the number of kernels
// launched (1), or -cudaError when a launch was refused
// (-cudaErrorInvalidValue for an unsupported dtype, head dim or length).

// B5a.  m_out and l_out may both be null (no residuals: the serving path).
extern "C" int dl_flash_fwd(const void* q, const void* k, const void* v,
                            void* o, void* m_out, void* l_out, int dtype,
                            int B, int L, int H, int D, int64_t qb,
                            int64_t ql, int64_t qh, int64_t kb, int64_t kl,
                            int64_t kh, int64_t vb, int64_t vl, int64_t vh,
                            int64_t ob, int64_t ol, int64_t oh, float scale,
                            int causal, cudaStream_t stream) {
  if (!shape_ok(B, L, H)) return -(int)cudaErrorInvalidValue;
  const Strides sq{qb, ql, qh}, sk{kb, kl, kh}, sv{vb, vl, vh}, so{ob, ol, oh};
#define DL_FWD(T, DIM)                                                       \
  return launch(flash_fwd<T, DIM>, fwd_smem_floats<DIM>(), B, L, H, stream, \
                static_cast<const T*>(q), static_cast<const T*>(k),         \
                static_cast<const T*>(v), static_cast<T*>(o),               \
                static_cast<float*>(m_out), static_cast<float*>(l_out), L,  \
                sq, sk, sv, so, scale, causal);
  DL_FLASH_DISPATCH(DL_FWD)
#undef DL_FWD
  return -(int)cudaErrorInvalidValue;
}

// B5c.  Writes dq and di (for B5b, which runs after it).
extern "C" int dl_flash_bwd_dq(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* m, const void* l, void* dq, void* di,
    int dtype, int B, int L, int H, int D, int64_t qb, int64_t ql,
    int64_t qh, int64_t kb, int64_t kl, int64_t kh, int64_t vb, int64_t vl,
    int64_t vh, int64_t ob, int64_t ol, int64_t oh, int64_t dob, int64_t dol,
    int64_t doh, int64_t dqb, int64_t dql, int64_t dqh, float scale,
    int causal, cudaStream_t stream) {
  if (!shape_ok(B, L, H)) return -(int)cudaErrorInvalidValue;
  const Strides sq{qb, ql, qh}, sk{kb, kl, kh}, sv{vb, vl, vh}, so{ob, ol, oh},
      sdo{dob, dol, doh}, sdq{dqb, dql, dqh};
#define DL_DQ(T, DIM)                                                         \
  return launch(flash_bwd_dq<T, DIM>, dq_smem_floats<DIM>(), B, L, H, stream, \
                static_cast<const T*>(q), static_cast<const T*>(k),           \
                static_cast<const T*>(v), static_cast<const T*>(o),           \
                static_cast<const T*>(dout), static_cast<const float*>(m),    \
                static_cast<const float*>(l), static_cast<T*>(dq),            \
                static_cast<float*>(di), L, sq, sk, sv, so, sdo, sdq, scale,  \
                causal);
  DL_FLASH_DISPATCH(DL_DQ)
#undef DL_DQ
  return -(int)cudaErrorInvalidValue;
}

// B5b.  Reads the di that B5c wrote.
extern "C" int dl_flash_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* m, const void* l, const void* di, void* dk, void* dv,
    int dtype, int B, int L, int H, int D, int64_t qb, int64_t ql,
    int64_t qh, int64_t kb, int64_t kl, int64_t kh, int64_t vb, int64_t vl,
    int64_t vh, int64_t dob, int64_t dol, int64_t doh, int64_t dkb,
    int64_t dkl, int64_t dkh, int64_t dvb, int64_t dvl, int64_t dvh,
    float scale, int causal, cudaStream_t stream) {
  if (!shape_ok(B, L, H)) return -(int)cudaErrorInvalidValue;
  const Strides sq{qb, ql, qh}, sk{kb, kl, kh}, sv{vb, vl, vh},
      sdo{dob, dol, doh}, sdk{dkb, dkl, dkh}, sdv{dvb, dvl, dvh};
#define DL_DKV(T, DIM)                                                       \
  return launch(flash_bwd_dkv<T, DIM>, dkv_smem_floats<DIM>(), B, L, H,      \
                stream, static_cast<const T*>(q), static_cast<const T*>(k),  \
                static_cast<const T*>(v), static_cast<const T*>(dout),       \
                static_cast<const float*>(m), static_cast<const float*>(l),  \
                static_cast<const float*>(di), static_cast<T*>(dk),          \
                static_cast<T*>(dv), L, sq, sk, sv, sdo, sdk, sdv, scale,    \
                causal);
  DL_FLASH_DISPATCH(DL_DKV)
#undef DL_DKV
  return -(int)cudaErrorInvalidValue;
}
#undef DL_FLASH_DISPATCH
