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
// 67.2M) that is 17.2, 34.4 and 25.8 GFLOP against 68, 102 and 102 MB of
// compulsory traffic (bfloat16 tensors, float32 m, l, di).  On the card's
// bfloat16 tensor cores (989 TFLOP/s) and HBM (3.35 TB/s) the bounds are
// 0.0203 ms (B5a, bytes), 0.0348 ms (B5b, operations) and 0.0305 ms (B5c,
// bytes): every kernel sits near the ridge, so in bfloat16 only the tensor
// cores can approach its bound.  In float32 the CUDA cores bound them
// (0.26, 0.51, 0.39 ms at 67 TFLOP/s).
//
// Which kernel runs where:
//
//   bfloat16 B5a  flash_fwd_mma      tensor cores (mma.sync m16n8k16)
//   bfloat16 B5b  flash_bwd_dkv_mma  tensor cores (mma.sync m16n8k16)
//   bfloat16 B5c  flash_bwd_dq_mma   tensor cores (mma.sync m16n8k16)
//   float32 B5a, B5b, B5c            CUDA cores: on tensor cores float32
//                                    means TF32 (10-bit mantissas), which
//                                    the float32 tolerances do not allow
//
// Ownership (every kernel).  Each block owns one 64-row output tile of one
// (batch, head): a query tile for B5a and B5c, a key tile for B5b, as the
// TPU kernels' grids own theirs, so no two blocks write one element, there
// are no floating-point atomics, and every gradient is the same bit for bit
// from run to run.  A block walks the other operand's 64-row tiles itself
// (the loop that replaces the TPU's sequential grid axis): B5a and B5c the
// key tiles up to the diagonal, longest rows first, B5b the query tiles
// from the diagonal to the end (the causal skip, at tile level).  Head dims
// 32, 64 and 128 are built: those of the repo's LM configurations.
//
// The tensor-core kernels (bfloat16 B5a, B5b, B5c): 128 threads, 4 warps of 16
// rows of the block's tile.  Tiles stay bfloat16 in shared memory, rows
// padded by 16 bytes so that the 8 rows an ldmatrix reads fall in 8
// distinct bank groups, and arrive by cp.async into a ring of two buffers:
// the next tile's copy is in flight while the current one is multiplied,
// with one __syncthreads a tile.  Products are mma.sync m16n8k16 with
// float32 accumulators in registers.
//   B5a: the warp's Q rows are A fragments, loaded once by ldmatrix; S = Q
//   K^T (K by ldmatrix) lands in a 16x64 float32 slab of registers, where
//   the online softmax runs (row max and sum over the 4 lanes of a quad by
//   two shuffles; the causal mask is -inf in registers on the diagonal
//   tile); P is rounded to bfloat16 and packed straight into the A
//   fragments of P V (the m16n8 accumulator layout is the m16n8k16 A
//   layout), with V read by ldmatrix.trans: P never touches shared memory.
//   B5b: the transposed formulation.  The warp's 16 key rows of K and V are
//   the A operands (held in registers for D <= 64; re-read from shared
//   memory by ldmatrix at D = 128, where registers would not hold them
//   beside the two 16x128 accumulators); per query tile S^T = K Q^T and
//   dP^T = V dO^T are 16x64 slabs in registers, P^T and dS^T are formed
//   there and packed into the A fragments of dV += P^T dO and dK += dS^T Q
//   (dO and Q by ldmatrix.trans).  Only Q, dO and the query rows' m, 1/l
//   and di pass through shared memory.
//   B5c: B5b turned to own query rows.  The prologue computes di of the
//   lane's rows g and g + 8 (O from device memory once, dO from its tile;
//   a sum over the 4 lanes of a quad) and keeps it with m and 1/l in
//   registers; the warp's Q and dO rows are A fragments (in registers for
//   D <= 64, re-read from shared memory at D = 128); per key tile S = Q K^T
//   and dP = dO V^T are 16x64 slabs in registers, dS = (dP - di) P scale
//   is formed in place and packed into the A fragments of dQ += dS K (K by
//   ldmatrix.trans).  P and dS never touch shared memory.
// The CUDA-core kernels (float32 B5a, B5b, B5c; simple and right): 256
// threads; tiles staged in shared memory as float32; for a
// 64x64 score tile thread t owns rows 4*(t/16) .. +3 and columns t%16 +
// 16*c, so row max and row sum reduce over a half warp by shuffles; P and
// dS pass through shared memory; products are float32 FMAs.  Tiles read
// down a column are padded by one float so that a half warp's reads hit 16
// distinct banks.
//
// Masking: masked scores are -inf in the forward and P = 0 in the backward
// (the Pallas kernels add -0.7*FLT_MAX): every row sees key column 0, so the
// row max is finite and exp of a masked score is exactly 0 either way.
//
// Rounding: expf and the divisions are the accurate ones (never built with
// --use_fast_math); nvcc may contract sums of products into FMAs, and sums
// (the tensor cores' among them) run in another order than the plain
// PyTorch versions' (ops/flash_attention.py), so each kernel is held to a
// tolerance against them, not bit for bit.
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
// Tensor-core building blocks (bfloat16): cp.async, ldmatrix, mma.sync
// ---------------------------------------------------------------------------
//
// Fragments of mma.sync.m16n8k16 (bf16 in, float32 accumulate), for lane
// l = 4*g + tq of a warp: the 16x16 A operand holds (row g, k 2tq .. +1),
// (row g+8, k 2tq ..), (row g, k 8+2tq ..), (row g+8, k 8+2tq ..) in its
// four registers; the 16x8 B operand (k 2tq .. +1, column g) and (k 8+2tq
// .., column g); the 16x8 float32 accumulator (row g, columns 2tq, 2tq+1)
// and (row g+8, the same columns).

using bf16 = __nv_bfloat16;

// 4 warps x 16 rows of the block's tile.  The kernels are declared with
// __launch_bounds__(kMmaThreads, 1): without the minimum of one block an SM,
// ptxas held the D = 64 forward to 128 registers and spilled.
constexpr int kMmaThreads = 128;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// 64 rows x D bfloat16 from src (row stride in elements) into shared
// memory rows of D + 8 elements, one 16-byte cp.async per chunk.
template <int D>
__device__ __forceinline__ void copy_tile_async(bf16* dst, const bf16* src,
                                                int64_t row_stride) {
  constexpr int kChunks = D / 8;
#pragma unroll
  for (int i = 0; i < kBM * kChunks / kMmaThreads; ++i) {
    const int idx = threadIdx.x + i * kMmaThreads;
    const int r = idx / kChunks, c = (idx % kChunks) * 8;
    cp_async16(dst + r * (D + 8) + c, src + r * row_stride + c);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a b
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two float32 rounded to bfloat16, lo in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A operand of rows r0 .. +15, k0 .. +15 of a row-major tile (row
// stride ld elements): lane l gives the address of row r0 + l%16 at column
// k0 + 8*(l/16).
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile,
                                       int ld, int r0, int k0, int lane) {
  ldsm_x4(a, tile + (r0 + (lane & 15)) * ld + k0 + ((lane >> 4) << 3));
}

// B operands of the two 8-column blocks n0 .. n0+15 over k0 .. +15, from a
// tile stored [n][k] (k contiguous: K in S = Q K^T, Q and dO in S^T = K
// Q^T and dP^T = V dO^T): b[0], b[1] for columns n0 .., b[2], b[3] for n0+8.
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[4], const bf16* tile,
                                          int ld, int n0, int k0, int lane) {
  ldsm_x4(b, tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 +
                 (((lane >> 3) & 1) << 3));
}

// The same from a tile stored [k][n] (n contiguous: V in P V, dO and Q in
// P^T dO and dS^T Q), transposed by ldmatrix.trans.
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[4], const bf16* tile,
                                          int ld, int k0, int n0, int lane) {
  ldsm_x4_trans(b, tile + (k0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * ld +
                       n0 + ((lane >> 4) << 3));
}

// The A operand for the 16 columns 16*kk .. +15 of a 16x64 float32 slab
// held as eight m16n8 accumulators, rounded to bfloat16.
__device__ __forceinline__ void slab_to_a(uint32_t (&a)[4],
                                          const float (&x)[8][4], int kk) {
  a[0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
  a[1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
  a[2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
  a[3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
}

// S += A B^T for a warp's 16 rows against the 64 rows of a tile stored
// [n][k] with k over D: A from a (D/16 fragments).
template <int D>
__device__ __forceinline__ void slab_product(float (&s)[8][4],
                                             const uint32_t (&a)[4],
                                             const bf16* tile, int kk,
                                             int lane) {
#pragma unroll
  for (int jp = 0; jp < 4; ++jp) {
    uint32_t b[4];
    load_b_nk(b, tile, D + 8, jp * 16, kk * 16, lane);
    mma_bf16(s[2 * jp], a, b[0], b[1]);
    mma_bf16(s[2 * jp + 1], a, b[2], b[3]);
  }
}

// acc (16 x D) += A (16 x 16, k = 16*kk .. +15) times rows 16*kk .. +15 of
// a tile stored [k][n] with n over D.
template <int D>
__device__ __forceinline__ void acc_product(float (&acc)[D / 8][4],
                                            const uint32_t (&a)[4],
                                            const bf16* tile, int kk,
                                            int lane) {
#pragma unroll
  for (int np = 0; np < D / 16; ++np) {
    uint32_t b[4];
    load_b_kn(b, tile, D + 8, kk * 16, np * 16, lane);
    mma_bf16(acc[2 * np], a, b[0], b[1]);
    mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
  }
}

// rows g (lo) and g + 8 (hi) of a 16 x D float32 accumulator, rounded to
// bfloat16, into row pointers (column 8*n + 2*tq of each)
template <int D>
__device__ __forceinline__ void store_acc(bf16* lo, bf16* hi,
                                          const float (&acc)[D / 8][4],
                                          int tq) {
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    *reinterpret_cast<uint32_t*>(lo + n * 8 + 2 * tq) =
        pack_bf16(acc[n][0], acc[n][1]);
    *reinterpret_cast<uint32_t*>(hi + n * 8 + 2 * tq) =
        pack_bf16(acc[n][2], acc[n][3]);
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
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


// The tensor-core forward (bfloat16).  Shared memory: the Q tile, then two
// K and two V buffers, each 64 rows of D + 8 bfloat16.
template <int D>
constexpr int fwd_mma_smem_bytes() {
  return 5 * kBM * (D + 8) * (int)sizeof(bf16);
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads, 1)
    flash_fwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ o,
                  float* __restrict__ m_out, float* __restrict__ l_out, int L,
                  Strides sq, Strides sk, Strides sv, Strides so, float scale,
                  int causal) {
  constexpr int kTile = kBM * (D + 8);
  constexpr int kKS = D / 16;  // k steps over D
  constexpr int kNO = D / 8;   // 8-column blocks of the output
  extern __shared__ __align__(16) unsigned char smem_tc[];
  bf16* qs = reinterpret_cast<bf16*>(smem_tc);
  bf16* ks = qs + kTile;      // [2][kBN][D + 8]
  bf16* vs = ks + 2 * kTile;  // [2][kBN][D + 8]

  const int tile = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = tile * kBM;
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int wr = (threadIdx.x >> 5) * 16;  // the warp's first row

  const bf16* kbase = k + b * sk.b + h * sk.h;
  const bf16* vbase = v + b * sv.b + h * sv.h;
  copy_tile_async<D>(qs, q + b * sq.b + q0 * sq.l + h * sq.h, sq.l);
  copy_tile_async<D>(ks, kbase, sk.l);
  copy_tile_async<D>(vs, vbase, sv.l);
  cp_async_commit();

  // rows g and g + 8 of the warp: m, l and the 16 x D accumulator
  uint32_t qf[kKS][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[kNO][4];
#pragma unroll
  for (int n = 0; n < kNO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int n_tiles = causal ? tile + 1 : L / kBN;  // kBM == kBN
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait_all();
    __syncthreads();  // tile t is in; every warp is done with tile t - 1
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < kKS; ++kk) load_a(qf[kk], qs, D + 8, wr, kk * 16,
                                             lane);
    }
    if (t + 1 < n_tiles) {  // the next tile into the other buffer
      const int64_t k1 = (int64_t)(t + 1) * kBN;
      copy_tile_async<D>(ks + ((t + 1) & 1) * kTile, kbase + k1 * sk.l, sk.l);
      copy_tile_async<D>(vs + ((t + 1) & 1) * kTile, vbase + k1 * sv.l, sv.l);
    }
    cp_async_commit();
    const bf16* kt = ks + (t & 1) * kTile;
    const bf16* vt = vs + (t & 1) * kTile;

    // S = Q K^T: key block j holds keys 8j + 2tq, +1 of rows g, g + 8
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKS; ++kk) slab_product<D>(s, qf[kk], kt, kk, lane);

    const bool diag = causal && t == tile;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale;
        if (diag && j * 8 + 2 * tq + (e & 1) > wr + g + (e >> 1) * 8)
          x = -INFINITY;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      alpha[r] = expf(m[r] - m_new);  // 0 on the first tile
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - m[e >> 1]);
        sum[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + quad_sum(sum[r]);
#pragma unroll
    for (int n = 0; n < kNO; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += bf16(P) V, P straight from the accumulators
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pf[4];
      slab_to_a(pf, s, kk);
      acc_product<D>(acc, pf, vt, kk, lane);
    }
  }

#pragma unroll
  for (int n = 0; n < kNO; ++n) {
    acc[n][0] /= l[0];
    acc[n][1] /= l[0];
    acc[n][2] /= l[1];
    acc[n][3] /= l[1];
  }
  const int row = q0 + wr + g;
  bf16* out = o + b * so.b + (int64_t)row * so.l + h * so.h;
  store_acc<D>(out, out + 8 * so.l, acc, tq);
  if (m_out != nullptr && tq == 0) {
    const int64_t stat = ((int64_t)b * gridDim.y + h) * L + row;
    m_out[stat] = m[0];
    l_out[stat] = l[0];
    m_out[stat + 8] = m[1];
    l_out[stat + 8] = l[1];
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

// The tensor-core dQ (bfloat16).  Shared memory: the Q and dO tiles, then
// two K and two V buffers, each 64 rows of D + 8 bfloat16.
template <int D>
constexpr int dq_mma_smem_bytes() {
  return 6 * kBM * (D + 8) * (int)sizeof(bf16);
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads, 1)
    flash_bwd_dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ o,
                     const bf16* __restrict__ dout,
                     const float* __restrict__ m_in,
                     const float* __restrict__ l_in, bf16* __restrict__ dq,
                     float* __restrict__ di_out, int L, Strides sq,
                     Strides sk, Strides sv, Strides so, Strides sdo,
                     Strides sdq, float scale, int causal) {
  constexpr int kTile = kBM * (D + 8);
  constexpr int kKS = D / 16;
  constexpr int kNO = D / 8;
  // Q and dO as A fragments in registers up to D = 64; at D = 128 they are
  // re-read from shared memory, as B5b does with K and V
  constexpr bool kQRegs = D <= 64;
  extern __shared__ __align__(16) unsigned char smem_tc[];
  bf16* qs = reinterpret_cast<bf16*>(smem_tc);
  bf16* dos = qs + kTile;
  bf16* ks = dos + kTile;     // [2][kBN][D + 8]
  bf16* vs = ks + 2 * kTile;  // [2][kBN][D + 8]

  const int tile = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = tile * kBM;
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int wr = (threadIdx.x >> 5) * 16;  // the warp's first query row
  const bf16* kbase = k + b * sk.b + h * sk.h;
  const bf16* vbase = v + b * sv.b + h * sv.h;

  copy_tile_async<D>(qs, q + b * sq.b + q0 * sq.l + h * sq.h, sq.l);
  copy_tile_async<D>(dos, dout + b * sdo.b + q0 * sdo.l + h * sdo.h, sdo.l);
  copy_tile_async<D>(ks, kbase, sk.l);
  copy_tile_async<D>(vs, vbase, sv.l);
  cp_async_commit();

  // rows g and g + 8 of the warp: m, 1/l and di (the same in the 4 lanes
  // of a quad) and the 16 x D accumulator of dQ
  const int64_t stat = ((int64_t)b * gridDim.y + h) * L + q0 + wr + g;
  const float mrow[2] = {m_in[stat], m_in[stat + 8]};
  const float inv_l[2] = {1.f / l_in[stat], 1.f / l_in[stat + 8]};
  float di[2];
  uint32_t qf[kQRegs ? kKS : 1][4], dof[kQRegs ? kKS : 1][4];
  float acc[kNO][4];
#pragma unroll
  for (int n = 0; n < kNO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int n_tiles = causal ? tile + 1 : L / kBN;  // kBM == kBN
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait_all();
    __syncthreads();  // tile t is in; every warp is done with tile t - 1
    if (t == 0) {
      // the prologue: di = sum_d O * dO over the row, each lane of the
      // quad a quarter of its 4-column groups (O from device memory, once;
      // dO from its tile), then m, 1/l; Q and dO into A fragments
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = wr + g + 8 * r;
        const bf16* orow = o + b * so.b + (int64_t)(q0 + row) * so.l +
                           h * so.h;
        float part = 0.f;
#pragma unroll
        for (int c = 4 * tq; c < D; c += 16) {
          float ov[4], dv[4];
          load4(orow + c, ov);
          load4(dos + row * (D + 8) + c, dv);
#pragma unroll
          for (int e = 0; e < 4; ++e) part = fmaf(ov[e], dv[e], part);
        }
        di[r] = quad_sum(part);
        if (tq == 0) di_out[stat + 8 * r] = di[r];
      }
      if constexpr (kQRegs) {
#pragma unroll
        for (int kk = 0; kk < kKS; ++kk) {
          load_a(qf[kk], qs, D + 8, wr, kk * 16, lane);
          load_a(dof[kk], dos, D + 8, wr, kk * 16, lane);
        }
      }
    }
    if (t + 1 < n_tiles) {  // the next tile into the other buffers
      const int64_t k1 = (int64_t)(t + 1) * kBN;
      copy_tile_async<D>(ks + ((t + 1) & 1) * kTile, kbase + k1 * sk.l, sk.l);
      copy_tile_async<D>(vs + ((t + 1) & 1) * kTile, vbase + k1 * sv.l, sv.l);
    }
    cp_async_commit();
    const bf16* kt = ks + (t & 1) * kTile;
    const bf16* vt = vs + (t & 1) * kTile;

    // S = Q K^T and dP = dO V^T: key block j holds keys 8j + 2tq, +1 of
    // rows g, g + 8
    float p[8][4], ds[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[j][e] = ds[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKS; ++kk) {
      uint32_t a[4];
      if constexpr (kQRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[kk][e];
      } else {
        load_a(a, qs, D + 8, wr, kk * 16, lane);
      }
      slab_product<D>(p, a, kt, kk, lane);
    }
#pragma unroll
    for (int kk = 0; kk < kKS; ++kk) {
      uint32_t a[4];
      if constexpr (kQRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = dof[kk][e];
      } else {
        load_a(a, dos, D + 8, wr, kk * 16, lane);
      }
      slab_product<D>(ds, a, vt, kk, lane);
    }
    // P = exp(s * scale - m) * (1/l), 0 where key > query on the diagonal;
    // then dS = (dP - di) P scale in place
    const bool diag = causal && t == tile;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float pe =
            diag && j * 8 + 2 * tq + (e & 1) > wr + g + 8 * r
                ? 0.f
                : expf(__fmul_rn(p[j][e], scale) - mrow[r]) * inv_l[r];
        ds[j][e] = (ds[j][e] - di[r]) * pe * scale;
      }
    // dQ += bf16(dS) K, K read [k][n] by ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      slab_to_a(a, ds, kk);
      acc_product<D>(acc, a, kt, kk, lane);
    }
  }

  const int64_t row = q0 + wr + g;
  bf16* out = dq + b * sdq.b + row * sdq.l + h * sdq.h;
  store_acc<D>(out, out + 8 * sdq.l, acc, tq);
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


// The tensor-core dK/dV (bfloat16).  Shared memory: the K and V tiles, two
// Q and two dO buffers (64 rows of D + 8 bfloat16 each), then two sets of
// the query rows' m, 1/l and di (float32).
template <int D>
constexpr int dkv_mma_smem_bytes() {
  return 6 * kBM * (D + 8) * (int)sizeof(bf16) +
         2 * 3 * kBM * (int)sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads, 1)
    flash_bwd_dkv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const bf16* __restrict__ dout,
                      const float* __restrict__ m_in,
                      const float* __restrict__ l_in,
                      const float* __restrict__ di_in, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, int L, Strides sq, Strides sk,
                      Strides sv, Strides sdo, Strides sdk, Strides sdv,
                      float scale, int causal) {
  constexpr int kTile = kBM * (D + 8);
  constexpr int kKS = D / 16;
  constexpr int kNO = D / 8;
  // K and V as A fragments in registers up to D = 64; at D = 128 they are
  // re-read from shared memory (two 16 x 128 float32 accumulators, the two
  // score slabs and them would not fit in 255 registers; ptxas still
  // spills 68 bytes there)
  constexpr bool kKVRegs = D <= 64;
  extern __shared__ __align__(16) unsigned char smem_tc[];
  bf16* ks = reinterpret_cast<bf16*>(smem_tc);
  bf16* vs = ks + kTile;
  bf16* qs = vs + kTile;         // [2][kBM][D + 8]
  bf16* dos = qs + 2 * kTile;    // [2][kBM][D + 8]
  float* stats = reinterpret_cast<float*>(dos + 2 * kTile);  // [2][3][kBM]

  const int kt = blockIdx.x;  // key tile 0 walks the most query tiles
  const int h = blockIdx.y, b = blockIdx.z;
  const int k0 = kt * kBN;
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int wr = (threadIdx.x >> 5) * 16;  // the warp's first key row
  const int64_t stat_bh = ((int64_t)b * gridDim.y + h) * L;
  const bf16* qbase = q + b * sq.b + h * sq.h;
  const bf16* dobase = dout + b * sdo.b + h * sdo.h;
  const int j0 = causal ? kt : 0, n_q = L / kBM;  // kBM == kBN

  copy_tile_async<D>(ks, k + b * sk.b + k0 * sk.l + h * sk.h, sk.l);
  copy_tile_async<D>(vs, v + b * sv.b + k0 * sv.l + h * sv.h, sv.l);
  copy_tile_async<D>(qs, qbase + (int64_t)j0 * kBM * sq.l, sq.l);
  copy_tile_async<D>(dos, dobase + (int64_t)j0 * kBM * sdo.l, sdo.l);
  cp_async_commit();
  if (threadIdx.x < kBM) {  // the first query tile's m, 1/l, di
    const int64_t i = stat_bh + j0 * kBM + threadIdx.x;
    stats[threadIdx.x] = m_in[i];
    stats[kBM + threadIdx.x] = 1.f / l_in[i];
    stats[2 * kBM + threadIdx.x] = di_in[i];
  }

  // key rows g and g + 8 of the warp: dK and dV
  uint32_t kf[kKVRegs ? kKS : 1][4], vf[kKVRegs ? kKS : 1][4];
  float acc_dk[kNO][4], acc_dv[kNO][4];
#pragma unroll
  for (int n = 0; n < kNO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dk[n][e] = acc_dv[n][e] = 0.f;

  for (int j = j0; j < n_q; ++j) {
    const int buf = (j - j0) & 1;
    cp_async_wait_all();
    __syncthreads();  // tile j is in; every warp is done with tile j - 1
    if constexpr (kKVRegs) {
      if (j == j0) {
#pragma unroll
        for (int kk = 0; kk < kKS; ++kk) {
          load_a(kf[kk], ks, D + 8, wr, kk * 16, lane);
          load_a(vf[kk], vs, D + 8, wr, kk * 16, lane);
        }
      }
    }
    // the next tile into the other buffers; its statistics stay in flight
    // in registers until this tile is done
    const bool more = j + 1 < n_q;
    float next_m = 0.f, next_l = 1.f, next_di = 0.f;
    if (more) {
      const int64_t r1 = (int64_t)(j + 1) * kBM;
      copy_tile_async<D>(qs + (buf ^ 1) * kTile, qbase + r1 * sq.l, sq.l);
      copy_tile_async<D>(dos + (buf ^ 1) * kTile, dobase + r1 * sdo.l,
                         sdo.l);
      if (threadIdx.x < kBM) {
        next_m = m_in[stat_bh + r1 + threadIdx.x];
        next_l = l_in[stat_bh + r1 + threadIdx.x];
        next_di = di_in[stat_bh + r1 + threadIdx.x];
      }
    }
    cp_async_commit();
    const bf16* qt = qs + buf * kTile;
    const bf16* dot = dos + buf * kTile;
    const float* ms = stats + buf * 3 * kBM;
    const float* ils = ms + kBM;
    const float* dis = ils + kBM;

    // S^T = K Q^T: rows the warp's keys g, g + 8; query block jn holds
    // queries 8 jn + 2tq, +1
    float p[8][4];
#pragma unroll
    for (int jn = 0; jn < 8; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[jn][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKS; ++kk) {
      uint32_t a[4];
      if constexpr (kKVRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = kf[kk][e];
      } else {
        load_a(a, ks, D + 8, wr, kk * 16, lane);
      }
      slab_product<D>(p, a, qt, kk, lane);
    }
    // P^T = exp(s * scale - m) * (1/l), 0 where key > query on the diagonal
    const bool diag = causal && j == kt;
#pragma unroll
    for (int jn = 0; jn < 8; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = jn * 8 + 2 * tq + (e & 1);
        p[jn][e] = diag && wr + g + (e >> 1) * 8 > col
                       ? 0.f
                       : expf(__fmul_rn(p[jn][e], scale) - ms[col]) * ils[col];
      }
    // dV += bf16(P^T) dO
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      slab_to_a(a, p, kk);
      acc_product<D>(acc_dv, a, dot, kk, lane);
    }
    // dP^T = V dO^T, then dS^T = (dP^T - di) P^T scale in place
    float ds[8][4];
#pragma unroll
    for (int jn = 0; jn < 8; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[jn][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKS; ++kk) {
      uint32_t a[4];
      if constexpr (kKVRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = vf[kk][e];
      } else {
        load_a(a, vs, D + 8, wr, kk * 16, lane);
      }
      slab_product<D>(ds, a, dot, kk, lane);
    }
#pragma unroll
    for (int jn = 0; jn < 8; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = jn * 8 + 2 * tq + (e & 1);
        ds[jn][e] = (ds[jn][e] - dis[col]) * p[jn][e] * scale;
      }
    // dK += bf16(dS^T) Q
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      slab_to_a(a, ds, kk);
      acc_product<D>(acc_dk, a, qt, kk, lane);
    }
    if (more && threadIdx.x < kBM) {  // free since this tile's barrier
      float* next = stats + (buf ^ 1) * 3 * kBM;
      next[threadIdx.x] = next_m;
      next[kBM + threadIdx.x] = 1.f / next_l;
      next[2 * kBM + threadIdx.x] = next_di;
    }
  }

  const int64_t row = k0 + wr + g;
  bf16* out_k = dk + b * sdk.b + row * sdk.l + h * sdk.h;
  bf16* out_v = dv + b * sdv.b + row * sdv.l + h * sdv.h;
  store_acc<D>(out_k, out_k + 8 * sdk.l, acc_dk, tq);
  store_acc<D>(out_v, out_v + 8 * sdv.l, acc_dv, tq);
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

// Sets the kernel's dynamic shared memory and launches it over
// (L / 64, H, B) blocks of `threads`; returns 1 (kernels launched) or
// -cudaError.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, int smem, int threads, int B, int L, int H,
           cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return -(int)err;
  kernel<<<dim3(L / kBM, H, B), threads, smem, stream>>>(args...);
  err = cudaGetLastError();
  return err == cudaSuccess ? 1 : -(int)err;
}

bool shape_ok(int B, int L, int H) {
  return B >= 1 && H >= 1 && L >= kBM && L % kBM == 0;
}

// every (batch, row, head) stride a multiple of 16 bytes: the tensor-core
// kernels copy 16-byte chunks with cp.async
template <typename... S>
bool rows_16b(int elt_bytes, S... s) {
  return ((s.b * elt_bytes % 16 == 0 && s.l * elt_bytes % 16 == 0 &&
           s.h * elt_bytes % 16 == 0) &&
          ...);
}

}  // namespace

// BODY(T, DIM) for the head dim D: each entry point launches its CUDA-core
// kernel for float32 (dtype 0) and its tensor-core kernel for bfloat16 (1).
#define DL_HEAD_DIMS(BODY, T)      \
  if (D == 32) { BODY(T, 32) }     \
  if (D == 64) { BODY(T, 64) }     \
  if (D == 128) { BODY(T, 128) }

// Every entry point: tensors [B, L, H, D] with element strides (batch, row,
// head) given and the D axis contiguous; m, l and di float32 [B, H, L],
// contiguous; dtype 0 = float32, 1 = bfloat16; D in {32, 64, 128}; L a
// multiple of 64; every pointer 16-byte aligned and every stride a multiple
// of 16 bytes (the wrapper checks all of it).  Each returns the number of
// kernels launched (1), or -cudaError when a launch was refused
// (-cudaErrorInvalidValue for an unsupported dtype, head dim, length or
// stride).

// B5a.  m_out and l_out may both be null (no residuals: the serving path).
extern "C" int dl_flash_fwd(const void* q, const void* k, const void* v,
                            void* o, void* m_out, void* l_out, int dtype,
                            int B, int L, int H, int D, int64_t qb,
                            int64_t ql, int64_t qh, int64_t kb, int64_t kl,
                            int64_t kh, int64_t vb, int64_t vl, int64_t vh,
                            int64_t ob, int64_t ol, int64_t oh, float scale,
                            int causal, cudaStream_t stream) {
  const Strides sq{qb, ql, qh}, sk{kb, kl, kh}, sv{vb, vl, vh}, so{ob, ol, oh};
  if (!shape_ok(B, L, H) || !rows_16b(dtype == 0 ? 4 : 2, sq, sk, sv, so))
    return -(int)cudaErrorInvalidValue;
#define DL_FWD(T, DIM)                                                      \
  return launch(flash_fwd<T, DIM>, fwd_smem_floats<DIM>() * 4, kThreads, B, \
                L, H, stream, static_cast<const T*>(q),                     \
                static_cast<const T*>(k), static_cast<const T*>(v),         \
                static_cast<T*>(o), static_cast<float*>(m_out),             \
                static_cast<float*>(l_out), L, sq, sk, sv, so, scale,       \
                causal);
#define DL_FWD_MMA(T, DIM)                                                  \
  return launch(flash_fwd_mma<DIM>, fwd_mma_smem_bytes<DIM>(), kMmaThreads, \
                B, L, H, stream, static_cast<const T*>(q),                  \
                static_cast<const T*>(k), static_cast<const T*>(v),         \
                static_cast<T*>(o), static_cast<float*>(m_out),             \
                static_cast<float*>(l_out), L, sq, sk, sv, so, scale,       \
                causal);
  if (dtype == 0) { DL_HEAD_DIMS(DL_FWD, float) }
  if (dtype == 1) { DL_HEAD_DIMS(DL_FWD_MMA, bf16) }
#undef DL_FWD
#undef DL_FWD_MMA
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
  const Strides sq{qb, ql, qh}, sk{kb, kl, kh}, sv{vb, vl, vh}, so{ob, ol, oh},
      sdo{dob, dol, doh}, sdq{dqb, dql, dqh};
  if (!shape_ok(B, L, H) ||
      !rows_16b(dtype == 0 ? 4 : 2, sq, sk, sv, so, sdo, sdq))
    return -(int)cudaErrorInvalidValue;
#define DL_DQ_ARGS(T)                                                       \
  B, L, H, stream, static_cast<const T*>(q), static_cast<const T*>(k),      \
      static_cast<const T*>(v), static_cast<const T*>(o),                   \
      static_cast<const T*>(dout), static_cast<const float*>(m),            \
      static_cast<const float*>(l), static_cast<T*>(dq),                    \
      static_cast<float*>(di), L, sq, sk, sv, so, sdo, sdq, scale, causal
#define DL_DQ_CORE(T, DIM)                                                  \
  return launch(flash_bwd_dq<T, DIM>, dq_smem_floats<DIM>() * 4, kThreads,  \
                DL_DQ_ARGS(T));
#define DL_DQ_MMA(T, DIM)                                                   \
  return launch(flash_bwd_dq_mma<DIM>, dq_mma_smem_bytes<DIM>(),            \
                kMmaThreads, DL_DQ_ARGS(T));
  if (dtype == 0) { DL_HEAD_DIMS(DL_DQ_CORE, float) }
  if (dtype == 1) { DL_HEAD_DIMS(DL_DQ_MMA, bf16) }
#undef DL_DQ_ARGS
#undef DL_DQ_CORE
#undef DL_DQ_MMA
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
  const Strides sq{qb, ql, qh}, sk{kb, kl, kh}, sv{vb, vl, vh},
      sdo{dob, dol, doh}, sdk{dkb, dkl, dkh}, sdv{dvb, dvl, dvh};
  if (!shape_ok(B, L, H) ||
      !rows_16b(dtype == 0 ? 4 : 2, sq, sk, sv, sdo, sdk, sdv))
    return -(int)cudaErrorInvalidValue;
#define DL_DKV_ARGS(T)                                                      \
  B, L, H, stream, static_cast<const T*>(q), static_cast<const T*>(k),      \
      static_cast<const T*>(v), static_cast<const T*>(dout),                \
      static_cast<const float*>(m), static_cast<const float*>(l),           \
      static_cast<const float*>(di), static_cast<T*>(dk),                   \
      static_cast<T*>(dv), L, sq, sk, sv, sdo, sdk, sdv, scale, causal
#define DL_DKV_CORE(T, DIM)                                               \
  return launch(flash_bwd_dkv<T, DIM>, dkv_smem_floats<DIM>() * 4, kThreads, \
                DL_DKV_ARGS(T));
#define DL_DKV_MMA(T, DIM)                                               \
  return launch(flash_bwd_dkv_mma<DIM>, dkv_mma_smem_bytes<DIM>(),         \
                kMmaThreads, DL_DKV_ARGS(T));
  if (dtype == 0) { DL_HEAD_DIMS(DL_DKV_CORE, float) }
  if (dtype == 1) { DL_HEAD_DIMS(DL_DKV_MMA, bf16) }
#undef DL_DKV_ARGS
#undef DL_DKV_CORE
#undef DL_DKV_MMA
  return -(int)cudaErrorInvalidValue;
}
#undef DL_HEAD_DIMS
