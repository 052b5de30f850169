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
// products of the input-dtype operands (3xTF32 products for float32 B5b
// and B5c, see below); for bfloat16 inputs P is rounded to
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
// cores can approach its bound.  In float32 (twice the bytes) the CUDA
// cores alone would bound them at 0.2567, 0.5133 and 0.3852 ms (67
// TFLOP/s).  Every float32 kernel forms S on the CUDA cores (2*D*N: 0.1283
// ms, 0.1286 with di) and its other products in 3xTF32, three TF32
// tensor-core passes a product at 495 TFLOP/s (B5a's P V 2*D*N: 0.0521
// ms; B5b 6*D*N: 0.1563 ms; B5c 4*D*N: 0.1042 ms); the two units run side
// by side, so B5a and B5c are bound at 0.1283 and 0.1286 ms by their
// CUDA-core work and B5b at 0.1563 ms by its tensor-core work (their
// float32 traffic, 135 MB for B5a and 203 MB for B5b and B5c, takes 0.0404
// and 0.0606 ms).
//
// Which kernel runs where:
//
//   bfloat16 B5a  flash_fwd_mma         tensor cores (mma.sync m16n8k16)
//   bfloat16 B5b  flash_bwd_dkv_mma     tensor cores (mma.sync m16n8k16)
//   bfloat16 B5c  flash_bwd_dq_mma      tensor cores (mma.sync m16n8k16)
//   float32 B5a   flash_fwd_tf32x3      tensor cores (mma.sync m16n8k8,
//   float32 B5b   flash_bwd_dkv_tf32x3  3xTF32) for P V, dP and the
//   float32 B5c   flash_bwd_dq_tf32x3   gradient products; S on the CUDA
//                                       cores
//
// Why 3xTF32 keeps float32 accuracy.  One TF32 pass rounds each operand to
// 11 significant bits (relative error up to 2^-11), which puts gradients
// 20-100x outside the float32 tolerances (rtol 2e-4, atol 2e-5).  3xTF32
// splits each operand x = hi + lo + e with hi = tf32(x) and lo = tf32(x -
// hi) (cvt.rna; x - hi is exact), so |e| <= 2^-22 |x|, and forms a b as
// a_lo b_hi + a_hi b_lo + a_hi b_hi: each product of two TF32 values is
// exact in float32, the dropped a_lo b_lo and the split errors are about
// 3 * 2^-22 |a b|, and the sums are float32 in the accumulators.  The
// output and the gradients then sit as close to a float64 route as plain
// float32's do (tests/test_torch_flash_tf32x3.py emulates the forward's P
// V and the backward's products at D = 32, 64, 128).  Two things 3xTF32
// does not give, which the kernels do otherwise:
//   - The recomputed P = exp(s * scale - m) / l must come from the scores
//     that m and l were taken over: exp turns a score a few ulps off into
//     a relative error of |s| * scale ulps in P, which with q x 8 (scores
//     up to about +-50) put dV at 1.8-4.1x its allowance on an H100 with S
//     in 3xTF32 (PERF.md).
//     So all three float32 kernels form S on the CUDA cores by one fmaf
//     chain (slab_scores_ffma): B5a's m is the row max of exactly the
//     scores B5b and B5c form again, bit for bit.
//   - The tensor core's own sums drift along a long k; each half tile's
//     P V and gradient products sum from zero and a rounded float32
//     addition adds them to the accumulator (acc_product_tf32).
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
// The bfloat16 tensor-core kernels (B5a, B5b, B5c): 128 threads, 4 warps of 16
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
// The float32 tensor-core kernels (B5a flash_fwd_tf32x3, B5b
// flash_bwd_dkv_tf32x3, B5c flash_bwd_dq_tf32x3): the bfloat16 kernels in
// 32-bit elements.  128 threads, 4 warps of 16 rows (256, 8 warps, at D =
// 128; see Warps below); tiles stay float32 in shared memory, rows
// padded by 4 floats (16 bytes), and arrive by cp.async (16-byte chunks of
// four floats) into a ring of two buffers with one __syncthreads a tile.
// S is an fmaf chain per element on the CUDA cores (slab_scores_ffma);
// every other product is mma.sync m16n8k8 TF32, issued three times a k
// step (the cross terms, then hi hi) into float32 accumulators.  A tile is
// walked in two halves of 32 columns (one a warp at D = 128, see below).  What they do about what bounds
// them:
//   - ldmatrix moves 16-bit elements (its .trans cannot transpose 32-bit
//     ones), so fragments come by 32-bit shared loads; with the pad the
//     bank of (row, col) is 4*row + col mod 32, so both the row-major read
//     (A operands; V in dP = dO V^T) and the transposed read (K in dS K,
//     dO in P^T dO, Q in dS^T Q) hit 32 distinct banks.
//   - S, P, dP and dS stay in 16x32 slabs in registers (accumulator
//     layout) and feed the next product's A operand from there: the
//     accumulator
//     gives lane (g, tq) columns 2tq and 2tq+1 where the TF32 A operand
//     wants k = tq and tq+4, so that product's k is permuted inside each
//     8-column block (no shuffle), and its B rows are read in that order.
//     P and dS never touch shared memory.
//   - Registers: two 16xD float32 accumulators (B5b), the half tile's
//     sums of up to 64 columns, two slabs and the hi and lo fragments fill
//     the 255 a thread (B5b at D = 64 uses 254; full 64-column slabs
//     spilled), so K and V (B5b) or Q and dO (B5c) are re-read from shared
//     memory and split each half tile at every head dim; an A fragment is
//     split once and serves 4 (or up to 8) column blocks, a B fragment
//     where it is loaded.  At D = 128 B5b still spills (nvcc's report is in
//     chip_smoke.py's log); the forms that spilled less were slower.
//   - Warps: at D = 128 a block's shared memory (6 tiles of 64 x 132
//     floats, 203 KB; B5a's 5, 165 KB) holds one block an SM, and four
//     warps left the dependent MMA chains waiting; there a block runs 8
//     warps, two to each
//     16 rows, each walking one 32-column half of every tile, and the two
//     partial accumulators are added once at the end through shared memory
//     (hand_over_partial; B5a's by the softmax rule), in the same order
//     every run.
//   - The split costs 3 ALU operations an element, a product three MMAs
//     and S a CUDA-core chain: the issue rate of mma.sync, the splits and
//     the FFMAs, not bytes, bounds them (wgmma with TMA-fed tiles is later
//     work, as for bfloat16).  S's chains read 10 16-byte shared loads a
//     64 FMAs (a lane holds two rows of the accumulator layout), 2.5 bytes
//     an FMA where an SM's shared memory serves about 1: in B5a the score
//     loop, not P V, takes most of the time (PERF.md).
//   - B5a: the online softmax runs on the S slab in registers (the row
//     max over the lane's 8 values and its quad, alpha = expf(m_old -
//     m_new) on l and the accumulator), P is formed in place and feeds P V
//     straight from the slab, so neither S nor P touches shared memory; a
//     32-column half of the diagonal tile that lies above every row of a
//     warp is skipped (the causal skip at half-tile granularity, uniform in
//     the warp).  At D = 128 the two warps of a 16-row slice keep their own
//     m, l and accumulator, merged once at the end by the softmax rule
//     (hand_over_partial with m and l).
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

// 64 rows x D elements from src (row stride in elements) into shared
// memory rows padded by 16 bytes (D + 8 bfloat16, D + 4 float32), one
// 16-byte cp.async per chunk, spread over the block's kThr threads.
template <int D, int kThr = kMmaThreads, typename T>
__device__ __forceinline__ void copy_tile_async(T* dst, const T* src,
                                                int64_t row_stride) {
  constexpr int kElts = 16 / (int)sizeof(T);  // a chunk, and the pad
  constexpr int kChunks = D / kElts;
#pragma unroll
  for (int i = 0; i < kBM * kChunks / kThr; ++i) {
    const int idx = threadIdx.x + i * kThr;
    const int r = idx / kChunks, c = (idx % kChunks) * kElts;
    cp_async16(dst + r * (D + kElts) + c, src + r * row_stride + c);
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
// Tensor-core building blocks (float32 as 3xTF32): mma.sync m16n8k8
// ---------------------------------------------------------------------------
//
// Fragments of mma.sync.m16n8k8 (tf32 in, float32 accumulate), for lane
// l = 4*g + tq: the 16x8 A operand holds (row g, k tq), (row g+8, k tq),
// (row g, k tq+4), (row g+8, k tq+4) in its four registers; the 8x8 B
// operand (k tq, column g) and (k tq+4, column g); the accumulator is
// m16n8k16's.  A TF32 value is a float32 whose low 13 mantissa bits are 0.
//
// An accumulator slab feeds the next product's A operand without a
// shuffle: lane (g, tq) holds columns 2tq and 2tq+1 of each 8-column
// block, so the k index of that product is permuted within the block,
// column 2tq into slot tq and 2tq+1 into slot tq+4, and its B operand's
// rows are read in the same order (load_b_kn_tf32).

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// c += a b, one TF32 pass (called only by mma_3xtf32)
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A and B operands split in two TF32 parts, hi = tf32(x), lo = tf32(x - hi)
struct Tf32A {
  uint32_t hi[4], lo[4];
};
struct Tf32B {
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));  // x - hi is exact
}

// c += a b in 3xTF32: the two small cross terms, then hi hi
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const Tf32A& a,
                                           const Tf32B& b) {
  mma_tf32(c, a.lo, b.hi[0], b.hi[1]);
  mma_tf32(c, a.hi, b.lo[0], b.lo[1]);
  mma_tf32(c, a.hi, b.hi[0], b.hi[1]);
}

// The A operand of rows r0 .. +15, k0 .. +7 of a row-major float32 tile
// (row stride ld floats).  With ld = D + 4 the bank of (row, col) is
// 4*row + col mod 32: the 32 lanes hit 32 banks.
__device__ __forceinline__ void load_a_tf32(Tf32A& a, const float* tile,
                                            int ld, int r0, int k0, int g,
                                            int tq) {
  const float* p = tile + (r0 + g) * ld + k0 + tq;
  split_tf32(p[0], a.hi[0], a.lo[0]);
  split_tf32(p[8 * ld], a.hi[1], a.lo[1]);
  split_tf32(p[4], a.hi[2], a.lo[2]);
  split_tf32(p[8 * ld + 4], a.hi[3], a.lo[3]);
}

// The B operand of columns n0 .. +7 over k0 .. +7 of a tile stored [n][k]
// (k contiguous: V in dP = dO V^T, dO in dP^T = V dO^T)
__device__ __forceinline__ void load_b_nk_tf32(Tf32B& b, const float* tile,
                                               int ld, int n0, int k0, int g,
                                               int tq) {
  const float* p = tile + (n0 + g) * ld + k0 + tq;
  split_tf32(p[0], b.hi[0], b.lo[0]);
  split_tf32(p[4], b.hi[1], b.lo[1]);
}

// The B operand of columns n0 .. +7 over rows 8j .. +7 of a tile stored
// [k][n] (n contiguous: K in dS K, dO and Q in P^T dO and dS^T Q), k
// permuted as slab_to_a_tf32 permutes it: slot tq is row 8j + 2tq, slot
// tq + 4 row 8j + 2tq + 1 (banks 8tq + g and 8tq + 4 + g: no conflict).
__device__ __forceinline__ void load_b_kn_tf32(Tf32B& b, const float* tile,
                                               int ld, int j, int n0, int g,
                                               int tq) {
  const float* p = tile + (8 * j + 2 * tq) * ld + n0 + g;
  split_tf32(p[0], b.hi[0], b.lo[0]);
  split_tf32(p[ld], b.hi[1], b.lo[1]);
}

// A slab: 16 rows x 32 columns (half a 64-row tile) of float32 held as four
// m16n8 accumulators; the kernels walk a tile in two halves, which keeps
// the two slabs and the two 16 x D accumulators of B5b in 255 registers.
constexpr int kHalf = 32;

// The A operand of the 8 columns 8j .. +7 of a slab, k permuted (column
// 8j + 2tq + e in slot tq + 4e)
__device__ __forceinline__ void slab_to_a_tf32(Tf32A& a,
                                               const float (&x)[4][4],
                                               int j) {
  split_tf32(x[j][0], a.hi[0], a.lo[0]);
  split_tf32(x[j][2], a.hi[1], a.lo[1]);
  split_tf32(x[j][1], a.hi[2], a.lo[2]);
  split_tf32(x[j][3], a.hi[3], a.lo[3]);
}

// S = A B^T over D on the CUDA cores: the warp's 16 rows r0 of a_tile
// against the 32 rows of b_tile, both stored [row][D + 4], each element one
// fmaf chain over d from 0 in order: float32 B5a (flash_fwd_tf32x3) takes m
// and l over these scores, and B5b and B5c recompute P = exp(s * scale - m)
// / l from the very same.  Lanes of one tq read the same B rows (a
// broadcast); the pad keeps the 16-byte reads conflict-free.  The d loop is
// unrolled kUnroll steps of 4, which lets the next steps' loads issue under
// this one's FMAs without changing any chain: B5a, with the registers to
// spare, takes 4 (6% off its time at the LM training shape on an H100,
// PERF.md); B5b and B5c, at up to 254 registers, take 1.
template <int D, int kUnroll = 1>
__device__ __forceinline__ void slab_scores_ffma(float (&s)[4][4],
                                                 const float* a_tile, int r0,
                                                 const float* b_tile, int g,
                                                 int tq) {
  const float* a0 = a_tile + (r0 + g) * (D + 4);
  const float* a1 = a0 + 8 * (D + 4);
  const float* b = b_tile + 2 * tq * (D + 4);
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll 1
  for (int d0 = 0; d0 < D; d0 += 4 * kUnroll)
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int d = d0 + 4 * u;
    float av0[4], av1[4];
    load4(a0 + d, av0);
    load4(a1 + d, av1);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float bv0[4], bv1[4];
      load4(b + 8 * j * (D + 4) + d, bv0);
      load4(b + (8 * j + 1) * (D + 4) + d, bv1);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][0] = fmaf(av0[e], bv0[e], s[j][0]);  // row g, column 8j + 2tq
        s[j][1] = fmaf(av0[e], bv1[e], s[j][1]);  // row g, column 8j + 2tq + 1
        s[j][2] = fmaf(av1[e], bv0[e], s[j][2]);  // row g + 8
        s[j][3] = fmaf(av1[e], bv1[e], s[j][3]);
      }
    }
  }
}

// X = A B^T over D in 3xTF32 (dP, dP^T): the warp's 16 rows r0 of a_tile
// against the 32 rows of b_tile, both stored [row][D + 4].  Each A
// fragment is split once and serves the 4 column blocks.
template <int D>
__device__ __forceinline__ void slab_product_tf32(float (&s)[4][4],
                                                  const float* a_tile, int r0,
                                                  const float* b_tile, int g,
                                                  int tq) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    Tf32A a;
    load_a_tf32(a, a_tile, D + 4, r0, kk * 8, g, tq);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      Tf32B b;
      load_b_nk_tf32(b, b_tile, D + 4, j * 8, kk * 8, g, tq);
      mma_3xtf32(s[j], a, b);
    }
  }
}

// acc (16 x D) += X tile in 3xTF32, X a slab in registers and tile the 32
// rows [k][n] (n over D) it multiplies: X's 8-column blocks are the k steps.
// Each output column block's 4 k steps (12 MMAs) sum from zero in t, which
// a rounded float32 addition adds to acc.  Chained straight into acc over
// the whole walk (384 MMAs into one dV accumulator at L = 1024), the tensor
// core's own sums left dV 7.7e-5 off its twin on an H100 where this leaves
// 4.8e-6, and used 0.56-0.71 of dV's allowance at q x 8 against 0.05-0.07
// (PERF.md).  t holds 64 output columns, 8 independent MMA chains, at a
// time (twice at D = 128): B5b at D = 128 spills, and every form tried on
// an H100 that spilled less (t of 32 columns, or X split once and t one
// column block) ran its D = 128 shape 2-4% slower (PERF.md).  Each acc
// element sees the same sums in the same order in every form.
template <int D>
__device__ __forceinline__ void acc_product_tf32(float (&acc)[D / 8][4],
                                                 const float (&x)[4][4],
                                                 const float* tile, int g,
                                                 int tq) {
  constexpr int kGroup = D / 8 < 8 ? D / 8 : 8;  // column blocks in t
#pragma unroll
  for (int n0 = 0; n0 < D / 8; n0 += kGroup) {
    float t[kGroup][4];
#pragma unroll
    for (int n = 0; n < kGroup; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) t[n][e] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      Tf32A a;
      slab_to_a_tf32(a, x, j);
#pragma unroll
      for (int n = 0; n < kGroup; ++n) {
        Tf32B b;
        load_b_kn_tf32(b, tile, D + 4, j, (n0 + n) * 8, g, tq);
        mma_3xtf32(t[n], a, b);
      }
    }
#pragma unroll
    for (int n = 0; n < kGroup; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n0 + n][e] += t[n][e];
  }
}

// The float32 tensor-core kernels' threads: 4 warps of 16 rows, or at D =
// 128 8 warps, two to each 16 rows, each walking one 32-column half of
// every tile.  Their two partial sums meet once at the end
// (hand_over_partial; the forward's by the softmax rule): at D = 128 one
// block fills an SM's shared memory, and four warps an SM left the tensor
// cores idle on their dependent MMA chains.
template <int D>
constexpr int kTf32Threads = D > 64 ? 2 * kMmaThreads : kMmaThreads;

// At 8 warps: warps 4-7 hand their accumulators to warps 0-3 of the same
// rows through shared memory (buf, free by then), lane-major so that the
// 32 lanes hit 32 banks; returns true in the warps that store the result,
// whose acc is then half 0's plus half 1's, the same order every run.  The
// forward passes its m and l too: the halves then merge by the online
// softmax's rule, m = max(m0, m1) and each side scaled by expf(m_i - m) (a
// side that skipped every key, m -inf and l and acc 0, adds 0); without
// them both weights are 1 and the sum is the backward's plain one.
template <int kThr, int N>
__device__ __forceinline__ bool hand_over_partial(float (&acc)[N][4],
                                                  float* buf,
                                                  float* m = nullptr,
                                                  float* l = nullptr) {
  if constexpr (kThr == kMmaThreads) {
    return true;
  } else {
    cp_async_wait_all();
    __syncthreads();  // every warp is done with the last tile
    float* part = buf + (threadIdx.x & (kMmaThreads - 1));
    const bool keep = threadIdx.x < kMmaThreads;
    if (!keep) {
#pragma unroll
      for (int n = 0; n < N; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          part[(n * 4 + e) * kMmaThreads] = acc[n][e];
      if (m != nullptr)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          part[(4 * N + r) * kMmaThreads] = m[r];
          part[(4 * N + 2 + r) * kMmaThreads] = l[r];
        }
    }
    __syncthreads();
    if (keep) {
      float a0[2] = {1.f, 1.f}, a1[2] = {1.f, 1.f};
      if (m != nullptr)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float m1 = part[(4 * N + r) * kMmaThreads];
          const float mm = fmaxf(m[r], m1);
          a0[r] = expf(m[r] - mm);
          a1[r] = expf(m1 - mm);
          l[r] = l[r] * a0[r] + part[(4 * N + 2 + r) * kMmaThreads] * a1[r];
          m[r] = mm;
        }
#pragma unroll
      for (int n = 0; n < N; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[n][e] = acc[n][e] * a0[e >> 1] +
                      part[(n * 4 + e) * kMmaThreads] * a1[e >> 1];
    }
    return keep;
  }
}

// rows g (lo) and g + 8 (hi) of a 16 x D float32 accumulator into row
// pointers (columns 8*n + 2*tq, +1 of each)
template <int D>
__device__ __forceinline__ void store_acc_f32(float* lo, float* hi,
                                              const float (&acc)[D / 8][4],
                                              int tq) {
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    *reinterpret_cast<float2*>(lo + n * 8 + 2 * tq) =
        make_float2(acc[n][0], acc[n][1]);
    *reinterpret_cast<float2*>(hi + n * 8 + 2 * tq) =
        make_float2(acc[n][2], acc[n][3]);
  }
}

// ---------------------------------------------------------------------------
// B5a: forward
// ---------------------------------------------------------------------------

// The tensor-core forward in float32 (3xTF32 for P V, S on the CUDA
// cores).  Shared memory: the Q tile, then two K and two V buffers, each 64
// rows of D + 4 floats.
template <int D>
constexpr int fwd_tf32_smem_bytes() {
  return 5 * kBM * (D + 4) * (int)sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(kTf32Threads<D>, 1)
    flash_fwd_tf32x3(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ m_out, float* __restrict__ l_out,
                     int L, Strides sq, Strides sk, Strides sv, Strides so,
                     float scale, int causal) {
  constexpr int kThr = kTf32Threads<D>;
  constexpr int kLd = D + 4;
  constexpr int kTile = kBM * kLd;
  constexpr int kNO = D / 8;
  extern __shared__ __align__(16) unsigned char smem_tc[];
  float* qs = reinterpret_cast<float*>(smem_tc);
  float* ks = qs + kTile;      // [2][kBN][D + 4]
  float* vs = ks + 2 * kTile;  // [2][kBN][D + 4]

  const int tile = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = tile * kBM;
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int warp = threadIdx.x >> 5;
  const int wr = (warp & 3) * 16;  // the warp's first query row
  const int half0 = warp >> 2;     // its first key half of a tile
  const float* kbase = k + b * sk.b + h * sk.h;
  const float* vbase = v + b * sv.b + h * sv.h;

  copy_tile_async<D, kThr>(qs, q + b * sq.b + q0 * sq.l + h * sq.h, sq.l);
  copy_tile_async<D, kThr>(ks, kbase, sk.l);
  copy_tile_async<D, kThr>(vs, vbase, sv.l);
  cp_async_commit();

  // rows g and g + 8 of the warp: m, l (the same in the 4 lanes of a quad)
  // and the 16 x D accumulator
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
    if (t + 1 < n_tiles) {  // the next tile into the other buffers
      const int64_t k1 = (int64_t)(t + 1) * kBN;
      copy_tile_async<D, kThr>(ks + ((t + 1) & 1) * kTile, kbase + k1 * sk.l,
                               sk.l);
      copy_tile_async<D, kThr>(vs + ((t + 1) & 1) * kTile, vbase + k1 * sv.l,
                               sv.l);
    }
    cp_async_commit();
    const float* kt = ks + (t & 1) * kTile;
    const float* vt = vs + (t & 1) * kTile;

    // the tile in two halves of 32 keys (one each at 8 warps); key block j
    // of a half holds keys 8j + 2tq, +1 of rows g, g + 8
    const bool diag = causal && t == tile;
#pragma unroll 1
    for (int half = half0; half < kBN / kHalf; half += kThr / kMmaThreads) {
      // the causal skip: every key of the half lies past the warp's rows
      if (diag && half * kHalf > wr + 15) continue;
      // S = Q K^T on the CUDA cores (the chains B5b and B5c form again),
      // scaled; -inf where key > query on the diagonal
      float s[4][4];
      slab_scores_ffma<D, 4>(s, qs, wr, kt + half * kHalf * kLd, g, tq);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int col = half * kHalf + j * 8 + 2 * tq + (e & 1);
          const float x = diag && col > wr + g + 8 * r
                              ? -INFINITY
                              : __fmul_rn(s[j][e], scale);
          s[j][e] = x;
          mx[r] = fmaxf(mx[r], x);
        }
      // the online softmax: m over the quad, P = exp(s - m) in place, l
      // and the accumulator rescaled by alpha (0 on a row's first half)
      float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m[r], quad_max(mx[r]));
        alpha[r] = expf(m[r] - m_new);
        m[r] = m_new;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
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
      // O += P V in 3xTF32, P straight from the slab, V read [k][n]
      acc_product_tf32<D>(acc, s, vt + half * kHalf * kLd, g, tq);
    }
  }

  if (!hand_over_partial<kThr>(acc, ks, m, l)) return;
#pragma unroll
  for (int n = 0; n < kNO; ++n) {
    acc[n][0] /= l[0];
    acc[n][1] /= l[0];
    acc[n][2] /= l[1];
    acc[n][3] /= l[1];
  }
  const int64_t row = q0 + wr + g;
  float* out = o + b * so.b + row * so.l + h * so.h;
  store_acc_f32<D>(out, out + 8 * so.l, acc, tq);
  if (m_out != nullptr && tq == 0) {
    const int64_t stat = ((int64_t)b * gridDim.y + h) * L + row;
    m_out[stat] = m[0];
    l_out[stat] = l[0];
    m_out[stat + 8] = m[1];
    l_out[stat + 8] = l[1];
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

// The tensor-core dQ in float32 (3xTF32).  Shared memory: the Q and dO
// tiles, then two K and two V buffers, each 64 rows of D + 4 floats.
template <int D>
constexpr int dq_tf32_smem_bytes() {
  return 6 * kBM * (D + 4) * (int)sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(kTf32Threads<D>, 1)
    flash_bwd_dq_tf32x3(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ o,
                        const float* __restrict__ dout,
                        const float* __restrict__ m_in,
                        const float* __restrict__ l_in,
                        float* __restrict__ dq, float* __restrict__ di_out,
                        int L, Strides sq, Strides sk, Strides sv, Strides so,
                        Strides sdo, Strides sdq, float scale, int causal) {
  constexpr int kThr = kTf32Threads<D>;
  constexpr int kLd = D + 4;
  constexpr int kTile = kBM * kLd;
  constexpr int kNO = D / 8;
  extern __shared__ __align__(16) unsigned char smem_tc[];
  float* qs = reinterpret_cast<float*>(smem_tc);
  float* dos = qs + kTile;
  float* ks = dos + kTile;    // [2][kBN][D + 4]
  float* vs = ks + 2 * kTile;  // [2][kBN][D + 4]

  const int tile = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = tile * kBM;
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int warp = threadIdx.x >> 5;
  const int wr = (warp & 3) * 16;  // the warp's first query row
  const int half0 = warp >> 2;     // its first key half of a tile
  const float* kbase = k + b * sk.b + h * sk.h;
  const float* vbase = v + b * sv.b + h * sv.h;

  copy_tile_async<D, kThr>(qs, q + b * sq.b + q0 * sq.l + h * sq.h, sq.l);
  copy_tile_async<D, kThr>(dos, dout + b * sdo.b + q0 * sdo.l + h * sdo.h,
                           sdo.l);
  copy_tile_async<D, kThr>(ks, kbase, sk.l);
  copy_tile_async<D, kThr>(vs, vbase, sv.l);
  cp_async_commit();

  // rows g and g + 8 of the warp: m, 1/l and di (the same in the 4 lanes
  // of a quad) and the 16 x D accumulator of dQ
  const int64_t stat = ((int64_t)b * gridDim.y + h) * L + q0 + wr + g;
  const float mrow[2] = {m_in[stat], m_in[stat + 8]};
  const float inv_l[2] = {1.f / l_in[stat], 1.f / l_in[stat + 8]};
  float di[2];
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
      // dO from its tile)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = wr + g + 8 * r;
        const float* orow = o + b * so.b + (int64_t)(q0 + row) * so.l +
                            h * so.h;
        float part = 0.f;
#pragma unroll
        for (int c = 4 * tq; c < D; c += 16) {
          float ov[4], dv[4];
          load4(orow + c, ov);
          load4(dos + row * kLd + c, dv);
#pragma unroll
          for (int e = 0; e < 4; ++e) part = fmaf(ov[e], dv[e], part);
        }
        di[r] = quad_sum(part);
        if (tq == 0 && half0 == 0) di_out[stat + 8 * r] = di[r];
      }
    }
    if (t + 1 < n_tiles) {  // the next tile into the other buffers
      const int64_t k1 = (int64_t)(t + 1) * kBN;
      copy_tile_async<D, kThr>(ks + ((t + 1) & 1) * kTile, kbase + k1 * sk.l,
                               sk.l);
      copy_tile_async<D, kThr>(vs + ((t + 1) & 1) * kTile, vbase + k1 * sv.l,
                               sv.l);
    }
    cp_async_commit();
    const float* kt = ks + (t & 1) * kTile;
    const float* vt = vs + (t & 1) * kTile;

    // the tile in two halves of 32 keys (one each at 8 warps): S = Q K^T on the CUDA cores (B5a's
    // chains), dP = dO V^T in 3xTF32 (dO re-read from shared memory and
    // split each half); key block j of a half holds keys 8j + 2tq, +1 of
    // rows g, g + 8
    const bool diag = causal && t == tile;
#pragma unroll 1
    for (int half = half0; half < kBN / kHalf; half += kThr / kMmaThreads) {
      const float* kh = kt + half * kHalf * kLd;
      float p[4][4], ds[4][4];
      slab_scores_ffma<D>(p, qs, wr, kh, g, tq);
      slab_product_tf32<D>(ds, dos, wr, vt + half * kHalf * kLd, g, tq);
      // P = exp(s * scale - m) * (1/l), 0 where key > query on the
      // diagonal; then dS = (dP - di) P scale in place
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int col = half * kHalf + j * 8 + 2 * tq + (e & 1);
          const float pe =
              diag && col > wr + g + 8 * r
                  ? 0.f
                  : expf(__fmul_rn(p[j][e], scale) - mrow[r]) * inv_l[r];
          ds[j][e] = (ds[j][e] - di[r]) * pe * scale;
        }
      // dQ += dS K, dS straight from the accumulators
      acc_product_tf32<D>(acc, ds, kh, g, tq);
    }
  }

  if (!hand_over_partial<kThr>(acc, ks)) return;
  const int64_t row = q0 + wr + g;
  float* out = dq + b * sdq.b + row * sdq.l + h * sdq.h;
  store_acc_f32<D>(out, out + 8 * sdq.l, acc, tq);
}

// ---------------------------------------------------------------------------
// B5b: dK and dV, one block per key tile
// ---------------------------------------------------------------------------

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

// The tensor-core dK/dV in float32 (3xTF32).  Shared memory: the K and V
// tiles, two Q and two dO buffers (64 rows of D + 4 floats each), then two
// sets of the query rows' m, 1/l and di.
template <int D>
constexpr int dkv_tf32_smem_bytes() {
  return (6 * kBM * (D + 4) + 2 * 3 * kBM) * (int)sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(kTf32Threads<D>, 1)
    flash_bwd_dkv_tf32x3(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ m_in,
                         const float* __restrict__ l_in,
                         const float* __restrict__ di_in,
                         float* __restrict__ dk, float* __restrict__ dv,
                         int L, Strides sq, Strides sk, Strides sv,
                         Strides sdo, Strides sdk, Strides sdv, float scale,
                         int causal) {
  constexpr int kThr = kTf32Threads<D>;
  constexpr int kLd = D + 4;
  constexpr int kTile = kBM * kLd;
  constexpr int kNO = D / 8;
  extern __shared__ __align__(16) unsigned char smem_tc[];
  float* ks = reinterpret_cast<float*>(smem_tc);
  float* vs = ks + kTile;
  float* qs = vs + kTile;          // [2][kBM][D + 4]
  float* dos = qs + 2 * kTile;     // [2][kBM][D + 4]
  float* stats = dos + 2 * kTile;  // [2][3][kBM]

  const int kt = blockIdx.x;  // key tile 0 walks the most query tiles
  const int h = blockIdx.y, b = blockIdx.z;
  const int k0 = kt * kBN;
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int warp = threadIdx.x >> 5;
  const int wr = (warp & 3) * 16;  // the warp's first key row
  const int half0 = warp >> 2;     // its first query half of a tile
  const int64_t stat_bh = ((int64_t)b * gridDim.y + h) * L;
  const float* qbase = q + b * sq.b + h * sq.h;
  const float* dobase = dout + b * sdo.b + h * sdo.h;
  const int j0 = causal ? kt : 0, n_q = L / kBM;  // kBM == kBN

  copy_tile_async<D, kThr>(ks, k + b * sk.b + k0 * sk.l + h * sk.h, sk.l);
  copy_tile_async<D, kThr>(vs, v + b * sv.b + k0 * sv.l + h * sv.h, sv.l);
  copy_tile_async<D, kThr>(qs, qbase + (int64_t)j0 * kBM * sq.l, sq.l);
  copy_tile_async<D, kThr>(dos, dobase + (int64_t)j0 * kBM * sdo.l, sdo.l);
  cp_async_commit();
  if (threadIdx.x < kBM) {  // the first query tile's m, 1/l, di
    const int64_t i = stat_bh + j0 * kBM + threadIdx.x;
    stats[threadIdx.x] = m_in[i];
    stats[kBM + threadIdx.x] = 1.f / l_in[i];
    stats[2 * kBM + threadIdx.x] = di_in[i];
  }

  // key rows g and g + 8 of the warp: dK and dV
  float acc_dk[kNO][4], acc_dv[kNO][4];
#pragma unroll
  for (int n = 0; n < kNO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dk[n][e] = acc_dv[n][e] = 0.f;

  for (int j = j0; j < n_q; ++j) {
    const int buf = (j - j0) & 1;
    cp_async_wait_all();
    __syncthreads();  // tile j is in; every warp is done with tile j - 1
    // the next tile into the other buffers; its statistics stay in flight
    // in registers until this tile is done
    const bool more = j + 1 < n_q;
    float next_m = 0.f, next_l = 1.f, next_di = 0.f;
    if (more) {
      const int64_t r1 = (int64_t)(j + 1) * kBM;
      copy_tile_async<D, kThr>(qs + (buf ^ 1) * kTile, qbase + r1 * sq.l,
                               sq.l);
      copy_tile_async<D, kThr>(dos + (buf ^ 1) * kTile, dobase + r1 * sdo.l,
                               sdo.l);
      if (threadIdx.x < kBM) {
        next_m = m_in[stat_bh + r1 + threadIdx.x];
        next_l = l_in[stat_bh + r1 + threadIdx.x];
        next_di = di_in[stat_bh + r1 + threadIdx.x];
      }
    }
    cp_async_commit();
    const float* qt = qs + buf * kTile;
    const float* dot = dos + buf * kTile;
    const float* ms = stats + buf * 3 * kBM;
    const float* ils = ms + kBM;
    const float* dis = ils + kBM;

    // the tile in two halves of 32 queries (one each at 8 warps): rows the
    // warp's keys g, g + 8; query block jn of a half holds queries 8 jn +
    // 2tq, +1
    const bool diag = causal && j == kt;
#pragma unroll 1
    for (int half = half0; half < kBM / kHalf; half += kThr / kMmaThreads) {
      const float* qh = qt + half * kHalf * kLd;
      const float* doh = dot + half * kHalf * kLd;
      // S^T = K Q^T on the CUDA cores (B5a's chains), then P^T = exp(s *
      // scale - m) * (1/l), 0 where key > query on the diagonal
      float p[4][4];
      slab_scores_ffma<D>(p, ks, wr, qh, g, tq);
#pragma unroll
      for (int jn = 0; jn < 4; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = half * kHalf + jn * 8 + 2 * tq + (e & 1);
          p[jn][e] = diag && wr + g + (e >> 1) * 8 > col
                         ? 0.f
                         : expf(__fmul_rn(p[jn][e], scale) - ms[col]) *
                               ils[col];
        }
      // dV += P^T dO, P^T straight from the accumulators
      acc_product_tf32<D>(acc_dv, p, doh, g, tq);
      // dP^T = V dO^T in 3xTF32 (V re-read from shared memory and split),
      // then dS^T = (dP^T - di) P^T scale in place
      float ds[4][4];
      slab_product_tf32<D>(ds, vs, wr, doh, g, tq);
#pragma unroll
      for (int jn = 0; jn < 4; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = half * kHalf + jn * 8 + 2 * tq + (e & 1);
          ds[jn][e] = (ds[jn][e] - dis[col]) * p[jn][e] * scale;
        }
      // dK += dS^T Q
      acc_product_tf32<D>(acc_dk, ds, qh, g, tq);
    }
    if (more && threadIdx.x < kBM) {  // free since this tile's barrier
      float* next = stats + (buf ^ 1) * 3 * kBM;
      next[threadIdx.x] = next_m;
      next[kBM + threadIdx.x] = 1.f / next_l;
      next[2 * kBM + threadIdx.x] = next_di;
    }
  }

  hand_over_partial<kThr>(acc_dv, ks);  // K and V are free by then
  if (!hand_over_partial<kThr>(acc_dk, qs)) return;
  const int64_t row = k0 + wr + g;
  float* out_k = dk + b * sdk.b + row * sdk.l + h * sdk.h;
  float* out_v = dv + b * sdv.b + row * sdv.l + h * sdv.h;
  store_acc_f32<D>(out_k, out_k + 8 * sdk.l, acc_dk, tq);
  store_acc_f32<D>(out_v, out_v + 8 * sdv.l, acc_dv, tq);
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

// BODY(T, DIM) for the head dim D: each entry point launches its float32
// kernel for dtype 0 (3xTF32 tensor cores beside the CUDA cores' scores)
// and its bfloat16 tensor-core kernel for dtype 1.
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
#define DL_FWD_ARGS(T)                                                      \
  B, L, H, stream, static_cast<const T*>(q), static_cast<const T*>(k),      \
      static_cast<const T*>(v), static_cast<T*>(o),                         \
      static_cast<float*>(m_out), static_cast<float*>(l_out), L, sq, sk,    \
      sv, so, scale, causal
#define DL_FWD_TF32(T, DIM)                                                 \
  return launch(flash_fwd_tf32x3<DIM>, fwd_tf32_smem_bytes<DIM>(),          \
                kTf32Threads<DIM>, DL_FWD_ARGS(T));
#define DL_FWD_MMA(T, DIM)                                                  \
  return launch(flash_fwd_mma<DIM>, fwd_mma_smem_bytes<DIM>(), kMmaThreads, \
                DL_FWD_ARGS(T));
  if (dtype == 0) { DL_HEAD_DIMS(DL_FWD_TF32, float) }
  if (dtype == 1) { DL_HEAD_DIMS(DL_FWD_MMA, bf16) }
#undef DL_FWD_ARGS
#undef DL_FWD_TF32
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
#define DL_DQ_TF32(T, DIM)                                                  \
  return launch(flash_bwd_dq_tf32x3<DIM>, dq_tf32_smem_bytes<DIM>(),        \
                kTf32Threads<DIM>, DL_DQ_ARGS(T));
#define DL_DQ_MMA(T, DIM)                                                   \
  return launch(flash_bwd_dq_mma<DIM>, dq_mma_smem_bytes<DIM>(),            \
                kMmaThreads, DL_DQ_ARGS(T));
  if (dtype == 0) { DL_HEAD_DIMS(DL_DQ_TF32, float) }
  if (dtype == 1) { DL_HEAD_DIMS(DL_DQ_MMA, bf16) }
#undef DL_DQ_ARGS
#undef DL_DQ_TF32
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
#define DL_DKV_TF32(T, DIM)                                               \
  return launch(flash_bwd_dkv_tf32x3<DIM>, dkv_tf32_smem_bytes<DIM>(),     \
                kTf32Threads<DIM>, DL_DKV_ARGS(T));
#define DL_DKV_MMA(T, DIM)                                               \
  return launch(flash_bwd_dkv_mma<DIM>, dkv_mma_smem_bytes<DIM>(),         \
                kMmaThreads, DL_DKV_ARGS(T));
  if (dtype == 0) { DL_HEAD_DIMS(DL_DKV_TF32, float) }
  if (dtype == 1) { DL_HEAD_DIMS(DL_DKV_MMA, bf16) }
#undef DL_DKV_ARGS
#undef DL_DKV_TF32
#undef DL_DKV_MMA
  return -(int)cudaErrorInvalidValue;
}
#undef DL_HEAD_DIMS
