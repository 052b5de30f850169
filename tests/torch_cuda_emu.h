// Host emulation of the CUDA features that the kernels of
// distlearn_tpu_torch/ops/csrc/flash_attention.cu, wire_kernels.cu and
// fused_update.cu use, so that they compile with g++ and run on the CPU
// (tests/test_torch_flash_emulated.py, tests/test_torch_wire_kernels.py,
// tests/test_torch_fused_emulated.py).
//
// Every thread of a block is a std::thread; blocks run one after another on
// the same threads.
// __syncthreads is a barrier over the block, and each warp collective
// (__shfl_xor_sync, ldmatrix, mma.sync) exchanges its lanes' operands
// through slots between two barriers over the warp.  ldmatrix,
// mma.sync.m16n8k16 (bfloat16) and mma.sync.m16n8k8 (TF32) follow the PTX
// ISA's fragment layouts; bfloat16 rounds to nearest even, cvt.rna.tf32.f32
// to nearest with ties away from zero.  cp.async either lands at once or is held back until the
// issuing thread's cp.async.wait_group, the two ends of what the card may
// do, so a tile read before its wait or overwritten while another warp
// reads it shows up as a wrong result in one of the two modes.
#pragma once
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __grid_constant__
// a static array in a kernel is shared by every thread of the one block
// that runs at a time
#define __shared__ static
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
#define __align__(x) alignas(x)

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 0 };
template <typename K>
cudaError_t cudaFuncSetAttribute(K, int, int) { return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
inline cudaError_t cudaGetDevice(int* dev) {
  *dev = 0;
  return cudaSuccess;
}
// two SMs: grid-stride kernels get few blocks, so few threads here
inline cudaError_t cudaDeviceGetAttribute(int* value, cudaDeviceAttr, int) {
  *value = 2;
  return cudaSuccess;
}
inline cudaError_t cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) {
  std::memset(p, v, n);
  return cudaSuccess;
}

struct __nv_bfloat16 { uint16_t x; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
struct alignas(16) float4 { float x, y, z, w; };
struct alignas(8) float2 { float x, y; };
inline float2 make_float2(float x, float y) { return {x, y}; }
struct alignas(8) uint2 { uint32_t x, y; };
struct alignas(4) char4 { signed char x, y, z, w; };

inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {uint16_t((u >> 16) | 0x40)};
  u += 0x7fffu + ((u >> 16) & 1u);
  return {uint16_t(u >> 16)};
}
inline float __bfloat162float(__nv_bfloat16 b) {
  const uint32_t u = uint32_t(b.x) << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) {
  return {__float2bfloat16_rn(a), __float2bfloat16_rn(b)};
}
inline float __uint_as_float(uint32_t u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
// one rounding each, never contracted into a neighbouring operation
inline float __fmul_rn(float a, float b) {
  volatile float r = a * b;
  return r;
}
inline float __fadd_rn(float a, float b) {
  volatile float r = a + b;
  return r;
}
inline float __fsub_rn(float a, float b) {
  volatile float r = a - b;
  return r;
}
inline float __fdiv_rn(float a, float b) {
  volatile float r = a / b;
  return r;
}
inline double __ddiv_rn(double a, double b) {
  volatile double r = a / b;
  return r;
}
inline float __double2float_rn(double x) {
  volatile float r = (float)x;  // to nearest even, the default mode
  return r;
}
inline int __float2int_rn(float x) { return (int)std::nearbyint(x); }
// cache hints (streaming loads and stores) change nothing on the host
template <typename T>
inline T __ldcs(const T* p) {
  return *p;
}
template <typename T>
inline void __stcs(T* p, T v) {
  *p = v;
}
inline uint32_t __float_as_uint(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  return u;
}
inline unsigned max(unsigned a, unsigned b) { return a > b ? a : b; }
inline unsigned atomicMax(unsigned* p, unsigned v) {
  std::atomic_ref<unsigned> a(*p);
  unsigned old = a.load();
  while (old < v && !a.compare_exchange_weak(old, v)) {
  }
  return old;
}

// the dynamic shared memory of the one block that runs at a time
alignas(128) inline unsigned char emu_smem[232448];

struct EmuBlock {
  std::unique_ptr<std::barrier<>> block;
  std::atomic<int> vote{0};  // __syncthreads_or
  std::vector<std::unique_ptr<std::barrier<>>> warps;
  uint64_t slots[32][32][8];  // [warp][lane][word]
};
inline EmuBlock* emu_block;
inline int emu_async_mode = 0;  // 0: cp.async lands at once; 1: at the wait
struct EmuCopy {
  void* dst;
  const void* src;
};
inline thread_local std::vector<EmuCopy> emu_pending;

inline int emu_lane() { return threadIdx.x % 32; }
inline void emu_warp_sync() {
  emu_block->warps[threadIdx.x / 32]->arrive_and_wait();
}
inline uint64_t* emu_slot(int lane) {
  return emu_block->slots[threadIdx.x / 32][lane];
}

inline void __syncthreads() { emu_block->block->arrive_and_wait(); }

inline int __syncthreads_or(int pred) {
  if (pred) emu_block->vote.fetch_or(1);
  __syncthreads();
  const int any = emu_block->vote.load();
  __syncthreads();
  if (threadIdx.x == 0) emu_block->vote.store(0);
  __syncthreads();
  return any;
}

inline float __shfl_xor_sync(unsigned, float x, int off) {
  std::memcpy(emu_slot(emu_lane()), &x, 4);
  emu_warp_sync();
  float y;
  std::memcpy(&y, emu_slot(emu_lane() ^ off), 4);
  emu_warp_sync();
  return y;
}

inline unsigned __reduce_max_sync(unsigned, unsigned x) {
  emu_slot(emu_lane())[0] = x;
  emu_warp_sync();
  unsigned m = 0;
  for (int l = 0; l < 32; ++l) m = max(m, (unsigned)emu_slot(l)[0]);
  emu_warp_sync();
  return m;
}

inline void cp_async16(void* dst, const void* src) {
  if (emu_async_mode == 0)
    std::memcpy(dst, src, 16);
  else
    emu_pending.push_back({dst, src});
}
inline void cp_async_commit() {}
inline void cp_async_wait_all() {
  for (const EmuCopy& c : emu_pending) std::memcpy(c.dst, c.src, 16);
  emu_pending.clear();
}

inline uint32_t emu_pack(uint16_t lo, uint16_t hi) {
  return uint32_t(lo) | (uint32_t(hi) << 16);
}
// r[i] of lane l: row l/4, columns 2(l%4), +1 of matrix i, whose 8 rows
// lanes 8i .. 8i+7 point at
inline void ldsm_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  emu_slot(emu_lane())[0] = (uint64_t)(uintptr_t)p;
  emu_warp_sync();
  const int l = emu_lane();
  for (int i = 0; i < 4; ++i) {
    const uint16_t* row =
        (const uint16_t*)(uintptr_t)emu_slot(i * 8 + l / 4)[0];
    r[i] = emu_pack(row[2 * (l % 4)], row[2 * (l % 4) + 1]);
  }
  emu_warp_sync();
}
// .trans: rows 2(l%4), +1, column l/4 of matrix i
inline void ldsm_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  emu_slot(emu_lane())[0] = (uint64_t)(uintptr_t)p;
  emu_warp_sync();
  const int l = emu_lane();
  for (int i = 0; i < 4; ++i) {
    const uint16_t* r0 =
        (const uint16_t*)(uintptr_t)emu_slot(i * 8 + 2 * (l % 4))[0];
    const uint16_t* r1 =
        (const uint16_t*)(uintptr_t)emu_slot(i * 8 + 2 * (l % 4) + 1)[0];
    r[i] = emu_pack(r0[l / 4], r1[l / 4]);
  }
  emu_warp_sync();
}
inline float emu_lo(uint64_t u) { return __bfloat162float({uint16_t(u)}); }
inline float emu_hi(uint64_t u) {
  return __bfloat162float({uint16_t(u >> 16)});
}
// c += a b over the warp: A 16x16 (row-major fragments), B 16x8, C 16x8
inline void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                     uint32_t b1) {
  uint64_t* s = emu_slot(emu_lane());
  for (int i = 0; i < 4; ++i) s[i] = a[i];
  s[4] = b0;
  s[5] = b1;
  emu_warp_sync();
  float A[16][16], Bm[16][8];
  for (int l = 0; l < 32; ++l) {
    const uint64_t* o = emu_slot(l);
    const int g = l / 4, t = l % 4;
    for (int h = 0; h < 2; ++h) {
      A[g][2 * t + h] = h ? emu_hi(o[0]) : emu_lo(o[0]);
      A[g + 8][2 * t + h] = h ? emu_hi(o[1]) : emu_lo(o[1]);
      A[g][8 + 2 * t + h] = h ? emu_hi(o[2]) : emu_lo(o[2]);
      A[g + 8][8 + 2 * t + h] = h ? emu_hi(o[3]) : emu_lo(o[3]);
      Bm[2 * t + h][g] = h ? emu_hi(o[4]) : emu_lo(o[4]);
      Bm[8 + 2 * t + h][g] = h ? emu_hi(o[5]) : emu_lo(o[5]);
    }
  }
  emu_warp_sync();
  const int g = emu_lane() / 4, t = emu_lane() % 4;
  for (int e = 0; e < 4; ++e) {
    const int row = g + (e >> 1) * 8, col = 2 * t + (e & 1);
    float acc = c[e];
    for (int k = 0; k < 16; ++k) acc += A[row][k] * Bm[k][col];
    c[e] = acc;
  }
}

// cvt.rna.tf32.f32: x rounded to 10 mantissa bits, to nearest with ties
// away from zero (a carry into the exponent is the right rounding), the
// low 13 bits 0; NaN and infinity pass through
inline uint32_t to_tf32(float x) {
  uint32_t u;
  std::memcpy(&u, &x, 4);
  if ((u & 0x7f800000u) == 0x7f800000u) return u;
  return (u + 0x1000u) & 0xffffe000u;
}
// c += a b over the warp: A 16x8, B 8x8, C 16x8, all TF32 bit patterns in
// 32-bit registers; each product of two TF32 values is exact in float32,
// and the sum runs in float32 over k in order
inline void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                     uint32_t b1) {
  uint64_t* s = emu_slot(emu_lane());
  for (int i = 0; i < 4; ++i) s[i] = a[i];
  s[4] = b0;
  s[5] = b1;
  emu_warp_sync();
  float A[16][8], Bm[8][8];
  for (int l = 0; l < 32; ++l) {
    const uint64_t* o = emu_slot(l);
    const int g = l / 4, t = l % 4;
    A[g][t] = __uint_as_float(uint32_t(o[0]));
    A[g + 8][t] = __uint_as_float(uint32_t(o[1]));
    A[g][t + 4] = __uint_as_float(uint32_t(o[2]));
    A[g + 8][t + 4] = __uint_as_float(uint32_t(o[3]));
    Bm[t][g] = __uint_as_float(uint32_t(o[4]));
    Bm[t + 4][g] = __uint_as_float(uint32_t(o[5]));
  }
  emu_warp_sync();
  const int g = emu_lane() / 4, t = emu_lane() % 4;
  for (int e = 0; e < 4; ++e) {
    const int row = g + (e >> 1) * 8, col = 2 * t + (e & 1);
    float acc = c[e];
    for (int k = 0; k < 8; ++k) acc += A[row][k] * Bm[k][col];
    c[e] = acc;
  }
}

template <typename Kernel, typename... Args>
void emu_launch(Kernel kernel, dim3 grid, int threads, Args... args) {
  EmuBlock blk;
  blk.block = std::make_unique<std::barrier<>>(threads);
  for (int w = 0; w < threads / 32; ++w)
    blk.warps.push_back(std::make_unique<std::barrier<>>(32));
  emu_block = &blk;
  std::vector<std::thread> ts;
  for (int t = 0; t < threads; ++t)
    ts.emplace_back([&, t] {
      threadIdx = dim3(t);
      blockDim = dim3(threads);
      gridDim = grid;
      for (unsigned z = 0; z < grid.z; ++z)
        for (unsigned y = 0; y < grid.y; ++y)
          for (unsigned x = 0; x < grid.x; ++x) {
            blockIdx = dim3(x, y, z);
            kernel(args...);
            cp_async_wait_all();
            // the block ends before the next one starts on the same
            // threads and shared memory
            __syncthreads();
          }
    });
  for (std::thread& th : ts) th.join();
}
