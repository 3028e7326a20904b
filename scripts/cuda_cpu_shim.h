// A CPU stand-in for the CUDA features the port's kernels use, so that a
// kernel source can be compiled with g++ and run on the CPU at a small
// size (scripts/cuda_cpu_rehearsal.py). One std::thread per CUDA thread,
// the blocks of a launch one after another; std::barrier for
// __syncthreads and for each warp; warp collectives (shuffles, ballots,
// ldmatrix, mma.sync m16n8k32 s8 and m16n8k16 bf16) exchange through a
// per-warp buffer with the lane layouts of the PTX ISA; cp.async copies at once (commit and
// wait are no-ops). Slow, and no model of timing or of memory ordering
// beyond the barriers; it checks indexing, layouts and arithmetic.
#pragma once
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <algorithm>
#include <atomic>
#include <barrier>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__ __restrict
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))
#define __launch_bounds__(...)

using std::max;
using std::min;

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};
struct __attribute__((aligned(16))) int4 { int x, y, z, w; };
struct __attribute__((aligned(16))) uint4 { unsigned x, y, z, w; };
struct __attribute__((aligned(16))) float4 { float x, y, z, w; };
struct __attribute__((aligned(8))) uint2 { unsigned x, y; };
struct __attribute__((aligned(8))) int2 { int x, y; };
struct __attribute__((aligned(8))) float2 { float x, y; };
struct __attribute__((aligned(4))) char4 { signed char x, y, z, w; };
struct __nv_bfloat16 { uint16_t bits; };
inline int4 make_int4(int x, int y, int z, int w) { return {x, y, z, w}; }
inline uint4 make_uint4(unsigned x, unsigned y, unsigned z, unsigned w) { return {x, y, z, w}; }
inline float4 make_float4(float x, float y, float z, float w) { return {x, y, z, w}; }
inline float2 make_float2(float x, float y) { return {x, y}; }
inline uint2 make_uint2(unsigned x, unsigned y) { return {x, y}; }

typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute {
  cudaFuncAttributeMaxDynamicSharedMemorySize,
  cudaFuncAttributePreferredSharedMemoryCarveout
};
enum { cudaSharedmemCarveoutMaxShared = 100 };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
template <class F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return cudaSuccess; }
template <class F>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int, size_t) {
  *n = 1;
  return cudaSuccess;
}
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
// Two "SMs": persistent kernels then walk their items in several rounds.
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) { *v = 2; return cudaSuccess; }

inline unsigned __float_as_uint(float f) { unsigned u; memcpy(&u, &f, 4); return u; }
inline float __uint_as_float(unsigned u) { float f; memcpy(&f, &u, 4); return f; }
inline int __float_as_int(float f) { int u; memcpy(&u, &f, 4); return u; }
inline float __int_as_float(int u) { float f; memcpy(&f, &u, 4); return f; }
inline float __int2float_rn(int i) { return static_cast<float>(i); }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
// Bytes of {b, a} (a bytes 0-3, b bytes 4-7) picked by the selector's nibbles.
inline unsigned __byte_perm(unsigned a, unsigned b, unsigned s) {
  const uint64_t both = (static_cast<uint64_t>(b) << 32) | a;
  unsigned r = 0;
  for (int i = 0; i < 4; ++i) r |= static_cast<unsigned>((both >> (8 * ((s >> (4 * i)) & 7))) & 0xFF) << (8 * i);
  return r;
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __popcll(unsigned long long x) { return __builtin_popcountll(x); }
inline int __ffs(int x) { return __builtin_ffs(x); }
inline int __clz(int x) { return x == 0 ? 32 : __builtin_clz(static_cast<unsigned>(x)); }
template <class T>
T __ldg(const T* p) { return *p; }
inline int atomicAdd(int* p, int v) { return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST); }
inline unsigned atomicAdd(unsigned* p, unsigned v) { return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST); }

struct ShimWarp {
  std::barrier<> bar{32};
  uint64_t x[32];
  unsigned m[32][6];
};
struct ShimBlock {
  std::unique_ptr<std::barrier<>> bar;
  std::vector<std::unique_ptr<ShimWarp>> warps;
  unsigned char* dyn;
  std::atomic<int> counts[2] = {0, 0};  // __syncthreads_count's, alternating
};
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;
inline thread_local ShimBlock* shim_blk;
inline thread_local int shim_tid;

inline void __syncthreads() { shim_blk->bar->arrive_and_wait(); }
// Barrier that counts the threads whose predicate holds.
inline int __syncthreads_count(int pred) {
  static thread_local int phase = 0;  // a thread serves one block
  std::atomic<int>& c = shim_blk->counts[phase];
  phase ^= 1;
  if (pred) c.fetch_add(1);
  shim_blk->bar->arrive_and_wait();
  const int n = c.load();
  shim_blk->bar->arrive_and_wait();
  shim_blk->counts[phase].store(0);  // the other counter, for the next call
  shim_blk->bar->arrive_and_wait();
  return n;
}
inline int __syncthreads_or(int pred) { return __syncthreads_count(pred != 0) != 0; }
inline ShimWarp& shim_warp() { return *shim_blk->warps[shim_tid >> 5]; }
inline void __syncwarp(unsigned = 0xffffffffu) { shim_warp().bar.arrive_and_wait(); }

template <class T>
T shim_from(int src, T v) {
  ShimWarp& w = shim_warp();
  uint64_t bits = 0;
  memcpy(&bits, &v, sizeof(T));
  w.x[shim_tid & 31] = bits;
  w.bar.arrive_and_wait();
  T r;
  bits = w.x[src & 31];
  memcpy(&r, &bits, sizeof(T));
  w.bar.arrive_and_wait();
  return r;
}
template <class T>
T __shfl_sync(unsigned, T v, int src) { return shim_from(src, v); }
template <class T>
T __shfl_up_sync(unsigned, T v, unsigned d) {
  const int lane = shim_tid & 31;
  return shim_from(lane >= static_cast<int>(d) ? lane - static_cast<int>(d) : lane, v);
}
template <class T>
T __shfl_down_sync(unsigned, T v, unsigned d) {
  const int lane = shim_tid & 31;
  return shim_from(lane + static_cast<int>(d) < 32 ? lane + static_cast<int>(d) : lane, v);
}
template <class T>
T __shfl_xor_sync(unsigned, T v, int m) { return shim_from((shim_tid & 31) ^ m, v); }
inline unsigned __ballot_sync(unsigned, int pred) {
  ShimWarp& w = shim_warp();
  w.x[shim_tid & 31] = pred != 0;
  w.bar.arrive_and_wait();
  unsigned r = 0;
  for (int i = 0; i < 32; ++i) r |= static_cast<unsigned>(w.x[i]) << i;
  w.bar.arrive_and_wait();
  return r;
}
inline int __any_sync(unsigned m, int pred) { return __ballot_sync(m, pred) != 0; }
inline int __all_sync(unsigned m, int pred) { return __ballot_sync(m, pred) == 0xffffffffu; }

// ---- the asm helpers of the kernel sources, by name ----
// Shared addresses are offsets into the launch's dynamic shared memory.
inline size_t __cvta_generic_to_shared(const void* p) {
  return static_cast<size_t>(static_cast<const unsigned char*>(p) - shim_blk->dyn);
}
template <int BYTES>
void cp_async(void* dst, const void* src) { memcpy(dst, src, BYTES); }
// cp.async with a source size: `bytes` copied, the rest of N zero-filled.
inline void shim_cp(void* dst, const void* src, int n, int bytes) {
  memcpy(dst, src, bytes);
  memset(static_cast<char*>(dst) + bytes, 0, n - bytes);
}
inline void cp_async16(void* dst, const void* src, int bytes) { shim_cp(dst, src, 16, bytes); }
inline void cp_async8(void* dst, const void* src, int bytes) { shim_cp(dst, src, 8, bytes); }
inline void cp_async4(void* dst, const void* src, int bytes) { shim_cp(dst, src, 4, bytes); }
inline void cp_async_commit() {}
inline void cp_async_wait_oldest() {}
template <int N>
void cp_async_wait() {}
inline void cp_async_wait_all() {}

inline void ldmatrix_x4(unsigned addr, unsigned& r0, unsigned& r1, unsigned& r2, unsigned& r3) {
  ShimWarp& w = shim_warp();
  const int lane = shim_tid & 31;
  w.x[lane] = addr;
  w.bar.arrive_and_wait();
  unsigned r[4];
  for (int j = 0; j < 4; ++j)
    memcpy(&r[j], shim_blk->dyn + w.x[j * 8 + lane / 4] + 4 * (lane % 4), 4);
  w.bar.arrive_and_wait();
  r0 = r[0], r1 = r[1], r2 = r[2], r3 = r[3];
}

// c += A (16 x 16 bf16, row) * B (16 x 8 bf16, col): the fragment layouts
// of mma.m16n8k16 .bf16 (two values a register, the lower k in the low
// half). Products exact, summed in double, rounded once to float32.
inline void mma_bf16(float (&c)[4], unsigned a0, unsigned a1, unsigned a2, unsigned a3,
                     unsigned b0, unsigned b1) {
  ShimWarp& w = shim_warp();
  const int lane = shim_tid & 31;
  const unsigned mine[6] = {a0, a1, a2, a3, b0, b1};
  memcpy(w.m[lane], mine, sizeof(mine));
  w.bar.arrive_and_wait();
  auto bf = [&](int src, int reg, int k) {
    return static_cast<double>(__uint_as_float((w.m[src][reg] >> (16 * (k % 2))) << 16));
  };
  auto a_at = [&](int r, int k) {
    return bf((r % 8) * 4 + (k % 8) / 2, (r >= 8 ? 1 : 0) + (k >= 8 ? 2 : 0), k);
  };
  auto b_at = [&](int k, int n) { return bf(n * 4 + (k % 8) / 2, 4 + (k >= 8 ? 1 : 0), k); };
  float out[4];
  for (int i = 0; i < 4; ++i) {
    const int r = lane / 4 + (i >= 2 ? 8 : 0), n = 2 * (lane % 4) + (i & 1);
    double s = c[i];
    for (int k = 0; k < 16; ++k) s += a_at(r, k) * b_at(k, n);
    out[i] = static_cast<float>(s);
  }
  w.bar.arrive_and_wait();
  for (int i = 0; i < 4; ++i) c[i] = out[i];
}

// c += A (16 x 32 s8, row) * B (32 x 8 s8, col): the fragment layouts of
// mma.m16n8k32 .s8 (groupID = lane / 4, threadID_in_group = lane % 4).
inline void mma_s8(int4& c, unsigned a0, unsigned a1, unsigned a2, unsigned a3, unsigned b0,
                   unsigned b1) {
  ShimWarp& w = shim_warp();
  const int lane = shim_tid & 31;
  const unsigned mine[6] = {a0, a1, a2, a3, b0, b1};
  memcpy(w.m[lane], mine, sizeof(mine));
  w.bar.arrive_and_wait();
  auto a_at = [&](int r, int k) {
    const int reg = (r >= 8 ? 1 : 0) + (k >= 16 ? 2 : 0);
    const int src = (r % 8) * 4 + (k % 16) / 4;
    return static_cast<int>(static_cast<signed char>(w.m[src][reg] >> (8 * (k % 4))));
  };
  auto b_at = [&](int k, int n) {
    const int reg = 4 + (k >= 16 ? 1 : 0);
    const int src = n * 4 + (k % 16) / 4;
    return static_cast<int>(static_cast<signed char>(w.m[src][reg] >> (8 * (k % 4))));
  };
  int out[4] = {c.x, c.y, c.z, c.w};
  for (int i = 0; i < 4; ++i) {
    const int r = lane / 4 + (i >= 2 ? 8 : 0), n = 2 * (lane % 4) + (i & 1);
    for (int k = 0; k < 32; ++k) out[i] += a_at(r, k) * b_at(k, n);
  }
  w.bar.arrive_and_wait();
  c = make_int4(out[0], out[1], out[2], out[3]);
}

struct ShimCfg {
  dim3 grid, block;
  size_t smem;
};
inline ShimCfg shim_cfg(dim3 g, dim3 b, size_t smem = 0, cudaStream_t = nullptr) {
  return {g, b, smem};
}

// Run every block of the launch, one after another; dynamic shared memory
// starts as 0xAB bytes, not zeros.
template <class... K, class... A>
void shim_launch(ShimCfg cfg, void (*kernel)(K...), A... args) {
  gridDim = cfg.grid;
  blockDim = cfg.block;
  const int nt = cfg.block.x * cfg.block.y * cfg.block.z;
  std::vector<unsigned char> dyn(cfg.smem + 64, 0xAB);
  for (unsigned bz = 0; bz < cfg.grid.z; ++bz)
    for (unsigned by = 0; by < cfg.grid.y; ++by)
      for (unsigned bx = 0; bx < cfg.grid.x; ++bx) {
        ShimBlock blk;
        blk.bar = std::make_unique<std::barrier<>>(nt);
        for (int i = 0; i < (nt + 31) / 32; ++i) blk.warps.push_back(std::make_unique<ShimWarp>());
        blk.dyn = dyn.data();
        std::vector<std::thread> ts;
        ts.reserve(nt);
        for (int t = 0; t < nt; ++t)
          ts.emplace_back([&, t] {
            shim_tid = t;
            shim_blk = &blk;
            threadIdx = dim3(t % cfg.block.x, (t / cfg.block.x) % cfg.block.y,
                             t / (cfg.block.x * cfg.block.y));
            blockIdx = dim3(bx, by, bz);
            kernel(args...);
            blk.bar->arrive_and_drop();
            blk.warps[t >> 5]->bar.arrive_and_drop();
          });
        for (auto& th : ts) th.join();
      }
}
