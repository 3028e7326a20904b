// Masked cosine top-m for NVIDIA Hopper (sm_90a).
//
// Replaces mobius_rag_tpu/ops/topk.py:_topk_kernel, the Pallas fused
// masked cosine top-k, and serves the JAX engine's exact vector arm
// (query/engine.py:277-279,477-485):
//
//   cos[b, c]   = (q[b]·v[c]) * s[c]            (s: int8 rows' scales, else 1)
//   score[b, c] = cos[b, c] + penalty[b, c] (+ NEG_INF where cos[b, c] < min_sim[b])
//   out[b]      = the top m of score[b, :], descending, lower row first on ties
//
// The rows are float32, bfloat16 or int8 (the store's
// MRAG_VECTOR_DTYPE=int8 form, with its per-row scales); each widens
// exactly to float32 as it is staged, so one pass-1 template serves all
// three. The scale multiplies the row's full dot (one rounded product)
// before the penalty and the min_sim test, as the JAX dense arm computes
// cos and then compares it.
//
// What bounds it: at the main path's shape (B=32 queries, C=70,144 rows,
// D=1536, m=40) it reads 431 MB of float32 rows for 6.9 GFLOP, i.e. 16
// FLOP per byte, far below the card's compute-to-bandwidth ratio: it is
// memory-bound, about 0.13 ms at the data-sheet 3.35 TB/s.
// int8 rows read a quarter of those bytes (108 MB, ~0.03 ms at 3.35 TB/s),
// which leaves the int8 form bound by pass 1's float32 FMAs (6.9 GFLOP)
// and the merge.
//
// What the design does about it: like the TPU kernel it reads the chunk
// matrix exactly once and never writes the [B, C] score matrix to device
// memory. Blocks run in no order on Hopper, so the TPU's sequential-grid
// running merge becomes two passes:
//
//   pass 1 (topk_tiles): one block per (128-row tile, group of 32
//     queries). The block stages 32-deep slices of the rows and queries
//     in shared memory; each thread accumulates 4 rows x 4 queries in
//     float32 registers, reading both operands as 128-bit shared loads
//     (2 loads per 16 FMAs; the row stride of 36 floats keeps the reads
//     of 8 consecutive rows on distinct banks). It then adds the penalty
//     and the min_sim mask, packs every (score, row) into one 64-bit key,
//     bitonic-sorts each query's 128 keys in shared memory and writes the
//     first min(m, 128) of them as this tile's partial list. At most 48
//     registers a thread, so 5 blocks fit an SM and the 548 tiles of the
//     main path run in one wave of the card's 132 SMs.
//   pass 2 (topk_merge), a tree: each block sorts up to 4096 partial keys
//     of one query in shared memory and keeps the first m; levels repeat,
//     all blocks of a level in parallel, until one block per query holds
//     the final top m.
//
// The 64-bit key is (order-preserving bits of the float score) << 32 |
// (0xFFFFFFFF - row), so a single descending sort gives score descending
// and, among equal scores, the lower row first: lax.top_k's tie order.
//
// Plain C interface for ctypes: the caller allocates the outputs and the
// scratch keys, the launches go on the caller's stream, nothing is
// allocated or synchronised here, and the return value is
// cudaGetLastError() after the launches.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE_ROWS = 128;  // rows per pass-1 block
constexpr int QG = 32;          // queries per pass-1 block
constexpr int DK = 32;          // depth slice staged per step
constexpr int SROW = DK + 4;    // shared row stride in floats (see pass 1)
constexpr int THREADS1 = 256;
constexpr int BLOCKS1_PER_SM = 5;
constexpr int BUF2 = 4096;      // keys one pass-2 block sorts
constexpr int THREADS2 = 1024;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ uint64_t make_key(float v, int row) {
  uint32_t u = __float_as_uint(v);
  uint32_t ord = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<uint64_t>(ord) << 32) |
         static_cast<uint64_t>(0xFFFFFFFFu - static_cast<uint32_t>(row));
}

__device__ __forceinline__ float key_val(uint64_t key) {
  uint32_t ord = static_cast<uint32_t>(key >> 32);
  uint32_t u = (ord & 0x80000000u) ? (ord & 0x7FFFFFFFu) : ~ord;
  return __uint_as_float(u);
}

__device__ __forceinline__ int key_row(uint64_t key) {
  return static_cast<int>(0xFFFFFFFFu - static_cast<uint32_t>(key));
}

// Four consecutive elements as float32 (16-byte aligned for float, 8 for
// bf16, 4 for int8; bf16 widens exactly by a 16-bit shift, int8 by an
// integer-to-float conversion, exact for |v| <= 127).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xFFFF0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xFFFF0000u));
}
__device__ __forceinline__ float4 load4(const int8_t* p) {
  char4 c = *reinterpret_cast<const char4*>(p);
  return make_float4(static_cast<float>(c.x), static_cast<float>(c.y),
                     static_cast<float>(c.z), static_cast<float>(c.w));
}

// Sort each of the total/n contiguous segments of s (n a power of two)
// into descending order. Called by every thread of the block; ends
// synchronised.
__device__ void bitonic_desc(uint64_t* s, int total, int n) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < total; i += blockDim.x) {
        int ixj = i ^ j;
        if (ixj > i) {
          uint64_t a = s[i], b = s[ixj];
          bool desc = ((i & (n - 1) & k) == 0);
          if (desc ? (a < b) : (a > b)) {
            s[i] = b;
            s[ixj] = a;
          }
        }
      }
      __syncthreads();
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS1, BLOCKS1_PER_SM)
topk_tiles(const float* __restrict__ q, const T* __restrict__ vec,
           const float* __restrict__ scales, const float* __restrict__ pen,
           long long pen_stride,
           const float* __restrict__ min_sim, int B, int C, int D, int P,
           uint64_t* __restrict__ partial) {
  // The staging tiles and, after the dot loop, the sort keys share it.
  __shared__ __align__(16) unsigned char smem[QG * TILE_ROWS * sizeof(uint64_t)];
  float* vs = reinterpret_cast<float*>(smem);  // [TILE_ROWS][SROW]
  float* qs = vs + TILE_ROWS * SROW;           // [QG][SROW]
  uint64_t* keys = reinterpret_cast<uint64_t*>(smem);  // [QG][TILE_ROWS]

  const int row0 = blockIdx.x * TILE_ROWS;
  const int q0 = blockIdx.y * QG;
  const int tid = threadIdx.x;
  const int rg = tid & 31;        // this thread's rows: rg + 32 i, i < 4
  const int qb = (tid >> 5) * 4;  // and queries qb .. qb + 3 of the group
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < D; k0 += DK) {
    for (int e = tid; e < TILE_ROWS * (DK / 4); e += THREADS1) {
      int rr = e / (DK / 4), kk = (e % (DK / 4)) * 4;
      int row = row0 + rr, k = k0 + kk;
      *reinterpret_cast<float4*>(vs + rr * SROW + kk) =
          (row < C && k < D) ? load4(vec + static_cast<size_t>(row) * D + k) : zero;
    }
    for (int e = tid; e < QG * (DK / 4); e += THREADS1) {
      int qq = e / (DK / 4), kk = (e % (DK / 4)) * 4;
      int qi = q0 + qq, k = k0 + kk;
      *reinterpret_cast<float4*>(qs + qq * SROW + kk) =
          (qi < B && k < D) ? load4(q + static_cast<size_t>(qi) * D + k) : zero;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < DK; kk += 4) {
      float4 qv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        qv[j] = *reinterpret_cast<const float4*>(qs + (qb + j) * SROW + kk);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float4 v = *reinterpret_cast<const float4*>(vs + (rg + 32 * i) * SROW + kk);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] = fmaf(qv[j].x, v.x, acc[i][j]);
          acc[i][j] = fmaf(qv[j].y, v.y, acc[i][j]);
          acc[i][j] = fmaf(qv[j].z, v.z, acc[i][j]);
          acc[i][j] = fmaf(qv[j].w, v.w, acc[i][j]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int rr = rg + 32 * i;
    int row = row0 + rr;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int qq = qb + j;
      int qi = q0 + qq;
      float s = -INFINITY;  // rows past C sort below every real score
      if (row < C && qi < B) {
        float dot = scales != nullptr ? __fmul_rn(acc[i][j], scales[row]) : acc[i][j];
        s = dot + pen[static_cast<size_t>(qi) * pen_stride + row];
        if (dot < min_sim[qi]) s += NEG_INF;
      }
      keys[qq * TILE_ROWS + rr] = make_key(s, row);
    }
  }
  __syncthreads();
  bitonic_desc(keys, QG * TILE_ROWS, TILE_ROWS);

  const size_t n_tiles = gridDim.x;
  for (int e = tid; e < QG * P; e += THREADS1) {
    int qq = e / P, p = e % P;
    int qi = q0 + qq;
    if (qi < B)
      partial[(static_cast<size_t>(qi) * n_tiles + blockIdx.x) * P + p] =
          keys[qq * TILE_ROWS + p];
  }
}

// Block (g, b) sorts keys [g * BUF2, (g + 1) * BUF2) of query b's n_in
// input keys and keeps the first m: into dst [B][gridDim.x][m] keys, or,
// on the last level (one block per query), into out_vals/out_idx.
__global__ void __launch_bounds__(THREADS2)
topk_merge(const uint64_t* __restrict__ src, int n_in, int m,
           uint64_t* __restrict__ dst, float* __restrict__ out_vals,
           int* __restrict__ out_idx) {
  __shared__ uint64_t buf[BUF2];
  const int g = blockIdx.x, b = blockIdx.y;
  const int base = g * BUF2;
  const int cnt = min(BUF2, n_in - base);
  int s = 2;
  while (s < cnt) s <<= 1;
  const uint64_t* in = src + static_cast<size_t>(b) * n_in + base;
  // Key 0 sorts below every real key (even a -inf score's).
  for (int i = threadIdx.x; i < s; i += blockDim.x) buf[i] = i < cnt ? in[i] : 0ull;
  __syncthreads();
  bitonic_desc(buf, s, s);
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    uint64_t key = i < s ? buf[i] : 0ull;
    if (dst != nullptr) {
      dst[(static_cast<size_t>(b) * gridDim.x + g) * m + i] = key;
    } else {
      out_vals[static_cast<size_t>(b) * m + i] = key_val(key);
      out_idx[static_cast<size_t>(b) * m + i] = key_row(key);
    }
  }
}

int partial_width(int m) { return m < TILE_ROWS ? m : TILE_ROWS; }

int n_tiles_of(int C) { return (C + TILE_ROWS - 1) / TILE_ROWS; }

}  // namespace

// Scratch the caller allocates: pass 1's partial keys and every merge
// level's output, in 64-bit keys.
extern "C" long long mrag_topk_scratch_elems(int B, int C, int m) {
  long long n_in = static_cast<long long>(n_tiles_of(C)) * partial_width(m);
  long long total = B * n_in;
  while (n_in > BUF2) {
    long long groups = (n_in + BUF2 - 1) / BUF2;
    total += B * groups * m;
    n_in = groups * m;
  }
  return total;
}

// q [B, D] f32; vec [C, D] row-major, f32 (vec_kind 0), bf16 (1) or int8
// (2), D a multiple of 4; scales [C] f32 or null (no scaling); pen f32
// with row stride pen_stride (C for [B, C], 0 for [C]); min_sim [B] f32;
// scratch: mrag_topk_scratch_elems(B, C, m) u64; out_vals [B, m] f32;
// out_idx [B, m] i32. Requires 1 <= m <= min(C, 1024).
extern "C" int mrag_masked_topk(const float* q, const void* vec, int vec_kind,
                                const float* scales, const float* pen,
                                long long pen_stride,
                                const float* min_sim, int B, int C, int D, int m,
                                void* scratch, float* out_vals, int* out_idx,
                                void* stream) {
  if (B < 1 || m < 1 || m > C || m > 1024 || D < 4 || D % 4 != 0 || vec_kind < 0 ||
      vec_kind > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = n_tiles_of(C);
  const int P = partial_width(m);
  dim3 grid1(n_tiles, (B + QG - 1) / QG);
  uint64_t* src = static_cast<uint64_t*>(scratch);
  if (vec_kind == 1)
    topk_tiles<__nv_bfloat16><<<grid1, THREADS1, 0, s>>>(
        q, static_cast<const __nv_bfloat16*>(vec), scales, pen, pen_stride, min_sim, B, C,
        D, P, src);
  else if (vec_kind == 2)
    topk_tiles<int8_t><<<grid1, THREADS1, 0, s>>>(
        q, static_cast<const int8_t*>(vec), scales, pen, pen_stride, min_sim, B, C, D, P,
        src);
  else
    topk_tiles<float><<<grid1, THREADS1, 0, s>>>(
        q, static_cast<const float*>(vec), scales, pen, pen_stride, min_sim, B, C, D, P,
        src);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  int n_in = n_tiles * P;
  uint64_t* next = src + static_cast<size_t>(B) * n_in;
  while (n_in > BUF2) {
    int groups = (n_in + BUF2 - 1) / BUF2;
    topk_merge<<<dim3(groups, B), THREADS2, 0, s>>>(src, n_in, m, next, nullptr, nullptr);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    src = next;
    next += static_cast<size_t>(B) * groups * m;
    n_in = groups * m;
  }
  topk_merge<<<dim3(1, B), THREADS2, 0, s>>>(src, n_in, m, nullptr, out_vals, out_idx);
  return static_cast<int>(cudaGetLastError());
}
