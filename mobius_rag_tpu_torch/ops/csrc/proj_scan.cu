// Probed cluster-block scans of the proj (projected-residual int8) ANN
// backend, for NVIDIA Hopper (sm_90a).
//
// Replaces both kernels of mobius_rag_tpu/ops/pallas_proj.py:
//
//   proj_blocks        (_kernel, pallas_proj.py:41)
//     raw[b, j, s]   = sum_i codes[probe[b, j], s, i] * q8[b, i]        (exact)
//   proj_gated_blocks  (_gated_kernel, pallas_proj.py:141)
//     score[b, j, s] = raw[b, j, s] * scale(slot)  where the slot passes the
//                      query's strict/relaxed/auto filter gate, else -1e30
//     rowid[b, j, s] = the slot's row id (word 3 of the gate pack)
//
// codes [nlist, pad, p] int8, q8 [B, p] int8, probe [B, P] int32; the
// gate pack words [nlist, W, pad] int32 is word-major (ops/proj.py
// gate_widths): 0 payer | state << 16, 1 program | valid << 16 |
// regulator << 17, 2 dequant scale (float bits), 3 row id, 4.. the j, d
// and p tag bitset words.
//
// Arithmetic: int8 x int8 products accumulate in int32 (__dp4a) and the
// sum converts to float once (__int2float_rn): the arithmetic of the XLA
// twin (dot_general with preferred_element_type=int32, then astype f32;
// ops/proj.py:387-389,672-674), exact for any p up to 2^31 / 127^2.
// The TPU kernel accumulated in f32, exact only while p * 127^2 < 2^24.
//
// What bounds it: every probed slot is read once, p bytes of codes (and,
// gated, W_lvl * 4 bytes of gate words) for 2p integer operations: at
// the 1M-row shape (B=32, P=66, pad=2048, p=256) about 1.1 GB of codes
// per batch for 1.1 G multiply-adds, so it is bound by memory and L2
// traffic, ~0.33 ms at the data-sheet 3.35 TB/s before L2 reuse between
// queries that probe the same cluster.
//
// What the design does about it (a simple first design): one block per
// (256-slot tile, probe j, query b). The block stages q8[b] (and, gated,
// the query's gate parameters) in shared memory. Each warp takes 32 slots
// in turn; for one slot its lanes stride over the row's 4-byte words, so a
// warp's loads are 128-byte coalesced runs, and an xor-shuffle reduction
// sums the lanes. The raw dots go to shared memory; then one thread per
// slot reads the slot's gate words (word-major, so consecutive threads
// read consecutive addresses), applies the gate and writes the outputs
// coalesced. Rows whose byte start is not 4-aligned (p % 4 != 0) take a
// byte loop. Tensor-core tiles that group the queries probing one
// cluster, TMA and double buffering are later work.
//
// Plain C interface for ctypes: the caller allocates the outputs, the
// launch goes on the caller's stream, nothing is allocated or
// synchronised here, and the return value is cudaGetLastError() after
// the launch. Probe ids outside [0, nlist) are clamped so that no read
// leaves the tables; the wrapper documents that callers pass valid ids.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 256;     // slots per block, one thread per slot in the epilogue
constexpr int THREADS = 256;  // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr float NEG_INF = -1e30f;
constexpr int Q_PAYER = 0, Q_STATE = 1, Q_PROGRAM = 2, Q_TAGMODE = 3;
constexpr int Q_STRICTOK = 4, Q_INHERIT = 5, Q_HASJ = 6, Q_HASDP = 7;
constexpr int ANY16 = 0xFFFE;

// Exact int dot of one row of p bytes against the staged query; every
// lane returns the full sum. WORDS: p % 4 == 0 and the codes are 4-byte
// aligned, so each lane reads whole 32-bit words.
template <bool WORDS>
__device__ __forceinline__ int row_dot(const int8_t* __restrict__ row,
                                       const int8_t* __restrict__ q_s, int p,
                                       int lane) {
  int acc = 0;
  if (WORDS) {
    const int* row_w = reinterpret_cast<const int*>(row);
    const int* q_w = reinterpret_cast<const int*>(q_s);
    const int nw = p >> 2;
    for (int w = lane; w < nw; w += 32) acc = __dp4a(__ldg(row_w + w), q_w[w], acc);
  } else {
    for (int i = lane; i < p; i += 32)
      acc += static_cast<int>(__ldg(row + i)) * static_cast<int>(q_s[i]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  return acc;
}

// Raw dots of this block's tile of slots into raw_s[0, n_slots).
template <bool WORDS>
__device__ __forceinline__ void tile_dots(const int8_t* __restrict__ block_codes,
                                          const int8_t* __restrict__ q_s, int p,
                                          int n_slots, float* raw_s) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int t = warp; t < n_slots; t += WARPS) {
    const int acc = row_dot<WORDS>(block_codes + static_cast<size_t>(t) * p, q_s, p, lane);
    if (lane == 0) raw_s[t] = __int2float_rn(acc);
  }
}

__device__ __forceinline__ int clamp_cell(int c, int nlist) {
  return c < 0 ? 0 : (c >= nlist ? nlist - 1 : c);
}

// Stage q8[b] in shared memory (p bytes, zero-padded to a word).
__device__ __forceinline__ void stage_query(const int8_t* __restrict__ q8, int b, int p,
                                            int8_t* q_s) {
  const int8_t* src = q8 + static_cast<size_t>(b) * p;
  const int p4 = (p + 3) & ~3;
  for (int i = threadIdx.x; i < p4; i += THREADS) q_s[i] = i < p ? src[i] : 0;
}

template <bool WORDS>
__global__ void __launch_bounds__(THREADS)
proj_blocks_kernel(const int* __restrict__ probe, const int8_t* __restrict__ codes,
                   const int8_t* __restrict__ q8, float* __restrict__ out, int P,
                   int nlist, int pad, int p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* raw_s = reinterpret_cast<float*>(smem);
  int8_t* q_s = reinterpret_cast<int8_t*>(smem + TILE * sizeof(float));
  const int b = blockIdx.z, j = blockIdx.y;
  const int s0 = blockIdx.x * TILE;
  const int n_slots = min(TILE, pad - s0);
  const int cell = clamp_cell(probe[b * P + j], nlist);
  stage_query(q8, b, p, q_s);
  __syncthreads();
  tile_dots<WORDS>(codes + (static_cast<size_t>(cell) * pad + s0) * p, q_s, p, n_slots,
                   raw_s);
  __syncthreads();
  const int t = threadIdx.x;
  if (t < n_slots) out[(static_cast<size_t>(b) * P + j) * pad + s0 + t] = raw_s[t];
}

template <bool WORDS, int LEVEL>
__global__ void __launch_bounds__(THREADS)
proj_gated_kernel(const int* __restrict__ probe, const int* __restrict__ qmeta,
                  const int* __restrict__ qbits, const int8_t* __restrict__ codes,
                  const int* __restrict__ words, const int8_t* __restrict__ q8,
                  float* __restrict__ score, int* __restrict__ rowid, int P, int nlist,
                  int pad, int p, int W, int tw) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* raw_s = reinterpret_cast<float*>(smem);
  int* qm_s = reinterpret_cast<int*>(smem + TILE * sizeof(float));  // 8 + 3*tw ints
  int8_t* q_s = reinterpret_cast<int8_t*>(qm_s + 8 + 3 * tw);
  const int b = blockIdx.z, j = blockIdx.y;
  const int s0 = blockIdx.x * TILE;
  const int n_slots = min(TILE, pad - s0);
  const int cell = clamp_cell(probe[b * P + j], nlist);
  stage_query(q8, b, p, q_s);
  for (int i = threadIdx.x; i < 8 + 3 * tw; i += THREADS)
    qm_s[i] = i < 8 ? qmeta[b * 8 + i] : qbits[static_cast<size_t>(b) * 3 * tw + i - 8];
  __syncthreads();
  tile_dots<WORDS>(codes + (static_cast<size_t>(cell) * pad + s0) * p, q_s, p, n_slots,
                   raw_s);
  __syncthreads();

  const int t = threadIdx.x;
  if (t >= n_slots) return;
  // word w of this slot: words[cell, w, s0 + t]
  const int* wp = words + static_cast<size_t>(cell) * W * pad + s0 + t;
  const int e0 = __ldg(wp), e1 = __ldg(wp + pad);
  const int scale_bits = __ldg(wp + 2 * pad), rid = __ldg(wp + 3 * pad);
  // int32 shifts are arithmetic: mask after every shift
  const int payer = e0 & 0xFFFF, state = (e0 >> 16) & 0xFFFF;
  const int program = e1 & 0xFFFF;
  const bool valid = (e1 >> 16) & 1, reg = (e1 >> 17) & 1;
  const int qp = qm_s[Q_PAYER], qs = qm_s[Q_STATE], qg = qm_s[Q_PROGRAM];
  const bool ok_p = qp == ANY16 || payer == qp || (qm_s[Q_INHERIT] != 0 && reg);
  const bool ok_s = qs == ANY16 || state == qs;
  const bool ok_g = qg == ANY16 || program == qg;
  const bool meta_ok = ok_p && ok_s && ok_g;
  bool strict = valid && meta_ok;
  bool relaxed = valid && meta_ok;
  if (LEVEL >= 1) {
    const int* qb = qm_s + 8;
    bool j_ov = false;
    for (int w = 0; w < tw; ++w) j_ov |= (__ldg(wp + (4 + w) * pad) & qb[w]) != 0;
    strict = strict && (j_ov || qm_s[Q_HASJ] == 0);
  }
  if (LEVEL >= 2) {
    const int* qb = qm_s + 8;
    bool dp_ov = false;
    for (int w = 0; w < tw; ++w) {
      dp_ov |= (__ldg(wp + (4 + tw + w) * pad) & qb[tw + w]) != 0;
      dp_ov |= (__ldg(wp + (4 + 2 * tw + w) * pad) & qb[2 * tw + w]) != 0;
    }
    relaxed = relaxed && (dp_ov || qm_s[Q_HASDP] == 0);
  }
  const bool autog = qm_s[Q_STRICTOK] != 0 ? strict : (strict || relaxed);
  const int tm = qm_s[Q_TAGMODE];
  const bool gate = tm == 0 ? autog : (tm == 1 ? relaxed : valid);
  const size_t o = (static_cast<size_t>(b) * P + j) * pad + s0 + t;
  score[o] = gate ? __fmul_rn(raw_s[t], __int_as_float(scale_bits)) : NEG_INF;
  rowid[o] = rid;
}

bool words_ok(const void* codes, int p) {
  return p % 4 == 0 && reinterpret_cast<uintptr_t>(codes) % 4 == 0;
}

}  // namespace

// Dynamic shared memory a launch needs (the wrapper checks it against the
// card's limit before calling).
extern "C" int mrag_proj_smem_bytes(int p, int tw, int gated) {
  return static_cast<int>(TILE * sizeof(float)) + (gated ? (8 + 3 * tw) * 4 : 0) +
         ((p + 3) & ~3);
}

// probe [B, P] i32; codes [nlist, pad, p] i8; q8 [B, p] i8 -> out [B, P, pad] f32.
extern "C" int mrag_proj_blocks(const int* probe, const int8_t* codes, const int8_t* q8,
                                float* out, int B, int P, int nlist, int pad, int p,
                                void* stream) {
  if (B < 1 || P < 1 || nlist < 1 || pad < 1 || p < 1 || B > 65535 || P > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int smem = mrag_proj_smem_bytes(p, 0, 0);
  dim3 grid((pad + TILE - 1) / TILE, P, B);
  if (words_ok(codes, p)) {
    cudaFuncSetAttribute(proj_blocks_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    proj_blocks_kernel<true><<<grid, THREADS, smem, s>>>(probe, codes, q8, out, P, nlist, pad, p);
  } else {
    cudaFuncSetAttribute(proj_blocks_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    proj_blocks_kernel<false><<<grid, THREADS, smem, s>>>(probe, codes, q8, out, P, nlist, pad, p);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool WORDS, int LEVEL>
static void launch_gated(dim3 grid, int smem, cudaStream_t s, const int* probe,
                         const int* qmeta, const int* qbits, const int8_t* codes,
                         const int* words, const int8_t* q8, float* score, int* rowid,
                         int P, int nlist, int pad, int p, int W, int tw) {
  cudaFuncSetAttribute(proj_gated_kernel<WORDS, LEVEL>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  proj_gated_kernel<WORDS, LEVEL><<<grid, THREADS, smem, s>>>(
      probe, qmeta, qbits, codes, words, q8, score, rowid, P, nlist, pad, p, W, tw);
}

// probe [B, P] i32; qmeta [B, 8] i32; qbits [B, 3*tw] i32; codes
// [nlist, pad, p] i8; words [nlist, W, pad] i32 (only the first W_lvl
// word rows are read: 4 + tw at tag_level <= 1, 4 + 3*tw at 2); q8
// [B, p] i8 -> score [B, P, pad] f32, rowid [B, P, pad] i32.
extern "C" int mrag_proj_gated_blocks(const int* probe, const int* qmeta, const int* qbits,
                                      const int8_t* codes, const int* words,
                                      const int8_t* q8, float* score, int* rowid, int B,
                                      int P, int nlist, int pad, int p, int W, int tw,
                                      int tag_level, void* stream) {
  if (B < 1 || P < 1 || nlist < 1 || pad < 1 || p < 1 || tw < 1 || B > 65535 ||
      P > 65535 || tag_level < 0 || tag_level > 2 ||
      W < (tag_level >= 2 ? 4 + 3 * tw : (tag_level == 1 ? 4 + tw : 4)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int smem = mrag_proj_smem_bytes(p, tw, 1);
  dim3 grid((pad + TILE - 1) / TILE, P, B);
  const bool w4 = words_ok(codes, p);
#define MRAG_GATED(WD, LV)                                                              \
  launch_gated<WD, LV>(grid, smem, s, probe, qmeta, qbits, codes, words, q8, score, rowid, \
                       P, nlist, pad, p, W, tw)
  if (w4) {
    if (tag_level == 0) MRAG_GATED(true, 0);
    else if (tag_level == 1) MRAG_GATED(true, 1);
    else MRAG_GATED(true, 2);
  } else {
    if (tag_level == 0) MRAG_GATED(false, 0);
    else if (tag_level == 1) MRAG_GATED(false, 1);
    else MRAG_GATED(false, 2);
  }
#undef MRAG_GATED
  return static_cast<int>(cudaGetLastError());
}
