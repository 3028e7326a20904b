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
// Arithmetic: int8 x int8 products accumulate in int32 on the tensor cores
// (mma.sync m16n8k32 s8.s8.s32) and each sum converts to float once
// (__int2float_rn): the arithmetic of the XLA twin (dot_general with
// preferred_element_type=int32, then astype f32; ops/proj.py), exact for
// any p up to 2^31 / 127^2, so every summation order gives the same bits.
//
// What bounds it on this card: bytes. A scan must read each distinct
// probed cluster block once (pad * p code bytes and, gated, pad * W_lvl * 4
// bytes of gate words) and write B * P * pad outputs; its 2 * B * P * pad * p
// int8 operations are a few microseconds of tensor-core time. Queries
// share blocks: the engine probes 64 cells + the 2 reserved slabs per
// query, so at B = 32 the 2,112 (b, j) pairs fall on ~880 of 1,002
// clusters (1M) or ~1,620 of 4,098 (10M), and the reserved slabs are
// probed by every query.
//
// What the design does about it:
// - Grouping. A first one-block kernel sorts the B * P (b, j) pairs by
//   clamped cluster id (a counting sort, stable in (b, j) order) into
//   scratch: the member list, the group count, and for each group a
//   record (cluster, first member, member count, first 16 members). Its
//   per-cluster counters live in shared memory up to GROUP_SMEM_NLIST
//   clusters, past that in the int32 scratch (the same kernel, a template
//   flag). A cluster nobody probes costs nothing; duplicates in one
//   query's list are separate members with equal output rows. Batches
//   over 32 queries go in chunks of 32, each grouped and scanned in turn.
// - Work items. One item is (probed cluster, 128-slot tile); persistent
//   blocks walk the items, so each probed tile is read once for all of
//   its members, however many queries probe it. An item's code rows come
//   in k-slices of at most KS bytes, one ring stage each; the int32 sums
//   of a slice go to the output element the same thread finishes at the
//   last slice (as int32 bits, read back by that thread), so shared
//   memory does not grow with p and every sum stays exact. Where one
//   slice covers p (p <= 256), an item is one stage, as it was.
// - Staging. Each block stages the launch's (at most 32) q8 rows and gate
//   parameters once (the q8 rows whole where they fit beside the ring,
//   else one k-slice per stage). An item's slice of codes, its W_lvl word
//   rows (each contiguous; with the last slice) and its group's record
//   come into one stage of a ring in shared memory through cp.async
//   (16-byte copies; 4-byte ones, or plain byte loads, where p or the
//   pointers are not aligned for them); the cluster id of the next item
//   to issue loads an iteration early, so no dependent global load stands
//   between items. The ring is double-buffered: a deeper one costs
//   resident blocks per SM, and more blocks hide an item's latency chain
//   (a few barriers) better than more tiles in flight.
// - Dots on the int8 tensor cores. A = the staged codes (16 slots per
//   warp x 32 bytes per step), B = up to 16 members' staged q8 rows (two
//   8-wide n-tiles; each lane points ldmatrix at its member's row), both
//   through ldmatrix. Shared rows are padded to kp + 16
//   bytes (kp = p rounded up to 32, zero-filled past p), a stride of 4 mod
//   8 words, so ldmatrix reads are free of bank conflicts. Groups larger
//   than 16 members loop over member tiles.
// - Epilogue, straight from the MMA fragments: each thread holds 2 slots x
//   up to 8 members; for each it evaluates the gate from the staged words
//   and the member's staged qmeta/qbits, scales the raw dot with
//   __fmul_rn, and writes score and row id at [b, j, s0 + s] (a warp's
//   stores are whole 32-byte sectors). Every output is written by exactly
//   one thread, without atomics, so results are deterministic.
// proj_blocks is the same kernel template without the words and the gate.
//
// Plain C interface for ctypes: the caller allocates the outputs and the
// int32 scratch (mrag_proj_scratch_ints), the launches go on the caller's
// stream, nothing is allocated or synchronised here, and each entry point
// returns cudaGetLastError() after its launches. Probe ids outside
// [0, nlist) are clamped so that no read leaves the tables; the wrapper
// documents that callers pass valid ids.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <climits>

namespace {

constexpr int TS = 128;          // slots per work item: 8 warps x one 16-row MMA tile
constexpr int THREADS = 256;
constexpr int MT = 16;           // members per member tile: two 8-wide MMA n-tiles
constexpr int QMAX = 32;         // queries one scan launch stages; larger batches go in chunks
constexpr int RECW = 20;         // ints per group record: cell, first member, count, 0, MT members
// The ring's depth: double buffering. Deeper rings cost resident blocks,
// and those overlap an item's latency better (scripts/proj_scan_check.py
// --sweep).
constexpr int STAGES = 2;
constexpr int GROUP_THREADS = 1024;
// Hopper: the most shared memory one block may take.
constexpr int SMEM_PER_BLOCK = 232448;
constexpr int GROUP_STATIC_SMEM = 2 * (GROUP_THREADS / 32) * 4;
constexpr int GROUP_CELL_BYTES = 12;  // bytes per cluster in the grouping: 3 ints
// Most clusters the grouping counts in shared memory; past that in scratch.
constexpr int GROUP_SMEM_NLIST = (SMEM_PER_BLOCK - GROUP_STATIC_SMEM) / GROUP_CELL_BYTES;
constexpr int KS = 256;          // code bytes of one k-slice (a multiple of 32)
constexpr float NEG_INF = -1e30f;
constexpr int Q_PAYER = 0, Q_STATE = 1, Q_PROGRAM = 2, Q_TAGMODE = 3;
constexpr int Q_STRICTOK = 4, Q_INHERIT = 5, Q_HASJ = 6, Q_HASDP = 7;
constexpr int ANY16 = 0xFFFE;

__host__ __device__ __forceinline__ int clamp_cell(int c, int nlist) {
  return c < 0 ? 0 : (c >= nlist ? nlist - 1 : c);
}

// Shared memory of one scan block, in bytes: a ring of STAGES stages
// (one k-slice of the tile's code rows, its word rows, its group's
// record; and, where the whole q8 rows do not fit beside the ring, the
// same k-slice of the launch's query rows), then the launch's whole query
// rows (QMAX q8 rows and one zero row) where they fit, and their gate
// parameters. level -1: proj_blocks (no words, no gate parameters).
struct Layout {
  int kpf, ns, kp, sb, qsb, q_whole, wl, qmw, words_off, rec_off, stage_q_off, stage, q_off,
      qm_off, total;
};

__host__ __device__ __forceinline__ Layout layout_of(int p, int tw, int level) {
  Layout L;
  L.kpf = (p + 31) & ~31;           // p rounded up to an MMA step
  L.ns = (L.kpf + KS - 1) / KS;     // k-slices of an item
  L.kp = L.kpf < KS ? L.kpf : KS;   // code bytes of a staged slice
  L.sb = L.kp + 16;                 // row stride: 4 mod 8 words
  L.wl = level < 0 ? 0 : 4 + (level == 0 ? 0 : (level == 1 ? tw : 3 * tw));
  L.qmw = level < 0 ? 0 : 8 + 3 * tw;
  L.words_off = TS * L.sb;
  L.rec_off = L.words_off + L.wl * TS * 4;
  L.stage_q_off = L.rec_off + RECW * 4;
  const int qm_bytes = QMAX * L.qmw * 4;
  const int whole = STAGES * L.stage_q_off + (QMAX + 1) * (L.kpf + 16) + qm_bytes;
  L.q_whole = whole <= SMEM_PER_BLOCK;
  if (L.q_whole) {
    L.qsb = L.kpf + 16;
    L.stage = L.stage_q_off;
    L.q_off = STAGES * L.stage;
    L.qm_off = L.q_off + (QMAX + 1) * L.qsb;
  } else {
    L.qsb = L.sb;
    L.stage = L.stage_q_off + (QMAX + 1) * L.sb;
    L.q_off = 0;  // in each stage, at stage_q_off
    L.qm_off = STAGES * L.stage;
  }
  L.total = L.qm_off + qm_bytes;
  return L;
}

// Scratch (int32): group records [BP][RECW] | members [BP] | group count
// | (GLOBAL) the per-cluster ints [3][nlist]. A record: the cluster, its
// first member in `members`, its member count, 0, and its first MT
// members (-1 past the count). Per cluster, in shared memory or (GLOBAL)
// in scratch: the count, then the placement cursor; the first member
// slot; the group.
template <bool GLOBAL>
__global__ void __launch_bounds__(GROUP_THREADS)
proj_group_kernel(const int* __restrict__ probe, int bp, int nlist, int* __restrict__ scratch) {
  extern __shared__ int shared_cells[];
  __shared__ int warp_sum[GROUP_THREADS / 32], warp_nz[GROUP_THREADS / 32];
  int* rec = scratch;
  int* members = rec + static_cast<size_t>(bp) * RECW;
  int* cells = GLOBAL ? members + bp + 1 : shared_cells;
  int* cursor = cells;
  int* first = cells + nlist;
  int* group_of = cells + 2 * static_cast<size_t>(nlist);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int c = tid; c < nlist; c += GROUP_THREADS) cursor[c] = 0;
  __syncthreads();
  for (int i = tid; i < bp; i += GROUP_THREADS) atomicAdd(&cursor[clamp_cell(probe[i], nlist)], 1);
  __syncthreads();
  // each thread owns a run of clusters; an exclusive scan over the runs
  // (shuffles in each warp, then over the warps' totals) gives every
  // cluster its first member slot and every probed one its group
  const int per = (nlist + GROUP_THREADS - 1) / GROUP_THREADS;
  const int lo = min(tid * per, nlist), hi = min(lo + per, nlist);
  int sum = 0, nz = 0;
  for (int c = lo; c < hi; ++c) {
    sum += cursor[c];
    nz += cursor[c] > 0;
  }
  int isum = sum, inz = nz;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int a = __shfl_up_sync(0xffffffffu, isum, off);
    const int z = __shfl_up_sync(0xffffffffu, inz, off);
    if (lane >= off) {
      isum += a;
      inz += z;
    }
  }
  if (lane == 31) {
    warp_sum[warp] = isum;
    warp_nz[warp] = inz;
  }
  __syncthreads();
  if (warp == 0) {
    int ws = warp_sum[lane], wz = warp_nz[lane];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int a = __shfl_up_sync(0xffffffffu, ws, off);
      const int z = __shfl_up_sync(0xffffffffu, wz, off);
      if (lane >= off) {
        ws += a;
        wz += z;
      }
    }
    warp_sum[lane] = ws;  // inclusive over the warps
    warp_nz[lane] = wz;
  }
  __syncthreads();
  const int before_sum = warp ? warp_sum[warp - 1] : 0, before_nz = warp ? warp_nz[warp - 1] : 0;
  int start = before_sum + isum - sum, g = before_nz + inz - nz;
  for (int c = lo; c < hi; ++c) {
    const int n = cursor[c];
    cursor[c] = start;
    first[c] = start;
    group_of[c] = g;
    if (n > 0) {  // a record's header, one 16-byte store
      reinterpret_cast<int4*>(rec + static_cast<size_t>(g) * RECW)[0] = make_int4(c, start, n, 0);
      ++g;
    }
    start += n;
  }
  const int n_groups = warp_nz[GROUP_THREADS / 32 - 1];
  if (tid == 0) members[bp] = n_groups;
  // the records' member slots start at -1, written in 16-byte runs
  for (int i = tid; i < n_groups * (MT / 4); i += GROUP_THREADS)
    reinterpret_cast<int4*>(rec + static_cast<size_t>(i / (MT / 4)) * RECW + 4)[i % (MT / 4)] =
        make_int4(-1, -1, -1, -1);
  __syncthreads();
  if (tid >= 32) return;
  // stable placement: one warp walks the pairs in (b, j) order; lanes on
  // the same cluster take consecutive slots in lane order, and a group's
  // first MT members also go into its record. The probe ids of 8 rounds
  // load together, so one load latency covers 8 rounds.
  constexpr int ROUNDS = 8;
  for (int base = 0; base < bp; base += 32 * ROUNDS) {
    int cs[ROUNDS];
#pragma unroll
    for (int u = 0; u < ROUNDS; ++u) {
      const int i = base + 32 * u + tid;
      cs[u] = i < bp ? clamp_cell(__ldg(probe + i), nlist) : -1;
    }
#pragma unroll
    for (int u = 0; u < ROUNDS; ++u) {
      const int c = cs[u], i = base + 32 * u + tid;
      unsigned same = 0;  // the lanes on this lane's cluster
#pragma unroll
      for (int k = 0; k < 32; ++k) same |= (__shfl_sync(0xffffffffu, c, k) == c) << k;
      const int rank = __popc(same & ((1u << tid) - 1u));
      if (c >= 0) {
        const int pos = cursor[c] + rank, local = pos - first[c];
        members[pos] = i;
        if (local < MT) rec[static_cast<size_t>(group_of[c]) * RECW + 4 + local] = i;
      }
      __syncwarp();
      if (c >= 0 && rank == 0) cursor[c] += __popc(same);
      __syncwarp();
    }
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until the oldest of the ring's committed groups has landed.
__device__ __forceinline__ void cp_async_wait_oldest() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 1) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned addr, unsigned& r0, unsigned& r1,
                                            unsigned& r2, unsigned& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr)
               : "memory");
}

// c += A (16 x 32 s8, row) * B (32 x 8 s8, col), exact int32
__device__ __forceinline__ void mma_s8(int4& c, unsigned a0, unsigned a1, unsigned a2,
                                       unsigned a3, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c.x), "+r"(c.y), "+r"(c.z), "+r"(c.w)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// fn(r, k) for every chunk k < cols of every row r < rows, the block's
// threads striding over them in row-major order without a division in
// the loop.
template <typename F>
__device__ __forceinline__ void for_chunks(int rows, int cols, F fn) {
  if (cols <= 0) return;
  const int dr = THREADS / cols, dk = THREADS - dr * cols;
  int r = static_cast<int>(threadIdx.x) / cols;
  int k = static_cast<int>(threadIdx.x) - r * cols;
  while (r < rows) {
    fn(r, k);
    r += dr;
    k += dk;
    if (k >= cols) {
      k -= cols;
      ++r;
    }
  }
}

// LEVEL -1: raw dots into out (proj_blocks); 0..2: gated scores into out
// and row ids into rowid, reading the level's W_lvl word rows. VEC: the
// code copy width (16 or 4 bytes through cp.async; 1: plain byte loads,
// where p or a pointer is not 4-byte aligned). SLICED: items in several
// k-slices, or the q8 rows staged a slice at a time (false where one slice
// covers p: the one-stage item, compiled without the slice bookkeeping).
// One launch takes bq <= QMAX queries.
template <int LEVEL, int VEC, bool SLICED>
__global__ void __launch_bounds__(THREADS)
proj_scan_kernel(const int* __restrict__ scratch, const int* __restrict__ qmeta,
                 const int* __restrict__ qbits, const int8_t* __restrict__ codes,
                 const int* __restrict__ words, const int8_t* __restrict__ q8,
                 float* __restrict__ out, int* __restrict__ rowid, int bq, int P, int pad,
                 int p, int W, int tw, int words16) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout_of(p, tw, LEVEL);
  const int bp = bq * P;
  const int* rec = scratch;
  const int* members = rec + static_cast<size_t>(bp) * RECW;
  const int n_tiles = (pad + TS - 1) / TS;
  const int total = members[bp] * n_tiles;
  const int grid = static_cast<int>(gridDim.x);
  int w = blockIdx.x;
  if (w >= total) return;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int* qm_all = reinterpret_cast<const int*>(smem + L.qm_off);

  // q8 rows [k0, k0 + 4 * kw) of the launch's queries into dst (row
  // stride qsb): zero past p, row QMAX all zero (the B rows of members
  // past a tile's count)
  auto stage_queries = [&](unsigned char* dst, int qsb, int k0, int kw) {
    for_chunks(QMAX + 1, kw, [&](int b, int k) {
      int v = 0;
      const int kk = k0 + 4 * k;
      if (b < bq && kk < p) {
        const int8_t* qr = q8 + static_cast<size_t>(b) * p + kk;
        if (VEC != 1) {
          v = __ldg(reinterpret_cast<const int*>(qr));
        } else {
          for (int e = 0; e < 4 && kk + e < p; ++e)
            v |= static_cast<int>(static_cast<uint8_t>(qr[e])) << (8 * e);
        }
      }
      reinterpret_cast<int*>(dst + b * qsb)[k] = v;
    });
  };
  // zero the ring (a code row's bytes past p meet zero q8 bytes, so what
  // a stage holds there is never summed; zeroed once all the same), and
  // stage the launch's whole queries and gate parameters once
  const int ring = L.q_whole ? L.q_off : L.qm_off;
  for (int i = tid; i < ring / 16; i += THREADS)
    reinterpret_cast<int4*>(smem)[i] = make_int4(0, 0, 0, 0);
  if (L.q_whole) stage_queries(smem + L.q_off, L.qsb, 0, L.kpf >> 2);
  if (LEVEL >= 0) {
    for_chunks(bq, L.qmw, [&](int b, int k) {
      reinterpret_cast<int*>(smem + L.qm_off)[b * L.qmw + k] =
          k < 8 ? __ldg(qmeta + b * 8 + k) : __ldg(qbits + static_cast<size_t>(b) * 3 * tw + k - 8);
    });
  }
  __syncthreads();

  auto cell_of = [&](int item) {
    return item < total ? __ldg(rec + static_cast<size_t>(item / n_tiles) * RECW) : 0;
  };
  // one step: k-slice `sl` of an item into stage st (the word rows with
  // the last slice, the record with every slice)
  auto issue = [&](int item, int sl, int st, int cell) {
    unsigned char* sg = smem + st * L.stage;
    const int g = item / n_tiles, s0 = (item - g * n_tiles) * TS;
    const int n = min(TS, pad - s0);
    const int k0 = sl * KS, width = SLICED ? min(KS, p - k0) : p;
    const int8_t* src = codes + (static_cast<size_t>(cell) * pad + s0) * p + k0;
    if (VEC == 1) {
      for_chunks(n, width, [&](int r, int k) {
        sg[r * L.sb + k] = static_cast<unsigned char>(src[static_cast<size_t>(r) * p + k]);
      });
    } else {
      for_chunks(n, width / VEC, [&](int r, int k) {
        cp_async<VEC>(sg + r * L.sb + k * VEC, src + static_cast<size_t>(r) * p + k * VEC);
      });
    }
    if (SLICED && !L.q_whole) stage_queries(sg + L.stage_q_off, L.qsb, k0, L.kp >> 2);
    if (LEVEL >= 0 && (!SLICED || sl == L.ns - 1)) {
      int* ws = reinterpret_cast<int*>(sg + L.words_off);
      const int* wsrc = words + static_cast<size_t>(cell) * W * pad + s0;
      const int n4 = words16 ? n >> 2 : 0;  // 16-byte chunks per word row
      for_chunks(L.wl, n4, [&](int r, int k) {
        cp_async<16>(ws + r * TS + 4 * k, wsrc + static_cast<size_t>(r) * pad + 4 * k);
      });
      for_chunks(L.wl, n - 4 * n4, [&](int r, int k) {
        cp_async<4>(ws + r * TS + 4 * n4 + k, wsrc + static_cast<size_t>(r) * pad + 4 * n4 + k);
      });
    }
    if (tid < RECW / 4)  // the group's record: 16-byte aligned in scratch and stage
      cp_async<16>(sg + L.rec_off + 16 * tid, rec + static_cast<size_t>(g) * RECW + 4 * tid);
  };

  // the ring over this block's steps (its items w, w + grid, ..., each in
  // ns k-slices): STAGES - 1 steps in flight ahead of the one computing;
  // the cell of the next step to issue loads one iteration early
  const int ns = SLICED ? L.ns : 1;
  const int n_steps = (total - w + grid - 1) / grid * ns;
  auto item_of = [&](int step) { return w + (SLICED ? step / ns : step) * grid; };
  for (int k = 0; k < STAGES - 1; ++k) {
    if (k < n_steps) issue(item_of(k), SLICED ? k % ns : 0, k, cell_of(item_of(k)));
    cp_async_commit();
  }
  int cell_ahead = STAGES - 1 < n_steps ? cell_of(item_of(STAGES - 1)) : 0;
  const int row0 = warp * 16 + (lane >> 2), col = 2 * (lane & 3);
  for (int it = 0; it < n_steps; ++it) {
    const int ahead = it + STAGES - 1;
    if (ahead < n_steps)
      issue(item_of(ahead), SLICED ? ahead % ns : 0, ahead % STAGES, cell_ahead);
    cell_ahead = ahead + 1 < n_steps ? cell_of(item_of(ahead + 1)) : 0;
    cp_async_commit();
    cp_async_wait_oldest();
    __syncthreads();
    const int item = item_of(it), sl = SLICED ? it % ns : 0;
    const bool last = !SLICED || sl == ns - 1;
    unsigned char* sg = smem + (it % STAGES) * L.stage;
    const int* ws = reinterpret_cast<const int*>(sg + L.words_off);
    int* hdr = reinterpret_cast<int*>(sg + L.rec_off);  // cell, m0, count, 0, members
    const int s0 = (item % n_tiles) * TS;
    const int n = min(TS, pad - s0);
    const int m0 = hdr[1], n_mem = hdr[2];
    // this slice's MMA steps (the whole q8 rows end at kpf) and its query rows
    const int kl = SLICED ? min(L.kp, L.kpf - sl * KS) : L.kp;
    const int8_t* q_rows = reinterpret_cast<const int8_t*>(
        !SLICED || L.q_whole ? smem + L.q_off + sl * KS : sg + L.stage_q_off);
    int* partial = reinterpret_cast<int*>(out);  // the sums of earlier slices
    for (int mb = 0; mb < n_mem; mb += MT) {
      const int cnt = min(MT, n_mem - mb);
      if (mb) {  // a group's later member tiles
        __syncthreads();
        if (tid < MT) hdr[4 + tid] = tid < cnt ? __ldg(members + m0 + mb + tid) : -1;
        __syncthreads();
      }
      // ---- tensor-core dots: warp w owns slots [16w, 16w + 16); this
      // lane's B row is member (lane & 7) + (lane >> 4) * 8's query
      // the fragment's elements: slots row0 and row0 + 8, members col,
      // col + 1 (+ 8 in the second n-tile); after the first slice they
      // start from the sums this thread stored at the earlier slices
      int acc[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
      if (SLICED && sl > 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int s = row0 + 8 * h, m = nt * 8 + col + e;
              if (s < n && m < cnt)
                acc[nt][2 * h + e] = partial[static_cast<size_t>(hdr[4 + m]) * pad + s0 + s];
            }
      }
      int4 acc0 = make_int4(acc[0][0], acc[0][1], acc[0][2], acc[0][3]);
      int4 acc1 = make_int4(acc[1][0], acc[1][1], acc[1][2], acc[1][3]);
      const bool two = cnt > 8;
      const int mi = (lane & 7) + (lane >> 4) * 8;
      const int brow = mi < cnt ? hdr[4 + mi] / P : QMAX;
      const unsigned a_base = smem_addr(
          sg + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * L.sb + (lane >> 4) * 16);
      const unsigned b_base = smem_addr(q_rows + brow * L.qsb + ((lane >> 3) & 1) * 16);
      for (int k0 = 0; k0 < kl; k0 += 32) {
        unsigned a0, a1, a2, a3, b0, b1, b2, b3;
        ldmatrix_x4(a_base + k0, a0, a1, a2, a3);
        ldmatrix_x4(b_base + k0, b0, b1, b2, b3);
        mma_s8(acc0, a0, a1, a2, a3, b0, b1);
        if (two) mma_s8(acc1, a0, a1, a2, a3, b2, b3);
      }
      acc[0][0] = acc0.x, acc[0][1] = acc0.y, acc[0][2] = acc0.z, acc[0][3] = acc0.w;
      acc[1][0] = acc1.x, acc[1][1] = acc1.y, acc[1][2] = acc1.z, acc[1][3] = acc1.w;
      if (SLICED && !last) {  // keep the sums for the next slice
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int s = row0 + 8 * h, m = nt * 8 + col + e;
              if (s < n && m < cnt)
                partial[static_cast<size_t>(hdr[4 + m]) * pad + s0 + s] = acc[nt][2 * h + e];
            }
        continue;
      }
      // ---- epilogue from the fragment
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int s = row0 + 8 * h;
        if (s >= n) continue;
        if (LEVEL < 0) {
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int m = nt * 8 + col + e;
              if (m < cnt)
                out[static_cast<size_t>(hdr[4 + m]) * pad + s0 + s] =
                    __int2float_rn(acc[nt][2 * h + e]);
            }
        } else {
          const int e0 = ws[s], e1 = ws[TS + s];
          const int scale_bits = ws[2 * TS + s], rid = ws[3 * TS + s];
          // int32 shifts are arithmetic: mask after every shift
          const int payer = e0 & 0xFFFF, state = (e0 >> 16) & 0xFFFF;
          const int program = e1 & 0xFFFF;
          const bool valid = (e1 >> 16) & 1, reg = (e1 >> 17) & 1;
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int m = nt * 8 + col + e;
              if (m >= cnt) continue;
              const int flat = hdr[4 + m];
              const int* qm = qm_all + (flat / P) * L.qmw;
              const int qp = qm[Q_PAYER], qs = qm[Q_STATE], qg = qm[Q_PROGRAM];
              const bool ok_p = qp == ANY16 || payer == qp || (qm[Q_INHERIT] != 0 && reg);
              const bool ok_s = qs == ANY16 || state == qs;
              const bool ok_g = qg == ANY16 || program == qg;
              const bool meta_ok = ok_p && ok_s && ok_g;
              const int tm = qm[Q_TAGMODE];
              const bool strict_ok = qm[Q_STRICTOK] != 0;
              // strict and relaxed as the plain gate defines them, each read
              // only where the mode can use it: strict under auto (tm 0),
              // relaxed under relaxed (tm 1) or an auto gate strict did not pass
              bool strict = valid && meta_ok;
              bool relaxed = strict;
              if (LEVEL >= 1 && strict && tm == 0 && qm[Q_HASJ] != 0) {
                const int* qb = qm + 8;
                bool j_ov = false;
                for (int t = 0; t < tw && !j_ov; ++t) j_ov = (ws[(4 + t) * TS + s] & qb[t]) != 0;
                strict = j_ov;
              }
              if (LEVEL >= 2 && relaxed && qm[Q_HASDP] != 0 &&
                  (tm == 1 || (tm == 0 && !strict_ok && !strict))) {
                const int* qb = qm + 8;
                bool dp_ov = false;
                for (int t = 0; t < tw && !dp_ov; ++t)
                  dp_ov = (ws[(4 + tw + t) * TS + s] & qb[tw + t]) != 0 ||
                          (ws[(4 + 2 * tw + t) * TS + s] & qb[2 * tw + t]) != 0;
                relaxed = dp_ov;
              }
              const bool autog = strict_ok ? strict : (strict || relaxed);
              const bool gate = tm == 0 ? autog : (tm == 1 ? relaxed : valid);
              const size_t o = static_cast<size_t>(flat) * pad + s0 + s;
              out[o] = gate ? __fmul_rn(__int2float_rn(acc[nt][2 * h + e]),
                                        __int_as_float(scale_bits))
                            : NEG_INF;
              rowid[o] = rid;
            }
        }
      }
    }
    __syncthreads();  // the stage is free for the next issue
  }
}

int vec_of(const void* codes, const void* q8, int p) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(codes), b = reinterpret_cast<uintptr_t>(q8);
  if (p % 4 || a % 4 || b % 4) return 1;
  return p % 16 == 0 && a % 16 == 0 ? 16 : 4;
}

template <int LEVEL, int VEC, bool SLICED>
void launch_scan(cudaStream_t s, const int* scratch, const int* qmeta, const int* qbits,
                 const int8_t* codes, const int* words, const int8_t* q8, float* out,
                 int* rowid, int bq, int P, int nlist, int pad, int p, int W, int tw) {
  auto kernel = proj_scan_kernel<LEVEL, VEC, SLICED>;
  const int smem = layout_of(p, tw, LEVEL).total;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                       cudaSharedmemCarveoutMaxShared);
  int dev = 0, sms = 1, per_sm = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
  // persistent blocks: as many as fit at once, never more than the items
  const long long upper = static_cast<long long>(std::min(nlist, bq * P)) * ((pad + TS - 1) / TS);
  const long long grid =
      std::min<long long>(upper, static_cast<long long>(std::max(per_sm, 1)) * sms);
  const int words16 =
      words != nullptr && pad % 4 == 0 && reinterpret_cast<uintptr_t>(words) % 16 == 0;
  kernel<<<static_cast<int>(grid), THREADS, smem, s>>>(scratch, qmeta, qbits, codes, words, q8,
                                                       out, rowid, bq, P, pad, p, W, tw, words16);
}

template <int LEVEL, bool SLICED>
void launch_vec(cudaStream_t s, const int* scratch, const int* qmeta, const int* qbits,
                const int8_t* codes, const int* words, const int8_t* q8, float* out,
                int* rowid, int bq, int P, int nlist, int pad, int p, int W, int tw) {
  switch (vec_of(codes, q8, p)) {
    case 16:
      launch_scan<LEVEL, 16, SLICED>(s, scratch, qmeta, qbits, codes, words, q8, out, rowid,
                                     bq, P, nlist, pad, p, W, tw);
      break;
    case 4:
      launch_scan<LEVEL, 4, SLICED>(s, scratch, qmeta, qbits, codes, words, q8, out, rowid,
                                    bq, P, nlist, pad, p, W, tw);
      break;
    default:
      launch_scan<LEVEL, 1, SLICED>(s, scratch, qmeta, qbits, codes, words, q8, out, rowid,
                                    bq, P, nlist, pad, p, W, tw);
  }
}

template <int LEVEL>
void launch_level(cudaStream_t s, const int* scratch, const int* qmeta, const int* qbits,
                  const int8_t* codes, const int* words, const int8_t* q8, float* out,
                  int* rowid, int bq, int P, int nlist, int pad, int p, int W, int tw) {
  const Layout L = layout_of(p, tw, LEVEL);
  if (L.ns > 1 || !L.q_whole)
    launch_vec<LEVEL, true>(s, scratch, qmeta, qbits, codes, words, q8, out, rowid, bq, P,
                            nlist, pad, p, W, tw);
  else
    launch_vec<LEVEL, false>(s, scratch, qmeta, qbits, codes, words, q8, out, rowid, bq, P,
                             nlist, pad, p, W, tw);
}

// int32 scratch of a grouping of B x P pairs: the records, the members,
// the group count and, past GROUP_SMEM_NLIST clusters, 3 ints a cluster.
long long scratch_ints(long long B, long long P, long long nlist) {
  return (RECW + 1LL) * B * P + 1 + (nlist > GROUP_SMEM_NLIST ? 3 * nlist : 0);
}

bool sizes_ok(int B, int P, int nlist, int pad, int p) {
  return B >= 1 && P >= 1 && nlist >= 1 && pad >= 1 && p >= 1 && B <= 65535 && P <= 65535 &&
         static_cast<long long>(B) * P <= (1 << 22) && scratch_ints(B, P, nlist) <= INT_MAX;
}

int group(const int* probe, int* scratch, int B, int P, int nlist, cudaStream_t s) {
  if (nlist > GROUP_SMEM_NLIST) {
    proj_group_kernel<true><<<1, GROUP_THREADS, 0, s>>>(probe, B * P, nlist, scratch);
  } else {
    const int smem = nlist * GROUP_CELL_BYTES;
    cudaFuncSetAttribute(proj_group_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
    proj_group_kernel<false><<<1, GROUP_THREADS, smem, s>>>(probe, B * P, nlist, scratch);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Dynamic shared memory of one scan block (the wrapper checks it against
// the card's limit before calling); tag_level -1 for proj_blocks.
extern "C" int mrag_proj_smem_bytes(int p, int tw, int tag_level) {
  return layout_of(p, tw, tag_level).total;
}

// int32 scratch of a grouping of B x P pairs over nlist clusters (-1 past
// what int32 offsets reach; the wrapper raises then).
extern "C" long long mrag_proj_scratch_ints(int B, int P, int nlist) {
  const long long n = scratch_ints(B, P, nlist);
  return n <= INT_MAX ? n : -1;
}

// ints per group record in the scratch (the wrapper reads records back).
extern "C" int mrag_proj_record_ints() { return RECW; }

// The grouping alone, of all B x P pairs at once (the scans group each
// chunk of QMAX queries): probe [B, P] i32 -> scratch, read back by the
// wrapper's group_probes.
extern "C" int mrag_proj_group(const int* probe, int* scratch, int B, int P, int nlist,
                               void* stream) {
  if (!sizes_ok(B, P, nlist, 1, 1)) return static_cast<int>(cudaErrorInvalidValue);
  return group(probe, scratch, B, P, nlist, static_cast<cudaStream_t>(stream));
}

// probe [B, P] i32; codes [nlist, pad, p] i8; q8 [B, p] i8; scratch
// (mrag_proj_scratch_ints) -> out [B, P, pad] f32. Queries go in chunks of
// QMAX, each grouped and scanned in turn on the stream.
extern "C" int mrag_proj_blocks(const int* probe, const int8_t* codes, const int8_t* q8,
                                int* scratch, float* out, int B, int P, int nlist, int pad,
                                int p, void* stream) {
  if (!sizes_ok(B, P, nlist, pad, p)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int q0 = 0; q0 < B; q0 += QMAX) {
    const int bq = std::min(QMAX, B - q0);
    const int rc = group(probe + static_cast<size_t>(q0) * P, scratch, bq, P, nlist, s);
    if (rc != 0) return rc;
    launch_level<-1>(s, scratch, nullptr, nullptr, codes, nullptr,
                     q8 + static_cast<size_t>(q0) * p,
                     out + static_cast<size_t>(q0) * P * pad, nullptr, bq, P, nlist, pad, p, 0,
                     0);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

// probe [B, P] i32; qmeta [B, 8] i32; qbits [B, 3*tw] i32; codes
// [nlist, pad, p] i8; words [nlist, W, pad] i32 (only the first W_lvl
// word rows are read: 4 at tag_level 0, 4 + tw at 1, 4 + 3*tw at 2); q8
// [B, p] i8; scratch -> score [B, P, pad] f32, rowid [B, P, pad] i32.
extern "C" int mrag_proj_gated_blocks(const int* probe, const int* qmeta, const int* qbits,
                                      const int8_t* codes, const int* words,
                                      const int8_t* q8, int* scratch, float* score,
                                      int* rowid, int B, int P, int nlist, int pad, int p,
                                      int W, int tw, int tag_level, void* stream) {
  if (!sizes_ok(B, P, nlist, pad, p) || tw < 1 || tag_level < 0 || tag_level > 2 ||
      W < layout_of(p, tw, tag_level).wl)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int q0 = 0; q0 < B; q0 += QMAX) {
    const int bq = std::min(QMAX, B - q0);
    const int rc = group(probe + static_cast<size_t>(q0) * P, scratch, bq, P, nlist, s);
    if (rc != 0) return rc;
    const size_t o = static_cast<size_t>(q0) * P * pad;
#define MRAG_LEVEL(LV)                                                                        \
  launch_level<LV>(s, scratch, qmeta + static_cast<size_t>(q0) * 8,                          \
                   qbits + static_cast<size_t>(q0) * 3 * tw, codes, words,                   \
                   q8 + static_cast<size_t>(q0) * p, score + o, rowid + o, bq, P, nlist, pad, \
                   p, W, tw)
    if (tag_level == 0) MRAG_LEVEL(0);
    else if (tag_level == 1) MRAG_LEVEL(1);
    else MRAG_LEVEL(2);
#undef MRAG_LEVEL
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}
