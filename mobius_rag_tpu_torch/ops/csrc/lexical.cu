// The sparse lexical arm under a dense gate, for NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package runs this arm as plain jnp
// (mobius_rag_tpu/query/engine.py lexical_raw, a scatter-add over the
// batch's union of bucket postings, then lax.top_k). The port's plain
// version (ops/lexical.py lexical_topk_reference) builds every product of
// the union, [B, U*P], scatter-adds them into a zeroed [B, C + 1] float64
// buffer (pads into column C), rounds it to float32 and sorts every row of
//
//   score[b, r] = (lex[b, r] > 0 ? lex[b, r] : NEG_INF) + penalty[b, r]
//
// stably, descending. This kernel pair gives the same top m bit for bit
// while it touches only what the answer needs:
//
//   lex_init     fills the [B, C] float64 accumulator with -0.0 and zeroes
//                the per-query touched counts.
//   lex_scatter  one block per (union column u, query b); a block whose
//                weight w[b, u] is 0 returns before it reads a posting.
//                Otherwise it walks bucket u's postings row [P] (the whole
//                row: a scrubbed row leaves holes of -1 that later
//                postings follow), forms each product as the plain version
//                does (the float32 weight times the bf16 weight widened to
//                float32, one rounding) and atomically adds the nonzero
//                ones in float64. Float32 products of the IDF and posting
//                weights span far fewer than 29 binary orders, so every
//                float64 sum is exact and its float32 rounding does not
//                depend on the atomics' order. The adder that reads back
//                -0.0 is the row's first (a sum of nonzero terms is never
//                -0.0 again), and appends the row to the query's touched
//                list, sized for the worst case min(C, U*P): one slot-claim
//                atomic a warp.
//   lex_select   one block per query walks its touched list: each sum
//                rounded to float32 once; live = score > 0 and penalty 0;
//                the live rows' keys (score bits << 32 | ~row: larger
//                key = higher score, then lower row) compacted in place;
//                in rounds of up to 1,024 keys, a radix select of the
//                round's last key (8 passes of 8 bits, ending as soon as a
//                digit's count is what is still needed) and the round's
//                keys sorted bitonically in shared memory (one round at
//                m <= 1,024). Fewer than m live rows: the rest is the dense
//                sort's dead tail, in row order from row 0: first the rows
//                whose dense value is exactly NEG_INF (unscored rows that
//                pass the gate, and scored rows that fail it: score +
//                NEG_INF rounds to NEG_INF in float32 for any score below
//                2^75), then the NEG_INF + NEG_INF rows (unscored and
//                gated). The penalty holds only 0 and NEG_INF (the
//                engine's gate_penalty).
//
// The accumulator is left holding the sums (-0.0 where untouched): a gather
// at the three arms' candidate rows, rounded to float32 and plus +0.0, is
// their lexical signal, the plain version's bit for bit
// (ops/lexical.py lexical_signals).
//
// What bounds it on this card: bytes. The live pairs' postings rows (4 +
// 2 bytes a posting), the accumulator's fill (8 bytes a row a query) and
// its touched entries (8 bytes each, read and written), the penalty at the
// touched rows and the outputs, at 3.35 TB/s (PERF.md gives the numbers
// at the benchmark's batches). The float64 atomics go to distinct rows
// but for a row in several of a query's buckets.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int INIT_THREADS = 256;
constexpr int SCATTER_THREADS = 256;
constexpr int SCATTER_ITEMS = 4;  // postings a thread has in flight
constexpr int SELECT_THREADS = 1024;
constexpr int SELECT_WARPS = SELECT_THREADS / 32;
constexpr int FILL_ROWS = 8;  // consecutive rows a thread tests in the dead fill
constexpr int ROUND_KEYS = 1024;  // keys a selection round sorts in shared memory
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned long long NEG_ZERO = 0x8000000000000000ull;
constexpr float NEG_INF = -1e30f;

__global__ void __launch_bounds__(INIT_THREADS)
    lex_init(unsigned long long* __restrict__ acc, long long n, int* __restrict__ counts,
             int B) {
  const long long stride = static_cast<long long>(gridDim.x) * INIT_THREADS;
  for (long long i = static_cast<long long>(blockIdx.x) * INIT_THREADS + threadIdx.x; i < n;
       i += stride)
    acc[i] = NEG_ZERO;
  if (blockIdx.x == 0)
    for (int j = threadIdx.x; j < B; j += INIT_THREADS) counts[j] = 0;
}

__global__ void __launch_bounds__(SCATTER_THREADS)
    lex_scatter(const float* __restrict__ weights, const int* __restrict__ buckets,
                const int* __restrict__ cols, const uint16_t* __restrict__ wts, int U, int P,
                long long C, double* __restrict__ acc, long long* __restrict__ touched,
                int* __restrict__ counts, long long cap) {
  const int u = blockIdx.x, b = blockIdx.y;
  const float w = weights[static_cast<long long>(b) * U + u];
  if (w == 0.0f) return;
  const long long base = static_cast<long long>(buckets[u]) * P;
  double* row_acc = acc + static_cast<long long>(b) * C;
  long long* mine = touched + static_cast<long long>(b) * cap;
  const int lane = threadIdx.x & 31;
  for (int j0 = 0; j0 < P; j0 += SCATTER_THREADS * SCATTER_ITEMS) {
    int col[SCATTER_ITEMS];
    float prod[SCATTER_ITEMS];
#pragma unroll
    for (int i = 0; i < SCATTER_ITEMS; ++i) {
      const int j = j0 + i * SCATTER_THREADS + threadIdx.x;
      col[i] = j < P ? cols[base + j] : -1;
      prod[i] = 0.0f;
      if (col[i] >= 0 && col[i] < C)
        prod[i] = __fmul_rn(w, __uint_as_float(static_cast<unsigned>(wts[base + j]) << 16));
    }
    bool first[SCATTER_ITEMS];
#pragma unroll
    for (int i = 0; i < SCATTER_ITEMS; ++i) {
      first[i] = false;
      if (prod[i] != 0.0f) {
        const double old = atomicAdd(row_acc + col[i], static_cast<double>(prod[i]));
        first[i] = static_cast<unsigned long long>(__double_as_longlong(old)) == NEG_ZERO;
      }
    }
#pragma unroll
    for (int i = 0; i < SCATTER_ITEMS; ++i) {
      const unsigned ballot = __ballot_sync(FULL, first[i]);
      if (ballot == 0) continue;
      int slot = 0;
      if (lane == 0) slot = atomicAdd(counts + b, __popc(ballot));
      slot = __shfl_sync(FULL, slot, 0);
      if (first[i]) mine[slot + __popc(ballot & ((1u << lane) - 1u))] = col[i];
    }
  }
}

// Exclusive prefix sum of `v` over the block's threads in thread order;
// `total` gets the sum. Every thread of the block calls it.
__device__ int block_scan(int v, int& total) {
  __shared__ int warp_sum[SELECT_WARPS];
  __shared__ int block_sum;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(FULL, incl, d);
    if (lane >= d) incl += t;
  }
  __syncthreads();  // the previous call's readers are done
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int own = lane < SELECT_WARPS ? warp_sum[lane] : 0;
    int x = own;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(FULL, x, d);
      if (lane >= d) x += t;
    }
    if (lane < SELECT_WARPS) warp_sum[lane] = x - own;
    if (lane == 31) block_sum = x;
  }
  __syncthreads();
  total = block_sum;
  return warp_sum[warp] + incl - v;
}

__device__ __forceinline__ float round_sum(const double* a, long long r) {
  return __double2float_rn(a[r]);
}

__global__ void __launch_bounds__(SELECT_THREADS)
    lex_select(const double* __restrict__ acc, long long* __restrict__ touched,
               const int* __restrict__ counts, const float* __restrict__ pen, long long C,
               long long cap, int m, float* __restrict__ vals, long long* __restrict__ idx) {
  __shared__ unsigned hist[256];
  __shared__ unsigned long long sel[ROUND_KEYS];
  __shared__ int pick_digit, pick_left, pick_done, n_sel;
  const int b = blockIdx.x, tid = threadIdx.x;
  const double* a = acc + static_cast<long long>(b) * C;
  const float* p = pen + static_cast<long long>(b) * C;
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(touched) + b * cap;
  float* out_v = vals + static_cast<long long>(b) * m;
  long long* out_i = idx + static_cast<long long>(b) * m;
  const int n = counts[b];

  // 1. the live rows' keys, compacted in place (a key lands at or before
  // the slot it was read from, after the whole chunk was read)
  int n_live = 0;
  for (int i0 = 0; i0 < n; i0 += SELECT_THREADS) {
    const int i = i0 + tid;
    unsigned long long key = 0;
    bool live = false;
    if (i < n) {
      const long long r = static_cast<long long>(keys[i]);
      const float s = round_sum(a, r);
      live = s > 0.0f && p[r] == 0.0f;
      key = (static_cast<unsigned long long>(__float_as_uint(s)) << 32) |
            static_cast<unsigned>(~static_cast<unsigned>(r));
    }
    int total;
    const int at = block_scan(live ? 1 : 0, total);
    if (live) keys[n_live + at] = key;
    n_live += total;
  }
  __syncthreads();

  // 2-3. the top `need` keys, in rounds of at most ROUND_KEYS: a round
  // takes the largest keys below `hi` (the smallest key the round before
  // took): the radix select of its last key, then its keys sorted
  // descending in shared memory
  const int need = min(m, n_live);
  unsigned long long hi = ~0ull;
  for (int done = 0; done < need;) {
    const int count = min(ROUND_KEYS, need - done);
    unsigned long long thresh = 0;  // every key below `hi` at or above it is taken
    if (n_live - done > count) {
      unsigned long long prefix = 0, mask = 0;
      unsigned left = count;  // keys still to take among those under `prefix`
      for (int shift = 56; shift >= 0; shift -= 8) {
        for (int i = tid; i < 256; i += SELECT_THREADS) hist[i] = 0;
        __syncthreads();
        for (int i = tid; i < n_live; i += SELECT_THREADS) {
          const unsigned long long key = keys[i];
          if ((key & mask) == prefix && key < hi) atomicAdd(&hist[(key >> shift) & 255], 1u);
        }
        __syncthreads();
        if (tid < 32) {  // lane l holds digits 255 - 8l down to 248 - 8l
          unsigned cnt[8], own = 0;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            cnt[j] = hist[255 - 8 * tid - j];
            own += cnt[j];
          }
          unsigned incl = own;
#pragma unroll
          for (int d = 1; d < 32; d <<= 1) {
            const unsigned t = __shfl_up_sync(FULL, incl, d);
            if (tid >= d) incl += t;
          }
          unsigned above = incl - own;
          if (above < left && left <= incl) {
            for (int j = 0; j < 8; ++j) {
              if (above + cnt[j] >= left) {
                pick_digit = 255 - 8 * tid - j;
                pick_left = static_cast<int>(left - above);
                pick_done = cnt[j] == left - above;
                break;
              }
              above += cnt[j];
            }
          }
        }
        __syncthreads();
        prefix |= static_cast<unsigned long long>(pick_digit) << shift;
        mask |= 0xFFull << shift;
        left = static_cast<unsigned>(pick_left);
        const bool stop = pick_done;
        __syncthreads();  // pick_* read before the next pass writes them
        if (stop) break;
      }
      thresh = prefix;
    }
    if (tid == 0) n_sel = 0;
    __syncthreads();
    for (int i = tid; i < n_live; i += SELECT_THREADS) {
      const unsigned long long key = keys[i];
      if (key >= thresh && key < hi) sel[atomicAdd(&n_sel, 1)] = key;
    }
    int width = 1;
    while (width < count) width <<= 1;
    __syncthreads();
    for (int i = count + tid; i < width; i += SELECT_THREADS) sel[i] = 0;
    __syncthreads();
    for (int k = 2; k <= width; k <<= 1)
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int i = tid; i < width; i += SELECT_THREADS) {
          const int o = i ^ j;
          if (o > i) {
            const unsigned long long x = sel[i], y = sel[o];
            if ((i & k) == 0 ? x < y : x > y) {
              sel[i] = y;
              sel[o] = x;
            }
          }
        }
        __syncthreads();
      }
    for (int i = tid; i < count; i += SELECT_THREADS) {
      out_v[done + i] = __uint_as_float(static_cast<unsigned>(sel[i] >> 32));
      out_i[done + i] = static_cast<long long>(~static_cast<unsigned>(sel[i]));
    }
    hi = sel[count - 1];
    done += count;
    __syncthreads();  // sel read before the next round writes it
  }

  // 4. the dead tail in row order: NEG_INF rows, then NEG_INF + NEG_INF
  int filled = need;
  for (int cls = 1; cls <= 2 && filled < m; ++cls) {
    const float v = cls == 1 ? NEG_INF : __fadd_rn(NEG_INF, NEG_INF);
    for (long long r0 = 0; r0 < C && filled < m;
         r0 += static_cast<long long>(SELECT_THREADS) * FILL_ROWS) {
      const long long first = r0 + static_cast<long long>(tid) * FILL_ROWS;
      unsigned take = 0;
#pragma unroll
      for (int j = 0; j < FILL_ROWS; ++j) {
        const long long r = first + j;
        if (r < C) {
          const bool open = p[r] == 0.0f;
          const bool scored =
              static_cast<unsigned long long>(__double_as_longlong(a[r])) != NEG_ZERO &&
              round_sum(a, r) > 0.0f;
          if (cls == 1 ? scored != open : !scored && !open) take |= 1u << j;
        }
      }
      int total;
      int at = filled + block_scan(__popc(take), total);
      for (int j = 0; j < FILL_ROWS; ++j)
        if ((take >> j) & 1u) {
          if (at < m) {
            out_v[at] = v;
            out_i[at] = first + j;
          }
          ++at;
        }
      filled += total;
    }
  }
}

}  // namespace

// Scatter and select in one call, on `stream`. weights [B, U] f32;
// buckets [U] i32; cols [H, P] i32 (-1 pad), wts [H, P] bf16 bits; pen
// [B, C] f32 holding 0 and NEG_INF alone; acc [B, C] f64 scratch (left
// holding the sums, -0.0 where untouched); touched [B, cap] i64 scratch,
// cap = min(C, U * P); counts [B] i32 scratch; vals [B, m] f32; idx
// [B, m] i64. Requires 1 <= m <= C.
extern "C" int mrag_lex_topk(const float* weights, const int* buckets, const int* cols,
                             const uint16_t* wts, const float* pen, int B, int U, int P,
                             long long C, int m, double* acc, long long* touched, int* counts,
                             long long cap, float* vals, long long* idx, void* stream) {
  if (B < 1 || U < 1 || P < 1 || C < 1 || m < 1 || m > C || B > 65535 ||
      cap < (C < static_cast<long long>(U) * P ? C : static_cast<long long>(U) * P))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n = static_cast<long long>(B) * C;
  const long long blocks = (n + INIT_THREADS - 1) / INIT_THREADS;
  lex_init<<<static_cast<unsigned>(blocks < 8192 ? blocks : 8192), INIT_THREADS, 0, s>>>(
      reinterpret_cast<unsigned long long*>(acc), n, counts, B);
  lex_scatter<<<dim3(U, B), SCATTER_THREADS, 0, s>>>(weights, buckets, cols, wts, U, P, C, acc,
                                                     touched, counts, cap);
  lex_select<<<B, SELECT_THREADS, 0, s>>>(acc, touched, counts, pen, C, cap, m, vals, idx);
  return static_cast<int>(cudaGetLastError());
}
