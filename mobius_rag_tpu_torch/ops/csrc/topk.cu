// Masked cosine top-m for NVIDIA Hopper (sm_90a).
//
// Replaces mobius_rag_tpu/ops/topk.py:151 (_topk_kernel, the Pallas fused
// masked cosine top-k) and serves the JAX engine's exact vector arm
// (query/engine.py:277-279,477-485):
//
//   cos[b, c]   = (q[b]·v[c]) * s[c]            (s: int8 rows' scales, else 1)
//   score[b, c] = cos[b, c] + penalty[b, c] (+ NEG_INF where cos[b, c] < min_sim[b])
//   out[b]      = the top m of score[b, :], descending, lower row first on ties
//
// The rows are float32, bfloat16 or int8 (the store's
// MRAG_VECTOR_DTYPE=int8 form, with its per-row scales). Two cores compute
// the dots. The tensor-core core (mma.sync m16n8k16 bf16 -> float32) takes
// bfloat16 rows at every query tile QT, int8 rows from QT = 4 and float32
// rows at QT = 32 (MMA_QT_INT8, MMA_QT_F32); every product there is exact,
// so only the order of the float32 sums differs from a float32 dot. The
// float32 FMA core takes the rest, where it measured faster (PERF.md): a
// few queries a tile pad most of an n8 tile, and splitting or widening the
// rows then costs more than the FMAs it saves; and a float32-row tile
// whose queries' first k-slice is not bf16-exact, since float32 rows
// against float32 queries take 9 tensor-core products a k-step. int8 rows
// widen exactly to float32 on the FMA core's shared -> register read
// (through the float bits of 2^23 + 128 + x). The scale multiplies the
// full dot (one rounded product) before the penalty and the min_sim test,
// as the JAX dense arm computes cos and then compares it.
//
// Exact bf16 operands. A float32 value x splits exactly into three bf16
// parts, each the truncation of what the parts before it leave: hi = x's
// top 16 bits, mid = those of r = x - hi, lo = r - mid (r and lo are exact
// in float32, and lo has at most 8 significant bits), so hi + mid + lo ==
// x away from float32 underflow, and a product of two parts is exact in
// the float32 accumulator. The engine sends bf16-rounded queries
// (query/engine.py prepare_batch), whose mid and lo are zero: after each
// k-slice lands, every thread tests the query chunks it copied, and
// __syncthreads_or, the slice's barrier, tells the block whether this
// slice's queries take 3 parts or 1. The rows' parts: bfloat16 rows are
// their own 1 part; int8 rows widen exactly to bf16 (|x| <= 128 has 8
// significant bits), 1 part; float32 rows split into 3. So a k-step takes
// (row parts) x (query parts) products: 1 or 3 on bf16 and int8 rows, 3 on
// float32 rows (9 where a later slice of a tile that began bf16-exact is
// not).
//
// The k-permutation (float32 and int8 rows). A k16 step's product is
// unchanged by any permutation of k applied to both A (rows) and B
// (queries). A lane of the m16n8k16 fragments holds k = 2t, 2t+1 (a0/a1,
// b0) and 2t+8, 2t+9 (a2/a3, b1) of its rows g and g+8 and its query g;
// here it takes instead 4 consecutive elements e..e+3 of the slice, e =
// 8t + 4kk on float32 rows (k-step kk of 2) and 16kk + 4t on int8 rows (kk
// of 8), e, e+1 in place of 2t, 2t+1 and e+2, e+3 in place of 2t+8, 2t+9:
// one 16-byte read of each row (float32) or one 4-byte read (int8), and
// one float4 of its query, for A and B alike. The k-steps of a slice
// cover its elements once. bfloat16 rows keep the layout of the PTX ISA:
// A from ldmatrix.x4, B from two float2 reads.
//
// What bounds it on this card: at the main path's shape (B=32 queries,
// C=70,144 rows, D=1536, m=40) float32 rows are 431 MB: bytes, 0.131 ms at
// 3.35 TB/s, against 20.7 GFLOP of bf16 products (3 a k-step, 0.021 ms at
// the 989 TFLOP/s bf16 peak) or 6.9 GFLOP of float32 FMAs (0.103 ms at 67
// TFLOP/s). int8 rows (108 MB; 0.035 ms) and bfloat16 rows (215 MB; 400
// MB with the penalty at one 1M shard's C=125,000) are bound by bytes too.
// Measured on an H100 (PERF.md), the tensor-core core's pass 1 is bound by
// its copies and its per-tile selection, not by its products: with
// bf16-exact queries at B=32 it takes ~0.22 ms on float32 rows, ~0.11 on
// int8 rows (C=70,144) and ~0.20 on bf16 rows (C=125,000), against ~0.21,
// ~0.08 and ~0.19 for its copies and selection alone; no copy of its block
// is in flight while it selects (~0.04 ms at C=125,000).
//
// What the design does about it:
//   pass 1 (topk_tiles<T, QT>): one block per (128-row tile, QT queries);
//     QT is 32, 16, 8, 4 or 1, the smallest that holds B, so that a small
//     batch computes few padded queries and a single search none. Row and
//     query k-slices (128 bytes of a row: 32 float32, 64 bfloat16 or 128
//     int8 values, and the queries' same depth in float32) come into a
//     ring in shared memory (NSTAGE stages) through cp.async 16-byte copies
//     (zero-filled past B, C and D), one barrier per slice, so slice k + 1
//     is in flight while slice k is computed. On the tensor cores a warp
//     computes MT m16 x NT n8 tiles (MmaGeom for bf16 rows: 2 x 2 at
//     QT=32; RowsGeom for float32 and int8 rows, 1 x QT / 8, so that one
//     warp makes each row tile's split or widened fragments); QT 4 and 1
//     pad to one n8 tile. The 144-byte row stride puts ldmatrix's 8 rows
//     and the int8 rows' 4-byte reads on distinct banks, and float32 rows'
//     16-byte reads of rows g and g+1 (a quarter warp) on alternate 16-byte
//     bank groups; the queries' stride (DK + 8 floats for bf16 rows, DK + 4
//     for float32, DK + 16 for int8) does the same for their float2 or
//     float4 reads. On the FMA core a lane computes RT rows x QTT queries
//     from 128-bit shared reads (Geom: 4 x 4 at QT=32); a warp's lanes take
//     consecutive rows and share its queries, so the query reads are
//     broadcasts and the row reads conflict-free. Then the penalty and
//     min_sim, one 64-bit key per (query, row) in shared memory, and one
//     warp per query selects the tile's top P = min(m, 128) keys without
//     sorting them: a bitwise search for the largest score word h with at
//     least P keys at or above it (ballots over the 128 keys held 4 per
//     lane), then the keys above h and, of those on h, the first in row
//     order by their rank. The warp writes its P keys unsorted and the
//     tile's largest.
//   pass 2 (topk_select), where m <= 128 and there are at least m tiles:
//     one block per query. Its threads each take the largest key of a set
//     of tiles; the m-th largest of those keys, cut to its score bits, is a
//     lower bound t on the query's m-th key (at least m keys are >= t),
//     and every one of the query's top m keys was kept by its own tile. So
//     the block reads the partial keys once, keeps those >= t (typically a
//     few times m) in shared memory, and bitonic-sorts only them. Where
//     more keys pass than its buffer holds (many equal scores), it merges
//     them in rounds, sorting and keeping the top m each time.
//   pass 2 (topk_merge), otherwise (m over 128, or fewer tiles than m): a
//     tree, each block sorting up to 4096 partial keys of one query and
//     keeping the first m, until one block per query holds the top m.
//
// The 64-bit key is (order-preserving bits of the float score) << 32 |
// (0xFFFFFFFF - row), so a single descending order gives score descending
// and, among equal scores, the lower row first: lax.top_k's tie order.
// Keys are unique through the row, so both selection rules are exact.
//
// Plain C interface for ctypes: the caller allocates the outputs and the
// scratch keys, the launches go on the caller's stream, nothing is
// allocated or synchronised here, and the return value is
// cudaGetLastError() after the launches.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int TILE_ROWS = 128;  // rows per pass-1 block
constexpr int KPL = TILE_ROWS / 32;  // a lane's keys in pass 1's selection
constexpr int SLICE_BYTES = 128;  // bytes of a row per k-slice
constexpr int NSTAGE = 2;       // ring depth of pass 1
constexpr int BUF2 = 4096;      // keys one pass-2 block holds
constexpr int THREADS2 = 1024;
constexpr int LOAD2 = 8;        // keys each pass-2 thread loads at once
constexpr float NEG_INF = -1e30f;

__host__ __device__ inline int n_tiles_of(int C) { return (C + TILE_ROWS - 1) / TILE_ROWS; }

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

__device__ __forceinline__ uint64_t kmax(uint64_t a, uint64_t b) { return a > b ? a : b; }

__device__ __forceinline__ int key_row(uint64_t key) {
  return static_cast<int>(0xFFFFFFFFu - static_cast<uint32_t>(key));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Copy `bytes` (0..16; the rest of the 16 zero-filled) from global to shared.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned addr, unsigned& r0, unsigned& r1,
                                            unsigned& r2, unsigned& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr)
               : "memory");
}

// c += A (16 x 16 bf16, row) * B (16 x 8 bf16, col), float32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], unsigned a0, unsigned a1, unsigned a2,
                                         unsigned a3, unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Two bf16 (the top halves of float bits u0, lower k, and u1) as one
// mma operand register.
__device__ __forceinline__ unsigned pack_top(unsigned u0, unsigned u1) {
  return __byte_perm(u0, u1, 0x7632);
}

// The exact split of two float32 elements into bf16 parts, packed as mma
// operands: hi + mid + lo == x (see the header).
__device__ __forceinline__ void split2(float2 x, unsigned& hi, unsigned& mid, unsigned& lo) {
  const unsigned u0 = __float_as_uint(x.x), u1 = __float_as_uint(x.y);
  const float r0 = x.x - __uint_as_float(u0 & 0xFFFF0000u);
  const float r1 = x.y - __uint_as_float(u1 & 0xFFFF0000u);
  const unsigned v0 = __float_as_uint(r0), v1 = __float_as_uint(r1);
  hi = pack_top(u0, u1);
  mid = pack_top(v0, v1);
  lo = pack_top(__float_as_uint(r0 - __uint_as_float(v0 & 0xFFFF0000u)),
                __float_as_uint(r1 - __uint_as_float(v1 & 0xFFFF0000u)));
}

// Four consecutive staged elements as float32: float32 as they are, int8
// exactly through the float 2^23 + 128 + x (its mantissa holds the byte
// x + 128), minus 2^23 + 128.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const int8_t* p) {
  const unsigned u = *reinterpret_cast<const unsigned*>(p) ^ 0x80808080u;
  constexpr float BIAS = 8388736.0f;  // 2^23 + 128
  return make_float4(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - BIAS,
                     __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - BIAS,
                     __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - BIAS,
                     __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - BIAS);
}

// The bf16 parts of four consecutive elements as mma operands: parts p of
// (x, y) into lo[p], of (z, w) into hi[p]. One part where the values are
// bf16-exact (their top halves), else the three of split2.
template <bool SPLIT>
__device__ __forceinline__ void parts4(float4 x, unsigned (&lo)[3], unsigned (&hi)[3]) {
  if constexpr (SPLIT) {
    split2(make_float2(x.x, x.y), lo[0], lo[1], lo[2]);
    split2(make_float2(x.z, x.w), hi[0], hi[1], hi[2]);
  } else {
    lo[0] = pack_top(__float_as_uint(x.x), __float_as_uint(x.y));
    hi[0] = pack_top(__float_as_uint(x.z), __float_as_uint(x.w));
  }
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

// The tensor-core core's geometry by the query tile QT: WM row groups x
// WN query groups of warps; a warp computes MT m16 tiles of rows x NT n8
// tiles of queries (QT 4 and 1 fill one n8 tile in part).
template <int QT>
struct MmaGeom;
template <>
struct MmaGeom<32> { static constexpr int WM = 4, WN = 2, MT = 2, NT = 2; };
template <>
struct MmaGeom<16> { static constexpr int WM = 4, WN = 2, MT = 2, NT = 1; };
template <>
struct MmaGeom<8> { static constexpr int WM = 8, WN = 1, MT = 1, NT = 1; };
template <>
struct MmaGeom<4> { static constexpr int WM = 4, WN = 1, MT = 2, NT = 1; };
template <>
struct MmaGeom<1> { static constexpr int WM = 4, WN = 1, MT = 2, NT = 1; };
// float32 and int8 rows, whose A fragments cost a split or a widening: one
// warp makes each m16 tile's fragments, for all of the tile's queries
template <int QT>
struct RowsGeom { static constexpr int WM = 8, WN = 1, MT = 1, NT = QT / 8; };
template <>
struct RowsGeom<4> : MmaGeom<4> {};
template <>
struct RowsGeom<1> : MmaGeom<1> {};

// The FMA core's geometry by QT: the block's warps are WQ query groups x
// WR row groups; a warp's lanes are LQ query lanes x 32 / LQ row lanes; a
// lane computes RT rows x QTT queries.
template <int QT>
struct Geom;
template <>
struct Geom<32> { static constexpr int WQ = 8, WR = 1, LQ = 1, RT = 4, QTT = 4; };
template <>
struct Geom<16> { static constexpr int WQ = 4, WR = 2, LQ = 1, RT = 2, QTT = 4; };
template <>
struct Geom<8> { static constexpr int WQ = 2, WR = 4, LQ = 1, RT = 1, QTT = 4; };
template <>
struct Geom<4> { static constexpr int WQ = 1, WR = 4, LQ = 1, RT = 1, QTT = 4; };
template <>
struct Geom<1> { static constexpr int WQ = 1, WR = 4, LQ = 1, RT = 1, QTT = 1; };

// The smallest query tile QT whose dots run on the tensor cores, by row
// type; below it the float32 FMA core computes them: where a few queries
// pad most of an n8 tile, splitting or widening the rows costs more than
// the FMAs it saves (PERF.md). bf16 rows always take the tensor cores.
constexpr int MMA_QT_F32 = 32;
constexpr int MMA_QT_INT8 = 4;

template <typename T, int QT>
constexpr bool use_mma() {
  return std::is_same<T, __nv_bfloat16>::value ||
         QT >= (std::is_same<T, float>::value ? MMA_QT_F32 : MMA_QT_INT8);
}

// Pass-1 layout for element type T and QT queries a block.
template <typename T, int QT>
struct Tile {
  static constexpr bool MMA = use_mma<T, QT>();
  static constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;  // A from ldmatrix
  static constexpr int A_PARTS = std::is_same<T, float>::value ? 3 : 1;  // the rows' bf16 parts
  // float32 rows on the tensor cores keep the FMA core for float32 queries
  static constexpr bool FMA_TOO = MMA && A_PARTS == 3;
  using MG = std::conditional_t<BF16, MmaGeom<QT>, RowsGeom<QT>>;
  static constexpr int WM = MG::WM, WN = MG::WN, MT = MG::MT, NT = MG::NT;
  static constexpr int WQ = Geom<QT>::WQ, WR = Geom<QT>::WR, LQ = Geom<QT>::LQ;
  static constexpr int RT = Geom<QT>::RT, QTT = Geom<QT>::QTT;
  static constexpr int LR = 32 / LQ;  // row lanes of an FMA warp
  static constexpr int WARPS = MMA ? WM * WN : WQ * WR;
  static constexpr int THREADS = 32 * WARPS;
  static_assert(WM * MT * 16 == TILE_ROWS, "the mma warps cover the tile's rows");
  static_assert(WN * NT * 8 == (QT < 8 ? 8 : QT), "the mma warps cover the tile's queries");
  static_assert(WR * LR * RT == TILE_ROWS, "the FMA warps cover the tile's rows");
  static_assert(WQ * LQ * QTT == QT, "the FMA warps cover the tile's queries");
  static_assert(!FMA_TOO || WQ * WR == WM * WN, "both cores run in one block");
  static constexpr int DK = SLICE_BYTES / sizeof(T);     // depth of a k-slice
  static constexpr int ROW_STRIDE = SLICE_BYTES + 16;    // bytes: 4 mod 32 words
  // floats, for conflict-free reads of the queries (see the header): on
  // the tensor cores 8 mod 32 words for bf16 rows' float2 reads at 2t and
  // 2t + 8, 4 mod 8 for float32 rows' float4 at 8t + 4kk, 16 mod 32 for
  // int8's at 16kk + 4t; 4 mod 8 for the FMA core's float4 broadcasts
  static constexpr int Q_STRIDE = DK + (!MMA ? 4 : BF16 ? 8 : A_PARTS == 3 ? 4 : 16);
  static constexpr int ROWS_BYTES = TILE_ROWS * ROW_STRIDE;
  static constexpr int Q_BYTES = QT * Q_STRIDE * 4;
  static constexpr int STAGE = ROWS_BYTES + Q_BYTES;
  static constexpr int RING = NSTAGE * STAGE;
  static constexpr int KEYS = QT * TILE_ROWS * 8;        // the keys reuse the ring
  static constexpr int SMEM = RING > KEYS ? RING : KEYS;
  static constexpr int ROW_CHUNKS = TILE_ROWS * (SLICE_BYTES / 16) / THREADS;  // a thread's
  static constexpr int Q_CHUNKS = (QT * DK / 4 + THREADS - 1) / THREADS;
  // int8 rows on the tensor cores: ptxas keeps the registers under what
  // the blocks that the shared memory holds (228 KB an SM, 1 KB of it
  // reserved a block) allow; left alone it takes enough to hold one block
  // fewer (at QT=32, 2 of 3). Other instantiations: no bound (0), which
  // measured faster (PERF.md)
  static constexpr int MIN_BLOCKS = MMA && sizeof(T) == 1 ? 233472 / (SMEM + 1024) : 0;
};

template <typename T, int QT>
__global__ void __launch_bounds__(Tile<T, QT>::THREADS, Tile<T, QT>::MIN_BLOCKS)
topk_tiles(const float* __restrict__ q, const T* __restrict__ vec,
           const float* __restrict__ scales, const float* __restrict__ pen,
           long long pen_stride, const float* __restrict__ min_sim, int B, int C, int D,
           int P, int cp_bytes, uint64_t* __restrict__ partial, uint64_t* __restrict__ tmax) {
  using G = Tile<T, QT>;
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* keys = reinterpret_cast<uint64_t*>(smem);  // after the dots: [QT][TILE_ROWS]

  const int q0 = blockIdx.y * QT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_tiles = n_tiles_of(C);
  const int tile = blockIdx.x;
  const int row0 = tile * TILE_ROWS;

  // k-slice ks into stage st: TILE_ROWS row slices of SLICE_BYTES in
  // 16-byte chunks (each one copy, or 16 / cp_bytes where the rows are not
  // 16-byte aligned), QT query slices of DK floats; zero past C, B and D
  const int n_slices = (D + G::DK - 1) / G::DK;
  const long long row_bytes = static_cast<long long>(D) * sizeof(T);
  auto stage = [&](int ks, int st) {
    unsigned char* sg = smem + st * G::STAGE;
#pragma unroll
    for (int u = 0; u < G::ROW_CHUNKS; ++u) {
      const int e = tid + u * G::THREADS;
      const int r = e / (SLICE_BYTES / 16), c = e % (SLICE_BYTES / 16);
      const int row = row0 + r;
      const long long kb = static_cast<long long>(ks) * SLICE_BYTES + 16 * c;  // byte in row
      const long long left = row < C ? row_bytes - kb : 0;
      const unsigned char* src = reinterpret_cast<const unsigned char*>(vec) +
                                 (left > 0 ? static_cast<size_t>(row) * row_bytes + kb : 0);
      unsigned char* dst = sg + r * G::ROW_STRIDE + 16 * c;
      if (cp_bytes == 16) {
        cp_async16(dst, src, left <= 0 ? 0 : (left < 16 ? static_cast<int>(left) : 16));
      } else {
        for (int h = 0; h < 16; h += cp_bytes) {
          const long long l = left - h;
          const int n = l <= 0 ? 0 : (l < cp_bytes ? static_cast<int>(l) : cp_bytes);
          if (cp_bytes == 8) cp_async8(dst + h, n ? src + h : src, n);
          else cp_async4(dst + h, n ? src + h : src, n);
        }
      }
    }
    float* qs = reinterpret_cast<float*>(sg + G::ROWS_BYTES);
#pragma unroll
    for (int u = 0; u < G::Q_CHUNKS; ++u) {
      const int e = tid + u * G::THREADS;
      if (e < QT * (G::DK / 4)) {
        const int qq = e / (G::DK / 4), c = e % (G::DK / 4);
        const int qi = q0 + qq, k = ks * G::DK + 4 * c;
        const bool in = qi < B && k < D;  // D % 4 == 0: a chunk is whole or absent
        cp_async16(qs + qq * G::Q_STRIDE + 4 * c, in ? q + static_cast<size_t>(qi) * D + k : q,
                   in ? 16 : 0);
      }
    }
  };

  // (query qq, row rr)'s key from its dot, into the key buffer
  auto emit = [&](int qq, int rr, float acc) {
    const int row = row0 + rr;
    const int qi = q0 + qq;
    float s = -INFINITY;  // rows past C sort below every real score
    if (row < C && qi < B) {
      const float dot = scales != nullptr ? __fmul_rn(acc, scales[row]) : acc;
      s = dot + pen[static_cast<size_t>(qi) * pen_stride + row];
      if (dot < min_sim[qi]) s += NEG_INF;
    }
    keys[qq * TILE_ROWS + rr] = make_key(s, row);
  };
#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < n_slices) stage(s, s);
    cp_async_commit();
  }

  // whether a query chunk this thread copied into the slice at sg is not
  // bf16-exact (the thread's own copies have landed for it)
  auto resid_of = [&](const unsigned char* sg) {
    unsigned resid = 0;
#pragma unroll
    for (int u = 0; u < G::Q_CHUNKS; ++u) {
      const int e = tid + u * G::THREADS;
      if (e < QT * (G::DK / 4)) {
        const int qq = e / (G::DK / 4), c = e % (G::DK / 4);
        const uint4 w =
            *reinterpret_cast<const uint4*>(sg + G::ROWS_BYTES + (qq * G::Q_STRIDE + 4 * c) * 4);
        resid |= (w.x | w.y | w.z | w.w) & 0xFFFFu;
      }
    }
    return resid != 0;
  };

  // the tensor-core core
  auto mma_core = [&]() {
    if constexpr (G::MMA) {
      const int wm = warp % G::WM, wn = warp / G::WM;
      const int g = lane >> 2, t = lane & 3;  // the mma fragments' group and lane in it
      float acc[G::MT][G::NT][4] = {};
      // bf16 rows: this lane's ldmatrix row of A, row wm * MT * 16 + lane % 16
      // (+ 16 i), k from 8 * (lane / 16) (+ 16 per k-step)
      const unsigned a_lane = smem_addr(smem) +
                              (wm * G::MT * 16 + (lane & 15)) * G::ROW_STRIDE + (lane >> 4) * 16;
      // the slice's k-steps (zero past D): (row parts) x (query parts)
      // products, the query parts 3 where SPLIT, else 1
      auto slice = [&](auto split_tag, const unsigned char* sg) {
        constexpr bool SPLIT = decltype(split_tag)::value;
        constexpr int QP = SPLIT ? 3 : 1;
        const float* qs = reinterpret_cast<const float*>(sg + G::ROWS_BYTES);
#pragma unroll
        for (int kk = 0; kk < G::DK / 16; ++kk) {
          // this lane's first element of the k-step: the PTX layout's 2t on
          // bf16 rows, the k-permutation's e on float32 and int8 rows
          const int e = G::BF16           ? kk * 16 + 2 * t
                        : sizeof(T) == 4 ? 8 * t + 4 * kk
                                         : 16 * kk + 4 * t;
          unsigned a[G::MT][4][G::A_PARTS];  // tile i's a0..a3, by part
#pragma unroll
          for (int i = 0; i < G::MT; ++i) {
            if constexpr (G::BF16) {
              ldmatrix_x4(a_lane + static_cast<unsigned>(sg - smem) + i * 16 * G::ROW_STRIDE +
                              kk * 32,
                          a[i][0][0], a[i][1][0], a[i][2][0], a[i][3][0]);
            } else {  // rows g and g + 8 of the m16 tile
              const unsigned char* ra =
                  sg + ((wm * G::MT + i) * 16 + g) * G::ROW_STRIDE + e * sizeof(T);
              unsigned lo[3], hi[3];
              parts4<G::A_PARTS == 3>(load4(reinterpret_cast<const T*>(ra)), lo, hi);
#pragma unroll
              for (int pa = 0; pa < G::A_PARTS; ++pa) a[i][0][pa] = lo[pa], a[i][2][pa] = hi[pa];
              parts4<G::A_PARTS == 3>(load4(reinterpret_cast<const T*>(ra + 8 * G::ROW_STRIDE)),
                                      lo, hi);
#pragma unroll
              for (int pa = 0; pa < G::A_PARTS; ++pa) a[i][1][pa] = lo[pa], a[i][3][pa] = hi[pa];
            }
          }
#pragma unroll
          for (int j = 0; j < G::NT; ++j) {
            const int n = (wn * G::NT + j) * 8 + g;  // this lane's query of the n8 tile
            float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
            if (QT >= 8 || n < QT) {
              const float* qn = qs + n * G::Q_STRIDE + e;
              if constexpr (G::BF16) {
                const float2 x0 = *reinterpret_cast<const float2*>(qn);
                const float2 x1 = *reinterpret_cast<const float2*>(qn + 8);
                x = make_float4(x0.x, x0.y, x1.x, x1.y);
              } else {
                x = *reinterpret_cast<const float4*>(qn);
              }
            }
            unsigned b0[3], b1[3];
            parts4<SPLIT>(x, b0, b1);
#pragma unroll
            for (int pa = 0; pa < G::A_PARTS; ++pa)
#pragma unroll
              for (int pb = 0; pb < QP; ++pb)
#pragma unroll
                for (int i = 0; i < G::MT; ++i)
                  mma_bf16(acc[i][j], a[i][0][pa], a[i][1][pa], a[i][2][pa], a[i][3][pa], b0[pb],
                           b1[pb]);
          }
        }
      };
      for (int ks = 0; ks < n_slices; ++ks) {
        cp_async_wait<NSTAGE - 2>();
        const unsigned char* sg = smem + (ks % NSTAGE) * G::STAGE;
        // slice ks landed for all; slice ks - 1's stage is free
        const bool split = __syncthreads_or(resid_of(sg));
        if (ks + NSTAGE - 1 < n_slices) stage(ks + NSTAGE - 1, (ks + NSTAGE - 1) % NSTAGE);
        cp_async_commit();
        if (split) slice(std::true_type{}, sg);
        else slice(std::false_type{}, sg);
      }
      cp_async_wait<0>();
      __syncthreads();  // the ring becomes the key buffer
      // accumulator h of tile (i, j): row g (+8 for h >= 2), query 2t + h % 2
#pragma unroll
      for (int i = 0; i < G::MT; ++i)
#pragma unroll
        for (int j = 0; j < G::NT; ++j)
#pragma unroll
          for (int h = 0; h < 4; ++h) {
            const int qq = (wn * G::NT + j) * 8 + 2 * t + (h & 1);
            if (QT >= 8 || qq < QT)
              emit(qq, (wm * G::MT + i) * 16 + g + 8 * (h >> 1), acc[i][j][h]);
          }
    }
  };

  // the float32 FMA core
  auto fma_core = [&]() {
    if constexpr (!G::BF16) {
      const int wr = warp % G::WR, wq = warp / G::WR;
      // this lane's rows: rbase + LR * i (i < RT); queries: qbase + LQ * j (j < QTT)
      const int rbase = wr * G::LR * G::RT + lane % G::LR;
      const int qbase = wq * G::LQ * G::QTT + lane / G::LR;
      float acc[G::RT][G::QTT] = {};
      // 4 depths of the slice at kk: each accumulator takes its 4 FMAs in k order
      auto step = [&](const T* rs, const float* qs, int kk) {
        float4 qv[G::QTT];
#pragma unroll
        for (int j = 0; j < G::QTT; ++j)
          qv[j] = *reinterpret_cast<const float4*>(qs + j * G::LQ * G::Q_STRIDE + kk);
#pragma unroll
        for (int i = 0; i < G::RT; ++i) {
          const float4 v = load4(rs + i * G::LR * (G::ROW_STRIDE / sizeof(T)) + kk);
#pragma unroll
          for (int j = 0; j < G::QTT; ++j) {
            acc[i][j] = fmaf(qv[j].x, v.x, acc[i][j]);
            acc[i][j] = fmaf(qv[j].y, v.y, acc[i][j]);
            acc[i][j] = fmaf(qv[j].z, v.z, acc[i][j]);
            acc[i][j] = fmaf(qv[j].w, v.w, acc[i][j]);
          }
        }
      };
      for (int ks = 0; ks < n_slices; ++ks) {
        cp_async_wait<NSTAGE - 2>();
        __syncthreads();  // slice ks landed for all; slice ks - 1's stage is free
        if (ks + NSTAGE - 1 < n_slices) stage(ks + NSTAGE - 1, (ks + NSTAGE - 1) % NSTAGE);
        cp_async_commit();
        const unsigned char* sg = smem + (ks % NSTAGE) * G::STAGE;
        const T* rs = reinterpret_cast<const T*>(sg) + rbase * (G::ROW_STRIDE / sizeof(T));
        const float* qs = reinterpret_cast<const float*>(sg + G::ROWS_BYTES) + qbase * G::Q_STRIDE;
        const int width = D - ks * G::DK;
        if (width >= G::DK) {
#pragma unroll
          for (int kk = 0; kk < G::DK; kk += 4) step(rs, qs, kk);
        } else {
          for (int kk = 0; kk < width; kk += 4) step(rs, qs, kk);
        }
      }
      cp_async_wait<0>();
      __syncthreads();  // the ring becomes the key buffer
#pragma unroll
      for (int i = 0; i < G::RT; ++i)
#pragma unroll
        for (int j = 0; j < G::QTT; ++j) emit(qbase + j * G::LQ, rbase + i * G::LR, acc[i][j]);
    }
  };

  if constexpr (!G::MMA) {
    fma_core();
  } else if constexpr (!G::FMA_TOO) {
    mma_core();
  } else {
    // float32 rows: the FMA core takes a tile whose queries' first slice
    // is not bf16-exact (float32 queries, whose 9 tensor-core products a
    // k-step are slower than the FMAs; PERF.md), the tensor cores the rest
    cp_async_wait<NSTAGE - 2>();
    if (__syncthreads_or(resid_of(smem))) fma_core();
    else mma_core();
  }
  __syncthreads();

  // one warp per query: the tile's top P keys (unsorted) and its largest
  const unsigned below = (1u << lane) - 1u;
  for (int qq = warp; qq < QT && q0 + qq < B; qq += G::WARPS) {
    const int qi = q0 + qq;
    uint64_t k[KPL];  // key r of the tile at lane r % 32, k[r / 32]
    uint64_t mx = 0;
#pragma unroll
    for (int i = 0; i < KPL; ++i) {
      k[i] = keys[qq * TILE_ROWS + lane + 32 * i];
      mx = kmax(mx, k[i]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = kmax(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    if (lane == 0) tmax[static_cast<size_t>(qi) * n_tiles + tile] = mx;
    uint64_t* out = partial + (static_cast<size_t>(qi) * n_tiles + tile) * P;
    if (P == TILE_ROWS) {  // every key of the tile is kept
#pragma unroll
      for (int i = 0; i < KPL; ++i) out[lane + 32 * i] = k[i];
      continue;
    }
    // h: the largest score word with at least P keys at or above it. The
    // keys above h are kept, and of those on h (equal scores) the first
    // P - above in row order, which is key order: lower row first.
    uint32_t hi[KPL];
#pragma unroll
    for (int i = 0; i < KPL; ++i) hi[i] = static_cast<uint32_t>(k[i] >> 32);
    auto count = [&](auto pred) {
      int n = 0;
#pragma unroll
      for (int i = 0; i < KPL; ++i) n += __popc(__ballot_sync(0xffffffffu, pred(i)));
      return n;
    };
    uint32_t h = 0;
    for (int bit = 31; bit >= 0; --bit) {
      const uint32_t c = h | (1u << bit);
      if (count([&](int i) { return hi[i] >= c; }) >= P) h = c;
    }
    const int need = P - count([&](int i) { return hi[i] > h; });  // keys to keep on h
    int base = 0, tied = 0;
#pragma unroll
    for (int i = 0; i < KPL; ++i) {
      const unsigned on_h = __ballot_sync(0xffffffffu, hi[i] == h);
      const bool kept = hi[i] > h || (hi[i] == h && tied + __popc(on_h & below) < need);
      const unsigned keep = __ballot_sync(0xffffffffu, kept);
      if (kept) out[base + __popc(keep & below)] = k[i];
      base += __popc(keep);
      tied += __popc(on_h);
    }
  }
}

// Block b: the top m of query b's n_tiles * m partial keys (each tile's
// top m), into out_vals/out_idx. Needs m <= THREADS2 and n_tiles >= m.
__global__ void __launch_bounds__(THREADS2)
topk_select(const uint64_t* __restrict__ partial, const uint64_t* __restrict__ tmax,
            int n_tiles, int m, float* __restrict__ out_vals, int* __restrict__ out_idx) {
  __shared__ uint64_t buf[BUF2];
  __shared__ int cnt;
  const int b = blockIdx.x, tid = threadIdx.x;
  // t: the largest score word h such that at least m of the threads'
  // group maxima (each the largest key of tiles tid, tid + THREADS2, ...)
  // are >= h << 32; at least m keys of the query are then >= t
  const uint64_t* tm = tmax + static_cast<size_t>(b) * n_tiles;
  uint64_t g = 0;
  for (int i = tid; i < n_tiles; i += THREADS2) g = kmax(g, tm[i]);
  const uint32_t gh = static_cast<uint32_t>(g >> 32);
  uint32_t h = 0;
  for (int bit = 31; bit >= 0; --bit) {
    const uint32_t c = h | (1u << bit);
    if (__syncthreads_count(g != 0 && gh >= c) >= m) h = c;
  }
  const uint64_t t = static_cast<uint64_t>(h) << 32;

  // keep the keys >= t, LOAD2 loads in flight a thread
  const uint64_t* in = partial + static_cast<size_t>(b) * n_tiles * m;
  const int n = n_tiles * m;
  if (tid == 0) cnt = 0;
  __syncthreads();
  const unsigned below = (1u << (tid & 31)) - 1u;
  for (int base = 0; base < n; base += THREADS2 * LOAD2) {
    uint64_t k[LOAD2];
#pragma unroll
    for (int u = 0; u < LOAD2; ++u) {
      const int i = base + u * THREADS2 + tid;
      k[u] = i < n ? in[i] : 0ull;
    }
#pragma unroll
    for (int u = 0; u < LOAD2; ++u) {
      const bool pass = k[u] != 0ull && k[u] >= t;
      const unsigned ballot = __ballot_sync(0xffffffffu, pass);
      const int leader = ballot ? __ffs(ballot) - 1 : 0;
      int slot = 0;
      if ((tid & 31) == leader && ballot) slot = atomicAdd(&cnt, __popc(ballot));
      slot = __shfl_sync(0xffffffffu, slot, leader) + __popc(ballot & below);
      if (pass && slot < BUF2) buf[slot] = k[u];
    }
  }
  __syncthreads();
  int total = cnt;
  if (total > BUF2) {
    // more keys pass than the buffer holds: merge them in rounds, sorting
    // the buffer and keeping its top m whenever a round could overflow it
    __syncthreads();
    if (tid == 0) cnt = 0;
    __syncthreads();
    for (int base = 0; base < n; base += THREADS2) {
      const int cur = cnt;
      __syncthreads();  // every thread has read cnt before any adds to it
      if (cur + THREADS2 > BUF2) {
        for (int i = cur + tid; i < BUF2; i += THREADS2) buf[i] = 0ull;
        __syncthreads();
        bitonic_desc(buf, BUF2, BUF2);
        if (tid == 0) cnt = m;
        __syncthreads();
      }
      const int i = base + tid;
      const uint64_t key = i < n ? in[i] : 0ull;
      if (key != 0ull && key >= t) buf[atomicAdd(&cnt, 1)] = key;
      __syncthreads();
    }
    total = cnt;
  }
  int s = 2;
  while (s < total) s <<= 1;
  for (int i = total + tid; i < s; i += THREADS2) buf[i] = 0ull;  // key 0 sorts last
  __syncthreads();
  bitonic_desc(buf, s, s);
  for (int i = tid; i < m; i += THREADS2) {
    out_vals[static_cast<size_t>(b) * m + i] = key_val(buf[i]);
    out_idx[static_cast<size_t>(b) * m + i] = key_row(buf[i]);
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

// The threshold merge serves m up to pass 1's partial width when there
// are at least m tiles; the tree serves the rest.
bool threshold_merge(int C, int m) { return m <= TILE_ROWS && n_tiles_of(C) >= m; }

template <int QT>
struct QTile {};

template <typename T, int QT>
cudaError_t launch_tiles(QTile<QT>, cudaStream_t s, const float* q, const void* vec,
                         const float* scales, const float* pen, long long pen_stride,
                         const float* min_sim, int B, int C, int D, int P, uint64_t* partial,
                         uint64_t* tmax) {
  auto kernel = topk_tiles<T, QT>;
  constexpr int smem = Tile<T, QT>::SMEM;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  // the largest copy that keeps every row's chunks aligned
  const uintptr_t a = reinterpret_cast<uintptr_t>(vec);
  const long long row_bytes = static_cast<long long>(D) * sizeof(T);
  const int cp_bytes = row_bytes % 16 == 0 && a % 16 == 0 ? 16
                       : row_bytes % 8 == 0 && a % 8 == 0 ? 8 : 4;
  // one block a tile (scripts/topk_check.py --sweep times grids of fewer
  // blocks, each walking its tiles)
  const int grid_x = n_tiles_of(C);
  dim3 grid(grid_x, (B + QT - 1) / QT);
  kernel<<<grid, Tile<T, QT>::THREADS, smem, s>>>(q, static_cast<const T*>(vec), scales, pen,
                                                  pen_stride, min_sim, B, C, D, P, cp_bytes,
                                                  partial, tmax);
  return cudaGetLastError();
}

// Pass 1 with the smallest query tile that holds B (up to 32 a block):
// a single query computes no padded one.
template <typename T>
cudaError_t launch_tiles_for(cudaStream_t s, const float* q, const void* vec,
                             const float* scales, const float* pen, long long pen_stride,
                             const float* min_sim, int B, int C, int D, int P,
                             uint64_t* partial, uint64_t* tmax) {
  auto go = [&](auto tile) {
    return launch_tiles<T>(tile, s, q, vec, scales, pen, pen_stride, min_sim, B, C, D, P,
                           partial, tmax);
  };
  if (B > 16) return go(QTile<32>{});
  if (B > 8) return go(QTile<16>{});
  if (B > 4) return go(QTile<8>{});
  if (B > 1) return go(QTile<4>{});
  return go(QTile<1>{});
}

}  // namespace

// Scratch the caller allocates, in 64-bit keys: pass 1's partial keys and
// tile maxima, and, on the tree path, every merge level's output.
extern "C" long long mrag_topk_scratch_elems(int B, int C, int m) {
  long long n_in = static_cast<long long>(n_tiles_of(C)) * partial_width(m);
  long long total = B * n_in + static_cast<long long>(B) * n_tiles_of(C);
  while (!threshold_merge(C, m) && n_in > BUF2) {
    long long groups = (n_in + BUF2 - 1) / BUF2;
    total += B * groups * m;
    n_in = groups * m;
  }
  return total;
}

// q [B, D] f32 (16-byte aligned); vec [C, D] row-major, f32 (vec_kind 0),
// bf16 (1) or int8 (2), D a multiple of 4; scales [C] f32 or null (no
// scaling); pen f32 with row stride pen_stride (C for [B, C], 0 for [C]);
// min_sim [B] f32; scratch: mrag_topk_scratch_elems(B, C, m) u64;
// out_vals [B, m] f32; out_idx [B, m] i32. Requires 1 <= m <= min(C, 1024).
extern "C" int mrag_masked_topk(const float* q, const void* vec, int vec_kind,
                                const float* scales, const float* pen,
                                long long pen_stride,
                                const float* min_sim, int B, int C, int D, int m,
                                void* scratch, float* out_vals, int* out_idx,
                                void* stream) {
  if (B < 1 || m < 1 || m > C || m > 1024 || D < 4 || D % 4 != 0 || vec_kind < 0 ||
      vec_kind > 2 || reinterpret_cast<uintptr_t>(q) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = n_tiles_of(C);
  const int P = partial_width(m);
  uint64_t* src = static_cast<uint64_t*>(scratch);
  uint64_t* tmax = src + static_cast<size_t>(B) * n_tiles * P;
  cudaError_t err;
  if (vec_kind == 1)
    err = launch_tiles_for<__nv_bfloat16>(s, q, vec, scales, pen, pen_stride, min_sim, B, C, D,
                                          P, src, tmax);
  else if (vec_kind == 2)
    err = launch_tiles_for<int8_t>(s, q, vec, scales, pen, pen_stride, min_sim, B, C, D, P,
                                   src, tmax);
  else
    err = launch_tiles_for<float>(s, q, vec, scales, pen, pen_stride, min_sim, B, C, D, P, src,
                                  tmax);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (threshold_merge(C, m)) {
    topk_select<<<B, THREADS2, 0, s>>>(src, tmax, n_tiles, m, out_vals, out_idx);
    return static_cast<int>(cudaGetLastError());
  }
  int n_in = n_tiles * P;
  uint64_t* next = tmax + static_cast<size_t>(B) * n_tiles;
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
