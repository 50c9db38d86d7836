// Fused AVSS shortlist: exact LUT distance + exact top-k, without a
// (B, N) distance matrix in device memory.
//
// Replaces: src/repro/kernels/shortlist.py::_shortlist_kernel (with its
// helpers _dist_block, _bitonic_sort, _merge_topk), called by
// lut_shortlist_pallas: phase 1 of two_phase and all of `ideal` once the
// store reaches fused_min_rows (or on the `fused` backend).
//
// Semantics: dist[b, n] = sum_d proj[n, 4 d + q[b, d]] (the one-hot query
// product written as a gather), plus 2**22 on rows whose `valid` byte is 0;
// the k smallest in (distance, row) lexicographic order, ties included --
// exactly jax.lax.top_k(-dist) order. All distances are integers below
// 2**24, so each (distance, row) pair is one unique 64-bit key
// (uint64(dist) << 32 | row) and any exact selection gives the same
// arrays.
//
// What bounds it on an H100. The benchmark's two_phase cells (B = 1,024
// queries, k = 64, 8-bit packed fields: 4,194,304 Omniglot rows of 48
// words, 262,144 CUB rows of 480) do 2 B N 4d one-hot multiply-adds
// (1.65 / 1.03 T: 0.833 / 0.521 ms at the int8 tensor-core peak of 1,979
// TOP/s) and read the operand once (805 / 503 MB: 0.24 / 0.15 ms at 3.35
// TB/s): operations bound. On top of that comes the selection: B N
// distances tested against a running threshold, and the few that pass
// kept and sorted.
//
// The one-table entry, for 8-bit packed fields (every MTMC and CUB store):
//   masks: one thread a (query, word) writes the query's one-hot mask in
//     the operand's own byte order to a (B, mw) scratch, once a call: byte
//     f of word w is 1 where the query selects column f row_words + w (mw:
//     row_words rounded up to 8 words, the rest 0); on the wgmma path it
//     also resets each query's shared bound.
//   select, one of two (kernels/shortlist.py::wgmma_route, from k and the
//     row's width alone):
//   - shortlist_wgmma, for k <= 64 and rows of whole 16-byte segments
//     (the cells'): persistent blocks, one an SM, walk (query tile of 128,
//     slice of rows) units cut so that the last round leaves under 5% of
//     the SMs idle. A block is two consumer warpgroups of 64 queries (the
//     wgmma's M) and a producer warp whose lane 0 keeps a ring of 4 TMA
//     slots full (bytes counted on each slot's mbarrier; a slot refilled
//     once every consumer warp has arrived on its other one; no
//     block-wide barrier after set-up). Rows of up to 3 columns of 64
//     bytes come 128 a slot, with their valid bytes, and the queries'
//     masks once a unit; wider rows one 64-byte K-column of the 128 masks
//     and of 256 rows a slot. The products are wgmma m64n128k32 u8 x u8
//     -> s32 from shared memory in the TMA's 64-byte swizzle, exact. No
//     wgmma is in flight across a branch, so ptxas serialises none; the
//     two warpgroups run apart, one selecting while the other's products
//     run. The selection reads the accumulators where the wgmma leaves
//     them (a lane: 2 queries x 32 rows): one compare a distance against
//     the query's threshold marks the rare 8-row blocks to look at, and a
//     shared body (a switch takes the block's accumulators by constant
//     index) turns what passes into 32-bit compact keys -- the penalty
//     bit, the distance (at most 255 d, below the penalty 2**22) and the
//     row within the slice, in the order of the (distance, row) keys --
//     and writes a key below the list's k-th into the lane's own
//     candidate slots (32 a lane of the query's quad, counted in a
//     register: no atomics). Each list keeps 64 sorted keys and its k-th
//     key in the quad's registers; a list whose slots could overflow in
//     the next 64 rows is folded (the warp sorts the 128 candidates and
//     merges them into the sorted keys). Units of one query share a bound
//     through global memory: every fold publishes its list's k-th
//     distance (atomicMin), and a tile's threshold is also held below the
//     least published, read under the tile's products; the first round
//     of units so spares the second most of its candidates. Each unit
//     writes one sorted list of k (distance, row) keys per query for its
//     slice to a (B, slices, k) scratch.
//   - shortlist_select, for larger k (lists of up to 2,048 keys) and
//     other row widths: blocks of up to 4 warps of 16 queries (the
//     mma.sync's M) walk the same units, rows staged 64 at a time through
//     a cp.async ring of `stages` (a row of up to 64 words whole, with the
//     block's masks beside the ring; a wider row in K-chunks carrying the
//     masks' same words), products on mma.sync m16n8k32 u8 x u8 -> s32
//     (A the warp's mask rows and B the staged rows, by ldmatrix), the
//     same compact keys selected from the accumulator fragments: a lane
//     counts its keys below its query's k-th, the quad sums the counts, a
//     list whose candidates would overflow is folded first, and each lane
//     writes its candidates at its quad's prefix.
//   merge: the merge rounds both entries share (shortlist_merge, below),
//     each query with all its slices' lists.
//   Shared memory (kernels/shortlist.py::shortlist_plan and
//   analysis/vmem.py model it): a wgmma block holds its ring (4 slots of
//   25 KB), whole rows' masks (24 KB), 128 lists of 192 keys (96 KB) and
//   the mbarriers: 226,384 bytes for whole rows, 201,808 in K-columns; an
//   mma.sync block 16 warps P 4 bytes of lists and its ring.
//
// Other operand kinds (4-, 16- and 32-bit packed fields, bf16 and f32)
// go to the block-table entry below as one block of N rows that every
// query visits (base 0, ids all 0): the same keys. The wrapper routes
// them, and 8-bit fields too where 255 d reaches the penalty.
//
// The block-table entry (shortlist_blocks_launch) computes the same thing
// for every query over its own list of row blocks: the routed search's
// top-p shards, the pager's device slots, a tenant stack's block. JAX gets
// it from jax.vmap of lut_shortlist_pallas over each query's concatenated
// blocks (src/repro/engine/engine.py:318, _routed_block_search). Inputs: a
// table of M blocks of `rows` rows, key bases base (M,), and visit lists
// ids (B, p); the key of row r of block m is (dist << 32) | (base[m] + r),
// so with ids ascending in base the key order is JAX's (distance, position
// in the concatenation) order. Its kernels:
//   group: one block of 1,024 threads counts the (query, visit) pairs of
//     each table block, scans the counts and lays out work units --
//     (table block, first pair, up to BQ = 16 pairs, row range) -- and the
//     pairs grouped by table block (the order inside a group is that of the
//     atomics; each pair still writes its own lists, so the result does not
//     depend on it). Every tile of a block that c pairs visit is cut into
//     ranges_of(c) row ranges, about `work` cost a unit, a unit costing
//     its rows x (row_cost + its pairs): staging a row and its products
//     outweighs a pair's selection at every width measured, so a tile of
//     few pairs is cut about as finely as a full one. The grid has a fixed
//     number of unit slots, at least the units any mix needs (see
//     shortlist_blocks_launch), and slots past the units in use return at
//     once, so one launch profile serves every mix. An id outside [0, M)
//     goes to an empty virtual block: its lists hold only the all-ones key.
//   select: one block of up to 4 warps per unit. It issues its first
//     stages, then numbers its pairs' lists (the ranges of the blocks each
//     query visits before this one) and builds the one-hot masks of its
//     pairs once for the whole row (16 x 1,920 B at d = 480). Rows are
//     staged 64 at a time in K-chunks of at most CHUNK_MAX words through a
//     2-3 deep cp.async ring, so shared memory does not grow with the row
//     width (2 blocks an SM at d = 480, 4 at d = 48). For 8-bit packed
//     fields the distances are products on the tensor cores: byte 4 w + f
//     of a packed row holds column f row_words + w and the mask has the
//     same byte order, so mma.sync m16n8k32 u8 x u8 -> s32 with the masks
//     as A (16 pairs, ldmatrix) and the staged rows as B (8 rows an
//     n-tile) sums each row's fields exactly (int32, every sum < 2**24);
//     the warps split the 64 rows of a tile, the next k-step's fragments
//     load under this one's products, and the 16 x 64 distances go through
//     shared memory to the selection. Other operand kinds take CUDA-core
//     dot products over the K-chunks: lane l takes rows l and l + 32,
//     one 16-byte load of each and one broadcast 16-byte load of a
//     pair's mask words per 4 words (__dp4a for 4- and 8-bit fields,
//     __dp2a_lo for 16-bit, an integer multiply-add for 32-bit, an
//     exact f32 FMA for bf16 / f32 words).
//     Selection: each warp keeps 4 pairs' lists (lanes over rows) as
//     above, but a list's sorted half is folded with its candidate half by
//     sorting the candidates and one bitonic merge (half the shuffles of
//     sorting both). A query with at least 2 MSEL lists also shares a bound
//     through global memory: each list publishes its r-th key (r = ceil(k
//     / MSEL)) into slot (list % 32) of its query (atomicMin), and the
//     MSEL-th smallest of the 32 slots lies at or above MSEL distinct
//     lists' r-th keys, so at least k of the query's keys lie at or below
//     it and no key above it can be in the result; a list keeps a key
//     below its k-th key and at or below that bound. The slots and the bound
//     are read at a tile's start and used at its folds and selection, so
//     no warp waits on them. A skipped key is never written; unfilled slots
//     keep the all-ones key, which the merge drops (k <= p * rows). Each
//     unit writes one sorted list per pair to the (B, p * split, k)
//     scratch, and each query's count of lists (lists_n).
//   merge: rounds of one block per (query, group of MERGE_KEYS / pow2(k)
//     lists), over each query's lists_n lists only: a block past them
//     returns, a block of one list copies it, the others merge their
//     sorted lists pairwise in a tree (log2 pow2(k) + 1 stages a level)
//     rather than sort all their keys.
// The work is B p rows d field sums, and the bytes read the union of the
// visited blocks (each staged once per unit that visits it).
//
// Work left for the selection: with rows in random order about
// k (1 + ln(R / k)) of a list's R rows beat its running threshold (~240
// of a one-table slice's 1,024 per query on the main path), a few more
// since the threshold tightens only at each fold. The worst case is rows
// in descending distance: every row is a candidate, and every tile
// folds every list. All rows tied is the best case: after the first k
// rows no key is below the threshold. Every order gives the same exact
// result.

#include <cuda.h>  // CUtensorMap; the encoder comes through the runtime
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr int RPL = 2;               // staged rows per lane
constexpr int ROWS = 32 * RPL;       // rows per staged tile
constexpr int MERGE_THREADS = 256;
constexpr int MERGE_KEYS = 2048;     // keys per merge block
constexpr int MAX_K = MERGE_KEYS / 2;
constexpr int QW = 4;                // pairs per warp, block-table select
constexpr int TQ = 16;               // queries per warp, one-table select
constexpr int MAX_WARPS = 4;         // warps per select block
constexpr int SMEM_MAX = 232448;     // dynamic shared memory of one block
constexpr unsigned long long PAD_KEY = ~0ull;
constexpr float MASK_PENALTY = 4194304.0f;  // 2**22
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int GROUP_THREADS = 1024;  // threads of the block-table grouping
// the block-table entry: pairs a unit at most (the MMA's M), words a pair
// of its distance tile, bound slots a query, lists whose r-th keys make a
// query's bound, words of a staged K-chunk at most
constexpr int BQ = MAX_WARPS * QW;
constexpr int DSTRIDE = 72;
constexpr int SLOTS = 32;
constexpr int MSEL = 8;
constexpr int CHUNK_MAX = 64;
// static shared memory of a block-table select block: per pair slot its
// query, list, bound slot and whether its query keeps a shared bound
constexpr int BLOCKS_STATIC_SMEM = BQ * (4 + 8 + 4 + 4);

enum Kind { kPacked = 0, kBf16 = 1, kF32 = 2 };

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Ascending bitonic sort of n (a power of two) keys in shared memory by
// `threads` threads; `sync` is the barrier that orders the stages.
template <typename K, typename Sync>
__device__ __forceinline__ void bitonic_sort(K* keys, int n, int tid,
                                             int threads, Sync sync) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < n / 2; i += threads) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const bool asc = (lo & size) == 0;
        const K a = keys[lo];
        const K b = keys[hi];
        if ((a > b) == asc) {
          keys[lo] = b;
          keys[hi] = a;
        }
      }
      sync();
    }
  }
}

// Ascending bitonic sort of 32 * L keys held by one warp in registers,
// key i * 32 + lane in x[i] of `lane`: partners in other lanes by
// __shfl_xor_sync, partners in the same lane by register swaps.
template <int L, typename K>
__device__ __forceinline__ void warp_sort(K (&x)[L], int lane) {
#pragma unroll
  for (int size = 2; size <= 32 * L; size <<= 1) {
#pragma unroll
    for (int j = size >> 1; j > 0; j >>= 1) {
      if (j >= 32) {
#pragma unroll
        for (int i = 0; i < L; ++i) {
          const int i2 = i ^ (j >> 5);
          if (i2 > i) {
            const bool asc = ((i * 32 + lane) & size) == 0;
            const K a = x[i];
            const K b = x[i2];
            if ((a > b) == asc) {
              x[i] = b;
              x[i2] = a;
            }
          }
        }
      } else {
        const bool lower = (lane & j) == 0;
#pragma unroll
        for (int i = 0; i < L; ++i) {
          const K y = __shfl_xor_sync(FULL, x[i], j);
          const bool asc = ((i * 32 + lane) & size) == 0;
          x[i] = (lower == asc) ? min(x[i], y) : max(x[i], y);
        }
      }
    }
  }
}

// The one-hot query as a mask in the operand's own layout: for each staged
// word of the row, a word whose field f is 1 where the query selects that
// column (for bf16 / f32 words, 1.0 in that half / word). A row's distance
// to the query is then the dot product of its words with the mask words.
template <int KIND, int BITS>
__device__ __forceinline__ uint32_t mask_flag(int field) {
  if (KIND == kBf16) return 0x3F80u << (16 * field);
  if (KIND == kF32) return 0x3F800000u;
  // packed: 4-bit fields as nibbles (two __dp4a on the even / odd nibbles),
  // 8- and 16-bit fields as bytes (__dp4a, __dp2a_lo), 32-bit as one int
  return BITS == 4 ? 1u << (4 * field) : (BITS == 32 ? 1u : 1u << (8 * field));
}

// acc += the fields of `v` selected by mask word `m`
// Packed kinds accumulate in uint32 (two's complement, read as int32),
// bf16 / f32 in float: exact either way below 2**24.
template <int KIND>
using Acc = typename std::conditional<KIND == kPacked, uint32_t, float>::type;

template <int KIND, int BITS>
__device__ __forceinline__ void dot_word(Acc<KIND>& acc, uint32_t v,
                                         uint32_t m) {
  if constexpr (KIND == kBf16) {
    acc = fmaf(__uint_as_float(v << 16), __uint_as_float(m << 16), acc);
    acc = fmaf(__uint_as_float(v & 0xFFFF0000u),
               __uint_as_float(m & 0xFFFF0000u), acc);
  } else if constexpr (KIND == kF32) {
    acc = fmaf(__uint_as_float(v), __uint_as_float(m), acc);
  } else if constexpr (BITS == 8) {
    acc = __dp4a(v, m, acc);
  } else if constexpr (BITS == 16) {
    acc = __dp2a_lo(v, m, acc);
  } else if constexpr (BITS == 4) {
    acc = __dp4a(v & 0x0F0F0F0Fu, m & 0x0F0F0F0Fu, acc);
    acc = __dp4a((v >> 4) & 0x0F0F0F0Fu, (m >> 4) & 0x0F0F0F0Fu, acc);
  } else {
    acc += v * m;
  }
}

template <int KIND, int BITS>
__device__ __forceinline__ void dot_chunk(Acc<KIND>& acc, const uint4& v,
                                          const uint4& m) {
  dot_word<KIND, BITS>(acc, v.x, m.x);
  dot_word<KIND, BITS>(acc, v.y, m.y);
  dot_word<KIND, BITS>(acc, v.z, m.z);
  dot_word<KIND, BITS>(acc, v.w, m.w);
}

// ---------------------------------------------------------------------------
// The block-table entry: grouping, select and merge passes of its own.
// ---------------------------------------------------------------------------

// Words a pair's mask or a staged row takes: the width rounded up to the
// MMA's 8 words (32 bytes), plus 4, so that 8 rows' 16-byte segments at
// this stride lie in 8 different bank groups (ldmatrix, and a lane's
// 16-byte load of its row).
__host__ __device__ __forceinline__ int blocks_stride(int words) {
  return 8 * ((words + 7) / 8) + 4;
}

// Rows of each range of a tile cut in s: whole 64-row tiles.
__host__ __device__ __forceinline__ int unit_rows(int rows, int s) {
  const int per = (rows + s - 1) / s;
  return ROWS * ((per + ROWS - 1) / ROWS);
}

// A unit's cost in pair-rows: its rows times (alpha + its pairs), alpha =
// ceil(row_words / 4) the cost of staging a row and its products in
// pair-rows of selection (the rows dominate at every width measured).
__host__ __device__ __forceinline__ int row_cost(int row_words) {
  return (row_words + 3) / 4;
}

// Row ranges of each tile of a table block that c pairs visit: about
// `work` cost a unit, at most `split` ranges (kernels/shortlist.py::
// BlocksPlan.ranges is its twin). Every tile of a block takes the ranges
// of its first, so a pair's lists are known from its block's count.
__host__ __device__ __forceinline__ int ranges_of(int c, int qb, int rows,
                                                  int row_words, int work,
                                                  int split) {
  const long long cc = c < qb ? c : qb;
  long long s = ((long long)rows * (row_cost(row_words) + cc) + work - 1) /
                work;
  s = s < 1 ? 1 : (s > split ? split : s);
  const int ur = unit_rows(rows, static_cast<int>(s));
  return (rows + ur - 1) / ur;
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
}

// acc (16 x 8, s32) += a (16 x 32 u8, row-major) b (32 x 8 u8, col-major)
__device__ __forceinline__ void mma_u8(int (&acc)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A 64-bit word that other blocks update with atomics, read from L2.
__device__ __forceinline__ unsigned long long ld_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

// Ascending bitonic merge of a bitonic sequence of 32 * L keys held as in
// warp_sort.
template <int L, typename K>
__device__ __forceinline__ void warp_clean(K (&x)[L], int lane) {
#pragma unroll
  for (int j = 16 * L; j > 0; j >>= 1) {
    if (j >= 32) {
#pragma unroll
      for (int i = 0; i < L; ++i) {
        const int i2 = i ^ (j >> 5);
        if (i2 > i) {
          const K a = x[i];
          const K b = x[i2];
          x[i] = min(a, b);
          x[i2] = max(a, b);
        }
      }
    } else {
      const bool lower = (lane & j) == 0;
#pragma unroll
      for (int i = 0; i < L; ++i) {
        const K y = __shfl_xor_sync(FULL, x[i], j);
        x[i] = lower ? min(x[i], y) : max(x[i], y);
      }
    }
  }
}

// keys[0, 32 L) sorted, keys[32 L, 64 L) candidates: sort the candidates,
// take the elementwise minimum with them reversed (a bitonic sequence that
// holds the 32 L smallest of both) and merge it.
template <int L, typename K>
__device__ __forceinline__ void fold_regs(K* keys, int lane) {
  K x[L], y[L];
#pragma unroll
  for (int i = 0; i < L; ++i) {
    x[i] = keys[i * 32 + lane];
    y[i] = keys[(L + i) * 32 + lane];
  }
  warp_sort<L>(y, lane);
#pragma unroll
  for (int i = 0; i < L; ++i) {
    x[i] = min(x[i], __shfl_sync(FULL, y[L - 1 - i], 31 - lane));
  }
  warp_clean<L>(x, lane);
#pragma unroll
  for (int i = 0; i < L; ++i) keys[i * 32 + lane] = x[i];
  __syncwarp();
}

// One warp folds its candidates keys[H, H + count) into its sorted half
// keys[0, H): the H smallest of both, sorted, in keys[0, H). K is the key
// type: 64-bit (distance, row) keys, or the one-table select's 32-bit
// compact ones; the all-ones key pads.
template <typename K>
__device__ __noinline__ void fold_half(K* keys, int H, int count, int lane) {
  for (int j = H + count + lane; j < 2 * H; j += 32) keys[j] = ~K(0);
  __syncwarp();
  if (H == 64) {
    fold_regs<2>(keys, lane);
  } else if (H == 128) {
    fold_regs<4>(keys, lane);
  } else {
    bitonic_sort(keys, 2 * H, lane, 32, [] { __syncwarp(); });
  }
}

// ---------------------------------------------------------------------------
// The one-table entry: 8-bit packed fields, products on the tensor cores.
// ---------------------------------------------------------------------------

// The (B, mw) one-hot masks, one thread a word: byte f of word w of query
// b is 1 where b selects column f row_words + w of the packed operand;
// words at or past row_words are 0. With `bounds` (B,), each query's
// shared bound is reset to no bound.
__global__ void shortlist_masks(const int* __restrict__ qw, int B, int d,
                                int row_words, int mw,
                                uint32_t* __restrict__ masks,
                                int* __restrict__ bounds) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long long)B * mw) return;
  const int b = static_cast<int>(e / mw);
  const int w = static_cast<int>(e - (long long)b * mw);
  if (bounds != nullptr && w == 0) bounds[b] = 0x7FFFFFFF;
  uint32_t m = 0u;
  if (w < row_words) {
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const long long col = (long long)f * row_words + w;
      if (col < 4LL * d) {
        const int qv = min(max(qw[(size_t)b * d + (col >> 2)], 0), 3);
        if (qv == static_cast<int>(col & 3)) m |= 1u << (8 * f);
      }
    }
  }
  masks[e] = m;
}

// Dynamic shared memory of a one-table select block: P 32-bit keys a
// query; a ring of `stages` slots of 64 staged rows (with the block's
// masks of the same words for K-chunked rows); whole rows' masks once
// beside the ring.
__host__ __device__ __forceinline__ int select_smem(int warps, int P,
                                                    int row_words, int chunk,
                                                    int stages) {
  const int qb = warps * TQ;
  const bool whole = chunk >= row_words;
  return qb * P * 4 + 4 * blocks_stride(chunk) *
                          (stages * (ROWS + (whole ? 0 : qb)) +
                           (whole ? qb : 0));
}

// Bits of a row's index within a slice of slice_rows rows.
__host__ __device__ __forceinline__ int row_bits(int slice_rows) {
  int b = 0;
  while ((1 << b) < slice_rows) ++b;
  return b;
}

// One table of N rows for every query, 8-bit packed fields: the select
// for k above the wgmma select's (or rows of a width no multiple of 4
// words). The grid's blocks walk the units (query tile u % q_tiles,
// slice u / q_tiles), so the query tiles of a slice run together and read
// its rows from L2 once the first has loaded them.
__global__ void __launch_bounds__(MAX_WARPS * 32, 3)
shortlist_select(const uint32_t* __restrict__ masks, int mw,
                 const uint32_t* __restrict__ op, int row_words,
                 const uint8_t* __restrict__ valid, int B, int N, int k,
                 int P, int chunk, int stages, int slice_rows, int n_slices,
                 unsigned long long* __restrict__ out) {
  extern __shared__ unsigned long long smem[];
  constexpr uint32_t PAD = 0xFFFFFFFFu;  // the compact all-ones key
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // the lane's query slots g, g + 8 of its warp
  const int t = lane & 3;   // and rows 2 t, 2 t + 1 of each n-tile
  const int qb = warps * TQ;
  const int H = P / 2;      // sorted keys a list; as many candidates
  const int rb = row_bits(slice_rows);
  const bool whole = chunk >= row_words;
  const int stride = blocks_stride(chunk);
  const int stage_words = stride * (ROWS + (whole ? 0 : qb));
  uint32_t* keys = reinterpret_cast<uint32_t*>(smem) + warp * TQ * P;
  uint32_t* ring = reinterpret_cast<uint32_t*>(smem) + qb * P;
  uint32_t* mres = ring + stages * stage_words;  // whole rows' masks

  const int q_tiles = (B + qb - 1) / qb;
  const int units = q_tiles * n_slices;
  for (int unit = blockIdx.x; unit < units; unit += gridDim.x) {
    if (unit != blockIdx.x) __syncthreads();  // the last unit's reads done
    const int b0 = (unit % q_tiles) * qb;
    const int slice = unit / q_tiles;
    const int q_here = min(qb, B - b0);
    const int n_begin = slice * slice_rows;
    const int n_end = min(N, n_begin + slice_rows);
    const int n_kc = whole ? 1 : (row_words + chunk - 1) / chunk;
    const int n_st = (n_end - n_begin + ROWS - 1) / ROWS * n_kc;
    const bool vec = row_words % 4 == 0 &&
                     (reinterpret_cast<uintptr_t>(op) & 15) == 0;

    // stage s = (tile s / n_kc, K-chunk s % n_kc) into ring slot s % stages;
    // the masks' words are whole k-steps (0 past the row)
    auto issue = [&](int s) {
      if (s < n_st) {
        const int r0 = n_begin + (s / n_kc) * ROWS;
        const int w0 = (s % n_kc) * chunk;
        const int ww = min(chunk, row_words - w0);
        const int r_here = min(ROWS, n_end - r0);
        uint32_t* buf = ring + (s % stages) * stage_words;
        if (vec) {
          const int segs = ww / 4;
          for (int e = threadIdx.x; e < r_here * segs; e += blockDim.x) {
            const int r = e / segs;
            const int j = e - r * segs;
            cp_async16(buf + r * stride + 4 * j,
                       op + (size_t)(r0 + r) * row_words + w0 + 4 * j);
          }
        } else {
          for (int e = threadIdx.x; e < r_here * ww; e += blockDim.x) {
            const int r = e / ww;
            const int j = e - r * ww;
            cp_async4(buf + r * stride + j,
                      op + (size_t)(r0 + r) * row_words + w0 + j);
          }
        }
        if (!whole) {
          const int segs = (ww + 7) / 8 * 2;
          uint32_t* mb = buf + ROWS * stride;
          for (int e = threadIdx.x; e < q_here * segs; e += blockDim.x) {
            const int qi = e / segs;
            const int j = e - qi * segs;
            cp_async16(mb + qi * stride + 4 * j,
                       masks + (size_t)(b0 + qi) * mw + w0 + 4 * j);
          }
        }
      }
      cp_async_commit();  // an empty group past the last stage
    };
    if (whole) {  // the block's masks, once, in the first stage's group
      const int segs = mw / 4;
      for (int e = threadIdx.x; e < q_here * segs; e += blockDim.x) {
        const int qi = e / segs;
        const int j = e - qi * segs;
        cp_async16(mres + qi * stride + 4 * j,
                   masks + (size_t)(b0 + qi) * mw + 4 * j);
      }
    }
    for (int s = 0; s < stages - 1; ++s) issue(s);
    for (int e = lane; e < TQ * P; e += 32) keys[e] = PAD;

    const bool active = warp * TQ < q_here;  // slots fill in order
    uint32_t own[2];  // the k-th key of slot g + 8 i's list
    int count[2];     // its candidates
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      own[i] = warp * TQ + g + 8 * i < q_here ? PAD : 0u;  // else none
      count[i] = 0;
    }
    int acc[8][4];      // slots g, g + 8 x rows 2 t, 2 t + 1 of n-tile j
    unsigned pen = 0u;  // bit 2 j + h: row 8 j + 2 t + h of the tile masked
    // A: lanes 0-15 mask rows 0-15 words 0-3, lanes 16-31 words 4-7; B: two
    // n-tiles' rows, words 0-3 and 4-7
    const int a_off =
        (warp * TQ + (lane & 7) + 8 * ((lane >> 3) & 1)) * stride +
        4 * (lane >> 4);
    const int b_off = ((lane >> 4) * 8 + (lane & 7)) * stride +
                      4 * ((lane >> 3) & 1);

    for (int s = 0; s < n_st; ++s) {
      if (stages == 2) {
        cp_async_wait<0>();
      } else if (stages == 3) {
        cp_async_wait<1>();
      } else {
        cp_async_wait<2>();
      }
      __syncthreads();  // stage s (and the masks) for every warp; the slot
      issue(s + stages - 1);  // refilled here was last read in stage s - 1
      if (!active) continue;
      const int tile = s / n_kc;
      const int kc = s - tile * n_kc;
      const int r0 = n_begin + tile * ROWS;
      const uint32_t* buf = ring + (s % stages) * stage_words;
      if (kc == 0) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[j][c] = 0;
        pen = 0u;
        if (valid != nullptr) {
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int n = r0 + 8 * j + 2 * t + h;
              if (n < n_end && valid[n] == 0) pen |= 1u << (2 * j + h);
            }
        }
      }
      const uint32_t* a_ptr = (whole ? mres : buf + ROWS * stride) + a_off;
      const uint32_t* b_ptr = buf + b_off;
      const int ksteps = (min(chunk, row_words - kc * chunk) + 7) / 8;
      uint32_t a[2][4], bf[2][4][4];
      auto load = [&](int ks, int slot) {
        ldsm_x4(a[slot], a_ptr + 8 * ks);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ldsm_x4(bf[slot][i], b_ptr + 16 * i * stride + 8 * ks);
        }
      };
      load(0, 0);
      for (int ks = 0; ks < ksteps; ks += 2) {
        if (ks + 1 < ksteps) load(ks + 1, 1);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          mma_u8(acc[2 * i], a[0], bf[0][i][0], bf[0][i][1]);
          mma_u8(acc[2 * i + 1], a[0], bf[0][i][2], bf[0][i][3]);
        }
        if (ks + 1 < ksteps) {
          if (ks + 2 < ksteps) load(ks + 2, 0);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            mma_u8(acc[2 * i], a[1], bf[1][i][0], bf[1][i][1]);
            mma_u8(acc[2 * i + 1], a[1], bf[1][i][2], bf[1][i][3]);
          }
        }
      }
      if (kc != n_kc - 1) continue;

      // the tile's selection, on the accumulators: the compact key of slot
      // g + 8 i and row 8 j + 2 t + h
#define TILE_KEY(j, i, h)                                                   \
    (r0 + 8 * (j) + 2 * t + (h) < n_end                                       \
         ? (((pen >> (2 * (j) + (h))) & 1u) << 31) |                          \
               (static_cast<uint32_t>(acc[j][2 * (i) + (h)]) << rb) |         \
               static_cast<uint32_t>(r0 - n_begin + 8 * (j) + 2 * t + (h))    \
         : PAD)
      int c[2], tot[2];  // the lane's and its quad's keys below own[i]
      auto tally = [&]() {
        c[0] = c[1] = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int i = 0; i < 2; ++i) c[i] += TILE_KEY(j, i, h) < own[i];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          tot[i] = c[i] + __shfl_xor_sync(FULL, c[i], 1);
          tot[i] += __shfl_xor_sync(FULL, tot[i], 2);
        }
      };
      tally();
      unsigned over[2];  // bit 4 g': slot g' + 8 i's candidates would overflow
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        over[i] = __ballot_sync(FULL, t == 0 && count[i] + tot[i] > H);
      }
      if ((over[0] | over[1]) != 0u) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          while (over[i] != 0u) {
            const int src = __ffs(over[i]) - 1;
            over[i] &= over[i] - 1u;
            uint32_t* kq = keys + ((src >> 2) + 8 * i) * P;
            fold_half(kq, H, __shfl_sync(FULL, count[i], src), lane);
            const uint32_t kth = kq[k - 1];
            if (g == (src >> 2)) {
              own[i] = kth;
              count[i] = 0;
            }
          }
        }
        tally();
      }
      if (__any_sync(FULL, (c[0] | c[1]) != 0)) {
        int pos[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {  // the lane's first slot: its quad's
          int x = c[i];                // exclusive prefix
          int y = __shfl_up_sync(FULL, x, 1, 4);
          if (t >= 1) x += y;
          y = __shfl_up_sync(FULL, x, 2, 4);
          if (t >= 2) x += y;
          pos[i] = H + count[i] + x - c[i];
          count[i] += tot[i];
        }
        uint32_t* kq0 = keys + g * P;
        uint32_t* kq1 = keys + (g + 8) * P;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint32_t k0 = TILE_KEY(j, 0, h);
            const uint32_t k1 = TILE_KEY(j, 1, h);
            if (k0 < own[0]) kq0[pos[0]++] = k0;
            if (k1 < own[1]) kq1[pos[1]++] = k1;
          }
        __syncwarp();
      }
#undef TILE_KEY
    }

    if (active) {
      for (int slot = 0; slot < TQ; ++slot) {
        const int src = 4 * (slot & 7);
        const int cnt = __shfl_sync(FULL, slot < 8 ? count[0] : count[1], src);
        uint32_t* kq = keys + slot * P;
        if (cnt > 0) fold_half(kq, H, cnt, lane);
        const int qi = warp * TQ + slot;
        if (qi < q_here) {
          // each compact key as its (distance, row) key
          unsigned long long* dst =
              out + ((size_t)(b0 + qi) * n_slices + slice) * k;
          for (int j = lane; j < k; j += 32) {
            const uint32_t c = kq[j];
            const uint32_t dist = ((c & 0x7FFFFFFFu) >> rb) + ((c >> 31) << 22);
            const uint32_t row = n_begin + (c & ((1u << rb) - 1u));
            dst[j] = c == PAD ? PAD_KEY
                              : (static_cast<unsigned long long>(dist) << 32) |
                                    row;
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The one-table entry's wgmma select: k <= WG_KMAX, rows of whole 16-byte
// segments (row_words % 4 == 0).
// ---------------------------------------------------------------------------

constexpr int WG_Q = 64;            // queries a consumer warpgroup (wgmma's M)
constexpr int WG_QB = 2 * WG_Q;     // queries a block: two consumer warpgroups
constexpr int WG_WARPS = 8;         // consumer warps; warp 8 is the producer
constexpr int WG_THREADS = 32 * (WG_WARPS + 1);
constexpr int WG_N = 128;           // rows of one wgmma (its N)
constexpr int WG_BOX = 64;          // bytes of a TMA box's row (64B swizzle)
constexpr int WG_H = 64;            // sorted keys a list
constexpr int WG_C = 128;           // candidate slots a list
constexpr int WG_P = WG_H + WG_C;
constexpr int WG_LANE_C = WG_C / 4;  // candidate slots of each quad lane
static_assert(WG_LANE_C == 32, "a quad lane's slots are a warp's width");
constexpr int WG_SEG = 64;          // rows between a list's overflow checks
constexpr int WG_KMAX = WG_H;
constexpr int WG_WHOLE_BOXES = 3;   // columns of a row staged whole

// Shared memory of a wgmma select block, byte offsets from a 1 KB aligned
// base: a ring of `stages` slots (whole rows: the tile's 128 rows in
// WG_WHOLE_BOXES 64-byte columns, zeros past the row; wider rows: one
// 64-byte column of the block's 128 masks and of the tile's 256 rows),
// each with the tile's valid bytes after its data; whole rows' masks once
// beside the ring; the 128 lists; the mbarriers.
struct WgSmem {
  int stage, masks, lists, bars, total;
};

__host__ __device__ __forceinline__ int wg_data(bool whole) {
  return (whole ? WG_WHOLE_BOXES * WG_N : WG_QB + 2 * WG_N) * WG_BOX;
}

__host__ __device__ __forceinline__ WgSmem wg_smem(bool whole, int stages) {
  WgSmem m;
  m.stage =
      (wg_data(whole) + (whole ? WG_N : 2 * WG_N) + 1023) / 1024 * 1024;
  m.masks = stages * m.stage;
  m.lists = m.masks + (whole ? WG_WHOLE_BOXES * WG_QB * WG_BOX : 0);
  m.bars = m.lists + WG_QB * WG_P * 4;
  m.total = m.bars + (2 * stages + 2) * 8 + 1024;  // + the alignment
  return m;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// One arrival of a warp, by its lane 0: predicated inside the asm, so that
// no branch is left around the warpgroup's wgmmas.
__device__ __forceinline__ void mbar_arrive_warp(uint32_t bar, int lane) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.eq.s32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}" ::"r"(bar),
      "r"(lane)
      : "memory");
}

// Until the phase of `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One TMA box of a tensor map into shared memory, its bytes counted on
// `bar`.
__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map,
                                       int x, int y, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_1d(uint32_t dst, const CUtensorMap* map,
                                       int x, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2}], [%3];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(bar)
      : "memory");
}

// A wgmma operand: rows of 64 bytes of K in the 64-byte swizzle the TMA
// boxes write (layout type 2), 8-row groups 512 bytes apart; addr is the
// shared address of row 0's K-step (a box's start, + 32 for its second).
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(512 >> 4) << 32) |
         (static_cast<uint64_t>(2) << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps reads of acc after the wg_wait that completes it.
__device__ __forceinline__ void wg_hold(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// acc (64 x 128, s32) = A (64 x 32 u8) B (128 x 32 u8)^T + (scale_d ?
// acc : 0), both operands K-major in shared memory behind their
// descriptors: one wgmma of a consumer warpgroup, asynchronous until
// wg_wait. Exact: every sum of 8-bit fields here is below 2**24.
__device__ __forceinline__ void wgmma_u8(int (&d)[64], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.u8.u8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// Distances below this can make a key below `own` (a list's k-th key):
// own's distance where own is a valid row's key (a later row of that
// distance has a larger row), every distance where it is a masked row's
// or the all-ones key, none for a slot without a query (own 0).
__device__ __forceinline__ int wg_thr(uint32_t own, int rb) {
  return (own >> 31) ? 0x7FFFFFFF
                     : static_cast<int>((own & 0x7FFFFFFFu) >> rb);
}

// A query's shared bound, held as 1 + the least k-th distance of a valid
// row that any of its units' lists holds: k of its keys lie below it, so
// no row of a distance at or above it is in its result. A list publishes
// its k-th key (a valid row's) whenever it folds.
__device__ __forceinline__ void wg_publish(int* bound, uint32_t kth,
                                           int rb) {
  if ((kth >> 31) == 0u) {
    atomicMin(bound, static_cast<int>(kth >> rb) + 1);
  }
}

// A query's shared bound, read from L2 (other blocks update it); used a
// tile after it is read, so that the read's latency hides.
__device__ __forceinline__ int wg_bound(const int* bound) {
  int v;
  asm volatile("ld.relaxed.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(bound));
  return v;
}

// One warp folds list kq's candidates into its sorted keys kq[0, WG_H):
// the WG_H smallest of both, sorted. Lane t of the list's quad (its first
// lane `quad`) holds candidates kq[WG_H + 32 t, + its count c): each lane
// passes its own count, the unfilled slots are padded, then the
// candidates are sorted and the elementwise minimum of the sorted keys
// with the 64 smallest candidates reversed (a bitonic sequence of the 64
// smallest of both) is merged.
__device__ __forceinline__ void wg_fold(uint32_t* kq, int c, int quad,
                                        int lane) {
#pragma unroll
  for (int sub = 0; sub < 4; ++sub) {
    if (lane >= __shfl_sync(FULL, c, quad + sub)) {
      kq[WG_H + sub * WG_LANE_C + lane] = ~0u;
    }
  }
  __syncwarp();
  uint32_t x[WG_H / 32], y[WG_C / 32];
#pragma unroll
  for (int i = 0; i < WG_H / 32; ++i) x[i] = kq[i * 32 + lane];
#pragma unroll
  for (int i = 0; i < WG_C / 32; ++i) y[i] = kq[WG_H + i * 32 + lane];
  warp_sort<WG_C / 32>(y, lane);
#pragma unroll
  for (int i = 0; i < WG_H / 32; ++i) {
    x[i] = min(x[i], __shfl_sync(FULL, y[WG_H / 32 - 1 - i], 31 - lane));
  }
  warp_clean<WG_H / 32>(x, lane);
#pragma unroll
  for (int i = 0; i < WG_H / 32; ++i) kq[i * 32 + lane] = x[i];
  __syncwarp();
}

// The valid bytes of a 128-row tile as 4 masks a warp holds alike: bit l
// of vm[x] is row 4 l + x's (all ones where no row is masked), so that a
// slot is released as soon as its wgmmas are done.
__device__ __forceinline__ void wg_valid(const uint8_t* vb, unsigned (&vm)[4],
                                         int lane) {
  const uint32_t w =
      vb != nullptr ? reinterpret_cast<const uint32_t*>(vb)[lane] : FULL;
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    vm[x] = __ballot_sync(FULL, ((w >> (8 * x)) & 0xFFu) != 0u);
  }
}

// The selection of a 64 x 128 distance tile by one consumer warp: its 16
// queries (slots g, g + 8 of its quad) x rows r0 + 8 j + 2 t + h (acc[4 j
// + 2 i + h], the wgmma's layout). A lane first marks the 8-row blocks j
// where one of its 4 distances is below its query's threshold (unrolled,
// one compare a distance); then, each 64 rows, the lists where a quad
// lane's candidate slots could overflow are folded, and the lane walks
// its marked blocks of those rows through one shared body (a switch takes
// the block's 4 accumulators by constant index): a key below its query's
// k-th key takes the lane's next candidate slot of that list. So the code
// that rarely runs exists once, not once a block, and no lane waits on
// another's. vm: the tile's valid rows (wg_valid); cnt: the lane's
// candidates in its 2 lists; qb: the 16 queries' shared bounds, where a
// fold publishes its list's k-th key.
__device__ __forceinline__ void wg_select(const int (&acc)[64], int r0,
                                          int n_begin, int n_end, int rb,
                                          int k, const unsigned (&vm)[4],
                                          uint32_t* lists, int* qb,
                                          int (&cnt)[2], uint32_t (&own)[2],
                                          int (&thr)[2], int lane) {
  const int g = lane >> 2;
  const int t = lane & 3;
  unsigned marked = 0u;  // bit j: block j holds a distance below threshold
#pragma unroll
  for (int j = 0; j < WG_N / 8; ++j) {
    marked |= static_cast<unsigned>((acc[4 * j] < thr[0]) |
                                    (acc[4 * j + 1] < thr[0]) |
                                    (acc[4 * j + 2] < thr[1]) |
                                    (acc[4 * j + 3] < thr[1]))
              << j;
  }
#pragma unroll 1
  for (int seg = 0; seg < WG_N / WG_SEG; ++seg) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // a lane adds at most WG_SEG / 4 a list
      unsigned over =
          __ballot_sync(FULL, cnt[i] > WG_LANE_C - WG_SEG / 4);
      while (over != 0u) {
        const int quad = (__ffs(over) - 1) & ~3;
        over &= ~(0xFu << quad);
        uint32_t* kq = lists + ((quad >> 2) + 8 * i) * WG_P;
        wg_fold(kq, cnt[i], quad, lane);
        const uint32_t kth = kq[k - 1];
        if (g == (quad >> 2)) {
          own[i] = kth;
          thr[i] = wg_thr(kth, rb);
          cnt[i] = 0;
        }
        if (lane == quad) wg_publish(qb + (quad >> 2) + 8 * i, kth, rb);
      }
    }
    unsigned mine = (marked >> (seg * (WG_SEG / 8))) &
                    ((1u << (WG_SEG / 8)) - 1u);
    while (mine != 0u) {
      const int j = seg * (WG_SEG / 8) + __ffs(mine) - 1;
      mine &= mine - 1u;
      int w[4];
      switch (j) {
        case 0:
          w[0] = acc[0], w[1] = acc[1];
          w[2] = acc[2], w[3] = acc[3];
          break;
        case 1:
          w[0] = acc[4], w[1] = acc[5];
          w[2] = acc[6], w[3] = acc[7];
          break;
        case 2:
          w[0] = acc[8], w[1] = acc[9];
          w[2] = acc[10], w[3] = acc[11];
          break;
        case 3:
          w[0] = acc[12], w[1] = acc[13];
          w[2] = acc[14], w[3] = acc[15];
          break;
        case 4:
          w[0] = acc[16], w[1] = acc[17];
          w[2] = acc[18], w[3] = acc[19];
          break;
        case 5:
          w[0] = acc[20], w[1] = acc[21];
          w[2] = acc[22], w[3] = acc[23];
          break;
        case 6:
          w[0] = acc[24], w[1] = acc[25];
          w[2] = acc[26], w[3] = acc[27];
          break;
        case 7:
          w[0] = acc[28], w[1] = acc[29];
          w[2] = acc[30], w[3] = acc[31];
          break;
        case 8:
          w[0] = acc[32], w[1] = acc[33];
          w[2] = acc[34], w[3] = acc[35];
          break;
        case 9:
          w[0] = acc[36], w[1] = acc[37];
          w[2] = acc[38], w[3] = acc[39];
          break;
        case 10:
          w[0] = acc[40], w[1] = acc[41];
          w[2] = acc[42], w[3] = acc[43];
          break;
        case 11:
          w[0] = acc[44], w[1] = acc[45];
          w[2] = acc[46], w[3] = acc[47];
          break;
        case 12:
          w[0] = acc[48], w[1] = acc[49];
          w[2] = acc[50], w[3] = acc[51];
          break;
        case 13:
          w[0] = acc[52], w[1] = acc[53];
          w[2] = acc[54], w[3] = acc[55];
          break;
        case 14:
          w[0] = acc[56], w[1] = acc[57];
          w[2] = acc[58], w[3] = acc[59];
          break;
        case 15:
          w[0] = acc[60], w[1] = acc[61];
          w[2] = acc[62], w[3] = acc[63];
          break;
        default:
          w[0] = w[1] = w[2] = w[3] = 0x7FFFFFFF;
      }
      const int col = 8 * j + 2 * t;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int h = e & 1;
        if (w[e] < thr[i] && r0 + col + h < n_end) {
          const int x = (col + h) & 3;
          const unsigned m = x == 0 ? vm[0]
                             : x == 1 ? vm[1]
                             : x == 2 ? vm[2]
                                      : vm[3];
          const uint32_t pen = ((m >> ((col + h) >> 2)) & 1u) ^ 1u;
          const uint32_t key = (pen << 31) |
                               (static_cast<uint32_t>(w[e]) << rb) |
                               static_cast<uint32_t>(r0 + col + h - n_begin);
          if (key < own[i]) {
            lists[(g + 8 * i) * WG_P + WG_H + t * WG_LANE_C + cnt[i]++] =
                key;
          }
        }
      }
    }
  }
}

// One table of N rows for every query, 8-bit packed fields, k <= WG_KMAX,
// rows of whole 16-byte segments. A persistent block of two consumer
// warpgroups (64 queries each: wgmma's M) and a producer warp walks the
// units (query tile u % q_tiles of 128 queries, slice u / q_tiles of
// slice_rows rows). The producer's lane 0 keeps a ring of `stages` TMA
// slots full, each slot's bytes counted on its `full` mbarrier, and
// refills a slot once every consumer warp has arrived on its `empty`
// one; nothing else waits block-wide. WHOLE rows (up to WG_WHOLE_BOXES
// columns of 64 bytes): a slot is a tile of 128 rows and the 128
// queries' masks are loaded once a unit beside the ring. Wider rows: a
// slot is one 64-byte K-column of the 128 queries' masks and of a tile of
// 256 rows (two accumulator tiles), and the tile's selection follows its
// last column. A tile's valid bytes come in its (last) slot; a warp
// turns them into ballot masks and releases the slot as soon as its
// wgmmas are done, so no slot is held through a selection. The two
// warpgroups run apart: one selects while the other's wgmmas run. No
// wgmma is in flight across a branch, so nothing serialises them. The
// units of a query share a bound (`bounds`, (B,), reset by the masks
// pass). Each unit writes one sorted list of k (distance, row) keys per
// query for its slice to out (B, n_slices, k).
template <bool WHOLE>
__global__ void __launch_bounds__(WG_THREADS, 1)
shortlist_wgmma(const __grid_constant__ CUtensorMap tm_rows,
                const __grid_constant__ CUtensorMap tm_masks,
                const __grid_constant__ CUtensorMap tm_valid, int has_valid,
                int row_bytes, int B, int N, int k, int stages,
                int slice_rows, int n_slices, int* __restrict__ bounds,
                unsigned long long* __restrict__ out) {
  extern __shared__ uint8_t smem_raw[];
  constexpr uint32_t PAD = 0xFFFFFFFFu;  // the compact all-ones key
  constexpr int R = WHOLE ? WG_N : 2 * WG_N;  // rows a tile
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the 64B swizzle's atoms
  uint8_t* sm = smem_raw + (base - raw);
  const WgSmem L = wg_smem(WHOLE, stages);
  const uint32_t full = base + L.bars;  // + 8 s
  const uint32_t empty = full + 8 * stages;
  const uint32_t mfull = empty + 8 * stages;
  const uint32_t mempty = mfull + 8;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, WG_WARPS);
    }
    mbar_init(mfull, 1);
    mbar_init(mempty, WG_WARPS);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int n_kc = WHOLE ? 1 : (row_bytes + WG_BOX - 1) / WG_BOX;
  const int q_tiles = (B + WG_QB - 1) / WG_QB;
  const int units = q_tiles * n_slices;
  const int rb = row_bits(slice_rows);

  if (warp == WG_WARPS) {  // the producer
    if (lane == 0) {
      int s = 0;
      uint32_t ph = 0, mph = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const int b0 = (u % q_tiles) * WG_QB;
        const int n_begin = (u / q_tiles) * slice_rows;
        const int n_end = min(N, n_begin + slice_rows);
        const int tiles = (n_end - n_begin + R - 1) / R;
        if (WHOLE) {  // once the consumers' wgmmas of the last unit are done
          if (u != static_cast<int>(blockIdx.x)) {
            mbar_wait(mempty, mph);
            mph ^= 1u;
          }
          mbar_expect_tx(mfull, WG_WHOLE_BOXES * WG_QB * WG_BOX);
          for (int c = 0; c < WG_WHOLE_BOXES; ++c) {
            tma_2d(base + L.masks + c * WG_QB * WG_BOX, &tm_masks,
                   c * WG_BOX, b0, mfull);
          }
        }
        for (int t = 0; t < tiles; ++t) {
          const int r0 = n_begin + t * R;
          for (int c = 0; c < n_kc; ++c) {
            mbar_wait(empty + 8 * s, ph ^ 1u);
            const uint32_t slot = base + s * L.stage;
            const uint32_t bar = full + 8 * s;
            const int vbytes = has_valid && c == n_kc - 1 ? R : 0;
            mbar_expect_tx(bar, wg_data(WHOLE) + vbytes);
            if (WHOLE) {
              for (int x = 0; x < WG_WHOLE_BOXES; ++x) {
                tma_2d(slot + x * WG_N * WG_BOX, &tm_rows, x * WG_BOX, r0,
                       bar);
              }
            } else {
              tma_2d(slot, &tm_masks, c * WG_BOX, b0, bar);
              tma_2d(slot + WG_QB * WG_BOX, &tm_rows, c * WG_BOX, r0, bar);
            }
            if (vbytes) tma_1d(slot + wg_data(WHOLE), &tm_valid, r0, bar);
            if (++s == stages) {
              s = 0;
              ph ^= 1u;
            }
          }
        }
      }
    }
    return;
  }

  // the consumers: warp w holds block query slots 16 w .. 16 w + 15
  const int wg = warp >> 2;
  const int g = lane >> 2;
  uint32_t* lists = reinterpret_cast<uint32_t*>(sm + L.lists) +
                    warp * 16 * WG_P;
  int s = 0;
  uint32_t ph = 0, mph = 0;
  auto take = [&]() {  // the next ring slot, once its bytes have landed
    const int slot = s;
    mbar_wait(full + 8 * s, ph);
    if (++s == stages) {
      s = 0;
      ph ^= 1u;
    }
    return slot;
  };
  auto valid_of = [&](int slot) -> const uint8_t* {
    return has_valid ? sm + slot * L.stage + wg_data(WHOLE) : nullptr;
  };
  int acc0[64], acc1[64];
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int b0 = (u % q_tiles) * WG_QB;
    const int slice = u / q_tiles;
    const int n_begin = slice * slice_rows;
    const int n_end = min(N, n_begin + slice_rows);
    const int tiles = (n_end - n_begin + R - 1) / R;
    const int q_here = min(WG_QB, B - b0);
    int* qb = bounds + b0 + warp * 16;  // the warp's queries' bounds
    for (int e = lane; e < 16 * WG_H; e += 32) {
      lists[(e / WG_H) * WG_P + e % WG_H] = PAD;
    }
    __syncwarp();
    uint32_t own[2];  // the k-th key of slot g + 8 i's list
    int thr[2];
    int cnt[2] = {0, 0};  // the lane's candidates in that list
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      own[i] = warp * 16 + g + 8 * i < q_here ? PAD : 0u;  // else none
      thr[i] = wg_thr(own[i], rb);
    }
    if (WHOLE) {
      mbar_wait(mfull, mph);
      mph ^= 1u;
      const uint32_t a0 = base + L.masks + wg * WG_Q * WG_BOX;
      int gb[2] = {0x7FFFFFFF, 0x7FFFFFFF};  // shared bounds, a tile old
      for (int t = 0; t < tiles; ++t) {
        const int slot = take();
        const uint32_t b = base + slot * L.stage;
        wg_fence();
#pragma unroll
        for (int ks = 0; ks < 2 * WG_WHOLE_BOXES; ++ks) {
          const int col = (ks >> 1) * WG_BOX * 128 + (ks & 1) * 32;
          wgmma_u8(acc0, wg_desc(a0 + col), wg_desc(b + col), ks);
        }
        wg_commit();
        wg_wait<0>();
        wg_hold(acc0);
        if (t == tiles - 1) {
          mbar_arrive_warp(mempty, lane);  // the unit's masks read
        }
        unsigned vm[4];
        wg_valid(valid_of(slot), vm, lane);
        mbar_arrive_warp(empty + 8 * slot, lane);  // the slot read
#pragma unroll
        for (int i = 0; i < 2; ++i) {  // the bounds read a tile ago, and
          thr[i] = min(thr[i], gb[i]);  // the next tile's, read under this
          gb[i] = thr[i] != 0 ? wg_bound(qb + g + 8 * i) : 0;  // selection
        }
        wg_select(acc0, n_begin + t * WG_N, n_begin, n_end, rb, k, vm,
                  lists, qb, cnt, own, thr, lane);
      }
    } else {
      int gb[2] = {0x7FFFFFFF, 0x7FFFFFFF};  // shared bounds, a tile old
      for (int t = 0; t < tiles; ++t) {
        int slot = 0;
        for (int c = 0; c < n_kc; ++c) {
          slot = take();
          const uint32_t a = base + slot * L.stage + wg * WG_Q * WG_BOX;
          const uint32_t b = base + slot * L.stage + WG_QB * WG_BOX;
          wg_fence();
#pragma unroll
          for (int ks = 0; ks < 2; ++ks) {
            const int sc = c > 0 || ks > 0;
            wgmma_u8(acc0, wg_desc(a + 32 * ks), wg_desc(b + 32 * ks), sc);
            wgmma_u8(acc1, wg_desc(a + 32 * ks),
                     wg_desc(b + WG_N * WG_BOX + 32 * ks), sc);
          }
          wg_commit();
          wg_wait<0>();
          if (c != n_kc - 1) mbar_arrive_warp(empty + 8 * slot, lane);
        }
        wg_hold(acc0);
        wg_hold(acc1);
        const uint8_t* vb = valid_of(slot);
        unsigned vm0[4], vm1[4];
        wg_valid(vb, vm0, lane);
        wg_valid(vb != nullptr ? vb + WG_N : nullptr, vm1, lane);
        mbar_arrive_warp(empty + 8 * slot, lane);
#pragma unroll
        for (int i = 0; i < 2; ++i) {  // as for whole rows
          thr[i] = min(thr[i], gb[i]);
          gb[i] = thr[i] != 0 ? wg_bound(qb + g + 8 * i) : 0;
        }
        const int r0 = n_begin + t * R;
        wg_select(acc0, r0, n_begin, n_end, rb, k, vm0, lists, qb, cnt, own,
                  thr, lane);
        wg_select(acc1, r0 + WG_N, n_begin, n_end, rb, k, vm1, lists, qb,
                  cnt, own, thr, lane);
      }
    }
    // fold what is left and write each query's k keys
    for (int slot = 0; slot < 16; ++slot) {
      uint32_t* kq = lists + slot * WG_P;
      const int quad = 4 * (slot & 7);
      const int c = slot < 8 ? cnt[0] : cnt[1];
      int left = 0;
#pragma unroll
      for (int sub = 0; sub < 4; ++sub) {
        left += __shfl_sync(FULL, c, quad + sub);
      }
      if (left > 0) wg_fold(kq, c, quad, lane);
      const int qi = warp * 16 + slot;
      if (qi < q_here) {
        if (lane == 0) wg_publish(qb + slot, kq[k - 1], rb);
        unsigned long long* dst =
            out + ((size_t)(b0 + qi) * n_slices + slice) * k;
        for (int j = lane; j < k; j += 32) {
          const uint32_t key = kq[j];
          const uint32_t dist =
              ((key & 0x7FFFFFFFu) >> rb) + ((key >> 31) << 22);
          const uint32_t row = n_begin + (key & ((1u << rb) - 1u));
          dst[j] = key == PAD ? PAD_KEY
                              : (static_cast<unsigned long long>(dist) << 32) |
                                    row;
        }
      }
    }
    __syncwarp();
  }
}

// The one-table select's plan: P keys a query, a power of two with H = P
// / 2 >= max(k, 64) (a tile's 64 rows fit after a fold); K-chunks of whole
// k-steps (at most CHUNK_MAX words, or the whole row); a merge round folds
// MERGE_KEYS / pow2(k) >= 2 lists into one, so k <= MAX_K. A compact key
// holds the penalty bit, the distance (at most 255 d, below the penalty
// 2**22) and the row within the slice, and a real one is never all ones.
bool select_ok(int B, int N, int d, int k, int row_words, int warps, int P,
               int chunk, int stages, int slice_rows) {
  return B >= 1 && B <= 65535 && k >= 1 && k <= MAX_K && k <= N && d >= 1 &&
         255LL * d < (1LL << 22) && slice_rows >= ROWS &&
         slice_rows <= (1 << 24) &&
         255LL * d + 1 < (1LL << (31 - row_bits(slice_rows))) &&
         row_words >= d && (warps == 1 || warps == 2 || warps == 4) &&
         P >= 2 * ROWS && (P & (P - 1)) == 0 && P / 2 >= k && chunk >= 8 &&
         chunk % 8 == 0 && (chunk >= row_words || chunk <= CHUNK_MAX) &&
         stages >= 2 && stages <= 4 && slice_rows >= ROWS &&
         slice_rows % ROWS == 0 &&
         select_smem(warps, P, row_words, chunk, stages) <= SMEM_MAX;
}

// What the grouping pass lays out for the select and merge passes.
struct Units {
  const long long* ids;  // (B p) the visit lists
  int* cnt;         // (M + 1) pairs of each table block
  int4* units;      // (u_max) {block, first pair, pairs, range | ranges << 16}
  int* n_units;     // units in use
  int* pairs;       // (B p) pair ids b * p + j, grouped by table block
  int* lists_n;     // (B) lists of each query (written by the select pass)
  unsigned long long* bound;  // (B) each query's shared bound
  unsigned long long* slots;  // (B, SLOTS) lists' published keys
};

// The row ranges of the block that visit i (= b p + j) names: of every
// tile of that block.
__device__ __forceinline__ int visit_ranges(const Units& u, int i, int M,
                                            int qb, int rows, int row_words,
                                            int work, int split) {
  const long long m = u.ids[i];
  if (m < 0 || m >= M) return 1;  // the virtual block
  return ranges_of(u.cnt[m], qb, rows, row_words, work, split);
}

// The grouping pass, one block of GROUP_THREADS: the (query, visit) pairs
// of ids (B p,) grouped by table block (an id outside [0, M) by the virtual
// block M) with each block's count, the units of each block's tiles of at
// most qb pairs, and the bounds reset. cursor (M + 1) is scratch.
__global__ void __launch_bounds__(GROUP_THREADS)
shortlist_blocks_group(int B, int p, int M, int qb, int rows, int row_words,
                       int work, int split, int* __restrict__ cursor,
                       Units u) {
  __shared__ int s_pairs[GROUP_THREADS / 32];
  __shared__ int s_units[GROUP_THREADS / 32];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int pairs_n = B * p;
  const int G = M + 1;
  int* cnt = u.cnt;
  auto group_of = [&](long long m) {
    return (m < 0 || m >= M) ? M : static_cast<int>(m);
  };
  auto ranges = [&](int g) {  // of every tile of block g
    return g == M ? 1 : ranges_of(cnt[g], qb, rows, row_words, work, split);
  };
  for (int g = tid; g < G; g += GROUP_THREADS) cnt[g] = 0;
  for (int b = tid; b < B; b += GROUP_THREADS) u.bound[b] = PAD_KEY;
  for (int e = tid; e < B * SLOTS; e += GROUP_THREADS) u.slots[e] = PAD_KEY;
  __syncthreads();
  for (int i = tid; i < pairs_n; i += GROUP_THREADS) {
    atomicAdd(&cnt[group_of(u.ids[i])], 1);
  }
  __syncthreads();
  // thread tid owns groups [g0, g1): their pairs and units, then a block
  // exclusive scan of both
  const int per = (G + GROUP_THREADS - 1) / GROUP_THREADS;
  const int g0 = min(G, tid * per);
  const int g1 = min(G, g0 + per);
  int np = 0, nu = 0;
  for (int g = g0; g < g1; ++g) {
    const int c = cnt[g];
    np += c;
    nu += (c + qb - 1) / qb * ranges(g);
  }
  int ip = np, iu = nu;  // inclusive scans within the warp
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int x = __shfl_up_sync(FULL, ip, off);
    const int y = __shfl_up_sync(FULL, iu, off);
    if (lane >= off) {
      ip += x;
      iu += y;
    }
  }
  if (lane == 31) {
    s_pairs[warp] = ip;
    s_units[warp] = iu;
  }
  __syncthreads();
  if (warp == 0) {
    int wp = s_pairs[lane], wu = s_units[lane];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int x = __shfl_up_sync(FULL, wp, off);
      const int y = __shfl_up_sync(FULL, wu, off);
      if (lane >= off) {
        wp += x;
        wu += y;
      }
    }
    s_pairs[lane] = wp - s_pairs[lane];  // exclusive, per warp
    s_units[lane] = wu - s_units[lane];
  }
  __syncthreads();
  int p0 = s_pairs[warp] + ip - np;
  int u0 = s_units[warp] + iu - nu;
  if (tid == GROUP_THREADS - 1) *u.n_units = u0 + nu;
  for (int g = g0; g < g1; ++g) {
    const int c = cnt[g];
    const int s = ranges(g);
    for (int f = 0; f < c; f += qb) {
      for (int r = 0; r < s; ++r) {
        u.units[u0++] = make_int4(g, p0 + f, min(qb, c - f), r | (s << 16));
      }
    }
    cursor[g] = p0;
    p0 += c;
  }
  __syncthreads();
  for (int i = tid; i < pairs_n; i += GROUP_THREADS) {
    u.pairs[atomicAdd(&cursor[group_of(u.ids[i])], 1)] = i;
  }
}

// The select pass, one block of `warps` warps per unit (blockIdx.x; slots
// past the units in use return). MMA: 8-bit packed fields on the tensor
// cores; else the CUDA-core dot products. Writes one sorted list of k keys
// per pair at (B, lists, k)[b, the pair's first list + range].
template <int KIND, int BITS, bool MMA>
__global__ void __launch_bounds__(MAX_WARPS * 32)
shortlist_blocks_select(const int* __restrict__ qw,
                        const uint32_t* __restrict__ op, int row_words,
                        const uint8_t* __restrict__ valid,
                        const long long* __restrict__ base, int M, int rows,
                        int d, int p, int k, int P, int chunk, int stages,
                        int work, int split, int lists,
                        unsigned long long* __restrict__ out, Units u) {
  extern __shared__ unsigned long long smem[];
  __shared__ int s_query[BQ];       // query of a pair slot, or -1
  __shared__ long long s_list[BQ];  // its list's first key
  __shared__ int s_slot[BQ];        // its bound slot
  __shared__ int s_shared[BQ];      // its query keeps a shared bound
  if (static_cast<int>(blockIdx.x) >= *u.n_units) return;
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int qb = warps * QW;
  const int H = P / 2;              // sorted keys a list; as many candidates
  const int mrows = MMA ? BQ : qb;  // the MMA's A has 16 rows
  const int mstride = blocks_stride(row_words);
  const int sstride = blocks_stride(chunk);
  unsigned long long* keys = smem + warp * QW * P;
  uint32_t* masks = reinterpret_cast<uint32_t*>(smem + qb * P);
  uint32_t* stage = masks + mrows * mstride;
  int* dist = reinterpret_cast<int*>(stage + stages * ROWS * sstride);

  // the unit's rows [n_begin, n_end) of its table block, their key rows
  // key0 + n
  const int4 un = u.units[blockIdx.x];
  const int range = un.w & 0xFFFF;
  const bool real = un.x < M;
  const int n_begin = range * unit_rows(rows, un.w >> 16);
  const int n_end = real ? min(rows, n_begin + unit_rows(rows, un.w >> 16))
                         : n_begin;
  const uint32_t* rows_op =
      real ? op + (size_t)un.x * rows * row_words : op;
  const uint8_t* rows_valid =
      real && valid != nullptr ? valid + (size_t)un.x * rows : nullptr;

  // stage s = (tile s / n_kc, K-chunk s % n_kc) into ring slot s % stages:
  // each warp copies whole rows, its lanes along the row
  const bool vec = row_words % 4 == 0 && chunk % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(op) & 15) == 0;
  const int n_kc = (row_words + chunk - 1) / chunk;
  const int n_st = (n_end - n_begin + ROWS - 1) / ROWS * n_kc;
  auto issue = [&](int s) {
    if (s < n_st) {
      const int r0 = n_begin + (s / n_kc) * ROWS;
      const int w0 = (s % n_kc) * chunk;
      const int ww = min(chunk, row_words - w0);
      uint32_t* buf = stage + (s % stages) * ROWS * sstride;
      for (int r = warp; r < ROWS && r0 + r < n_end; r += warps) {
        const uint32_t* src = rows_op + (size_t)(r0 + r) * row_words + w0;
        if (vec) {
          for (int j = lane; j < ww / 4; j += 32) {
            cp_async16(buf + r * sstride + 4 * j, src + 4 * j);
          }
        } else {
          for (int j = lane; j < ww; j += 32) {
            cp_async4(buf + r * sstride + j, src + j);
          }
        }
      }
    }
    cp_async_commit();  // an empty group past the last stage
  };
  // float kinds: zero the ring first, since a float mask word of 0 must not
  // meet a NaN in a staged word that is never copied; integer products
  // with a 0 mask are 0 whatever the word
  if (KIND != kPacked) {
    for (int e = threadIdx.x; e < stages * ROWS * sstride; e += blockDim.x) {
      stage[e] = 0u;
    }
    __syncthreads();
  }
  // the first stages are in flight while the unit is set up
  for (int s = 0; s < stages - 1; ++s) issue(s);
  const unsigned key0 = real ? static_cast<unsigned>(base[un.x]) : 0u;

  // each pair slot's query; the masks zeroed and the lists emptied
  for (int qi = threadIdx.x; qi < qb; qi += blockDim.x) {
    s_query[qi] = qi < un.z ? u.pairs[un.y + qi] / p : -1;
  }
  for (int e = threadIdx.x; e < mrows * mstride; e += blockDim.x) {
    masks[e] = 0u;
  }
  for (int e = lane; e < QW * P; e += 32) keys[e] = PAD_KEY;
  __syncthreads();
  // each pair slot's list and bound slot: the pair's lists follow the
  // ranges of the blocks its query visits before it; a query with fewer
  // than 2 MSEL lists keeps no shared bound (it costs more than it saves)
  for (int qi = threadIdx.x; qi < un.z; qi += blockDim.x) {
    const int pair = u.pairs[un.y + qi];
    const int b = pair / p;
    const int jp = pair - b * p;
    int li = range, n = 0;
    for (int j0 = 0; j0 < p; j0 += 8) {
      int s8[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s8[j] = j0 + j < p ? visit_ranges(u, b * p + j0 + j, M, qb, rows,
                                          row_words, work, split)
                           : 0;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        li += j0 + j < jp ? s8[j] : 0;
        n += s8[j];
      }
    }
    if (range == 0) u.lists_n[b] = n;  // every unit of b would agree
    s_list[qi] = ((long long)b * lists + li) * k;
    s_slot[qi] = b * SLOTS + li % SLOTS;
    s_shared[qi] = n >= 2 * MSEL;
  }
  // the one-hot masks of the whole row, once: eight query words in flight
  // a thread
  const int n_q = un.z * d;
  for (int e0 = threadIdx.x; e0 < n_q; e0 += 8 * blockDim.x) {
    int qv[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int e = e0 + i * blockDim.x;
      qv[i] = e < n_q ? qw[(size_t)s_query[e / d] * d + e % d] : 0;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int e = e0 + i * blockDim.x;
      if (e < n_q) {
        const int qi = e / d;
        const int col = 4 * (e - qi * d) + min(max(qv[i], 0), 3);
        int word, field;
        if (KIND == kPacked) {
          word = col % row_words;
          field = col / row_words;
        } else if (KIND == kBf16) {
          word = col >> 1;
          field = col & 1;
        } else {
          word = col;
          field = 0;
        }
        atomicOr(&masks[qi * mstride + word], mask_flag<KIND, BITS>(field));
      }
    }
  }
  // the masks and the pair slots' lists, bound slots and flags for every
  // warp: a unit of no rows (the virtual block) has no ring barrier
  __syncthreads();

  const bool active = s_query[warp * QW] >= 0;  // slots fill in order
  bool q_on[QW];
  int count[QW];
  unsigned long long own[QW];  // the list's k-th key
  unsigned long long gb[QW];   // the query's shared bound, as last read
#pragma unroll
  for (int q = 0; q < QW; ++q) {
    q_on[q] = s_query[warp * QW + q] >= 0;
    count[q] = 0;
    own[q] = PAD_KEY;
    gb[q] = PAD_KEY;
  }
  int accm[8][4];            // MMA: 16 pairs x 8 rows an n-tile
  Acc<KIND> acc[RPL][QW];    // CUDA cores: the warp's pairs x a lane's rows
  unsigned long long gb_read[QW];    // the bound read at the tile's start
  unsigned long long slot_read[QW];  // and the query's slot `lane`
  uint8_t vbyte[RPL];        // a lane's rows' valid bytes
  const int nt = 8 / warps;  // n-tiles of a row tile a warp computes
  const int rank = (k + MSEL - 1) / MSEL;  // of the key a list publishes

  // one key of pair slot q of this warp, offered to its list: a key below
  // the list's k-th key and at or below the query's bound joins the
  // candidates (a key equal to the bound may be a second copy, from a
  // block the query visits twice, that the result holds too); a full
  // candidate half is folded first, and the fold publishes the list's
  // r-th key and reads the query's bound
#define OFFER(q, key_expr)                                                   \
  {                                                                          \
    const unsigned long long key = (key_expr);                               \
    bool pass = key < own[q] && key <= gb[q];                                \
    unsigned m = __ballot_sync(FULL, pass);                                  \
    if (m != 0u) {                                                           \
      const int slot = warp * QW + (q);                                      \
      unsigned long long* kq = keys + (q) * P;                               \
      if (count[q] + __popc(m) > H) {                                        \
        fold_half(kq, H, count[q], lane);                                    \
        count[q] = 0;                                                        \
        own[q] = kq[k - 1];                                                  \
        if (s_shared[slot]) {                                                \
          const unsigned long long rk = kq[rank - 1];                        \
          if (rk != PAD_KEY && lane == 0) {                                  \
            atomicMin(u.slots + s_slot[slot], rk);                           \
          }                                                                  \
          unsigned long long v[1] = {slot_read[q]};                          \
          warp_sort<1>(v, lane);                                             \
          const unsigned long long bnd = __shfl_sync(FULL, v[0], MSEL - 1);  \
          if (bnd < gb[q]) {                                                 \
            gb[q] = bnd;                                                     \
            if (lane == 0) atomicMin(u.bound + s_query[slot], bnd);          \
          }                                                                  \
        }                                                                    \
        pass = key < own[q] && key <= gb[q];                                 \
        m = __ballot_sync(FULL, pass);                                       \
      }                                                                      \
      if (pass) kq[H + count[q] + __popc(m & ((1u << lane) - 1u))] = key;    \
      count[q] += __popc(m);                                                 \
      __syncwarp();                                                          \
    }                                                                        \
  }

  for (int s = 0; s < n_st; ++s) {
    if (stages == 2) {
      cp_async_wait<0>();
    } else if (stages == 3) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<2>();
    }
    __syncthreads();  // stage s (and the masks) for every warp; the slot
    issue(s + stages - 1);  // refilled here was last read in stage s - 1
    const int tile = s / n_kc;
    const int kc = s - tile * n_kc;
    const int r0 = n_begin + tile * ROWS;
    const int w0 = kc * chunk;
    const int ww = min(chunk, row_words - w0);
    const uint32_t* buf = stage + (s % stages) * ROWS * sstride;
    if (kc == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) accm[i][c] = 0;
#pragma unroll
      for (int j = 0; j < RPL; ++j)
#pragma unroll
        for (int q = 0; q < QW; ++q) acc[j][q] = 0;
      if (active) {
        // read now, used at the tile's selection: no wait here
#pragma unroll
        for (int q = 0; q < QW; ++q) {
          const int b = s_query[warp * QW + q];
          const bool on = q_on[q] && s_shared[warp * QW + q];
          gb_read[q] = on ? ld_relaxed(u.bound + b) : PAD_KEY;
          slot_read[q] =
              on ? ld_relaxed(u.slots + (size_t)b * SLOTS + lane) : PAD_KEY;
        }
#pragma unroll
        for (int j = 0; j < RPL; ++j) {
          const int n = r0 + j * 32 + lane;
          vbyte[j] = rows_valid != nullptr && n < n_end ? rows_valid[n] : 1;
        }
      }
    }
    if constexpr (MMA) {
      // A: the masks' k-step, lanes 0-15 rows 0-15 words 0-3, lanes 16-31
      // words 4-7; B: two n-tiles' rows, words 0-3 and 4-7. The next
      // k-step's fragments are loaded before this one's products.
      const uint32_t* a_ptr =
          masks + ((lane & 7) + 8 * ((lane >> 3) & 1)) * mstride + w0 +
          4 * (lane >> 4);
      const uint32_t* b_ptr = buf + (lane & 7) * sstride +
                              4 * ((lane >> 3) & 1);
      const int ksteps = (ww + 7) / 8;
      uint32_t a[2][4], bf[2][4][4];
      auto load = [&](int ks, int slot) {
        ldsm_x4(a[slot], a_ptr + 8 * ks);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (2 * i < nt) {
            const int tsel = warp + (2 * i + (lane >> 4)) * warps;
            ldsm_x4(bf[slot][i], b_ptr + tsel * 8 * sstride + 8 * ks);
          }
        }
      };
      load(0, 0);
      for (int ks = 0; ks < ksteps; ks += 2) {
        if (ks + 1 < ksteps) load(ks + 1, 1);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (2 * i < nt) {
            mma_u8(accm[2 * i], a[0], bf[0][i][0], bf[0][i][1]);
            mma_u8(accm[2 * i + 1], a[0], bf[0][i][2], bf[0][i][3]);
          }
        }
        if (ks + 1 < ksteps) {
          if (ks + 2 < ksteps) load(ks + 2, 0);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (2 * i < nt) {
              mma_u8(accm[2 * i], a[1], bf[1][i][0], bf[1][i][1]);
              mma_u8(accm[2 * i + 1], a[1], bf[1][i][2], bf[1][i][3]);
            }
          }
        }
      }
      if (kc == n_kc - 1) {
        // pair g (and g + 8) x rows 2t, 2t + 1 of each n-tile
        const int g = lane >> 2;
        const int t = lane & 3;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (i < nt) {
            const int col = (warp + i * warps) * 8 + 2 * t;
            *reinterpret_cast<int2*>(dist + g * DSTRIDE + col) =
                make_int2(accm[i][0], accm[i][1]);
            *reinterpret_cast<int2*>(dist + (g + 8) * DSTRIDE + col) =
                make_int2(accm[i][2], accm[i][3]);
          }
        }
        __syncthreads();  // the tile's distances (read before the next
                          // tile's are written: the ring's barrier)
        if (active) {
#pragma unroll
          for (int q = 0; q < QW; ++q) gb[q] = min(gb[q], gb_read[q]);
#pragma unroll
          for (int j = 0; j < RPL; ++j) {
            const int row = j * 32 + lane;
            const int n = r0 + row;
#pragma unroll
            for (int q = 0; q < QW; ++q) {
              OFFER(q, n < n_end && q_on[q]
                           ? (static_cast<unsigned long long>(
                                  static_cast<unsigned>(
                                      dist[(warp * QW + q) * DSTRIDE + row]) +
                                  (vbyte[j] == 0 ? (1u << 22) : 0u))
                              << 32) | (key0 + static_cast<unsigned>(n))
                           : PAD_KEY);
            }
          }
        }
      }
    } else if (active) {
      // lane l takes rows l and l + 32 of the tile: each mask load (a
      // broadcast) serves RPL rows
      const uint4* mq =
          reinterpret_cast<const uint4*>(masks + warp * QW * mstride + w0);
      const int chunks = (ww + 3) / 4;
      for (int c = 0; c < chunks; ++c) {
        uint4 v[RPL];
#pragma unroll
        for (int j = 0; j < RPL; ++j) {
          v[j] = reinterpret_cast<const uint4*>(
              buf + (j * 32 + lane) * sstride)[c];
        }
#pragma unroll
        for (int q = 0; q < QW; ++q) {
          const uint4 m = mq[q * (mstride / 4) + c];
#pragma unroll
          for (int j = 0; j < RPL; ++j) {
            dot_chunk<KIND, BITS>(acc[j][q], v[j], m);
          }
        }
      }
      if (kc == n_kc - 1) {
#pragma unroll
        for (int q = 0; q < QW; ++q) gb[q] = min(gb[q], gb_read[q]);
#pragma unroll
        for (int j = 0; j < RPL; ++j) {
          const int n = r0 + j * 32 + lane;
#pragma unroll
          for (int q = 0; q < QW; ++q) {
            const float dv =
                (KIND == kPacked
                     ? static_cast<float>(static_cast<int>(acc[j][q]))
                     : static_cast<float>(acc[j][q])) +
                (vbyte[j] == 0 ? MASK_PENALTY : 0.f);
            OFFER(q, n < n_end && q_on[q]
                         ? (static_cast<unsigned long long>(
                                __float2uint_rz(dv))
                            << 32) | (key0 + static_cast<unsigned>(n))
                         : PAD_KEY);
          }
        }
      }
    }
  }
#undef OFFER

  if (active) {
#pragma unroll
    for (int q = 0; q < QW; ++q) {
      unsigned long long* kq = keys + q * P;
      if (count[q] > 0) fold_half(kq, H, count[q], lane);
      if (q_on[q]) {
        unsigned long long* dst = out + s_list[warp * QW + q];
        for (int j = lane; j < k; j += 32) dst[j] = kq[j];
      }
    }
  }
}

// One merge round of either entry: (B, m_in, k) -> (B, m_out, k), each
// output list the k smallest keys of `group` consecutive input lists, over
// the n_in = ceil(lists_n[b] / div) lists query b has in this round (every
// m_in list where lists_n is null, as for the one-table entry): a block
// past them returns, a block of one list copies it. The lists are
// sorted, so the block merges them pairwise in a tree: each list padded to
// K2 = pow2(k) keys, the elementwise minimum of one with the other reversed
// holds the K2 smallest of both as a bitonic sequence, which log2(K2)
// stages sort.
__global__ void __launch_bounds__(MERGE_THREADS)
shortlist_merge(const unsigned long long* __restrict__ in,
                       unsigned long long* __restrict__ out,
                       const int* __restrict__ lists_n, int div, int m_in,
                       int m_out, int k, int K2, int group) {
  __shared__ unsigned long long keys[MERGE_KEYS];
  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int n_in =
      lists_n != nullptr ? (lists_n[b] + div - 1) / div : m_in;
  const int first = g * group;
  if (first >= n_in) return;
  const int here = min(group, n_in - first);
  const unsigned long long* src = in + ((size_t)b * m_in + first) * k;
  unsigned long long* dst = out + ((size_t)b * m_out + g) * k;
  if (here == 1) {
    for (int j = threadIdx.x; j < k; j += MERGE_THREADS) dst[j] = src[j];
    return;
  }
  for (int j = threadIdx.x; j < here * K2; j += MERGE_THREADS) {
    const int list = j / K2;
    const int e = j - list * K2;
    keys[j] = e < k ? src[list * k + e] : PAD_KEY;
  }
  __syncthreads();
  for (int w = 1; w < here; w <<= 1) {
    // list a = 2 w i takes the K2 smallest of itself and list a + w
    const int pairs = (here + 2 * w - 1) / (2 * w);
    for (int j = threadIdx.x; j < pairs * K2; j += MERGE_THREADS) {
      const int i = j / K2;
      const int e = j - i * K2;
      const int a = 2 * w * i;
      if (a + w < here) {
        keys[a * K2 + e] = min(keys[a * K2 + e],
                               keys[(a + w) * K2 + K2 - 1 - e]);
      }
    }
    __syncthreads();
    for (int st = K2 >> 1; st > 0; st >>= 1) {
      for (int j = threadIdx.x; j < pairs * (K2 >> 1); j += MERGE_THREADS) {
        const int i = j / (K2 >> 1);
        const int c = j - i * (K2 >> 1);
        const int a = 2 * w * i;
        if (a + w < here) {
          const int lo = a * K2 + 2 * c - (c & (st - 1));
          const unsigned long long x = keys[lo];
          const unsigned long long y = keys[lo + st];
          keys[lo] = min(x, y);
          keys[lo + st] = max(x, y);
        }
      }
      __syncthreads();
    }
  }
  for (int j = threadIdx.x; j < k; j += MERGE_THREADS) dst[j] = keys[j];
}

int blocks_smem(int warps, int P, int row_words, int chunk, int stages,
                bool mma) {
  return warps * QW * P * 8 +
         (mma ? BQ : warps * QW) * blocks_stride(row_words) * 4 +
         stages * ROWS * blocks_stride(chunk) * 4 +
         (mma ? BQ * DSTRIDE * 4 : 0);
}

template <int KIND, int BITS, bool MMA>
int launch_blocks_select(const int* qw, const uint32_t* op, int row_words,
                         const uint8_t* valid, const long long* base, int M,
                         int rows, int d, int p, int k, int warps, int P,
                         int chunk, int stages, int work, int split,
                         int lists, int u_max, unsigned long long* out,
                         const Units& u, cudaStream_t st) {
  const int smem = blocks_smem(warps, P, row_words, chunk, stages, MMA);
  cudaError_t err = cudaFuncSetAttribute(
      shortlist_blocks_select<KIND, BITS, MMA>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  shortlist_blocks_select<KIND, BITS, MMA><<<u_max, warps * 32, smem, st>>>(
      qw, op, row_words, valid, base, M, rows, d, p, k, P, chunk, stages,
      work, split, lists, out, u);
  return static_cast<int>(cudaGetLastError());
}

int blocks_select_any(int kind, int bits, const int* qw, const uint32_t* op,
                      int row_words, const uint8_t* valid,
                      const long long* base, int M, int rows, int d, int p,
                      int k, int warps, int P, int chunk, int stages,
                      int work, int split, int lists, int u_max,
                      unsigned long long* out, const Units& u,
                      cudaStream_t st) {
#define BSELECT(KIND, BITS, MMA)                                            \
  launch_blocks_select<KIND, BITS, MMA>(qw, op, row_words, valid, base, M,  \
                                        rows, d, p, k, warps, P, chunk,     \
                                        stages, work, split, lists, u_max,  \
                                        out, u, st)
  if (kind == kBf16) return BSELECT(kBf16, 16, false);
  if (kind == kF32) return BSELECT(kF32, 32, false);
  if (kind == kPacked && bits == 4) return BSELECT(kPacked, 4, false);
  if (kind == kPacked && bits == 8) return BSELECT(kPacked, 8, true);
  if (kind == kPacked && bits == 16) return BSELECT(kPacked, 16, false);
  if (kind == kPacked && bits == 32) return BSELECT(kPacked, 32, false);
#undef BSELECT
  return static_cast<int>(cudaErrorInvalidValue);
}

// Merge rounds: each query's lists_n[b] (<= m; m where lists_n is null)
// sorted lists in `a` -> its k smallest in out (B, k), ping-ponging
// between a and bscr.
int merge_lists(unsigned long long* a, unsigned long long* bscr,
                       unsigned long long* out, const int* lists_n, int B,
                       int m, int k, cudaStream_t st) {
  int K2 = 1;
  while (K2 < k) K2 <<= 1;
  const int group = MERGE_KEYS / K2;
  unsigned long long* src = a;
  int div = 1;
  while (m > 1) {
    const int m_out = (m + group - 1) / group;
    unsigned long long* dst = m_out == 1 ? out : (src == a ? bscr : a);
    shortlist_merge<<<dim3(m_out, B), MERGE_THREADS, 0, st>>>(
        src, dst, lists_n, div, m, m_out, k, K2, group);
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
    m = m_out;
    div *= group;
    src = dst;
  }
  return 0;
}

// The dynamic shared memory a kernel may take, set once per device (and
// again only for a larger size): cudaFuncSetAttribute is not repeated on
// the serving path.
template <typename F>
int allow_smem(F* kernel, int bytes, int (&done)[16]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 0 && dev < 16 && done[dev] >= bytes) return 0;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 0 && dev < 16) done[dev] = bytes;
  return 0;
}

// The (B, mw) one-hot masks of both one-table selects (and the wgmma
// select's bounds reset).
int launch_masks(const int* qw, int B, int d, int row_words, uint32_t* masks,
                 int* bounds, cudaStream_t st) {
  const int mw = 8 * ((row_words + 7) / 8);
  const long long words = (long long)B * mw;
  shortlist_masks<<<static_cast<unsigned>((words + 255) / 256), 256, 0,
                    st>>>(qw, B, d, row_words, mw, masks, bounds);
  return static_cast<int>(cudaGetLastError());
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up once through the runtime
// (the library links no libcuda of its own); null where there is none.
EncodeTiled tensor_map_encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A tensor map of `rows` rows of `width` bytes (a multiple of 16), boxes
// of 64 bytes x box_rows rows in the 64-byte swizzle (zeros past the
// edges); rank 1 (box_rows 0): `width` bytes, boxes of `box` bytes.
bool tensor_map(EncodeTiled enc, CUtensorMap* map, const void* ptr,
                unsigned long long width, unsigned long long rows,
                unsigned box_rows, unsigned box) {
  const cuuint64_t dims[2] = {width, rows};
  const cuuint64_t strides[1] = {width};
  const cuuint32_t boxes[2] = {box_rows ? static_cast<cuuint32_t>(WG_BOX)
                                        : static_cast<cuuint32_t>(box),
                               box_rows};
  const cuuint32_t steps[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, box_rows ? 2 : 1,
             const_cast<void*>(ptr), dims, strides, boxes, steps,
             CU_TENSOR_MAP_INTERLEAVE_NONE,
             box_rows ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// What the wgmma select takes (kernels/shortlist.py::shortlist_plan and
// wgmma_route): as select_ok, with k <= WG_KMAX, rows of whole 16-byte
// segments at 16-byte aligned addresses, slices of whole tiles, a ring of
// 3 to 8 slots, and rows of up to 3 columns of 64 bytes when WHOLE.
bool wgmma_ok(int B, int N, int d, int k, int row_words, const void* op,
              const void* valid, int whole, int stages, int slice_rows,
              int blocks) {
  const int R = whole ? WG_N : 2 * WG_N;
  const int n_box = (4 * row_words + WG_BOX - 1) / WG_BOX;
  return B >= 1 && B <= 65535 && N >= 1 && k >= 1 && k <= WG_KMAX &&
         k <= N && d >= 1 && 255LL * d < (1LL << 22) && row_words >= d &&
         row_words % 4 == 0 &&
         (reinterpret_cast<uintptr_t>(op) & 15) == 0 &&
         (reinterpret_cast<uintptr_t>(valid) & 15) == 0 &&
         (!whole || n_box <= WG_WHOLE_BOXES) && stages >= 3 &&
         stages <= 8 &&
         slice_rows >= R && slice_rows % R == 0 &&
         slice_rows <= (1 << 24) &&
         255LL * d + 1 < (1LL << (31 - row_bits(slice_rows))) &&
         blocks >= 1 &&
         wg_smem(whole != 0, stages).total <= SMEM_MAX;
}

}  // namespace

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The wrapper sizes its merge scratch from this; it checks it at load time.
extern "C" int shortlist_merge_keys() { return MERGE_KEYS; }

// qw (B, d) int32 query words; op (N, row_words) int32 words of 8-bit
// packed fields; valid (N,) uint8 or null. The plan (warps of 16 queries a
// select block, P keys a query, K-chunks of `chunk` words through a ring
// of `stages`, slice_rows) comes from kernels/shortlist.py::shortlist_plan.
// mask_scratch holds B * mw int32 words (mw: row_words rounded up to 8);
// scratch_a B * slices * k keys, scratch_b B * ceil(slices / (MERGE_KEYS /
// pow2(k))) * k; out_keys (B, k). Returns cudaGetLastError() of the first
// failing launch, else 0.
extern "C" int shortlist_launch(const void* qw, const void* op,
                                int row_words, const void* valid, int B,
                                int N, int d, int k, int warps, int P,
                                int chunk, int stages, int slice_rows,
                                int blocks, void* mask_scratch,
                                void* scratch_a, void* scratch_b,
                                void* out_keys, void* stream) {
  if (!select_ok(B, N, d, k, row_words, warps, P, chunk, stages,
                 slice_rows) ||
      blocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int mw = 8 * ((row_words + 7) / 8);
  auto* masks = static_cast<uint32_t*>(mask_scratch);
  int err = launch_masks(static_cast<const int*>(qw), B, d, row_words, masks,
                         nullptr, st);
  if (err != 0) return err;
  static int smem_set[16] = {};
  const int smem = select_smem(warps, P, row_words, chunk, stages);
  err = allow_smem(shortlist_select, smem, smem_set);
  if (err != 0) return err;
  const int n_slices = (N + slice_rows - 1) / slice_rows;
  auto* a = static_cast<unsigned long long*>(scratch_a);
  auto* out = static_cast<unsigned long long*>(out_keys);
  shortlist_select<<<blocks, warps * 32, smem, st>>>(
      masks, mw, static_cast<const uint32_t*>(op), row_words,
      static_cast<const uint8_t*>(valid), B, N, k, P, chunk, stages,
      slice_rows, n_slices, n_slices == 1 ? out : a);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return merge_lists(a, static_cast<unsigned long long*>(scratch_b),
                            out, nullptr, B, n_slices, k, st);
}

// The wgmma select's entry, for k <= WG_KMAX and row_words % 4 == 0 (the
// rest as shortlist_launch): whole (rows of up to 3 columns of 64 bytes,
// tiles of 128 rows) or not (tiles of 256 rows in 64-byte K-columns), a
// ring of `stages` slots, slice_rows a unit, `blocks` persistent blocks
// (from kernels/shortlist.py::shortlist_plan). Returns cudaGetLastError()
// of the first failing launch, cudaErrorNotSupported where no tensor map
// can be encoded, else 0. mask_scratch holds B * mw + B int32
// words: the masks, then each query's shared bound.
extern "C" int shortlist_wgmma_launch(const void* qw, const void* op,
                                      int row_words, const void* valid,
                                      int B, int N, int d, int k, int whole,
                                      int stages, int slice_rows, int blocks,
                                      void* mask_scratch, void* scratch_a,
                                      void* scratch_b, void* out_keys,
                                      void* stream) {
  if (!wgmma_ok(B, N, d, k, row_words, op, valid, whole, stages, slice_rows,
                blocks)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const EncodeTiled enc = tensor_map_encoder();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int mw = 8 * ((row_words + 7) / 8);
  auto* masks = static_cast<uint32_t*>(mask_scratch);
  const int R = whole ? WG_N : 2 * WG_N;
  CUtensorMap tm_rows, tm_masks, tm_valid = {};
  if (!tensor_map(enc, &tm_rows, op, 4ULL * row_words, N, R, 0) ||
      !tensor_map(enc, &tm_masks, masks, 4ULL * mw, B, WG_QB, 0) ||
      (valid != nullptr &&
       !tensor_map(enc, &tm_valid, valid, N, 1, 0, R))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int* bounds = reinterpret_cast<int*>(masks + (size_t)B * mw);
  int err = launch_masks(static_cast<const int*>(qw), B, d, row_words, masks,
                         bounds, st);
  if (err != 0) return err;
  const int smem = wg_smem(whole != 0, stages).total;
  const int n_slices = (N + slice_rows - 1) / slice_rows;
  auto* a = static_cast<unsigned long long*>(scratch_a);
  auto* out = static_cast<unsigned long long*>(out_keys);
  auto* dst = n_slices == 1 ? out : a;
  static int smem_set[2][16] = {};
  if (whole) {
    err = allow_smem(shortlist_wgmma<true>, smem, smem_set[1]);
    if (err != 0) return err;
    shortlist_wgmma<true><<<blocks, WG_THREADS, smem, st>>>(
        tm_rows, tm_masks, tm_valid, valid != nullptr, 4 * row_words, B, N,
        k, stages, slice_rows, n_slices, bounds, dst);
  } else {
    err = allow_smem(shortlist_wgmma<false>, smem, smem_set[0]);
    if (err != 0) return err;
    shortlist_wgmma<false><<<blocks, WG_THREADS, smem, st>>>(
        tm_rows, tm_masks, tm_valid, valid != nullptr, 4 * row_words, B, N,
        k, stages, slice_rows, n_slices, bounds, dst);
  }
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return merge_lists(a, static_cast<unsigned long long*>(scratch_b), out,
                     nullptr, B, n_slices, k, st);
}
// The block-table entry. qw (B, d) int32 query words; op (M, rows,
// row_words) 32-bit words (kinds as shortlist_launch); valid (M, rows)
// uint8 (or bool) or null; base (M,) int64 key rows of each block's row 0
// (base + rows <= 2**32); ids (B, p) int64 visited blocks of each query,
// ascending in base. Plan (kernels/shortlist.py::shortlist_blocks_plan):
// warps (1, 2 or 4) of 4 pairs a unit, P keys a list, K-chunks of `chunk`
// words through a ring of `stages`, about `work` cost a unit and at
// most `split` ranges a tile, t_max tile slots (at least ceil(B p / qb) +
// min(M + 1, B p)) and u_max unit slots (at least min(t_max split,
// floor(rows (alpha t_max + 2 B p) / work) + t_max), alpha = row_cost: a
// block of c pairs has ceil(c / qb) tiles whose c' = min(c, qb) pairs sum
// to at most c + qb - 1, so the sum of the units' ceil(rows (alpha + c') /
// work) stays below it). group_scratch: int32, 4 u_max + 2 (M + 1) +
// B p + B + 1 entries (16-byte aligned); bound_scratch: uint64,
// B (1 + SLOTS); scratch_a B * p * split * k keys, scratch_b
// B * ceil(p * split / (MERGE_KEYS / pow2(k))) * k; out_keys (B, k). Requires
// 1 <= k <= min(MAX_K, p * rows). Returns cudaGetLastError() of the first
// failing launch, else 0.
extern "C" int shortlist_blocks_launch(
    const void* qw, const void* op, int kind, int bits, int row_words,
    const void* valid, const void* base, const void* ids, int B, int M,
    int rows, int d, int p, int k, int warps, int P, int chunk, int stages,
    int work, int split, int t_max, int u_max, void* group_scratch,
    void* bound_scratch, void* scratch_a, void* scratch_b, void* out_keys,
    void* stream) {
  const bool mma = kind == kPacked && bits == 8;
  const int qb = warps * QW;
  const long long pairs = (long long)B * p;
  const long long lists = (long long)p * split;
  if (k < 1 || k > MAX_K || B < 1 || B > 65535 || p < 1 || M < 1 ||
      rows < 1 || row_words < 1 || (long long)p * rows < k ||
      !(warps == 1 || warps == 2 || warps == 4) || P < 128 ||
      (P & (P - 1)) != 0 || P / 2 < k || chunk < 8 || chunk % 8 != 0 ||
      chunk > CHUNK_MAX || stages < 2 || stages > 4 || work < 1 ||
      split < 1 || split > (rows + ROWS - 1) / ROWS || split > 0x7FFF ||
      pairs > 0x3FFFFFFFLL || lists * k > 0x7FFFFFFFLL ||
      (long long)t_max < (pairs + qb - 1) / qb + (M + 1 < pairs ? M + 1
                                                                 : pairs) ||
      (long long)u_max <
          std::min((long long)t_max * split,
                   (long long)rows *
                           ((long long)row_cost(row_words) * t_max +
                            2 * pairs) / work + t_max) ||
      blocks_smem(warps, P, row_words, chunk, stages, mma) +
              BLOCKS_STATIC_SMEM > SMEM_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* gs = static_cast<int*>(group_scratch);
  auto* bs = static_cast<unsigned long long*>(bound_scratch);
  Units u;
  u.ids = static_cast<const long long*>(ids);
  u.units = reinterpret_cast<int4*>(gs);
  u.cnt = gs + 4 * (size_t)u_max;
  int* cursor = u.cnt + M + 1;
  u.pairs = cursor + M + 1;
  u.lists_n = u.pairs + pairs;
  u.n_units = u.lists_n + B;
  u.bound = bs;
  u.slots = bs + B;
  shortlist_blocks_group<<<1, GROUP_THREADS, 0, st>>>(
      B, p, M, qb, rows, row_words, work, split, cursor, u);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  auto* a = static_cast<unsigned long long*>(scratch_a);
  auto* out = static_cast<unsigned long long*>(out_keys);
  err = blocks_select_any(
      kind, bits, static_cast<const int*>(qw),
      static_cast<const uint32_t*>(op), row_words,
      static_cast<const uint8_t*>(valid),
      static_cast<const long long*>(base), M, rows, d, p, k, warps, P, chunk,
      stages, work, split, static_cast<int>(lists), u_max,
      lists == 1 ? out : a, u, st);
  if (err != 0) return err;
  return merge_lists(a, static_cast<unsigned long long*>(scratch_b),
                            out, u.lists_n, B, static_cast<int>(lists), k,
                            st);
}
