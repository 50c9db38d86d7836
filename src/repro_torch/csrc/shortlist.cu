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
// What bounds it on an H100: issued instructions and shared-memory
// latency, not bytes. At the main path's shapes (B = 256, N = 65,536,
// d = 48, packed 8-bit fields: 48 int32 words a row) the kernel reads
// >= 12.6 MB of packed operand (~4 us at 3.35 TB/s) and sums
// B * N * d = 805 M fields. Written as a gather, each field costs a load
// of its (word, shift), a load of the word, a shift, a mask and an add;
// here the one-hot query becomes a mask in the operand's own packed layout
// and a row's distance is a dot product of words, 4 fields per __dp4a,
// plus ~8 instructions per (query, row) for the key and its test against
// the running threshold, and the sorts of the candidates.
//
// Design. The TPU kernel walks N sequentially and folds each tile into a
// running top-k buffer; blocks on the GPU run in no order, so this is two
// passes:
//   select: one block per (tile of QW x W queries, slice of rows), W <= 4
//     warps of QW = 4 queries each. The block stages its slice ROWS = 64
//     rows at a time in shared memory (cp.async, 16 bytes where the rows
//     allow it, double-buffered), the row stride a multiple of 4 words with
//     an odd quarter so that 16-byte loads of 32 rows hit every bank group.
//     Lane l of every warp takes rows l and l + 32: one 16-byte load of 4
//     words of each, then for each of the warp's queries one broadcast
//     16-byte load of the query's 4 mask words and the dot products
//     (__dp4a for 4- and 8-bit fields, __dp2a_lo for 16-bit, an integer
//     multiply-add for 32-bit, an exact f32 FMA for bf16 / f32 words). A
//     row longer than the staging room is staged in windows of words, the
//     masks rebuilt per window. Each query keeps, in shared memory, its
//     sorted top-k and a candidate buffer, and in a register the running
//     threshold: the k-th smallest key seen so far. A row whose key is
//     below it is appended to the buffer (__ballot_sync + __popc give each
//     lane its slot); when the buffer would overflow, the warp sorts
//     top-k + buffer (P keys: in registers with __shfl_xor_sync up to 256,
//     bitonic in shared memory above), keeps the first k and tightens the
//     threshold. Only candidates are ever sorted, never the whole slice.
//     Each block writes one sorted top-k per query for its slice to a
//     (B, slices, k) scratch.
//   merge: rounds of one block per (query, group of MERGE_KEYS / k lists)
//     that sort the group's keys and keep the k smallest, until one list
//     remains.
// The operand may be the packed int32 words (4/8/16/32-bit fields,
// column m of a word holds projection columns {w * dp + m}) or the
// unpacked bf16 / f32 projection, all read as 32-bit words. Sums are
// exact in any order (integers below 2**24).
//
// Shared memory per select block (the wrapper's plan, kernels/shortlist.py
// ::shortlist_plan): QW W (P * 8 + mask stride * 4) + 2 * 64 * stride * 4
// bytes, P = max(128, 2 * pow2(k)). On the main path (W = 4, P = 128,
// mask stride 48, stride 52) that is 45 KB: 4 blocks (16 warps) an SM,
// and the plan cuts 32 slices so that the 512 blocks are one wave and one
// merge round. At k = 1,024 (P = 2,048) the plan drops to fewer warps.
//
// The block-table entry (shortlist_blocks_launch) computes the same thing
// for every query over its own list of row blocks: the routed search's
// top-p shards, the pager's device slots, a tenant stack's block. JAX gets
// it from jax.vmap of lut_shortlist_pallas over each query's concatenated
// blocks (src/repro/engine/engine.py:318, _routed_block_search). Inputs: a
// table of M blocks of `rows` rows, key bases base (M,), and visit lists
// ids (B, p); the key of row r of block m is (dist << 32) | (base[m] + r),
// so with ids ascending in base the key order is JAX's (distance, position
// in the concatenation) order. It has kernels of its own, so the one-table
// entry above keeps its code path:
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
//     shared memory to the selection. Other operand kinds keep the
//     CUDA-core dot products of the one-table entry, over K-chunks.
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
// k (1 + ln(R / k)) of a slice's R rows beat the running threshold (~285
// of 2,048 per query on the main path), a few more since the threshold
// tightens only at each sort. The worst case is rows in descending
// distance: every row is a candidate, and the warp sorts P keys for every
// P - k rows. All rows tied is the best case: after the first k rows no
// key is below the threshold. Every order gives the same exact result.

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
constexpr int QW = 4;                // queries per warp
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
// static shared memory of a select block: each query slot's query and list
constexpr int SELECT_STATIC_SMEM = MAX_WARPS * QW * (4 + 8);

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

// Words per staged row: a multiple of 4 (16-byte loads) whose quarter is
// odd, so the 8 lanes of each quarter-warp phase read 8 different 16-byte
// bank groups.
__host__ __device__ __forceinline__ int stage_stride(int window) {
  const int q = (window + 3) / 4;
  return 4 * (q | 1);
}

// Words per query's mask row: the window rounded up to 16 bytes.
__host__ __device__ __forceinline__ int mask_stride(int window) {
  return 4 * ((window + 3) / 4);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Ascending bitonic sort of n (a power of two) keys in shared memory by
// `threads` threads; `sync` is the barrier that orders the stages.
template <typename Sync>
__device__ __forceinline__ void bitonic_sort(unsigned long long* keys, int n,
                                             int tid, int threads,
                                             Sync sync) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < n / 2; i += threads) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const bool asc = (lo & size) == 0;
        const unsigned long long a = keys[lo];
        const unsigned long long b = keys[hi];
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
template <int L>
__device__ __forceinline__ void warp_sort(unsigned long long (&x)[L],
                                          int lane) {
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
            const unsigned long long a = x[i];
            const unsigned long long b = x[i2];
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
          const unsigned long long y = __shfl_xor_sync(FULL, x[i], j);
          const bool asc = ((i * 32 + lane) & size) == 0;
          x[i] = (lower == asc) ? min(x[i], y) : max(x[i], y);
        }
      }
    }
  }
}

template <int L>
__device__ __forceinline__ void warp_sort_smem(unsigned long long* keys,
                                               int lane) {
  unsigned long long x[L];
#pragma unroll
  for (int i = 0; i < L; ++i) x[i] = keys[i * 32 + lane];
  warp_sort<L>(x, lane);
#pragma unroll
  for (int i = 0; i < L; ++i) keys[i * 32 + lane] = x[i];
  __syncwarp();
}

// One warp folds its candidate buffer keys[k, k + count) into its sorted
// top-k keys[0, k): pad the rest of the P slots, sort, keep the first k.
// Up to 256 keys are sorted in registers, more in shared memory.
__device__ __noinline__ void refold(unsigned long long* keys, int k,
                                    int P, int count, int lane) {
  for (int j = k + count + lane; j < P; j += 32) keys[j] = PAD_KEY;
  __syncwarp();
  if (P == 128) {
    warp_sort_smem<4>(keys, lane);
  } else if (P == 256) {
    warp_sort_smem<8>(keys, lane);
  } else {
    bitonic_sort(keys, P, lane, 32, [] { __syncwarp(); });
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

// One table of N rows for every query; block x is (query tile x % q_tiles,
// slice x / q_tiles).
template <int KIND, int BITS>
__global__ void __launch_bounds__(MAX_WARPS * 32)
shortlist_select(const int* __restrict__ qw, const uint32_t* __restrict__ op,
                 int row_words, const uint8_t* __restrict__ valid,
                 int B, int N, int d, int k, int P, int slice_rows,
                 int window, int n_slices,
                 unsigned long long* __restrict__ out) {
  extern __shared__ unsigned long long smem[];
  __shared__ int s_query[MAX_WARPS * QW];        // query of a slot, or -1
  __shared__ long long s_list[MAX_WARPS * QW];   // its list's first key
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int qb = warps * QW;                  // queries per block
  const int mstride = mask_stride(window);
  const int stride = stage_stride(window);
  unsigned long long* keys = smem + warp * QW * P;           // warps*QW*P
  uint32_t* masks = reinterpret_cast<uint32_t*>(smem + qb * P);
  uint32_t* stage = masks + qb * mstride;                    // 2*ROWS*stride

  // the block's rows [n_begin, n_end) and the query and output list of
  // each query slot
  const int q_tiles = (B + qb - 1) / qb;
  const int b0 = (blockIdx.x % q_tiles) * qb;  // query tiles fastest: a
  const int slice = blockIdx.x / q_tiles;      // slice is re-read from L2
  const int n_begin = slice * slice_rows;
  const int n_end = min(N, n_begin + slice_rows);
  for (int qi = threadIdx.x; qi < qb; qi += blockDim.x) {
    const int b = b0 + qi;
    s_query[qi] = b < B ? b : -1;
    s_list[qi] = ((long long)b * n_slices + slice) * k;
  }
  const bool vec = row_words % 4 == 0 && window % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(op) & 15) == 0;

  // zero the staging buffers once: the padding words past a window are
  // never copied, and a float mask word of 0 must not meet a NaN there
  for (int e = threadIdx.x; e < 2 * ROWS * stride; e += blockDim.x) {
    stage[e] = 0u;
  }
  for (int e = lane; e < QW * P; e += 32) keys[e] = PAD_KEY;
  __syncthreads();  // zeros and query slots before the first use

  // masks of words [w0, w0 + window) for the block's queries
  auto build_masks = [&](int w0) {
    for (int e = threadIdx.x; e < qb * mstride; e += blockDim.x) {
      masks[e] = 0u;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < qb * d; e += blockDim.x) {
      const int qi = e / d;
      const int dim = e - qi * d;
      const int b = s_query[qi];
      if (b < 0) continue;
      const int qv = min(max(qw[(size_t)b * d + dim], 0), 3);
      const int col = 4 * dim + qv;
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
      word -= w0;
      if (word >= 0 && word < window) {
        atomicOr(&masks[qi * mstride + word], mask_flag<KIND, BITS>(field));
      }
    }
    __syncthreads();
  };

  const int n_row_tiles = (n_end - n_begin + ROWS - 1) / ROWS;
  const int n_win = (row_words + window - 1) / window;
  const int n_stages = n_row_tiles * n_win;

  // stage s = (tile s / n_win, window s % n_win) into buffer s & 1: each
  // warp copies whole rows, its lanes along the row
  auto issue = [&](int s) {
    const int r0 = n_begin + (s / n_win) * ROWS;
    const int w0 = (s % n_win) * window;
    const int ww = min(window, row_words - w0);
    uint32_t* buf = stage + (s & 1) * ROWS * stride;
    for (int r = warp; r < ROWS && r0 + r < n_end; r += warps) {
      const uint32_t* src = op + (size_t)(r0 + r) * row_words + w0;
      if (vec) {
        for (int j = lane; j < ww / 4; j += 32) {
          cp_async16(buf + r * stride + 4 * j, src + 4 * j);
        }
      } else {
        for (int j = lane; j < ww; j += 32) cp_async4(buf + r * stride + j,
                                                      src + j);
      }
    }
    cp_async_commit();
  };

  const bool active = s_query[warp * QW] >= 0;  // slots fill in order
  bool q_on[QW];
  const int cap = P - k;  // candidate slots per query
  unsigned long long thr[QW];
  int count[QW];
  Acc<KIND> acc[RPL][QW];
#pragma unroll
  for (int q = 0; q < QW; ++q) {
    q_on[q] = s_query[warp * QW + q] >= 0;
    thr[q] = PAD_KEY;
    count[q] = 0;
  }

  if (n_win == 1) build_masks(0);
  if (n_stages > 0) issue(0);
  for (int s = 0; s < n_stages; ++s) {
    if (s + 1 < n_stages) {
      issue(s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int w = s % n_win;
    if (n_win > 1) build_masks(w * window);
    if (active) {
      if (w == 0) {
#pragma unroll
        for (int j = 0; j < RPL; ++j)
#pragma unroll
          for (int q = 0; q < QW; ++q) acc[j][q] = 0;
      }
      // lane l takes rows l and l + 32 of the tile: each mask load (a
      // broadcast) serves RPL rows
      const uint32_t* tile = stage + (s & 1) * ROWS * stride;
      const uint4* mq = reinterpret_cast<const uint4*>(
          masks + warp * QW * mstride);
      const int chunks = (min(window, row_words - w * window) + 3) / 4;
      for (int c = 0; c < chunks; ++c) {
        uint4 v[RPL];
#pragma unroll
        for (int j = 0; j < RPL; ++j) {
          v[j] = reinterpret_cast<const uint4*>(
              tile + (j * 32 + lane) * stride)[c];
        }
#pragma unroll
        for (int q = 0; q < QW; ++q) {
          const uint4 m = mq[q * (mstride / 4) + c];
#pragma unroll
          for (int j = 0; j < RPL; ++j) dot_chunk<KIND, BITS>(acc[j][q], v[j], m);
        }
      }
      if (w == n_win - 1) {
#pragma unroll
        for (int j = 0; j < RPL; ++j) {
          const int n = n_begin + (s / n_win) * ROWS + j * 32 + lane;
          const float pen =
              (valid != nullptr && n < n_end && valid[n] == 0)
                  ? MASK_PENALTY
                  : 0.f;
#pragma unroll
          for (int q = 0; q < QW; ++q) {
            const float dist =
                (KIND == kPacked
                     ? static_cast<float>(static_cast<int>(acc[j][q]))
                     : static_cast<float>(acc[j][q])) + pen;
            const unsigned long long key =
                n < n_end && q_on[q]
                    ? (static_cast<unsigned long long>(__float2uint_rz(dist))
                       << 32) | static_cast<unsigned int>(n)
                    : PAD_KEY;
            bool pass = key < thr[q];
            unsigned m = __ballot_sync(FULL, pass);
            if (m != 0u) {
              unsigned long long* kq = keys + q * P;
              if (count[q] + __popc(m) > cap) {
                refold(kq, k, P, count[q], lane);
                thr[q] = kq[k - 1];
                count[q] = 0;
                pass = key < thr[q];
                m = __ballot_sync(FULL, pass);
              }
              if (pass) {
                kq[k + count[q] + __popc(m & ((1u << lane) - 1u))] = key;
              }
              count[q] += __popc(m);
              __syncwarp();
            }
          }
        }
      }
    }
    __syncthreads();  // the buffer (and masks) are refilled next
  }

  if (active) {
#pragma unroll
    for (int q = 0; q < QW; ++q) {
      unsigned long long* kq = keys + q * P;
      if (count[q] > 0) refold(kq, k, P, count[q], lane);
      if (q_on[q]) {
        unsigned long long* dst = out + s_list[warp * QW + q];
        for (int j = lane; j < k; j += 32) dst[j] = kq[j];
      }
    }
  }
}

// One merge round: lists (B, m_in, k) sorted -> (B, m_out, k) sorted, each
// output list the k smallest keys of `group` consecutive input lists,
// sorted in n (a power of two >= min(group, m_in) * k) keys.
__global__ void __launch_bounds__(MERGE_THREADS)
shortlist_merge(const unsigned long long* __restrict__ in,
                unsigned long long* __restrict__ out, int m_in, int m_out,
                int k, int group, int n) {
  __shared__ unsigned long long keys[MERGE_KEYS];
  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int first = g * group;
  for (int j = threadIdx.x; j < n; j += MERGE_THREADS) {
    const int list = first + j / k;
    keys[j] = (j < group * k && list < m_in)
        ? in[((size_t)b * m_in + list) * k + j % k]
        : PAD_KEY;
  }
  __syncthreads();
  bitonic_sort(keys, n, threadIdx.x, MERGE_THREADS,
               [] { __syncthreads(); });
  unsigned long long* dst = out + ((size_t)b * m_out + g) * k;
  for (int j = threadIdx.x; j < k; j += MERGE_THREADS) dst[j] = keys[j];
}

int select_smem(int warps, int P, int window) {
  return warps * QW * (P * 8 + mask_stride(window) * 4) +
         2 * ROWS * stage_stride(window) * 4;
}

template <int KIND, int BITS>
int launch_select(const int* qw, const uint32_t* op, int row_words,
                  const uint8_t* valid, int B, int N, int d, int k, int warps,
                  int P, int slice_rows, int window, int n_slices,
                  long long grid_tiles, unsigned long long* out,
                  cudaStream_t st) {
  const int smem = select_smem(warps, P, window);
  cudaError_t err = cudaFuncSetAttribute(
      shortlist_select<KIND, BITS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = grid_tiles * n_slices;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  shortlist_select<KIND, BITS>
      <<<static_cast<unsigned>(blocks), warps * 32, smem, st>>>(
          qw, op, row_words, valid, B, N, d, k, P, slice_rows, window,
          n_slices, out);
  return static_cast<int>(cudaGetLastError());
}

int select_any(int kind, int bits, const int* qw, const uint32_t* op,
               int row_words, const uint8_t* valid, int B, int N, int d,
               int k, int warps, int P, int slice_rows, int window,
               int n_slices, long long grid_tiles, unsigned long long* out,
               cudaStream_t st) {
#define SELECT(KIND, BITS)                                                  \
  launch_select<KIND, BITS>(qw, op, row_words, valid, B, N, d, k, warps, P, \
                            slice_rows, window, n_slices, grid_tiles, out,  \
                            st)
  if (kind == kBf16) return SELECT(kBf16, 16);
  if (kind == kF32) return SELECT(kF32, 32);
  if (kind == kPacked && bits == 4) return SELECT(kPacked, 4);
  if (kind == kPacked && bits == 8) return SELECT(kPacked, 8);
  if (kind == kPacked && bits == 16) return SELECT(kPacked, 16);
  if (kind == kPacked && bits == 32) return SELECT(kPacked, 32);
#undef SELECT
  return static_cast<int>(cudaErrorInvalidValue);
}

// Merge rounds: each query's m sorted lists of k keys in `a` -> its k
// smallest in out (B, k), ping-ponging between a and bscr.
int merge_lists(unsigned long long* a, unsigned long long* bscr,
                unsigned long long* out, int B, int m, int k,
                cudaStream_t st) {
  const int group = MERGE_KEYS / k;
  unsigned long long* src = a;
  while (m > 1) {
    const int m_out = (m + group - 1) / group;
    const int lists = group < m ? group : m;
    int n = 1;
    while (n < lists * k) n <<= 1;
    unsigned long long* dst = m_out == 1 ? out : (src == a ? bscr : a);
    shortlist_merge<<<dim3(m_out, B), MERGE_THREADS, 0, st>>>(
        src, dst, m, m_out, k, group, n);
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
    m = m_out;
    src = dst;
  }
  return 0;
}

// The one-table select pass's plan: a merge round folds
// MERGE_KEYS / k >= 2 lists into one, so k <= MAX_K; the select pass needs
// at least 32 candidate slots.
bool plan_ok(int k, int rows, int warps, int slice_rows, int window,
             int row_words, int P) {
  return !(k < 1 || k > MAX_K || warps < 1 || warps > MAX_WARPS ||
           slice_rows < ROWS || slice_rows % ROWS != 0 || window < 1 ||
           window > row_words || rows < 1 || P < k + 32 ||
           (P & (P - 1)) != 0 ||
           select_smem(warps, P, window) + SELECT_STATIC_SMEM > SMEM_MAX);
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
template <int L>
__device__ __forceinline__ void warp_clean(unsigned long long (&x)[L],
                                           int lane) {
#pragma unroll
  for (int j = 16 * L; j > 0; j >>= 1) {
    if (j >= 32) {
#pragma unroll
      for (int i = 0; i < L; ++i) {
        const int i2 = i ^ (j >> 5);
        if (i2 > i) {
          const unsigned long long a = x[i];
          const unsigned long long b = x[i2];
          x[i] = min(a, b);
          x[i2] = max(a, b);
        }
      }
    } else {
      const bool lower = (lane & j) == 0;
#pragma unroll
      for (int i = 0; i < L; ++i) {
        const unsigned long long y = __shfl_xor_sync(FULL, x[i], j);
        x[i] = lower ? min(x[i], y) : max(x[i], y);
      }
    }
  }
}

// keys[0, 32 L) sorted, keys[32 L, 64 L) candidates: sort the candidates,
// take the elementwise minimum with them reversed (a bitonic sequence that
// holds the 32 L smallest of both) and merge it.
template <int L>
__device__ __forceinline__ void fold_regs(unsigned long long* keys,
                                          int lane) {
  unsigned long long x[L], y[L];
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
// keys[0, H): the H smallest of both, sorted, in keys[0, H).
__device__ __noinline__ void fold_half(unsigned long long* keys, int H,
                                       int count, int lane) {
  for (int j = H + count + lane; j < 2 * H; j += 32) keys[j] = PAD_KEY;
  __syncwarp();
  if (H == 64) {
    fold_regs<2>(keys, lane);
  } else if (H == 128) {
    fold_regs<4>(keys, lane);
  } else {
    bitonic_sort(keys, 2 * H, lane, 32, [] { __syncwarp(); });
  }
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

// One merge round of the block-table entry: (B, m_in, k) -> (B, m_out, k),
// each output list the k smallest keys of `group` consecutive input lists,
// over the n_in = ceil(lists_n[b] / div) lists query b has in this round:
// a block past them returns, a block of one list copies it. The lists are
// sorted, so the block merges them pairwise in a tree: each list padded to
// K2 = pow2(k) keys, the elementwise minimum of one with the other reversed
// holds the K2 smallest of both as a bitonic sequence, which log2(K2)
// stages sort.
__global__ void __launch_bounds__(MERGE_THREADS)
shortlist_blocks_merge(const unsigned long long* __restrict__ in,
                       unsigned long long* __restrict__ out,
                       const int* __restrict__ lists_n, int div, int m_in,
                       int m_out, int k, int K2, int group) {
  __shared__ unsigned long long keys[MERGE_KEYS];
  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int n_in = (lists_n[b] + div - 1) / div;
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

// Merge rounds of the block-table entry: each query's lists_n[b] (<= m)
// sorted lists in `a` -> its k smallest in out (B, k), ping-ponging
// between a and bscr.
int blocks_merge_lists(unsigned long long* a, unsigned long long* bscr,
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
    shortlist_blocks_merge<<<dim3(m_out, B), MERGE_THREADS, 0, st>>>(
        src, dst, lists_n, div, m, m_out, k, K2, group);
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
    m = m_out;
    div *= group;
    src = dst;
  }
  return 0;
}

}  // namespace

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The wrapper sizes its merge scratch from this; it checks it at load time.
extern "C" int shortlist_merge_keys() { return MERGE_KEYS; }

// qw (B, d) int32 query words; op (N, row_words) 32-bit words of the
// operand (kind 0 packed int32, 1 bf16 pairs, 2 f32); valid (N,) uint8 or
// null. The plan (qb queries per block, slice_rows, window words, P keys
// per query) comes from kernels/shortlist.py::shortlist_plan. scratch_a
// holds B * slices * k keys, scratch_b B * ceil(slices / (MERGE_KEYS / k))
// * k; out_keys (B, k). Returns cudaGetLastError() of the first failing
// launch, else 0.
extern "C" int shortlist_launch(const void* qw, const void* op, int kind,
                                int bits, int row_words, const void* valid,
                                int B, int N, int d, int k, int warps,
                                int slice_rows, int window, int P,
                                void* scratch_a, void* scratch_b,
                                void* out_keys, void* stream) {
  if (!plan_ok(k, N, warps, slice_rows, window, row_words, P) || k > N) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_slices = (N + slice_rows - 1) / slice_rows;
  auto* a = static_cast<unsigned long long*>(scratch_a);
  auto* out = static_cast<unsigned long long*>(out_keys);
  const int qb = warps * QW;
  const int err = select_any(
      kind, bits, static_cast<const int*>(qw),
      static_cast<const uint32_t*>(op), row_words,
      static_cast<const uint8_t*>(valid), B, N, d, k, warps, P, slice_rows,
      window, n_slices, (B + qb - 1) / qb, n_slices == 1 ? out : a, st);
  if (err != 0) return err;
  return merge_lists(a, static_cast<unsigned long long*>(scratch_b), out, B,
                     n_slices, k, st);
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
  return blocks_merge_lists(a, static_cast<unsigned long long*>(scratch_b),
                            out, u.lists_n, B, static_cast<int>(lists), k,
                            st);
}
