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
// in the concatenation) order. Inverted lists:
//   group: one block of 1,024 threads counts the (query, visit) pairs of
//     each table block, scans the counts, and lays out a tile table --
//     (table block, first pair, up to QW x W pairs) -- and the pairs
//     grouped by table block (the order inside a group is that of the
//     atomics; each pair still writes its own lists, so the result does not
//     depend on it). An id outside [0, M) goes to an empty virtual block:
//     its lists hold only the all-ones key.
//   select: the same pass as above, one select block per (tile, slice of
//     the table block's rows); it stages the rows once for every query of
//     its tile and writes one sorted list per (query, visit, slice) to the
//     (B, p * slices, k) scratch. A slice shorter than k pads its list
//     with the all-ones key, which the merge drops (k <= p * rows). The
//     grid has a fixed number of tile slots (ceil(B p / qb) + min(M + 1,
//     B p), at least the tiles any mix needs); blocks past the tiles in
//     use return at once, so one launch serves every mix.
//   merge: the same rounds, over each query's p * slices lists.
// The work is B p rows d field sums, and the bytes read the union of the
// visited blocks (each staged once per tile that visits it).
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

// What the block-table entry's select blocks read besides the operand.
struct BlockArgs {
  const int4* tiles;      // (t_max) {table block, first pair, pairs, 0}
  const int* pairs;       // (B p) pair ids b * p + j, grouped by block
  const int* n_tiles;     // tiles in use
  const long long* base;  // (M) key row of each table block's row 0
  int M;                  // table blocks (M: the empty virtual block)
  int p;                  // visits per query
  int t_max;              // tile slots of the grid
};

// BLOCKS = false: one row table of N rows for every query; block x is
// (query tile x % q_tiles, slice x / q_tiles). BLOCKS = true: a table of
// blocks of N rows each, and block x is (tile x % t_max, slice x / t_max)
// of the grouping pass's tile table.
template <int KIND, int BITS, bool BLOCKS>
__global__ void __launch_bounds__(MAX_WARPS * 32)
shortlist_select(const int* __restrict__ qw, const uint32_t* __restrict__ op,
                 int row_words, const uint8_t* __restrict__ valid,
                 int B, int N, int d, int k, int P, int slice_rows,
                 int window, int n_slices,
                 unsigned long long* __restrict__ out, BlockArgs blk) {
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

  // the block's rows [n_begin, n_end) of its table, their key rows
  // key0 + n, and the query and output list of each query slot
  int slice, n_begin, n_end;
  const uint32_t* rows_op = op;
  const uint8_t* rows_valid = valid;
  unsigned key0 = 0u;
  if (BLOCKS) {
    const int t = blockIdx.x % blk.t_max;
    slice = blockIdx.x / blk.t_max;
    if (t >= *blk.n_tiles) return;   // an unused tile slot: the whole block
    const int4 tile = blk.tiles[t];
    const bool real = tile.x < blk.M;
    n_begin = slice * slice_rows;
    n_end = real ? min(N, n_begin + slice_rows) : n_begin;
    if (real) {
      rows_op = op + (size_t)tile.x * N * row_words;
      if (valid != nullptr) rows_valid = valid + (size_t)tile.x * N;
      key0 = static_cast<unsigned>(blk.base[tile.x]);
    }
    const int lists = blk.p * n_slices;
    for (int qi = threadIdx.x; qi < qb; qi += blockDim.x) {
      if (qi < tile.z) {
        const int pair = blk.pairs[tile.y + qi];
        const int b = pair / blk.p;
        s_query[qi] = b;
        s_list[qi] = ((long long)b * lists + (pair - b * blk.p) * n_slices +
                      slice) * k;
      } else {
        s_query[qi] = -1;
      }
    }
  } else {
    const int q_tiles = (B + qb - 1) / qb;
    const int b0 = (blockIdx.x % q_tiles) * qb;  // query tiles fastest: a
    slice = blockIdx.x / q_tiles;                // slice is re-read from L2
    n_begin = slice * slice_rows;
    n_end = min(N, n_begin + slice_rows);
    for (int qi = threadIdx.x; qi < qb; qi += blockDim.x) {
      const int b = b0 + qi;
      s_query[qi] = b < B ? b : -1;
      s_list[qi] = ((long long)b * n_slices + slice) * k;
    }
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
      const uint32_t* src = rows_op + (size_t)(r0 + r) * row_words + w0;
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
              (rows_valid != nullptr && n < n_end && rows_valid[n] == 0)
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
                       << 32) | (key0 + static_cast<unsigned int>(n))
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

// The block-table entry's grouping pass, one block of GROUP_THREADS: the
// (query, visit) pairs of ids (B p,) grouped by table block (an id
// outside [0, M) by the virtual block M), and the tile table of at most
// qb pairs a tile, with its length in *n_tiles. groups (M + 1) is scratch.
__global__ void __launch_bounds__(GROUP_THREADS)
shortlist_group(const int* __restrict__ ids, int pairs_n, int M, int qb,
                int* __restrict__ groups, int4* __restrict__ tiles,
                int* __restrict__ pairs, int* __restrict__ n_tiles) {
  __shared__ int s_pairs[GROUP_THREADS / 32];
  __shared__ int s_tiles[GROUP_THREADS / 32];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int G = M + 1;
  auto group_of = [&](int i) {
    const int m = ids[i];
    return (m < 0 || m >= M) ? M : m;
  };
  for (int g = tid; g < G; g += GROUP_THREADS) groups[g] = 0;
  __syncthreads();
  for (int i = tid; i < pairs_n; i += GROUP_THREADS) {
    atomicAdd(&groups[group_of(i)], 1);
  }
  __syncthreads();
  // thread tid owns groups [g0, g1): its pairs and tiles, then a block
  // exclusive scan of both
  const int per = (G + GROUP_THREADS - 1) / GROUP_THREADS;
  const int g0 = min(G, tid * per);
  const int g1 = min(G, g0 + per);
  int np = 0, nt = 0;
  for (int g = g0; g < g1; ++g) {
    const int c = groups[g];
    np += c;
    nt += (c + qb - 1) / qb;
  }
  int ip = np, it = nt;  // inclusive scans within the warp
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int a = __shfl_up_sync(FULL, ip, off);
    const int b = __shfl_up_sync(FULL, it, off);
    if (lane >= off) {
      ip += a;
      it += b;
    }
  }
  if (lane == 31) {
    s_pairs[warp] = ip;
    s_tiles[warp] = it;
  }
  __syncthreads();
  if (warp == 0) {
    int wp = s_pairs[lane], wt = s_tiles[lane];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int a = __shfl_up_sync(FULL, wp, off);
      const int b = __shfl_up_sync(FULL, wt, off);
      if (lane >= off) {
        wp += a;
        wt += b;
      }
    }
    s_pairs[lane] = wp - s_pairs[lane];  // exclusive, per warp
    s_tiles[lane] = wt - s_tiles[lane];
  }
  __syncthreads();
  int p0 = s_pairs[warp] + ip - np;
  int t0 = s_tiles[warp] + it - nt;
  if (tid == GROUP_THREADS - 1) *n_tiles = t0 + nt;
  for (int g = g0; g < g1; ++g) {
    const int c = groups[g];
    for (int f = 0; f < c; f += qb) {
      tiles[t0++] = make_int4(g, p0 + f, min(qb, c - f), 0);
    }
    groups[g] = p0;  // the group's first pair: its cursor below
    p0 += c;
  }
  __syncthreads();
  for (int i = tid; i < pairs_n; i += GROUP_THREADS) {
    pairs[atomicAdd(&groups[group_of(i)], 1)] = i;
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

template <int KIND, int BITS, bool BLOCKS>
int launch_select(const int* qw, const uint32_t* op, int row_words,
                  const uint8_t* valid, int B, int N, int d, int k, int warps,
                  int P, int slice_rows, int window, int n_slices,
                  long long grid_tiles, unsigned long long* out,
                  const BlockArgs& blk, cudaStream_t st) {
  const int smem = select_smem(warps, P, window);
  cudaError_t err = cudaFuncSetAttribute(
      shortlist_select<KIND, BITS, BLOCKS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = grid_tiles * n_slices;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  shortlist_select<KIND, BITS, BLOCKS>
      <<<static_cast<unsigned>(blocks), warps * 32, smem, st>>>(
          qw, op, row_words, valid, B, N, d, k, P, slice_rows, window,
          n_slices, out, blk);
  return static_cast<int>(cudaGetLastError());
}

template <bool BLOCKS>
int select_any(int kind, int bits, const int* qw, const uint32_t* op,
               int row_words, const uint8_t* valid, int B, int N, int d,
               int k, int warps, int P, int slice_rows, int window,
               int n_slices, long long grid_tiles, unsigned long long* out,
               const BlockArgs& blk, cudaStream_t st) {
#define SELECT(KIND, BITS)                                                  \
  launch_select<KIND, BITS, BLOCKS>(qw, op, row_words, valid, B, N, d, k,  \
                                    warps, P, slice_rows, window, n_slices, \
                                    grid_tiles, out, blk, st)
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

// The select pass's plan, as both entries check it: a merge round folds
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
  const int err = select_any<false>(
      kind, bits, static_cast<const int*>(qw),
      static_cast<const uint32_t*>(op), row_words,
      static_cast<const uint8_t*>(valid), B, N, d, k, warps, P, slice_rows,
      window, n_slices, (B + qb - 1) / qb, n_slices == 1 ? out : a,
      BlockArgs{}, st);
  if (err != 0) return err;
  return merge_lists(a, static_cast<unsigned long long*>(scratch_b), out, B,
                     n_slices, k, st);
}

// The block-table entry. qw (B, d) int32 query words; op (M, rows,
// row_words) 32-bit words (kinds as shortlist_launch); valid (M, rows)
// uint8 or null; base (M,) int64 key rows of each block's row 0 (base + rows
// <= 2**32); ids (B, p) int32 visited blocks of each query, ascending in
// base. Plan (kernels/shortlist.py::shortlist_blocks_plan): warps,
// slice_rows, window, P as shortlist_launch, t_max tile slots (at least
// ceil(B p / qb) + min(M + 1, B p)). group_scratch: int32, 4 t_max + M + 1
// + B p + 1 entries (16-byte aligned); scratch_a B * p * slices * k keys,
// scratch_b B * ceil(p * slices / (MERGE_KEYS / k)) * k; out_keys (B, k).
// Requires 1 <= k <= min(MAX_K, p * rows).
extern "C" int shortlist_blocks_launch(
    const void* qw, const void* op, int kind, int bits, int row_words,
    const void* valid, const void* base, const void* ids, int B, int M,
    int rows, int d, int p, int k, int warps, int slice_rows, int window,
    int P, int t_max, void* group_scratch, void* scratch_a, void* scratch_b,
    void* out_keys, void* stream) {
  const int qb = warps * QW;
  const long long pairs = (long long)B * p;
  if (!plan_ok(k, rows, warps, slice_rows, window, row_words, P) || B < 1 ||
      B > 65535 || p < 1 || M < 1 || (long long)p * rows < k ||
      pairs > 0x3FFFFFFFLL ||
      (long long)t_max < (pairs + qb - 1) / qb + (M + 1 < pairs ? M + 1
                                                                 : pairs)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* gs = static_cast<int*>(group_scratch);
  int4* tiles = reinterpret_cast<int4*>(gs);
  int* groups = gs + 4 * (size_t)t_max;
  int* pair_ids = groups + M + 1;
  int* n_tiles = pair_ids + pairs;
  shortlist_group<<<1, GROUP_THREADS, 0, st>>>(
      static_cast<const int*>(ids), static_cast<int>(pairs), M, qb, groups,
      tiles, pair_ids, n_tiles);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const int n_slices = (rows + slice_rows - 1) / slice_rows;
  const int lists = p * n_slices;
  auto* a = static_cast<unsigned long long*>(scratch_a);
  auto* out = static_cast<unsigned long long*>(out_keys);
  const BlockArgs blk{tiles, pair_ids, n_tiles,
                      static_cast<const long long*>(base), M, p, t_max};
  err = select_any<true>(
      kind, bits, static_cast<const int*>(qw),
      static_cast<const uint32_t*>(op), row_words,
      static_cast<const uint8_t*>(valid), B, rows, d, k, warps, P,
      slice_rows, window, n_slices, t_max, lists == 1 ? out : a, blk, st);
  if (err != 0) return err;
  return merge_lists(a, static_cast<unsigned long long*>(scratch_b), out, B,
                     lists, k, st);
}
