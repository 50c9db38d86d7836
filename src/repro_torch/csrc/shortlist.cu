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
// Bound on an H100: operations. At the main path's shapes (B = 256,
// N = 65,536, d = 48, packed 8-bit fields: 48 int32 words a row) the
// kernel must read >= 12.6 MB of packed operand (~4 us at 3.35 TB/s) but
// do B * N * d = 805 M field extractions and adds (~12 us at the f32
// non-tensor rate), plus the selection.
//
// Design. The TPU kernel walks N sequentially and folds each tile into a
// running top-k buffer; blocks on the GPU run in no order, so this is two
// passes:
//   pass 1: one block per (chunk of CHUNK rows, tile of TB queries). It
//     decodes each query word into the (word, shift) of its field once,
//     computes the TB x CHUNK distances into shared memory (each thread
//     owns rows, so a row's words stay in L1 across the TB queries), masks
//     the ragged edge (rows >= N get the all-ones key and sort last),
//     then per query bitonic-sorts the CHUNK keys in shared memory and
//     writes the first k, sorted, to a (B, chunks, k) scratch.
//   pass 2: merge rounds. One block per (query, group of CHUNK / k lists)
//     sorts the group's keys and keeps the k smallest, until one list
//     remains.
// The operand may be the packed int32 words (4/8/16/32-bit fields,
// column m of a word holds projection columns {w * dp + m}) or the
// unpacked bf16 / f32 projection: all three are read as 32-bit words and
// a field is (word >> shift) & mask. Supports k <= 1024.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int CHUNK = 2048;  // rows per pass-1 block; keys per merge block
constexpr int TB = 8;        // queries per pass-1 block
constexpr int MAX_K = CHUNK / 2;
constexpr unsigned long long PAD_KEY = ~0ull;
constexpr float MASK_PENALTY = 4194304.0f;  // 2**22

enum Kind { kPacked = 0, kBf16 = 1, kF32 = 2 };

template <int KIND>
__device__ __forceinline__ float field_value(uint32_t word, int shift,
                                             uint32_t mask) {
  const uint32_t f = (word >> shift) & mask;
  if (KIND == kPacked) return static_cast<float>(static_cast<int>(f));
  if (KIND == kBf16) return __uint_as_float(f << 16);
  return __uint_as_float(f);
}

// Ascending bitonic sort of CHUNK keys in shared memory by the block.
__device__ void bitonic_sort(unsigned long long* keys) {
  for (int size = 2; size <= CHUNK; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < CHUNK / 2; i += THREADS) {
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
      __syncthreads();
    }
  }
}

template <int KIND>
__global__ void __launch_bounds__(THREADS)
shortlist_pass1(const int* __restrict__ qw, const uint32_t* __restrict__ op,
                int row_words, int bits, const uint8_t* __restrict__ valid,
                int B, int N, int d, int k, int n_chunks,
                unsigned long long* __restrict__ out) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* keys = smem;                          // CHUNK
  float* dist = reinterpret_cast<float*>(keys + CHUNK);     // TB * CHUNK
  int* loc = reinterpret_cast<int*>(dist + TB * CHUNK);     // TB * d
  const int chunk = blockIdx.x;
  const int b0 = blockIdx.y * TB;
  const int n0 = chunk * CHUNK;
  const uint32_t mask =
      KIND == kPacked ? (bits == 32 ? 0xFFFFFFFFu : ((1u << bits) - 1u))
                      : (KIND == kBf16 ? 0xFFFFu : 0xFFFFFFFFu);

  // query word -> (word index << 5 | shift) of its LUT field
  for (int e = threadIdx.x; e < TB * d; e += THREADS) {
    const int qi = e / d;
    const int dim = e % d;
    const int b = b0 + qi;
    int qv = b < B ? qw[(size_t)b * d + dim] : 0;
    qv = min(max(qv, 0), 3);
    const int col = 4 * dim + qv;
    int word, shift;
    if (KIND == kPacked) {
      word = col % row_words;
      shift = bits * (col / row_words);
    } else if (KIND == kBf16) {
      word = col >> 1;
      shift = (col & 1) * 16;
    } else {
      word = col;
      shift = 0;
    }
    loc[e] = (word << 5) | shift;
  }
  __syncthreads();

  const int nq = min(TB, B - b0);
  for (int r = threadIdx.x; r < CHUNK; r += THREADS) {
    const int n = n0 + r;
    if (n >= N) continue;
    const uint32_t* row = op + (size_t)n * row_words;
    const float pen = (valid != nullptr && valid[n] == 0) ? MASK_PENALTY : 0.f;
    for (int qi = 0; qi < nq; ++qi) {
      const int* lq = loc + qi * d;
      float acc = 0.f;
      for (int dim = 0; dim < d; ++dim) {
        const int l = lq[dim];
        acc += field_value<KIND>(__ldg(row + (l >> 5)), l & 31, mask);
      }
      dist[qi * CHUNK + r] = acc + pen;
    }
  }
  __syncthreads();

  for (int qi = 0; qi < nq; ++qi) {
    for (int r = threadIdx.x; r < CHUNK; r += THREADS) {
      const int n = n0 + r;
      keys[r] = n < N
          ? (static_cast<unsigned long long>(
                 __float2uint_rz(dist[qi * CHUNK + r])) << 32) |
                static_cast<unsigned int>(n)
          : PAD_KEY;
    }
    __syncthreads();
    bitonic_sort(keys);
    unsigned long long* dst = out + ((size_t)(b0 + qi) * n_chunks + chunk) * k;
    for (int j = threadIdx.x; j < k; j += THREADS) dst[j] = keys[j];
    __syncthreads();
  }
}

// One merge round: lists (B, m_in, k) sorted -> (B, m_out, k) sorted, each
// output list the k smallest keys of `group` consecutive input lists.
__global__ void __launch_bounds__(THREADS)
shortlist_merge(const unsigned long long* __restrict__ in,
                unsigned long long* __restrict__ out, int m_in, int m_out,
                int k, int group) {
  __shared__ unsigned long long keys[CHUNK];
  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int first = g * group;
  for (int j = threadIdx.x; j < CHUNK; j += THREADS) {
    const int list = first + j / k;
    keys[j] = (j < group * k && list < m_in)
        ? in[((size_t)b * m_in + list) * k + j % k]
        : PAD_KEY;
  }
  __syncthreads();
  bitonic_sort(keys);
  unsigned long long* dst = out + ((size_t)b * m_out + g) * k;
  for (int j = threadIdx.x; j < k; j += THREADS) dst[j] = keys[j];
}

template <int KIND>
int launch_pass1(const int* qw, const uint32_t* op, int row_words, int bits,
                 const uint8_t* valid, int B, int N, int d, int k,
                 int n_chunks, unsigned long long* out, cudaStream_t st) {
  const size_t smem = CHUNK * sizeof(unsigned long long) +
                      TB * CHUNK * sizeof(float) + TB * d * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      shortlist_pass1<KIND>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n_chunks, (B + TB - 1) / TB);
  shortlist_pass1<KIND><<<grid, THREADS, smem, st>>>(
      qw, op, row_words, bits, valid, B, N, d, k, n_chunks, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The wrapper sizes its scratch from this; it checks it at load time.
extern "C" int shortlist_chunk_rows() { return CHUNK; }

// qw (B, d) int32 query words; op (N, row_words) 32-bit words of the
// operand (kind 0 packed int32, 1 bf16 pairs, 2 f32); valid (N,) uint8 or
// null. scratch_a holds B * ceil(N / CHUNK) * k keys, scratch_b
// B * ceil(ceil(N / CHUNK) / (CHUNK / k)) * k; out_keys (B, k).
// Returns cudaGetLastError() of the first failing launch, else 0.
extern "C" int shortlist_launch(const void* qw, const void* op, int kind,
                                int bits, int row_words, const void* valid,
                                int B, int N, int d, int k, void* scratch_a,
                                void* scratch_b, void* out_keys,
                                void* stream) {
  // a merge round folds CHUNK / k >= 2 lists into one, so k <= MAX_K
  if (k < 1 || k > MAX_K || k > N) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_chunks = (N + CHUNK - 1) / CHUNK;
  auto* a = static_cast<unsigned long long*>(scratch_a);
  auto* bscr = static_cast<unsigned long long*>(scratch_b);
  auto* out = static_cast<unsigned long long*>(out_keys);
  unsigned long long* first = n_chunks == 1 ? out : a;
  const int* q = static_cast<const int*>(qw);
  const uint32_t* w = static_cast<const uint32_t*>(op);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  int err;
  if (kind == kPacked) {
    err = launch_pass1<kPacked>(q, w, row_words, bits, v, B, N, d, k,
                                n_chunks, first, st);
  } else if (kind == kBf16) {
    err = launch_pass1<kBf16>(q, w, row_words, bits, v, B, N, d, k,
                              n_chunks, first, st);
  } else {
    err = launch_pass1<kF32>(q, w, row_words, bits, v, B, N, d, k, n_chunks,
                             first, st);
  }
  if (err != 0) return err;
  const int group = CHUNK / k;
  int m = n_chunks;
  unsigned long long* src = a;
  while (m > 1) {
    const int m_out = (m + group - 1) / group;
    unsigned long long* dst = m_out == 1 ? out : (src == a ? bscr : a);
    shortlist_merge<<<dim3(m_out, B), THREADS, 0, st>>>(src, dst, m, m_out,
                                                        k, group);
    err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
    m = m_out;
    src = dst;
  }
  return 0;
}
