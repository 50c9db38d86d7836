// Backward of HAT's episodic MCAM physics: the gradient of the weighted
// straight-through sense-amp votes (and of the summed mismatch) with
// respect to both string grids.
//
// Replaces: no Pallas kernel. The JAX package differentiates the jnp
// physics with jax.grad (repro.engine.engine.RetrievalEngine.episode_votes
// -> repro.core.avss.votes_from_mismatch with mcam.ste_step), which keeps
// the (B, N, seg, L, sl) mismatch grid and several per-cell tensors of the
// same size alive: at the paper's Omniglot episode (B = 800, N = 2,000,
// 64 strings of 24 cells) each is 9.8 GB. This kernel recomputes a
// string's current from the two grids instead of storing anything per
// cell.
//
// Gradient, per (query b, row n, string s of S), w = weights[s]:
//   forward (mcam_physics.cuh, the bits of mcam_search.cu's dense entry):
//     m_c = |q_c - s_c|;  x_c = m_c + sigma_device * dev_c (noisy) or m_c;
//     e_c = exp(clip(x_c, 0, 3) * log rho);  R = sum_c e_c (cells in order);
//     I = sl / R * rf,  rf = 1 + sigma_read * rn (noisy) or 1
//   up    = gv[b, n] * w * sum_t s_t (1 - s_t) / tau,  s_t = sigmoid((I - th_t) / tau)
//   G_c   = up * (-sl / R^2) * rf * log rho * e_c * mask_c + gd[b, n] * w
//   dq[b, s, c] += G_c * sgn(q_c - s_c)    (summed over n)
//   ds[n, s, c] -= G_c * sgn(q_c - s_c)    (summed over b)
// The kinks follow jax.grad's rules, not torch's: sgn is +1 at 0 (the
// gradient of jnp.abs at 0) and mask_c, the gradient of jnp.clip, is 1 in
// (0, 3), 0.5 at 0 and at 3, 0 outside. Noiseless strings are not clipped
// (mask 1), as repro.core.mcam.string_resistance does not clip them.
//
// Bound on an H100: instruction issue, as for the forward: every (b, n,
// string) recomputes the noisy current (two hashes, Box-Muller and exp a
// cell) before its gradient; the grids are a few MB. chip_smoke.py counts
// 57 operations a cell from the formula (the forward's 45, then the clip
// mask, the cell's gradient, its sign and the two sums, and the string's
// sigmoid terms spread over its cells).
//
// Design. The first version recomputed every current twice (one launch
// summed ds over the queries, one dq over the rows) and gave its dq pass
// one thread a (query, string): ~12 warps an SM. Here each (b, n, string)
// current is computed once, and its cell gradients go both ways:
// - A warp owns one string s and a tile of 32 rows (a lane a row) and
//   walks a chunk of at most 128 queries in order. A lane sums ds over its
//   chunk in registers, in query order. Per query, the warp sums the 32
//   rows' dq terms by a fixed reduce-scatter over its lanes (shuffles,
//   no atomics) and writes them to dq_part[tile, b, s, :].
// - ds_part[chunk, n, s, :] holds each chunk's sum. A second launch sums
//   dq_part over the tiles and ds_part over the chunks, each in order.
//   Both workspaces come from the wrapper (torch's allocator): 4 bytes a
//   (row tile, query, cell) and a (query chunk, row, cell), ~400 MB at the
//   paper's episode. Every sum has one order, so a second run gives the
//   same bits.
// - ceil(N / 32) x ceil(B / 128) x S warps (28,224 at the paper's
//   episode), 8 strings of one row tile and query chunk a block of 256
//   threads: the 8 warps read the same gradient words and neighbouring
//   query strings, and the block computes the chunk's noise-hash prefixes
//   (QueryHash) once into shared memory.
// - Strings of 24 cells (the unrolled instance) read a string as three
//   8-byte loads and take four cells' mismatches from one __vabsdiffs4
//   and byte_float, as the forward does; a row's string stays in
//   registers across the queries. The sign of q - s is folded into the
//   cell term; the sigmoid terms use the fast exp and division (the
//   gradient is held to a tolerance, not to the plain version's bits). Any
//   other sl up to MAX_SL, or a grid not on an 8-byte boundary, takes the
//   generic instance: byte loads, a second pass over the cells instead of
//   a register array, ds sums in local memory and a warp sum a cell.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mcam_physics.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;  // strings of a block
constexpr int ROWS = 32;             // rows of a tile: one a lane
constexpr int SPECIALISED_SL = 24;   // kernels/mcam_search.py SPECIALISED_SL
constexpr int MAX_SL = 64;           // kernels/mcam_episode.py MAX_GENERIC_SL
constexpr int MAX_CHUNK = 128;       // kernels/mcam_episode.py QUERY_CHUNK
constexpr int SUM_THREADS = 256;
constexpr unsigned FULL = 0xFFFFFFFFu;

struct Args {
  const int8_t* q;
  const int8_t* s;
  const float* gv;
  const float* gd;
  const float* w;
  const float* th;
  int nth;
  const int64_t* qidx;
  float* dq_part;
  float* ds_part;
  int B, N, S, sl, chunk;
  float tau;
};

// jax.grad of jnp.clip at x: 1 inside (0, 3), 0.5 on a bound, 0 outside.
__device__ __forceinline__ float clip_mask(float x) {
  return (x > 0.f && x < 3.f) ? 1.f : ((x == 0.f || x == 3.f) ? 0.5f : 0.f);
}

// The string's scale of its cell terms e_c * mask_c, given R = r, the
// read factor rf and the upstream gradient of the votes gvw (times w):
// gvw * sum_t s_t (1 - s_t) / tau * (-sl / R^2) * rf * log rho.
__device__ __forceinline__ float cell_scale(float r, float slf, float rf,
                                            float gvw, const float* th,
                                            int nth, float inv_tau,
                                            float tau, const Physics& p) {
  const float cur = __fmul_rn(__fdiv_rn(slf, r), rf);
  float dsig = 0.f;
  for (int k = 0; k < nth; ++k) {
    const float z = (cur - __ldg(th + k)) * inv_tau;
    const float sg = __fdividef(1.f, 1.f + __expf(-z));
    dsig += sg * (1.f - sg);
  }
  return gvw * __fdiv_rn(dsig, tau) * (-__fdiv_rn(slf, r * r)) * rf *
         p.log_rho;
}

// v[0..23] of every lane summed over the warp's 32 lanes, scattered: lane
// l returns the total of cell 12 b4 + 6 b3 + 3 b2 + (l & 3) (b_i: bit i
// of l), valid where (l & 3) < 3. The halving steps (xor 16, 8, 4) keep
// half the cells a lane and add the partner's other half; xor 2 and 1 sum
// the last three in full. One fixed order of additions.
__device__ __forceinline__ float warp_sum_24(float (&v)[SPECIALISED_SL],
                                             int lane) {
#pragma unroll
  for (int j = 0; j < 12; ++j) {
    const bool up = lane & 16;
    const float send = up ? v[j] : v[12 + j];
    const float keep = up ? v[12 + j] : v[j];
    v[j] = keep + __shfl_xor_sync(FULL, send, 16);
  }
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    const bool up = lane & 8;
    const float send = up ? v[j] : v[6 + j];
    const float keep = up ? v[6 + j] : v[j];
    v[j] = keep + __shfl_xor_sync(FULL, send, 8);
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const bool up = lane & 4;
    const float send = up ? v[j] : v[3 + j];
    const float keep = up ? v[3 + j] : v[j];
    v[j] = keep + __shfl_xor_sync(FULL, send, 4);
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    v[j] += __shfl_xor_sync(FULL, v[j], 2);
    v[j] += __shfl_xor_sync(FULL, v[j], 1);
  }
  const int k = lane & 3;
  return k == 0 ? v[0] : (k == 1 ? v[1] : v[2]);
}

__device__ __forceinline__ int warp_sum_24_cell(int lane) {
  return 12 * ((lane >> 4) & 1) + 6 * ((lane >> 3) & 1) +
         3 * ((lane >> 2) & 1) + (lane & 3);
}

// One warp's task: string st, rows tile * 32 + lane, queries [b0, b1).
template <int K, bool NOISY>
__device__ __forceinline__ void task_24(const Args& a, const Physics& p,
                                        const QueryHash* qh, int st,
                                        int tile, int kb, int b0, int b1) {
  constexpr int SL = SPECIALISED_SL;
  const int lane = threadIdx.x & 31;
  const int n = tile * ROWS + lane;
  const bool active = n < a.N;
  const int S = a.S;
  const float slf = static_cast<float>(SL);
  const float inv_tau = 1.f / a.tau;
  const float ws = __ldg(a.w + st);
  const uint32_t sid = static_cast<uint32_t>(n) * static_cast<uint32_t>(S) +
                       static_cast<uint32_t>(st);
  uint2 sw[3] = {{0u, 0u}, {0u, 0u}, {0u, 0u}};
  if (active) {
    const uint2* sp = reinterpret_cast<const uint2*>(
        a.s + ((size_t)n * S + st) * SL);
#pragma unroll
    for (int k = 0; k < 3; ++k) sw[k] = __ldg(sp + k);
  }
  float acc[SL];
#pragma unroll
  for (int c = 0; c < SL; ++c) acc[c] = 0.f;

  for (int b = b0; b < b1; ++b) {
    float t[SL];
    if (active) {
      const size_t pair = (size_t)b * a.N + n;
      const float gvw = __ldg(a.gv + pair) * ws;
      const float g0 = __ldg(a.gd + pair) * ws;
      const uint2* qp = reinterpret_cast<const uint2*>(
          a.q + ((size_t)b * S + st) * SL);
      uint32_t m4[6], ng[6];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const uint2 qw = __ldg(qp + k);
        m4[2 * k] = __vabsdiffs4(qw.x, sw[k].x);
        m4[2 * k + 1] = __vabsdiffs4(qw.y, sw[k].y);
        ng[2 * k] = __vcmpltu4(qw.x, sw[k].x);  // 0xFF where q < s
        ng[2 * k + 1] = __vcmpltu4(qw.y, sw[k].y);
      }
      StringKeys sk{};
      if (NOISY) sk = string_keys<K>(qh[b - b0], sid);
      float r = 0.f;
#pragma unroll
      for (int c = 0; c < SL; ++c) {
        const float m = byte_float(m4[c >> 2], c & 3);
        float e, mask = 1.f;
        if (NOISY) {
          const float x = noisy_exponent(m, cell_key<K>(c), sk, p);
          e = expf(__fmul_rn(clip_mismatch(x), p.log_rho));
          mask = clip_mask(x);
        } else {
          e = expf(__fmul_rn(m, p.log_rho));
        }
        r = c == 0 ? e : __fadd_rn(r, e);
        // e_c * mask_c with the sign of q_c - s_c (-1 where q < s)
        const uint32_t neg = (ng[c >> 2] << (31 - 8 * (c & 3))) & 0x80000000u;
        t[c] = __uint_as_float(__float_as_uint(e * mask) ^ neg);
      }
      const float rf = NOISY ? read_factor(sk, p) : 1.f;
      const float scale = cell_scale(r, slf, rf, gvw, a.th, a.nth, inv_tau,
                                     a.tau, p);
#pragma unroll
      for (int c = 0; c < SL; ++c) {
        // sgn * (scale * e * mask + g0): sgn rides on t[c]'s sign bit
        const float sg0 = __uint_as_float(
            __float_as_uint(g0) ^ (__float_as_uint(t[c]) & 0x80000000u));
        t[c] = __fmaf_rn(scale, t[c], sg0);
        acc[c] += t[c];
      }
    } else {
#pragma unroll
      for (int c = 0; c < SL; ++c) t[c] = 0.f;
    }
    const float v = warp_sum_24(t, lane);
    if ((lane & 3) < 3) {
      a.dq_part[(((size_t)tile * a.B + b) * S + st) * SL +
                warp_sum_24_cell(lane)] = v;
    }
  }
  if (active) {
    float4* dst = reinterpret_cast<float4*>(
        a.ds_part + (((size_t)kb * a.N + n) * S + st) * SL);
#pragma unroll
    for (int k = 0; k < SL / 4; ++k) {
      dst[k] = make_float4(-acc[4 * k], -acc[4 * k + 1], -acc[4 * k + 2],
                           -acc[4 * k + 3]);
    }
  }
}

// The generic instance: any sl <= MAX_SL, any alignment.
template <int K, bool NOISY>
__device__ __forceinline__ void task_any(const Args& a, const Physics& p,
                                         const QueryHash* qh, int st,
                                         int tile, int kb, int b0, int b1) {
  const int lane = threadIdx.x & 31;
  const int n = tile * ROWS + lane;
  const bool active = n < a.N;
  const int S = a.S;
  const int sl = a.sl;
  const float slf = static_cast<float>(sl);
  const float inv_tau = 1.f / a.tau;
  const float ws = __ldg(a.w + st);
  const uint32_t sid = static_cast<uint32_t>(n) * static_cast<uint32_t>(S) +
                       static_cast<uint32_t>(st);
  const int8_t* ss = a.s + ((size_t)(active ? n : 0) * S + st) * sl;
  float acc[MAX_SL];
  for (int c = 0; c < sl; ++c) acc[c] = 0.f;

  for (int b = b0; b < b1; ++b) {
    const int8_t* qs = a.q + ((size_t)b * S + st) * sl;
    StringKeys sk{};
    float scale = 0.f, g0 = 0.f;
    if (active) {
      const size_t pair = (size_t)b * a.N + n;
      if (NOISY) sk = string_keys<K>(qh[b - b0], sid);
      float r = 0.f;
      for (int c = 0; c < sl; ++c) {
        const float m = static_cast<float>(abs(
            static_cast<int>(__ldg(qs + c)) - static_cast<int>(__ldg(ss + c))));
        const float e = cell_term<NOISY>(
            m, cell_key<K>(static_cast<uint32_t>(c)), sk, p);
        r = c == 0 ? e : __fadd_rn(r, e);
      }
      const float rf = NOISY ? read_factor(sk, p) : 1.f;
      scale = cell_scale(r, slf, rf, __ldg(a.gv + pair) * ws, a.th, a.nth,
                         inv_tau, a.tau, p);
      g0 = __ldg(a.gd + pair) * ws;
    }
    for (int c = 0; c < sl; ++c) {
      float t = 0.f;
      if (active) {
        const int d = static_cast<int>(__ldg(qs + c)) -
                      static_cast<int>(__ldg(ss + c));
        const float m = static_cast<float>(abs(d));
        float e, mask = 1.f;
        if (NOISY) {
          const float x = noisy_exponent(
              m, cell_key<K>(static_cast<uint32_t>(c)), sk, p);
          e = expf(__fmul_rn(clip_mismatch(x), p.log_rho));
          mask = clip_mask(x);
        } else {
          e = expf(__fmul_rn(m, p.log_rho));
        }
        t = __fmaf_rn(scale, e * mask, g0);
        if (d < 0) t = -t;
        acc[c] += t;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) t += __shfl_xor_sync(FULL, t, off);
      if (lane == 0) {
        a.dq_part[(((size_t)tile * a.B + b) * S + st) * sl + c] = t;
      }
    }
  }
  if (active) {
    float* dst = a.ds_part + (((size_t)kb * a.N + n) * S + st) * sl;
    for (int c = 0; c < sl; ++c) dst[c] = -acc[c];
  }
}

// blockIdx.x -> (string group of WARPS strings, row tile, query chunk).
// K: 1 with a leading noise stream.
template <int SL, int K, bool NOISY>
__global__ void __launch_bounds__(THREADS, 3)
episode_grad(Args a, Physics p) {
  __shared__ QueryHash qh[MAX_CHUNK];
  const int groups = (a.S + WARPS - 1) / WARPS;
  const int tiles = (a.N + ROWS - 1) / ROWS;
  const int g = static_cast<int>(blockIdx.x % groups);
  const int rest = static_cast<int>(blockIdx.x / groups);
  const int tile = rest % tiles;
  const int kb = rest / tiles;
  const int b0 = kb * a.chunk;
  const int b1 = min(a.B, b0 + a.chunk);
  if (NOISY) {
    for (int i = threadIdx.x; i < b1 - b0; i += THREADS) {
      qh[i] = query_hash<K>(p.seed, p.stream,
                            static_cast<uint32_t>(a.qidx[b0 + i]));
    }
  }
  __syncthreads();
  const int st = g * WARPS + (threadIdx.x >> 5);
  if (st >= a.S) return;  // warp-uniform, after the block's only barrier
  if constexpr (SL == SPECIALISED_SL) {
    task_24<K, NOISY>(a, p, qh, st, tile, kb, b0, b1);
  } else {
    task_any<K, NOISY>(a, p, qh, st, tile, kb, b0, b1);
  }
}

// dq[i] = sum over the row tiles of dq_part, ds[i] = sum over the query
// chunks of ds_part, each in order; one thread an output.
__global__ void __launch_bounds__(SUM_THREADS)
episode_grad_sum(const float* __restrict__ dq_part, int tiles,
                 long long dq_count, float* __restrict__ dq,
                 const float* __restrict__ ds_part, int chunks,
                 long long ds_count, float* __restrict__ ds) {
  const long long i = (long long)blockIdx.x * SUM_THREADS + threadIdx.x;
  const bool is_dq = i < dq_count;
  const long long j = is_dq ? i : i - dq_count;
  if (!is_dq && j >= ds_count) return;
  const float* part = is_dq ? dq_part : ds_part;
  const int parts = is_dq ? tiles : chunks;
  const long long stride = is_dq ? dq_count : ds_count;
  float v = parts > 0 ? __ldg(part + j) : 0.f;
#pragma unroll 4
  for (int k = 1; k < parts; ++k) v += __ldg(part + k * stride + j);
  (is_dq ? dq : ds)[j] = v;
}

template <int SL>
cudaError_t launch_grad(int has_stream, int noisy, const Args& a,
                        const Physics& p, unsigned blocks,
                        cudaStream_t stream) {
  auto kernel = noisy ? (has_stream ? episode_grad<SL, 1, true>
                                    : episode_grad<SL, 0, true>)
                      // noiseless strings draw no noise: no stream
                      : episode_grad<SL, 0, false>;
  kernel<<<blocks, THREADS, 0, stream>>>(a, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q (B, S, sl) int8, s (N, S, sl) int8 (cell values in [0, 3]),
// gv, gd (B, N) f32, w (S,) f32, th (nth,) f32, qidx (B,) int64 ->
// dq (B, S, sl) f32 and ds (N, S, sl) f32. Workspaces: dq_part
// (ceil(N / 32), B, S, sl) f32 and ds_part (ceil(B / chunk), N, S, sl)
// f32, the latter 16-byte aligned; chunk: queries a block walks, 1..128.
// instance: 24 for the unrolled instance (needs sl == 24 and 8-byte
// aligned grids), else 0; sl <= 64. The physics arguments are those of
// mcam_search_dense. Two launches: the gradient, then the sums.
extern "C" int mcam_episode_backward(
    const void* q, const void* s, const void* gv, const void* gd,
    const void* w, const void* th, int nth, const void* qidx, void* dq,
    void* ds, void* dq_part, void* ds_part, int B, int N, int S, int sl,
    int instance, int chunk, int noisy, unsigned seed, float sigma_device,
    float sigma_read, float log_rho, int has_stream, unsigned noise_stream,
    float tau, void* stream) {
  if (sl < 1 || sl > MAX_SL || chunk < 1 || chunk > MAX_CHUNK ||
      (instance != 0 && instance != sl)) {
    return cudaErrorInvalidValue;
  }
  const Physics p{seed, noisy, sigma_device, sigma_read, log_rho,
                  noise_stream};
  const Args a{static_cast<const int8_t*>(q), static_cast<const int8_t*>(s),
               static_cast<const float*>(gv), static_cast<const float*>(gd),
               static_cast<const float*>(w), static_cast<const float*>(th),
               nth, static_cast<const int64_t*>(qidx),
               static_cast<float*>(dq_part), static_cast<float*>(ds_part),
               B, N, S, sl, chunk, tau};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long tiles = ((long long)N + ROWS - 1) / ROWS;
  const long long chunks = ((long long)B + chunk - 1) / chunk;
  const long long blocks =
      ((long long)S + WARPS - 1) / WARPS * tiles * chunks;
  if (blocks > 0) {
    const cudaError_t err =
        instance == SPECIALISED_SL
            ? launch_grad<SPECIALISED_SL>(has_stream, noisy, a, p,
                                          static_cast<unsigned>(blocks), st)
            : launch_grad<0>(has_stream, noisy, a, p,
                             static_cast<unsigned>(blocks), st);
    if (err != cudaSuccess) return err;
  }
  const long long dq_count = (long long)B * S * sl;
  const long long ds_count = (long long)N * S * sl;
  const long long outs = dq_count + ds_count;
  if (outs > 0) {
    episode_grad_sum<<<static_cast<unsigned>((outs + SUM_THREADS - 1) /
                                             SUM_THREADS),
                       SUM_THREADS, 0, st>>>(
        static_cast<const float*>(dq_part), static_cast<int>(tiles),
        dq_count, static_cast<float*>(dq), static_cast<const float*>(ds_part),
        static_cast<int>(chunks), ds_count, static_cast<float*>(ds));
  }
  return static_cast<int>(cudaGetLastError());
}
