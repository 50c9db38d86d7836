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
// Design (right first, not yet fast): two launches with a fixed summation
// order and no atomics, so a second run gives the same bits. One thread
// owns one (row, string) and loops over the B queries in order to sum ds;
// then one thread owns one (query, string) and loops over the N rows to
// sum dq. Each recomputes the current with the forward's device code (the
// same R, summed in the same order), keeps the cell terms e_c * mask_c and
// the gradient sums in registers (24-cell strings: cells unrolled; any
// other sl up to MAX_SL: the same code over local arrays), and reads its
// two strings byte by byte from L1. 128 threads a block.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mcam_physics.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int SPECIALISED_SL = 24;  // the unrolled instance
constexpr int MAX_SL = 64;          // kernels/mcam_episode.py MAX_GENERIC_SL

// OVER_B: out is ds (N, S, sl), summed over the B queries; else dq
// (B, S, sl), summed over the N rows. K: 1 with a leading noise stream.
template <int SL, int K, bool NOISY, bool OVER_B>
__global__ void __launch_bounds__(THREADS)
episode_grad(const int8_t* __restrict__ q, const int8_t* __restrict__ s,
             const float* __restrict__ gv, const float* __restrict__ gd,
             const float* __restrict__ w, const float* __restrict__ th,
             int nth, const int64_t* __restrict__ qidx,
             float* __restrict__ out, int B, int N, int S, int sl, float tau,
             Physics p) {
  constexpr int CAP = SL > 0 ? SL : MAX_SL;
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  const int O = OVER_B ? N : B;
  if (t >= (long long)O * S) return;
  const int o = static_cast<int>(t / S);
  const int st = static_cast<int>(t % S);
  const int len = SL > 0 ? SL : sl;
  const int I = OVER_B ? B : N;
  const float ws = __ldg(w + st);
  const float slf = static_cast<float>(len);

  float acc[CAP];
#pragma unroll
  for (int c = 0; c < CAP; ++c) acc[c] = 0.f;

  for (int i = 0; i < I; ++i) {
    const int b = OVER_B ? i : o;
    const int n = OVER_B ? o : i;
    const int8_t* qs = q + ((size_t)b * S + st) * len;
    const int8_t* ss = s + ((size_t)n * S + st) * len;
    const QueryHash qh =
        query_hash<K>(p.seed, p.stream, static_cast<uint32_t>(qidx[b]));
    const StringKeys sk = string_keys<K>(
        qh, static_cast<uint32_t>(n) * static_cast<uint32_t>(S) +
                static_cast<uint32_t>(st));

    // forward: the cell terms and their sum, as mcam_search.cu computes them
    float ev[CAP];     // e_c * mask_c
    uint64_t neg = 0;  // bit c: q_c < s_c
    float r = 0.f;
#pragma unroll
    for (int c = 0; c < CAP; ++c) {
      if (SL == 0 && c >= len) break;
      const int d = static_cast<int>(__ldg(qs + c)) -
                    static_cast<int>(__ldg(ss + c));
      neg |= static_cast<uint64_t>(d < 0) << c;
      const float m = static_cast<float>(abs(d));
      float me = m;
      float mask = 1.f;
      if (NOISY) {
        const float x = noisy_exponent(m, cell_key<K>(static_cast<uint32_t>(c)),
                                       sk, p);
        me = clip_mismatch(x);
        mask = (x > 0.f && x < 3.f) ? 1.f : ((x == 0.f || x == 3.f) ? 0.5f
                                                                    : 0.f);
      }
      const float e = expf(__fmul_rn(me, p.log_rho));
      r = c == 0 ? e : __fadd_rn(r, e);
      ev[c] = e * mask;
    }
    const float rf = NOISY ? read_factor(sk, p) : 1.f;
    const float cur = NOISY ? __fmul_rn(__fdiv_rn(slf, r), rf)
                            : __fdiv_rn(slf, r);

    // backward
    float dsig = 0.f;
    for (int k = 0; k < nth; ++k) {
      const float z = __fdiv_rn(cur - __ldg(th + k), tau);
      const float sg = __fdiv_rn(1.f, 1.f + expf(-z));
      dsig += sg * (1.f - sg);
    }
    const size_t pair = (size_t)b * N + n;
    const float up = __ldg(gv + pair) * ws * __fdiv_rn(dsig, tau);
    const float a = up * (-__fdiv_rn(slf, r * r)) * rf * p.log_rho;
    const float g0 = __ldg(gd + pair) * ws;
#pragma unroll
    for (int c = 0; c < CAP; ++c) {
      if (SL == 0 && c >= len) break;
      const float gc = a * ev[c] + g0;
      // dq takes +sgn(q - s), ds -sgn(q - s); sgn is -1 where q < s
      const bool minus = ((neg >> c) & 1ull) != (OVER_B ? 1ull : 0ull);
      acc[c] += minus ? -gc : gc;
    }
  }
  float* dst = out + ((size_t)o * S + st) * len;
#pragma unroll
  for (int c = 0; c < CAP; ++c) {
    if (SL == 0 && c >= len) break;
    dst[c] = acc[c];
  }
}

template <int SL, int K, bool NOISY>
cudaError_t launch(const int8_t* q, const int8_t* s, const float* gv,
                   const float* gd, const float* w, const float* th, int nth,
                   const int64_t* qidx, float* dq, float* ds, int B, int N,
                   int S, int sl, float tau, const Physics& p,
                   cudaStream_t stream) {
  if ((long long)N * S > 0) {
    const unsigned blocks =
        static_cast<unsigned>(((long long)N * S + THREADS - 1) / THREADS);
    episode_grad<SL, K, NOISY, true><<<blocks, THREADS, 0, stream>>>(
        q, s, gv, gd, w, th, nth, qidx, ds, B, N, S, sl, tau, p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if ((long long)B * S > 0) {
    const unsigned blocks =
        static_cast<unsigned>(((long long)B * S + THREADS - 1) / THREADS);
    episode_grad<SL, K, NOISY, false><<<blocks, THREADS, 0, stream>>>(
        q, s, gv, gd, w, th, nth, qidx, dq, B, N, S, sl, tau, p);
  }
  return cudaGetLastError();
}

template <int SL>
cudaError_t dispatch(int has_stream, int noisy, const int8_t* q,
                     const int8_t* s, const float* gv, const float* gd,
                     const float* w, const float* th, int nth,
                     const int64_t* qidx, float* dq, float* ds, int B, int N,
                     int S, int sl, float tau, const Physics& p,
                     cudaStream_t stream) {
  if (noisy) {
    return has_stream
        ? launch<SL, 1, true>(q, s, gv, gd, w, th, nth, qidx, dq, ds, B, N,
                              S, sl, tau, p, stream)
        : launch<SL, 0, true>(q, s, gv, gd, w, th, nth, qidx, dq, ds, B, N,
                              S, sl, tau, p, stream);
  }
  // noiseless strings draw no noise, so the stream does not enter
  return launch<SL, 0, false>(q, s, gv, gd, w, th, nth, qidx, dq, ds, B, N,
                              S, sl, tau, p, stream);
}

}  // namespace

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q (B, S, sl) int8, s (N, S, sl) int8 (cell values in [0, 3]),
// gv, gd (B, N) f32, w (S,) f32, th (nth,) f32, qidx (B,) int64 ->
// dq (B, S, sl) f32 and ds (N, S, sl) f32; sl == 24 takes the unrolled
// instance, any other sl <= 64 the generic one. The physics arguments are
// those of mcam_search_dense.
extern "C" int mcam_episode_backward(
    const void* q, const void* s, const void* gv, const void* gd,
    const void* w, const void* th, int nth, const void* qidx, void* dq,
    void* ds, int B, int N, int S, int sl, int noisy, unsigned seed,
    float sigma_device, float sigma_read, float log_rho, int has_stream,
    unsigned noise_stream, float tau, void* stream) {
  if (sl < 1 || sl > MAX_SL) return cudaErrorInvalidValue;
  const Physics p{seed, noisy, sigma_device, sigma_read, log_rho,
                  noise_stream};
  auto fn = sl == SPECIALISED_SL ? dispatch<SPECIALISED_SL> : dispatch<0>;
  return static_cast<int>(fn(
      has_stream, noisy, static_cast<const int8_t*>(q),
      static_cast<const int8_t*>(s), static_cast<const float*>(gv),
      static_cast<const float*>(gd), static_cast<const float*>(w),
      static_cast<const float*>(th), nth, static_cast<const int64_t*>(qidx),
      static_cast<float*>(dq), static_cast<float*>(ds), B, N, S, sl, tau, p,
      static_cast<cudaStream_t>(stream)));
}
