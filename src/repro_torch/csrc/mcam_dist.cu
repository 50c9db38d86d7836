// Dense AVSS LUT-distance product: out (B, N) f32 = q (B, K) . s (N, K)^T.
//
// Replaces: src/repro/kernels/mcam_dist.py::_matmul_kernel (the Pallas
// MXU matmul behind lut_dist_matmul / ops.avss_ideal_dist), phase 1 of
// two_phase on the pallas/mxu backends below fused_min_rows.
//
// Bound on an H100: bytes. At the main path's shapes (B = 256 one-hot
// queries, N = 65,536 rows, K = 4d = 192) the product does 6.4 GFLOP but
// must write a 67 MB (B, N) f32 matrix and read a 25 MB bf16 operand:
// ~28 us at 3.35 TB/s against ~6.5 us of bf16 tensor-core work.
//
// Design: a shared-memory-tiled SIMT product, 64 x 64 output tile per
// 256-thread block, 4 x 4 outputs per thread, K in steps of 32. Inputs
// (bf16 or f32) are widened to f32 in shared memory and accumulated with
// f32 FMAs, which is exact for the integer-valued LUT operands (sums stay
// below 2**24), so the result equals the reference bit for bit whatever
// the order. Ragged B / N / K edges are zero-filled on load and masked on
// store, with no padding copy. Output stores are coalesced along N, which
// is what the byte bound rewards; wgmma / TMA are left to a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;   // query rows per block
constexpr int BN = 64;   // support rows per block
constexpr int BK = 32;   // depth per shared-memory stage
constexpr int TX = 16;
constexpr int TY = 16;

template <typename T>
__device__ __forceinline__ float widen(T x);

template <>
__device__ __forceinline__ float widen<float>(float x) { return x; }

template <>
__device__ __forceinline__ float widen<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(TX * TY)
lut_dist_kernel(const T* __restrict__ q, const T* __restrict__ s,
                float* __restrict__ out, int B, int N, int K) {
  __shared__ float qs[BM][BK + 1];
  __shared__ float ss[BN][BK + 1];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * TX + tx;
  const int b0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = tid; e < BM * BK; e += TX * TY) {
      const int r = e / BK;
      const int c = e % BK;
      const int gk = k0 + c;
      const int gb = b0 + r;
      const int gn = n0 + r;
      qs[r][c] = (gb < B && gk < K) ? widen(q[(size_t)gb * K + gk]) : 0.f;
      ss[r][c] = (gn < N && gk < K) ? widen(s[(size_t)gn * K + gk]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[ty + TY * i][kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = ss[tx + TX * j][kk];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gb = b0 + ty + TY * i;
    if (gb >= B) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + TX * j;
      if (gn < N) out[(size_t)gb * N + gn] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = bf16, 1 = f32 (both operands). Returns cudaGetLastError().
extern "C" int mcam_dist_launch(const void* q, const void* s, void* out,
                                int B, int N, int K, int dtype,
                                void* stream) {
  const dim3 block(TX, TY);
  const dim3 grid((N + BN - 1) / BN, (B + BM - 1) / BM);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    lut_dist_kernel<__nv_bfloat16><<<grid, block, 0, st>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(s), static_cast<float*>(out), B,
        N, K);
  } else {
    lut_dist_kernel<float><<<grid, block, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(s),
        static_cast<float*>(out), B, N, K);
  }
  return static_cast<int>(cudaGetLastError());
}
