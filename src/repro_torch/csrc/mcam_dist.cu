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
// Design, bf16 operands (the store's projection): one 256-thread block per
// 128 x 128 output tile, two warpgroups of 64 query rows each issuing
// wgmma.mma_async m64n128k16 (f32 += bf16 x bf16) from shared memory. K is
// cut into 64-wide blocks (one 128-byte swizzle row of bf16) held in a
// ring of STAGES shared-memory stages; at K = 192 the whole depth of both
// tiles is in flight at once. Two routes fill the stages, chosen by the
// wrapper from the shapes (never by failure):
//   tma:    K % 8 == 0 and 16-byte aligned operands (a TMA descriptor needs
//           a 16-byte row stride): one thread issues cp.async.bulk.tensor
//           loads with 128-byte swizzle and mbarrier completion; the
//           ragged B / N / K edges are zero-filled by the TMA unit.
//   ragged: any other K (190, or 4d with odd d): every thread loads 16-byte
//           chunks of 8 elements with bounds checks and stores them in the
//           same swizzled layout, then fences the generic proxy against the
//           async one. cp.async's smallest copy is 4 bytes, and a row of
//           odd K starts 2-byte aligned, so this route uses plain loads.
// The epilogue stages the tile in shared memory (padded rows) and writes
// it out with consecutive threads on consecutive columns, coalesced along
// N, since the output write is the bound.
//
// Exactness: the operands are integer-valued (0/1 queries, LUT entries
// < 256 in bf16) and every partial sum stays below 2**24, so f32
// accumulation on the tensor cores is exact in any order and the result
// equals the plain version bit for bit.
//
// f32 operands (long weighted encodings) keep the shared-memory-tiled SIMT
// f32-FMA product: TF32 keeps 10 mantissa bits and would round LUT entries
// above 2**11, so the tensor cores cannot take them exactly.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>

namespace {

// ---------------------------------------------------------------------------
// bf16: wgmma
// ---------------------------------------------------------------------------

constexpr int BM = 128;          // query rows per block (2 warpgroups x 64)
constexpr int BN = 128;          // support rows per block (wgmma n)
constexpr int KB = 64;           // depth per stage: 128 bytes of bf16
constexpr int STAGES = 3;
constexpr int THREADS = 256;
constexpr int A_BYTES = BM * KB * 2;
constexpr int B_BYTES = BN * KB * 2;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int OUT_LD = BN + 4;   // padded f32 row of the staged output tile
constexpr int SMEM_BYTES = 1024 + STAGES * STAGE_BYTES + 64;
static_assert(BM * OUT_LD * 4 <= STAGES * STAGE_BYTES,
              "the output tile is staged in the operand ring");

enum Route { kTma = 0, kRagged = 1, kSimtF32 = 2 };

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// K-major operand in 128-byte swizzle: 8-row groups of 1,024 bytes
// (SBO = 1024), leading offset unused by the swizzled mode (LBO = 16).
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// d[64] += A (64 x 16, desc a) . B (128 x 16, desc b)^T
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a,
                                                 uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// Ragged route: rows [row0, row0 + R) x depth [64 kb, 64 kb + 64) of a
// (rows, K) bf16 matrix into the 128-byte-swizzled stage layout TMA would
// write (16-byte chunk c of row r at r * 128 + ((c ^ (r & 7)) << 4)),
// zero outside the matrix.
template <int R>
__device__ __forceinline__ void fill_stage(uint8_t* dst,
                                           const uint16_t* __restrict__ src,
                                           int rows, int K, int row0,
                                           int kb) {
  for (int e = threadIdx.x; e < R * 8; e += THREADS) {
    const int r = e >> 3;
    const int c = e & 7;
    const int gr = row0 + r;
    const int k0 = kb * KB + c * 8;
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    if (gr < rows) {
      const uint16_t* p = src + (size_t)gr * K;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint32_t v = k0 + j < K ? __ldg(p + k0 + j) : 0u;
        w[j >> 1] |= v << ((j & 1) * 16);
      }
    }
    *reinterpret_cast<uint4*>(dst + r * 128 + ((c ^ (r & 7)) << 4)) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

template <int ROUTE>
__global__ void __launch_bounds__(THREADS)
lut_dist_wgmma(const __grid_constant__ CUtensorMap map_q,
               const __grid_constant__ CUtensorMap map_s,
               const uint16_t* __restrict__ q, const uint16_t* __restrict__ s,
               float* __restrict__ out, int B, int N, int K) {
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1,024 bytes: align the stages to it
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + STAGES * STAGE_BYTES);
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int b_tiles = (B + BM - 1) / BM;
  const int b0 = (blockIdx.x % b_tiles) * BM;  // query tiles fastest: the
  const int n0 = (blockIdx.x / b_tiles) * BN;  // s tile is re-read from L2
  const int nkb = (K + KB - 1) / KB;

  if (ROUTE == kTma && tid == 0) {
    for (int st = 0; st < STAGES; ++st) mbar_init(&full[st], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int kb = 0; kb < nkb && kb < STAGES; ++kb) {
      uint8_t* sa = base + kb * STAGE_BYTES;
      mbar_expect_tx(&full[kb], STAGE_BYTES);
      tma_load_2d(sa, &map_q, &full[kb], kb * KB, b0);
      tma_load_2d(sa + A_BYTES, &map_s, &full[kb], kb * KB, n0);
    }
  }
  __syncthreads();

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  for (int kb = 0; kb < nkb; ++kb) {
    const int st = kb % STAGES;
    uint8_t* sa = base + st * STAGE_BYTES;
    uint8_t* sb = sa + A_BYTES;
    if (ROUTE == kTma) {
      mbar_wait(&full[st], (kb / STAGES) & 1);
    } else {
      fill_stage<BM>(sa, q, B, K, b0, kb);
      fill_stage<BN>(sb, s, N, K, n0, kb);
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      __syncthreads();
    }
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < KB / 16; ++kk) {
      wgmma_m64n128k16(acc, smem_desc(sa + wg * 64 * 128 + kk * 32),
                       smem_desc(sb + kk * 32));
    }
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    __syncthreads();  // both warpgroups are done with this stage
    if (ROUTE == kTma && tid == 0 && kb + STAGES < nkb) {
      mbar_expect_tx(&full[st], STAGE_BYTES);
      tma_load_2d(sa, &map_q, &full[st], (kb + STAGES) * KB, b0);
      tma_load_2d(sb, &map_s, &full[st], (kb + STAGES) * KB, n0);
    }
  }

  // accumulator fragment -> shared tile: thread (warp w, lane l) of a
  // warpgroup holds rows 16 w + l / 4 (+ 8) and column pairs 8 j + 2 (l % 4)
  float* tile = reinterpret_cast<float*>(base);
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    const int r = wg * 64 + warp * 16 + (lane >> 2) + 8 * ((i >> 1) & 1);
    const int c = (i >> 2) * 8 + (lane & 3) * 2;
    *reinterpret_cast<float2*>(tile + r * OUT_LD + c) =
        make_float2(acc[i], acc[i + 1]);
  }
  __syncthreads();
  for (int e = tid; e < BM * BN; e += THREADS) {
    const int r = e / BN;
    const int c = e % BN;
    const int gb = b0 + r;
    const int gn = n0 + c;
    if (gb < B && gn < N) out[(size_t)gb * N + gn] = tile[r * OUT_LD + c];
  }
}

// ---------------------------------------------------------------------------
// f32: SIMT FMA (exact for integer entries < 2**24)
// ---------------------------------------------------------------------------

constexpr int SM_ = 64;   // query rows per block
constexpr int SN_ = 64;   // support rows per block
constexpr int SK_ = 32;   // depth per shared-memory stage
constexpr int TX = 16;
constexpr int TY = 16;

__global__ void __launch_bounds__(TX * TY)
lut_dist_simt(const float* __restrict__ q, const float* __restrict__ s,
              float* __restrict__ out, int B, int N, int K) {
  __shared__ float qs[SM_][SK_ + 1];
  __shared__ float ss[SN_][SK_ + 1];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * TX + tx;
  const int b0 = blockIdx.y * SM_;
  const int n0 = blockIdx.x * SN_;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += SK_) {
    for (int e = tid; e < SM_ * SK_; e += TX * TY) {
      const int r = e / SK_;
      const int c = e % SK_;
      const int gk = k0 + c;
      const int gb = b0 + r;
      const int gn = n0 + r;
      qs[r][c] = (gb < B && gk < K) ? q[(size_t)gb * K + gk] : 0.f;
      ss[r][c] = (gn < N && gk < K) ? s[(size_t)gn * K + gk] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < SK_; ++kk) {
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

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime, so the library needs no
// -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// (rows, K) bf16, row-major: boxes of 64 x box_rows with 128-byte swizzle,
// zero fill out of bounds.
int make_map(CUtensorMap* map, const void* ptr, int rows, int K,
             int box_rows) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K) * 2};
  const cuuint32_t box[2] = {KB, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                         const_cast<void*>(ptr), dims, strides, box, elem,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// route: 0 = bf16 wgmma fed by TMA (K % 8 == 0, 16-byte aligned operands),
// 1 = bf16 wgmma fed by plain loads (any K), 2 = f32 SIMT. The wrapper
// picks it from the shapes (kernels/mcam_dist.py::dist_route). Returns
// cudaGetLastError() of the launch, or the error that prevented it.
extern "C" int mcam_dist_launch(const void* q, const void* s, void* out,
                                int B, int N, int K, int route,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == kSimtF32) {
    const dim3 block(TX, TY);
    const dim3 grid((N + SN_ - 1) / SN_, (B + SM_ - 1) / SM_);
    lut_dist_simt<<<grid, block, 0, st>>>(static_cast<const float*>(q),
                                          static_cast<const float*>(s),
                                          static_cast<float*>(out), B, N, K);
    return static_cast<int>(cudaGetLastError());
  }
  CUtensorMap map_q, map_s;
  auto kernel = lut_dist_wgmma<kRagged>;
  if (route == kTma) {
    if (K % 8 != 0 || (reinterpret_cast<uintptr_t>(q) & 15) ||
        (reinterpret_cast<uintptr_t>(s) & 15)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    int err = make_map(&map_q, q, B, K, BM);
    if (err == 0) err = make_map(&map_s, s, N, K, BN);
    if (err != 0) return err;
    kernel = lut_dist_wgmma<kTma>;
  } else if (route == kRagged) {
    memset(&map_q, 0, sizeof(map_q));
    memset(&map_s, 0, sizeof(map_s));
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles =
      static_cast<long long>((B + BM - 1) / BM) * ((N + BN - 1) / BN);
  if (tiles > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(tiles), THREADS, SMEM_BYTES, st>>>(
      map_q, map_s, static_cast<const uint16_t*>(q),
      static_cast<const uint16_t*>(s), static_cast<float*>(out), B, N, K);
  return static_cast<int>(cudaGetLastError());
}
