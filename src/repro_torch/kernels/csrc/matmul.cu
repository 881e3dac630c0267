// Tiled shared-memory GEMM for Hopper (sm_90a): C = A @ B with f32
// accumulation, C in A's dtype.
//
// Replaces: src/repro/kernels/matmul.py::matmul_pallas (body _matmul_kernel).
// The TPU kernel walks K as the innermost, sequential grid axis and keeps the
// f32 accumulator in VMEM scratch across those steps. GPU blocks run in no
// order, so here each block owns one BM x BN tile of C and walks K itself in
// BK steps, with the accumulator in registers. The TPU version pads every
// dimension to its block and slices the result back; this kernel masks the
// ragged M/N/K edges itself (zeros are loaded past the edge, stores past the
// edge are dropped), so no padded copy is ever made.
//
// Operands are taken by their row and column strides, so a transposed view
// (the gemm "tn" specs pass a.T) is read in place. The loader walks the
// operand's unit-stride dimension with consecutive threads, so global reads
// stay coalesced for row-major and column-major operands alike.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 tensor core, 67 TFLOP/s f32 without
// tensor cores, 3.35 TB/s HBM3):
//   - 4096^3 bf16: 137.4 GFLOP / 989 TFLOP/s = 0.139 ms against 100.7 MB /
//     3.35 TB/s = 0.030 ms: bound by operations (tensor cores).
//   - 4096^3 f32:  137.4 GFLOP / 67 TFLOP/s = 2.05 ms against 201 MB /
//     3.35 TB/s = 0.060 ms: bound by operations (FP32 FMA pipes). The f32
//     path must stay true f32 (no TF32), so tensor cores are not an option.
//   - small M (e.g. 1 x 256 x 33): a handful of FLOPs per byte, bound by
//     bytes and in practice by launch latency.
// What the design does about it: both paths reuse every shared-memory tile
// across a whole register block (8x8 outputs per thread for f32, 64x32 per
// warp through WMMA bf16 fragments with f32 accumulators), which lifts the
// arithmetic intensity of each tile load far above the card's ridge. It is
// deliberately the simple version: no TMA, no wgmma, no multi-stage pipeline,
// so loads and math do not overlap. Those belong to a later revision.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

// --------------------------------------------------------------------------
// f32: register-blocked SIMT GEMM, every product an f32 FMA.
// --------------------------------------------------------------------------

constexpr int kF32Bk = 8;
constexpr int kF32Tm = 8;  // outputs per thread along M
constexpr int kF32Tn = 8;  // outputs per thread along N

template <int BM, int BN>
__global__ void __launch_bounds__((BM / kF32Tm) * (BN / kF32Tn))
sgemm_kernel(const float* __restrict__ A, const float* __restrict__ B,
             float* __restrict__ C, int M, int N, int K, long long sam,
             long long sak, long long sbk, long long sbn) {
  constexpr int kThreadsN = BN / kF32Tn;
  constexpr int kThreadsM = BM / kF32Tm;
  constexpr int kThreads = kThreadsM * kThreadsN;
  __shared__ float As[kF32Bk][BM];
  __shared__ float Bs[kF32Bk][BN];

  const int tid = threadIdx.x;
  const int tx = tid % kThreadsN;
  const int ty = tid / kThreadsN;
  const long long m0 = (long long)blockIdx.y * BM;
  const long long n0 = (long long)blockIdx.x * BN;
  const bool a_m_unit = (sam == 1);  // column-major A (a transposed view)
  const bool b_n_unit = (sbn == 1);  // row-major B

  float acc[kF32Tm][kF32Tn];
#pragma unroll
  for (int i = 0; i < kF32Tm; ++i)
#pragma unroll
    for (int j = 0; j < kF32Tn; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kF32Bk) {
    for (int e = tid; e < BM * kF32Bk; e += kThreads) {
      const int mm = a_m_unit ? e % BM : e / kF32Bk;
      const int kk = a_m_unit ? e / BM : e % kF32Bk;
      const long long gm = m0 + mm;
      const int gk = k0 + kk;
      As[kk][mm] = (gm < M && gk < K) ? A[gm * sam + gk * sak] : 0.f;
    }
    for (int e = tid; e < BN * kF32Bk; e += kThreads) {
      const int nn = b_n_unit ? e % BN : e / kF32Bk;
      const int kk = b_n_unit ? e / BN : e % kF32Bk;
      const long long gn = n0 + nn;
      const int gk = k0 + kk;
      Bs[kk][nn] = (gn < N && gk < K) ? B[gk * sbk + gn * sbn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kF32Bk; ++kk) {
      float a[kF32Tm], b[kF32Tn];
      // Strided ownership (row ty + i*kThreadsM, column tx + j*kThreadsN):
      // neighbouring threads read neighbouring shared-memory words, so the
      // reads are free of bank conflicts and the stores below coalesce.
#pragma unroll
      for (int i = 0; i < kF32Tm; ++i) a[i] = As[kk][ty + i * kThreadsM];
#pragma unroll
      for (int j = 0; j < kF32Tn; ++j) b[j] = Bs[kk][tx + j * kThreadsN];
#pragma unroll
      for (int i = 0; i < kF32Tm; ++i)
#pragma unroll
        for (int j = 0; j < kF32Tn; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kF32Tm; ++i) {
    const long long gm = m0 + ty + i * kThreadsM;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < kF32Tn; ++j) {
      const long long gn = n0 + tx + j * kThreadsN;
      if (gn < N) C[gm * N + gn] = acc[i][j];
    }
  }
}

// --------------------------------------------------------------------------
// bf16: WMMA tensor-core fragments (bf16 in, f32 accumulate), bf16 out.
// --------------------------------------------------------------------------

namespace wmma = nvcuda::wmma;

constexpr int kBf16Bk = 32;
constexpr int kPad = 8;  // keeps WMMA leading dimensions multiples of 8

template <int BM, int BN>
struct Bf16Tile {
  static constexpr int kWarpsM = 2;
  static constexpr int kWarpsN = BN / 32;
  static constexpr int kThreads = 32 * kWarpsM * kWarpsN;
  static constexpr int kFragM = BM / kWarpsM / 16;  // 16x16 fragments per warp along M
  static constexpr int kFragN = 2;                  // ... along N (32 columns per warp)
};

template <int BM, int BN>
__global__ void __launch_bounds__(Bf16Tile<BM, BN>::kThreads)
bf16gemm_kernel(const __nv_bfloat16* __restrict__ A,
                const __nv_bfloat16* __restrict__ B, __nv_bfloat16* __restrict__ C,
                int M, int N, int K, long long sam, long long sak, long long sbk,
                long long sbn) {
  using T = Bf16Tile<BM, BN>;
  __shared__ __align__(32) __nv_bfloat16 As[BM][kBf16Bk + kPad];
  __shared__ __align__(32) __nv_bfloat16 Bs[kBf16Bk][BN + kPad];
  __shared__ __align__(32) float Cs[T::kWarpsM * T::kWarpsN][16 * 16];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int wm = warp / T::kWarpsN;
  const int wn = warp % T::kWarpsN;
  const long long m0 = (long long)blockIdx.y * BM;
  const long long n0 = (long long)blockIdx.x * BN;
  const bool a_m_unit = (sam == 1);
  const bool b_n_unit = (sbn == 1);
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[T::kFragM][T::kFragN];
#pragma unroll
  for (int i = 0; i < T::kFragM; ++i)
#pragma unroll
    for (int j = 0; j < T::kFragN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += kBf16Bk) {
    for (int e = tid; e < BM * kBf16Bk; e += T::kThreads) {
      const int mm = a_m_unit ? e % BM : e / kBf16Bk;
      const int kk = a_m_unit ? e / BM : e % kBf16Bk;
      const long long gm = m0 + mm;
      const int gk = k0 + kk;
      As[mm][kk] = (gm < M && gk < K) ? A[gm * sam + gk * sak] : zero;
    }
    for (int e = tid; e < BN * kBf16Bk; e += T::kThreads) {
      const int nn = b_n_unit ? e % BN : e / kBf16Bk;
      const int kk = b_n_unit ? e / BN : e % kBf16Bk;
      const long long gn = n0 + nn;
      const int gk = k0 + kk;
      Bs[kk][nn] = (gn < N && gk < K) ? B[gk * sbk + gn * sbn] : zero;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBf16Bk; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>
          af[T::kFragM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>
          bfr[T::kFragN];
#pragma unroll
      for (int i = 0; i < T::kFragM; ++i)
        wmma::load_matrix_sync(af[i], &As[(wm * T::kFragM + i) * 16][kk],
                               kBf16Bk + kPad);
#pragma unroll
      for (int j = 0; j < T::kFragN; ++j)
        wmma::load_matrix_sync(bfr[j], &Bs[kk][(wn * T::kFragN + j) * 16], BN + kPad);
#pragma unroll
      for (int i = 0; i < T::kFragM; ++i)
#pragma unroll
        for (int j = 0; j < T::kFragN; ++j)
          wmma::mma_sync(acc[i][j], af[i], bfr[j], acc[i][j]);
    }
    __syncthreads();
  }

  // Epilogue: each warp stages one 16x16 f32 fragment at a time in its own
  // shared-memory slot, then writes the in-range part as bf16.
  float* stage = Cs[warp];
#pragma unroll
  for (int i = 0; i < T::kFragM; ++i) {
#pragma unroll
    for (int j = 0; j < T::kFragN; ++j) {
      wmma::store_matrix_sync(stage, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const long long r0 = m0 + (wm * T::kFragM + i) * 16;
      const long long c0 = n0 + (wn * T::kFragN + j) * 16;
      for (int e = lane; e < 256; e += 32) {
        const long long gm = r0 + e / 16;
        const long long gn = c0 + e % 16;
        if (gm < M && gn < N) C[gm * N + gn] = __float2bfloat16(stage[e]);
      }
      __syncwarp();
    }
  }
}

template <int BM, int BN>
cudaError_t launch_f32(const float* a, const float* b, float* c, int M, int N,
                       int K, long long sam, long long sak, long long sbk,
                       long long sbn, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const int threads = (BM / kF32Tm) * (BN / kF32Tn);
  sgemm_kernel<BM, BN><<<grid, threads, 0, stream>>>(a, b, c, M, N, K, sam, sak,
                                                     sbk, sbn);
  return cudaGetLastError();
}

template <int BM, int BN>
cudaError_t launch_bf16(const __nv_bfloat16* a, const __nv_bfloat16* b,
                        __nv_bfloat16* c, int M, int N, int K, long long sam,
                        long long sak, long long sbk, long long sbn,
                        cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  bf16gemm_kernel<BM, BN><<<grid, Bf16Tile<BM, BN>::kThreads, 0, stream>>>(
      a, b, c, M, N, K, sam, sak, sbk, sbn);
  return cudaGetLastError();
}

}  // namespace

// C entry points (bound with ctypes). Pointers are device pointers, strides
// are in elements, C is a contiguous M x N output. Both use 128 x 128 tiles.
// Each returns cudaGetLastError() after its launch.

extern "C" int matmul_f32(const void* a, const void* b, void* c, int M, int N,
                          int K, long long sam, long long sak, long long sbk,
                          long long sbn, void* stream) {
  return launch_f32<128, 128>(static_cast<const float*>(a),
                              static_cast<const float*>(b), static_cast<float*>(c),
                              M, N, K, sam, sak, sbk, sbn,
                              static_cast<cudaStream_t>(stream));
}

extern "C" int matmul_bf16(const void* a, const void* b, void* c, int M, int N,
                           int K, long long sam, long long sak, long long sbk,
                           long long sbn, void* stream) {
  return launch_bf16<128, 128>(static_cast<const __nv_bfloat16*>(a),
                               static_cast<const __nv_bfloat16*>(b),
                               static_cast<__nv_bfloat16*>(c), M, N, K, sam, sak,
                               sbk, sbn, static_cast<cudaStream_t>(stream));
}
