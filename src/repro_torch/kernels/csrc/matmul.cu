// Tiled shared-memory GEMM for Hopper (sm_90a): C = A @ B with f32
// accumulation, C in A's dtype. The kernels here take every layout: they are
// the entries for the operands the TMA kernels cannot read.
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
// so loads and math do not overlap. The operands that TMA can read go to the
// TMA kernels: bf16 to matmul_wgmma.cu (entry matmul_bf16), f32 to
// matmul_f32_tma.cu (entry matmul_f32, batches included). These keep the
// rest: strides that are not multiples of 16 bytes, unaligned bases, a
// column-major B, and (bf16) batches; entries matmul_f32_simt and
// matmul_bf16_wmma.
//
// Batch axis. The reference's Convolution im2col path vmaps the GEMM over
// images (src/repro/bench/dnn/convolution.py:47): one shared (O, C*KH*KW)
// weight times a batch of (C*KH*KW, OH*OW) patch matrices. Here that is the
// grid's third axis: block z computes C[z] = A[z] @ B[z], each operand offset
// by its own batch stride, and a stride of 0 broadcasts an operand (the shared
// weight) to every z. One kernel source serves both: kBatched instantiates it
// with the batch offsets and without them. Held in registers through the main
// loop (the operand pointers are otherwise kernel parameters), the offsets
// slowed the 2-D product at 4096^3 on an H100 from 8.30 to 11.60 ms (f32) and
// from 2.65 to 4.61 ms (bf16), so a 2-D call (or a batch of 1) launches the
// instantiation without them, which compiles to the 2-D kernel as it was.
// At Convolution's preset 4 (256 x 2304 shared, times 64 of 2304 x 900, f32):
// 67.95 GFLOP / 67 TFLOP/s = 1.01 ms against 592 MB / 3.35 TB/s = 0.18 ms, so
// bound by operations like the 2-D f32 product. The shared weight is re-read
// by every image's blocks from L2 (2.4 MB, far below its 50 MB).

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

template <int BM, int BN, bool kBatched>
__global__ void __launch_bounds__((BM / kF32Tm) * (BN / kF32Tn))
sgemm_kernel(const float* __restrict__ A, const float* __restrict__ B,
             float* __restrict__ C, int M, int N, int K, long long sab,
             long long sam, long long sak, long long sbb, long long sbk,
             long long sbn) {
  constexpr int kThreadsN = BN / kF32Tn;
  constexpr int kThreadsM = BM / kF32Tm;
  constexpr int kThreads = kThreadsM * kThreadsN;
  __shared__ float As[kF32Bk][BM];
  __shared__ float Bs[kF32Bk][BN];

  if constexpr (kBatched) {
    // Block z owns batch entry z; a batch stride of 0 broadcasts the operand.
    A += (long long)blockIdx.z * sab;
    B += (long long)blockIdx.z * sbb;
    C += (long long)blockIdx.z * M * N;
  }

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

template <int BM, int BN, bool kBatched>
__global__ void __launch_bounds__(Bf16Tile<BM, BN>::kThreads)
bf16gemm_kernel(const __nv_bfloat16* __restrict__ A,
                const __nv_bfloat16* __restrict__ B, __nv_bfloat16* __restrict__ C,
                int M, int N, int K, long long sab, long long sam, long long sak,
                long long sbb, long long sbk, long long sbn) {
  using T = Bf16Tile<BM, BN>;
  __shared__ __align__(32) __nv_bfloat16 As[BM][kBf16Bk + kPad];
  __shared__ __align__(32) __nv_bfloat16 Bs[kBf16Bk][BN + kPad];
  __shared__ __align__(32) float Cs[T::kWarpsM * T::kWarpsN][16 * 16];

  if constexpr (kBatched) {
    A += (long long)blockIdx.z * sab;
    B += (long long)blockIdx.z * sbb;
    C += (long long)blockIdx.z * M * N;
  }

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
cudaError_t launch_f32(const float* a, const float* b, float* c, int batch, int M,
                       int N, int K, long long sab, long long sam, long long sak,
                       long long sbb, long long sbk, long long sbn,
                       cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, batch);
  const int threads = (BM / kF32Tm) * (BN / kF32Tn);
  if (batch > 1) {
    sgemm_kernel<BM, BN, true><<<grid, threads, 0, stream>>>(a, b, c, M, N, K, sab,
                                                             sam, sak, sbb, sbk, sbn);
  } else {
    sgemm_kernel<BM, BN, false><<<grid, threads, 0, stream>>>(a, b, c, M, N, K, sab,
                                                              sam, sak, sbb, sbk, sbn);
  }
  return cudaGetLastError();
}

template <int BM, int BN>
cudaError_t launch_bf16(const __nv_bfloat16* a, const __nv_bfloat16* b,
                        __nv_bfloat16* c, int batch, int M, int N, int K,
                        long long sab, long long sam, long long sak, long long sbb,
                        long long sbk, long long sbn, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, batch);
  constexpr int kThreads = Bf16Tile<BM, BN>::kThreads;
  if (batch > 1) {
    bf16gemm_kernel<BM, BN, true><<<grid, kThreads, 0, stream>>>(
        a, b, c, M, N, K, sab, sam, sak, sbb, sbk, sbn);
  } else {
    bf16gemm_kernel<BM, BN, false><<<grid, kThreads, 0, stream>>>(
        a, b, c, M, N, K, sab, sam, sak, sbb, sbk, sbn);
  }
  return cudaGetLastError();
}

}  // namespace

// C entry points (bound with ctypes). Pointers are device pointers, strides
// are in elements, C is a contiguous batch x M x N output. A batch stride of 0
// broadcasts that operand; batch 1 is the plain 2-D product. batch is the
// grid's z extent, at most 65535 (the caller checks). Both use 128 x 128
// tiles. Each returns cudaGetLastError() after its launch.

extern "C" int matmul_f32_simt(const void* a, const void* b, void* c, int batch, int M,
                               int N, int K, long long sab, long long sam, long long sak,
                               long long sbb, long long sbk, long long sbn,
                               void* stream) {
  return launch_f32<128, 128>(static_cast<const float*>(a),
                              static_cast<const float*>(b), static_cast<float*>(c),
                              batch, M, N, K, sab, sam, sak, sbb, sbk, sbn,
                              static_cast<cudaStream_t>(stream));
}

extern "C" int matmul_bf16_wmma(const void* a, const void* b, void* c, int batch, int M,
                                int N, int K, long long sab, long long sam, long long sak,
                                long long sbb, long long sbk, long long sbn,
                                void* stream) {
  return launch_bf16<128, 128>(static_cast<const __nv_bfloat16*>(a),
                               static_cast<const __nv_bfloat16*>(b),
                               static_cast<__nv_bfloat16*>(c), batch, M, N, K, sab,
                               sam, sak, sbb, sbk, sbn,
                               static_cast<cudaStream_t>(stream));
}
