// Cross-channel local response normalisation for Hopper (sm_90a), f32:
//   y[n,c,s] = x[n,c,s] / (k + alpha * sum_{|j-c| <= size/2} x[n,j,s]^2)^beta
// over NCHW with the spatial axes flattened to S = H*W and zeros past the
// channel edges (AlexNet's LRN, paper eq. 3; alpha is not divided by size).
//
// Replaces: src/repro/kernels/lrn.py::lrn_pallas (body _lrn_kernel). The TPU
// kernel turns the window sum into a (C x C) band-matrix product on the MXU,
// a TPU idiom that spends 2*C multiply-adds per element to do size adds' worth
// of work. Here each output sums its own window of `size` squares, in the
// oracle's order (kernels/ref.py::lrn_ref: channel c-size/2 first, each square
// rounded before it is added, no fused multiply-add, no running window sum),
// so the window sum is the oracle's to the bit. The power is where the two
// kernels differ: lrn_f32 takes it as 2^(-beta * log2 d) and multiplies,
// within a few ulp of the oracle's pow and division (kernels/lrn.py::
// lrn_model is that arithmetic in PyTorch); lrn_f32_smem keeps powf and a
// division, as the oracle writes it.
//
// Bound on an H100 SXM: 8 bytes per element (one f32 read, one write) against
// about 2*size+4 operations, so bytes bound it. At the DNN LRN's preset 4,
// (128, 512, 16, 16): 134.2 MB / 3.35 TB/s = 0.040 ms. What counts is bytes in
// flight and the instructions spent per byte.
//
// Two kernels, one C entry point each; kernels/lrn.py::_route picks the entry
// from size, S and the base address:
//
// - lrn_f32 (ring_kernel): sizes 3 and 5 (a template over size/2), S a
//   multiple of 4 and a 16-byte aligned base. Each thread owns four
//   neighbouring spatial positions (one float4) of one image and walks a chunk
//   of kChunk output channels plus a halo of size/2 channels on each side.
//   The channel loop is unrolled whole, so its rings are registers and the
//   compiler issues the chunk's loads ahead of their use: the last `size`
//   squares stay in one ring and the last size/2 + 1 values in another; each
//   output sums its own window from the ring in the oracle's order.
//   Neighbouring threads take neighbouring float4s, so each warp reads and
//   writes 512 contiguous bytes a channel, with the evict-first hint (each
//   element is read once, its halo copy by the neighbouring chunk's block,
//   mostly from L2: 2*(size/2)/kChunk = 12.5% at size 5).
// - lrn_f32_smem (smem_kernel, the first design of this port): every other
//   odd size up to 65 and any S. Threads walk neighbouring spatial positions,
//   one each; a block stages its 32-channel chunk plus the halo in shared
//   memory with scalar loads, then each output sums its window from there.
//
// Tried on the way, at preset 4, size 5 (throwaway builds timed side by side
// on one card): the ring kernel with powf and a division ran 1.8x slower
// than with exp2f/log2f, so the power's issue time, not the loads, held it;
// then, with exp2f, an explicit lookahead of 2, 3, 4 or 8 float4 loads, 8,
// 16, 24 or 64 channels a thread, 64 or 256 threads a block, or more blocks
// an SM were each as fast or slower than one load ahead, 32 channels and 128
// threads.

#include <cuda_runtime.h>

namespace {

// ------------------------------------------------- the register-ring kernel

constexpr int kRingThreads = 128;  // float4 columns per block
constexpr int kChunk = 32;         // output channels per thread

__device__ __forceinline__ float4 square(float4 v) {
  return make_float4(__fmul_rn(v.x, v.x), __fmul_rn(v.y, v.y), __fmul_rn(v.z, v.z),
                     __fmul_rn(v.w, v.w));
}

__device__ __forceinline__ float4 add(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}

// x * d^-beta with d = k + alpha*win, as x * 2^(-beta * log2 d): log2f and
// exp2f (1 and 2 ulp) and two multiplies in place of powf and a division,
// which at a few dozen instructions an output cost more issue time than the
// loads take.
__device__ __forceinline__ float norm_exp2(float v, float win, float alpha, float beta,
                                           float k) {
  const float d = __fadd_rn(k, __fmul_rn(alpha, win));
  return __fmul_rn(v, exp2f(__fmul_rn(-beta, log2f(d))));
}

// The same as the oracle writes it, x / d^beta.
__device__ __forceinline__ float norm_pow(float v, float win, float alpha, float beta,
                                          float k) {
  return __fdiv_rn(v, powf(__fadd_rn(k, __fmul_rn(alpha, win)), beta));
}

template <int HALF>
__global__ void __launch_bounds__(kRingThreads, 8)
ring_kernel(const float4* __restrict__ x, float4* __restrict__ y, int C, int S4,
            long long cols, float alpha, float beta, float k) {
  constexpr int W = 2 * HALF + 1;  // the window
  constexpr int R = kChunk + 2 * HALF;  // channels a thread loads
  const long long col = (long long)blockIdx.x * kRingThreads + threadIdx.x;
  if (col >= cols) return;
  const long long n = col / S4;
  const int s4 = (int)(col - n * S4);
  const long long plane = (long long)C * S4;
  const float4* xc = x + n * plane + s4;  // channel 0 of this column
  float4* yc = y + n * plane + s4;
  const int c0 = blockIdx.y * kChunk;

  // Load r holds channel c0 - HALF + r (zero past either edge).
  auto load = [&](int r) {
    const int ch = c0 - HALF + r;
    return (ch >= 0 && ch < C) ? __ldcs(xc + (long long)ch * S4)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
  };
  float4 next = load(0);
  float4 sq[W];         // squares of loads r-2*HALF .. r
  float4 val[HALF + 1];  // values of loads r-HALF .. r
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float4 v = next;
    if (r + 1 < R) next = load(r + 1);
    sq[r % W] = square(v);
    val[r % (HALF + 1)] = v;
    const int c = c0 + r - 2 * HALF;  // the output whose window just closed
    if (r >= 2 * HALF && c < C) {
      // Channels c-HALF .. c+HALF are loads r-2*HALF .. r, summed in that
      // order from the first square (the oracle's 0 + sq is sq).
      float4 win = sq[(r - 2 * HALF) % W];
#pragma unroll
      for (int j = 1; j < W; ++j) win = add(win, sq[(r - 2 * HALF + j) % W]);
      const float4 xv = val[(r - HALF) % (HALF + 1)];
      __stcs(yc + (long long)c * S4, make_float4(norm_exp2(xv.x, win.x, alpha, beta, k),
                                                 norm_exp2(xv.y, win.y, alpha, beta, k),
                                                 norm_exp2(xv.z, win.z, alpha, beta, k),
                                                 norm_exp2(xv.w, win.w, alpha, beta, k)));
    }
  }
}

template <int HALF>
cudaError_t launch_ring(const float* x, float* y, int N, int C, long long S, float alpha,
                        float beta, float k, cudaStream_t stream) {
  const long long cols = (long long)N * (S / 4);
  const dim3 grid((unsigned)((cols + kRingThreads - 1) / kRingThreads),
                  (unsigned)((C + kChunk - 1) / kChunk));
  ring_kernel<HALF><<<grid, kRingThreads, 0, stream>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(y), C, (int)(S / 4),
      cols, alpha, beta, k);
  return cudaGetLastError();
}

// --------------------------------------------- the shared-memory kernel

constexpr int kBlockS = 128;  // spatial positions per block, one per thread
constexpr int kChunkC = 32;   // output channels per block
constexpr int kMaxHalf = 32;  // size <= 65: the tile stays within 48 KB

__global__ void __launch_bounds__(kBlockS)
smem_kernel(const float* __restrict__ x, float* __restrict__ y, int C, long long S,
            int half, float alpha, float beta, float k) {
  extern __shared__ float tile[];  // (kChunkC + 2*half) rows of kBlockS
  const int tid = threadIdx.x;
  const long long s = (long long)blockIdx.x * kBlockS + tid;
  const int c0 = blockIdx.y * kChunkC;
  const int c1 = min(c0 + kChunkC, C);
  const long long base = (long long)blockIdx.z * C * S;
  const int rows = (c1 - c0) + 2 * half;

  // Row r holds channel c0 - half + r. Each thread stages and later reads its
  // own column only, so the tile needs no barrier.
  for (int r = 0; r < rows; ++r) {
    const int ch = c0 - half + r;
    tile[r * kBlockS + tid] =
        (s < S && ch >= 0 && ch < C) ? x[base + (long long)ch * S + s] : 0.f;
  }
  if (s >= S) return;
  const int size = 2 * half + 1;
  for (int c = c0; c < c1; ++c) {
    const float* col = tile + (c - c0) * kBlockS + tid;  // row of channel c - half
    float win = 0.f;
    for (int j = 0; j < size; ++j) {
      const float v = col[j * kBlockS];
      win = __fadd_rn(win, __fmul_rn(v, v));
    }
    y[base + (long long)c * S + s] = norm_pow(col[half * kBlockS], win, alpha, beta, k);
  }
}

}  // namespace

// C entry points (bound with ctypes): x and y are contiguous (N, C, S) f32 on
// the device, size = 2*half + 1. Each returns cudaGetLastError() after its
// launch, or cudaErrorInvalidValue, launching nothing, for what it does not
// take. lrn_f32: half 1 or 2, S % 4 == 0, both bases 16-byte aligned, C <=
// 65535 * 32 (the grid's y extent). lrn_f32_smem: half <= 32 and N <= 65535
// (the grid's z extent; the caller checks N and C).

extern "C" int lrn_f32(const void* x, void* y, int N, int C, long long S, int half,
                       float alpha, float beta, float k, void* stream) {
  if (S % 4 || reinterpret_cast<unsigned long long>(x) % 16 ||
      reinterpret_cast<unsigned long long>(y) % 16)
    return (int)cudaErrorInvalidValue;
  const auto xf = static_cast<const float*>(x);
  const auto yf = static_cast<float*>(y);
  const auto s = static_cast<cudaStream_t>(stream);
  if (half == 1) return (int)launch_ring<1>(xf, yf, N, C, S, alpha, beta, k, s);
  if (half == 2) return (int)launch_ring<2>(xf, yf, N, C, S, alpha, beta, k, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int lrn_f32_smem(const void* x, void* y, int N, int C, long long S, int half,
                            float alpha, float beta, float k, void* stream) {
  if (half < 0 || half > kMaxHalf) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((S + kBlockS - 1) / kBlockS),
                  (unsigned)((C + kChunkC - 1) / kChunkC), (unsigned)N);
  const size_t smem = (size_t)(kChunkC + 2 * half) * kBlockS * sizeof(float);
  smem_kernel<<<grid, kBlockS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y), C, S, half, alpha, beta, k);
  return (int)cudaGetLastError();
}
