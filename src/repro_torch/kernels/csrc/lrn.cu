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
// rounded before it is added, no fused multiply-add), so the window sum is the
// oracle's to the bit and only powf can differ by an ulp or two.
//
// Bound on an H100 SXM: 8 bytes per element (one f32 read, one write) against
// about 2*size+4 operations, so bytes bound it. At the DNN LRN's preset 4,
// (128, 512, 16, 16): 134.2 MB / 3.35 TB/s = 0.040 ms.
// What the design does about it: threads walk neighbouring spatial positions,
// so every load and store is coalesced along S; a block stages the x values of
// its channel chunk plus a halo of size/2 channels on each side in shared
// memory, so each element is read from device memory once per chunk (the halo
// adds 2*(size/2)/kChunkC = 12.5% at size 5, mostly served by L2). An image at
// preset 4 has only S = 256 positions, so one thread per (n, s) walking all
// channels would launch 32768 threads, too few to hide latency on 132 SMs;
// splitting the channels into chunks of kChunkC gives a grid of
// (S/128, C/32, N) = 4096 blocks there.

#include <cuda_runtime.h>

namespace {

constexpr int kBlockS = 128;  // spatial positions per block, one per thread
constexpr int kChunkC = 32;   // output channels per block
constexpr int kMaxHalf = 32;  // size <= 65: the tile stays within 48 KB

__global__ void __launch_bounds__(kBlockS)
lrn_kernel(const float* __restrict__ x, float* __restrict__ y, int C, long long S,
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
    const float denom = powf(__fadd_rn(k, __fmul_rn(alpha, win)), beta);
    y[base + (long long)c * S + s] = __fdiv_rn(col[half * kBlockS], denom);
  }
}

}  // namespace

// C entry point (bound with ctypes): x and y are contiguous (N, C, S) f32 on
// the device, size = 2*half + 1 with half <= 32, N <= 65535 (the grid's z
// extent; the caller checks both). Returns cudaGetLastError() after the launch.
extern "C" int lrn_f32(const void* x, void* y, int N, int C, long long S, int half,
                       float alpha, float beta, float k, void* stream) {
  if (half < 0 || half > kMaxHalf) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((S + kBlockS - 1) / kBlockS),
                  (unsigned)((C + kChunkC - 1) / kChunkC), (unsigned)N);
  const size_t smem = (size_t)(kChunkC + 2 * half) * kBlockS * sizeof(float);
  lrn_kernel<<<grid, kBlockS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y), C, S, half, alpha, beta,
      k);
  return (int)cudaGetLastError();
}
