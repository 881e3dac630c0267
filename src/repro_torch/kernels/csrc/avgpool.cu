// Non-overlapping average pooling for Hopper (sm_90a), f32: each output is
// the mean of one ksize x ksize window of an NCHW input, stride ksize, with H
// and W divisible by ksize (the caller checks).
//
// Replaces: src/repro/kernels/avgpool.py::avgpool_pallas (body
// _avgpool_kernel). The TPU kernel hands VMEM a (channel block x whole image)
// tile, pads the channels to the block and reduces with a reshape. A grid over
// outputs needs neither: one thread owns one output element, sums its window
// in f32 row by row, and writes the mean. Nothing is padded or sliced back.
//
// Bound on an H100 SXM: 4 * (1 + 1/ksize^2) bytes per input element (each
// input read once, each output written once) against one add per input, so
// bytes bound it. At the DNN Pooling's preset 4, (128, 256, 32, 32) with
// ksize 2: 167.8 MB / 3.35 TB/s = 0.050 ms.
// What the design does about it: neighbouring threads own neighbouring
// outputs of a row, so their windows tile the input rows contiguously and
// every load and store coalesces. For ksize 2 each thread reads its two rows
// as one float2 each (8-byte loads; a warp covers 256 contiguous bytes per
// row) when the input is 8-byte aligned, which a contiguous NCHW tensor with
// even W is unless it is a view at an odd offset.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

template <int KS>  // KS > 0: the window size at compile time; 0: runtime ks
__global__ void __launch_bounds__(kThreads)
avgpool_kernel(const float* __restrict__ x, float* __restrict__ y, long long total,
               int H, int W, int ks) {
  const long long o = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (o >= total) return;
  const int k = KS > 0 ? KS : ks;
  const int OW = W / k, OH = H / k;
  const int ow = (int)(o % OW);
  const long long t = o / OW;
  const int oh = (int)(t % OH);
  const long long nc = t / OH;
  const float* win = x + nc * H * W + (long long)oh * k * W + (long long)ow * k;
  float acc = 0.f;
  if constexpr (KS == 2) {
    const float2 r0 = *reinterpret_cast<const float2*>(win);
    const float2 r1 = *reinterpret_cast<const float2*>(win + W);
    acc = __fadd_rn(__fadd_rn(__fadd_rn(r0.x, r0.y), r1.x), r1.y);
  } else {
    for (int i = 0; i < k; ++i)
      for (int j = 0; j < k; ++j) acc = __fadd_rn(acc, win[(long long)i * W + j]);
  }
  y[o] = __fdiv_rn(acc, (float)(k * k));
}

}  // namespace

// C entry point (bound with ctypes): x is a contiguous (N, C, H, W) f32 input
// on the device, y a contiguous (N, C, H/ks, W/ks) output. Returns
// cudaGetLastError() after the launch.
extern "C" int avgpool_f32(const void* x, void* y, long long NC, int H, int W, int ks,
                           void* stream) {
  if (ks < 1 || H % ks != 0 || W % ks != 0) return (int)cudaErrorInvalidValue;
  const long long total = NC * (H / ks) * (W / ks);
  if (total == 0) return (int)cudaSuccess;
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  const float* xf = static_cast<const float*>(x);
  float* yf = static_cast<float*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ks == 2 && reinterpret_cast<std::uintptr_t>(xf) % 8 == 0) {
    avgpool_kernel<2><<<blocks, kThreads, 0, st>>>(xf, yf, total, H, W, ks);
  } else {
    avgpool_kernel<0><<<blocks, kThreads, 0, st>>>(xf, yf, total, H, W, ks);
  }
  return (int)cudaGetLastError();
}
