// Mandelbrot escape-time counts for Hopper (sm_90a): the flat per-pixel loop
// and the Mariani-Silver adaptive version with device-side launch (Dynamic
// Parallelism), the paper's §V-B pair.
//
// Counterpart of src/repro/bench/level2/mandelbrot.py::escape_time (:57) and
// ::mariani_silver (:61). No TPU kernel stands behind them: a TPU has no
// device-side launch, so the reference classifies tiles by their border and
// walks every tile through lax.map + cond. Here the classification decides
// on the card which tiles get a child grid.
//
// - mandelbrot_flat_i32 (flat_kernel): one thread a pixel, 256 a block.
// - mandelbrot_dp_i32 (border_kernel + tile_kernel): one parent CTA of 128
//   threads a 32x32 tile, one thread a border pixel (the four edges, the
//   corners twice, as the reference's border). When every border pixel
//   stays in the set for max_iter steps (__syncthreads_and), the CTA fills
//   its tile with max_iter. Otherwise thread 0 launches one child grid over
//   the tile (4 CTAs of 256 threads, one thread a pixel) into
//   cudaStreamFireAndForget. One level of children, as the reference: a
//   deeper recursion fills sub-tiles on a rule the flat count does not
//   promise. Under CUDA 12's device runtime there is no device-side
//   cudaDeviceSynchronize; a parent grid completes only after its children,
//   which is all the host's stream needs. Each launch's status goes into
//   status[0] (the first error) and each child grid counts itself into
//   status[1]; the host reads both (kernels/mandelbrot.py::DpStatus).
//
// Bound: operations. The Workload counts 10 f32 operations an iteration;
// where a pixel escapes early, the work is what this image needs (the sum
// of its counts), not n^2 * max_iter. The loop is a chain of dependent
// operations a pixel, so it runs on issue latency with enough warps to
// hide it; interior tiles cost the adaptive kernel 128 border pixels
// instead of 1024.
//
// Every pixel follows bench/level2/mandelbrot.py::_iterate operation by
// operation: |z| by hypotf (torch.hypot's device function), real = (zr*zr -
// zi*zi) + cr and imag = (zr*zi + zi*zr) + ci, each operation rounded on its
// own (__fmul_rn/__fsub_rn/__fadd_rn: no FMA contraction), so both kernels
// give the plain version's counts bit for bit.
//
// Built with -rdc=true and device-linked against cudadevrt
// (kernels/_build.py).

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;
constexpr int kFlatThreads = 256;
constexpr int kBorderThreads = 4 * kTile;  // one thread a border pixel
constexpr int kChildThreads = 256;
constexpr int kChildBlocks = kTile * kTile / kChildThreads;

__device__ __forceinline__ int escape_count(float cr, float ci, int max_iter) {
  float zr = 0.f, zi = 0.f;
  int n = 0;
  for (; n < max_iter; ++n) {
    if (!(hypotf(zr, zi) <= 2.f)) break;
    const float re = __fadd_rn(__fsub_rn(__fmul_rn(zr, zr), __fmul_rn(zi, zi)), cr);
    const float im = __fadd_rn(__fadd_rn(__fmul_rn(zr, zi), __fmul_rn(zi, zr)), ci);
    zr = re;
    zi = im;
  }
  return n;
}

__global__ void flat_kernel(const float2* __restrict__ c, int* __restrict__ out, long long pixels,
                            int max_iter) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= pixels) return;
  const float2 z = c[i];
  out[i] = escape_count(z.x, z.y, max_iter);
}

// One tile's pixels, launched from the device by border_kernel.
__global__ void tile_kernel(const float2* __restrict__ c, int* __restrict__ out, int n,
                            int max_iter, int x0, int y0) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const long long i = static_cast<long long>(y0 + t / kTile) * n + x0 + t % kTile;
  const float2 z = c[i];
  out[i] = escape_count(z.x, z.y, max_iter);
}

__global__ void __launch_bounds__(kBorderThreads)
border_kernel(const float2* __restrict__ c, int* __restrict__ out, int* status, int n,
              int max_iter) {
  const int tiles_x = n / kTile;
  const int x0 = (blockIdx.x % tiles_x) * kTile, y0 = (blockIdx.x / tiles_x) * kTile;
  const int edge = threadIdx.x / kTile, k = threadIdx.x % kTile;
  const int y = edge == 0 ? y0 : edge == 1 ? y0 + kTile - 1 : y0 + k;
  const int x = edge == 2 ? x0 : edge == 3 ? x0 + kTile - 1 : x0 + k;
  const float2 z = c[static_cast<long long>(y) * n + x];
  const bool inside = escape_count(z.x, z.y, max_iter) == max_iter;
  if (__syncthreads_and(inside)) {
    for (int p = threadIdx.x; p < kTile * kTile; p += kBorderThreads)
      out[static_cast<long long>(y0 + p / kTile) * n + x0 + p % kTile] = max_iter;
  } else if (threadIdx.x == 0) {
    tile_kernel<<<kChildBlocks, kChildThreads, 0, cudaStreamFireAndForget>>>(c, out, n, max_iter,
                                                                            x0, y0);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess)
      atomicCAS(&status[0], 0, static_cast<int>(err));
    else
      atomicAdd(&status[1], 1);
  }
}

}  // namespace

// c: n*n complex64 (float2), row-major; out: n*n int32.
extern "C" int mandelbrot_flat_i32(const void* c, void* out, int n, int max_iter, void* stream) {
  if (n <= 0 || max_iter < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long pixels = static_cast<long long>(n) * n;
  const long long blocks = (pixels + kFlatThreads - 1) / kFlatThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  flat_kernel<<<static_cast<unsigned>(blocks), kFlatThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(static_cast<const float2*>(c),
                                                     static_cast<int*>(out), pixels, max_iter);
  return static_cast<int>(cudaGetLastError());
}

// n % 32 == 0; status: two int32 on the card, status[0] the first failed
// device-side launch's error, status[1] the child grids launched (both
// accumulate across calls).
extern "C" int mandelbrot_dp_i32(const void* c, void* out, void* status, int n, int max_iter,
                                 void* stream) {
  if (n <= 0 || n % kTile || max_iter < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = static_cast<long long>(n / kTile) * (n / kTile);
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  // A child launch holds a slot of the device runtime's launch buffer until
  // its grid starts: room for every tile means no launch fails for lack of
  // one (the default is 2048; a 2048 px image has 4096 tiles).
  size_t pending = 0;
  cudaError_t err = cudaDeviceGetLimit(&pending, cudaLimitDevRuntimePendingLaunchCount);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (pending < static_cast<size_t>(tiles)) {
    err = cudaDeviceSetLimit(cudaLimitDevRuntimePendingLaunchCount, static_cast<size_t>(tiles));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  border_kernel<<<static_cast<unsigned>(tiles), kBorderThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(c), static_cast<int*>(out), static_cast<int*>(status), n,
      max_iter);
  return static_cast<int>(cudaGetLastError());
}
