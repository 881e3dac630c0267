// Row softmax over the last axis for Hopper (sm_90a), f32 inside, output in
// the input's dtype.
//
// Replaces: src/repro/kernels/softmax.py::softmax_pallas (body
// _softmax_kernel). The TPU kernel tiles rows over the grid and walks column
// chunks in VMEM twice: pass 1 keeps an online max and sum of exponentials,
// pass 2 writes exp(x - m) / l. Here one block owns one row. Pass 1 reads the
// row from device memory once, keeps each thread's online (max, sum) pair in
// registers, and, when the row fits, parks the values in shared memory. A
// warp-shuffle and then a cross-warp reduction merge the pairs. Pass 2 reads
// the row back from shared memory (or from device memory when it did not
// fit) and writes the normalised values. Columns past C are never touched:
// the strided loop stops at C, which is what the reference's -1e30 mask
// amounts to. The reference's constants are kept: the running max starts at
// -1e30 and the normaliser is 1 / max(l, 1e-30).
//
// Bound on an H100 SXM: 5 FLOP and 8 bytes per f32 element (one read, one
// write). At 32768 x 16384 f32 that is 4.3 GB / 3.35 TB/s = 1.28 ms against
// 2.7 GFLOP, so the kernel is bound by bytes. What the design does about it:
// every element crosses HBM exactly once each way (the second pass reads
// shared memory, not HBM, whenever C * 4 bytes fits the per-block budget),
// and the online update spends one exponential per element in the common
// case (the running sum is rescaled only when the max grows).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
// Rows up to this many bytes (as f32) are cached in dynamic shared memory for
// the second pass; 96 KB leaves room for two blocks on one SM.
constexpr int kSmemRowBytes = 96 * 1024;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f32(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16(v);
}

// Merge two online-softmax states (m, l) into (m, l).
__device__ __forceinline__ void merge(float& m, float& l, float mo, float lo) {
  const float mn = fmaxf(m, mo);
  l = l * expf(m - mn) + lo * expf(mo - mn);
  m = mn;
}

template <typename T>
__global__ void softmax_kernel(const T* __restrict__ x, T* __restrict__ y, int C,
                               long long ldx, long long ldy, int cache_row) {
  extern __shared__ float row[];
  __shared__ float red_m[32];
  __shared__ float red_l[32];

  const T* xr = x + (long long)blockIdx.x * ldx;
  T* yr = y + (long long)blockIdx.x * ldy;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int n_warps = blockDim.x / 32;

  // Pass 1: online max and sum of exponentials, f32.
  float m = kNegInf, l = 0.f;
  for (int c = tid; c < C; c += blockDim.x) {
    const float v = to_f32(xr[c]);
    if (cache_row) row[c] = v;
    if (v > m) {
      l = l * expf(m - v) + 1.f;
      m = v;
    } else {
      l += expf(v - m);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    merge(m, l, __shfl_xor_sync(kFull, m, off), __shfl_xor_sync(kFull, l, off));
  if (lane == 0) {
    red_m[warp] = m;
    red_l[warp] = l;
  }
  __syncthreads();
  if (warp == 0) {
    m = lane < n_warps ? red_m[lane] : kNegInf;
    l = lane < n_warps ? red_l[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      merge(m, l, __shfl_xor_sync(kFull, m, off), __shfl_xor_sync(kFull, l, off));
    if (lane == 0) {
      red_m[0] = m;
      red_l[0] = l;
    }
  }
  __syncthreads();
  m = red_m[0];
  const float inv = 1.f / fmaxf(red_l[0], 1e-30f);

  // Pass 2: each thread reads back the columns it cached itself, so the
  // shared-memory row needs no barrier of its own.
  for (int c = tid; c < C; c += blockDim.x) {
    const float v = cache_row ? row[c] : to_f32(xr[c]);
    from_f32(expf(v - m) * inv, &yr[c]);
  }
}

template <typename T>
cudaError_t launch(const void* x, void* y, int R, int C, long long ldx,
                   long long ldy, cudaStream_t stream) {
  // Set on every launch: the attribute is per device, and the call is a
  // cheap host-side update.
  const cudaError_t err = cudaFuncSetAttribute(
      softmax_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemRowBytes);
  if (err != cudaSuccess) return err;
  const long long row_bytes = (long long)C * sizeof(float);
  const int cache_row = row_bytes <= kSmemRowBytes ? 1 : 0;
  int threads = ((C + 31) / 32) * 32;
  if (threads > 512) threads = 512;
  softmax_kernel<T><<<R, threads, cache_row ? (size_t)row_bytes : 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), C, ldx, ldy, cache_row);
  return cudaGetLastError();
}

}  // namespace

// C entry points (bound with ctypes): x is R rows of C columns with row
// stride ldx and unit column stride; y likewise with ldy. Each returns
// cudaGetLastError() after its launch.

extern "C" int softmax_f32(const void* x, void* y, int R, int C, long long ldx,
                           long long ldy, void* stream) {
  return launch<float>(x, y, R, C, ldx, ldy, static_cast<cudaStream_t>(stream));
}

extern "C" int softmax_bf16(const void* x, void* y, int R, int C, long long ldx,
                            long long ldy, void* stream) {
  return launch<__nv_bfloat16>(x, y, R, C, ldx, ldy,
                               static_cast<cudaStream_t>(stream));
}
