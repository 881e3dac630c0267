// Row softmax over the last axis for Hopper (sm_90a), f32 inside, output in
// the input's dtype.
//
// Replaces: src/repro/kernels/softmax.py::softmax_pallas (body
// _softmax_kernel). The TPU kernel tiles rows over the grid and walks column
// chunks in VMEM twice: pass 1 keeps an online max and sum of exponentials,
// pass 2 writes exp(x - m) / l. The reference's constants are kept here: the
// max starts at -1e30 and the normaliser is 1 / max(l, 1e-30).
//
// Bound on an H100 SXM: 5 FLOP and 8 bytes per f32 element (one read, one
// write). At 32768 x 16384 f32 that is 4.3 GB / 3.35 TB/s = 1.28 ms against
// 2.7 GFLOP, so the kernel is bound by bytes: it must keep enough bytes in
// flight (by Little's law about 16-20 KB an SM) and spend little else.
//
// Two kernels, one C entry point each per dtype; kernels/softmax.py::_route
// picks the entry from dtype, shape, strides and address:
//
// - softmax_f32 / softmax_bf16 (rows_kernel): the row lives in registers.
//   One CTA per row; each thread owns F floats, F/N vectors of 16 bytes
//   (N = 4 f32 or 8 bf16 values), vector j of the row at thread j % threads.
//   All of a thread's 16-byte loads are issued before any arithmetic, with
//   the evict-first hint (the row is read once). Then an exact row max (a
//   warp shuffle, then each warp reduces the 32 warp maxima from shared
//   memory), one expf(x - m) per element kept in registers and summed, the
//   same reduction for the sum, and 16-byte evict-first stores of e * inv.
//   Each output is today's expf(x - m) * inv; only l differs, by summation
//   order. F is a template over {4, 8, 16, 32} (bf16 {8, 16, 32}); the
//   launcher takes the smallest F whose row fits 512 threads, else F = 32 at
//   up to 1024 threads, so C <= 32768 (kMaxCols). Every instance is capped
//   at 64 registers (__launch_bounds__(1024)), so an SM holds two
//   512-thread rows. The entry takes C % N == 0, a base and row stride that
//   are multiples of 16 bytes, and C <= kMaxCols.
// - softmax_f32_online / softmax_bf16_online (online_kernel, the first
//   design of this port): every other row. One block per row, scalar loads,
//   an online max and sum in f32 with the row parked in shared memory when
//   it fits 96 KB, then a second pass of expf(v - m) * inv. It takes any C
//   and any row stride.
//
// Tried on the way, at 32768 x 16384 f32 (throwaway builds timed side by
// side on one card): 1024 threads of 16 floats a row in place of 512 of 32,
// and plain cached loads and stores in place of the evict-first ones, each
// within 1% of the kernel here. Not tried: a persistent CTA per SM that
// brings row r+1 into a two-stage shared-memory ring by a 1-D TMA bulk copy
// while it reduces and writes row r.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxCols = 32768;  // 1024 threads x 32 floats

// ---------------------------------------------------------------- helpers

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f32(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16(v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// 16 bytes of T as N floats, loaded and stored with the evict-first hint.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float* v) {
    const float4 q = __ldcs(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  }
  __device__ static void store(float* p, const float* v) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float* v) {
    const uint4 q = __ldcs(reinterpret_cast<const uint4*>(p));
    const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // The low half of each word is the lower-addressed value.
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float* v) {
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<const unsigned*>(&h);
    }
    __stcs(reinterpret_cast<uint4*>(p), make_uint4(w[0], w[1], w[2], w[3]));
  }
};

// ------------------------------------------------ register-resident rows

template <typename T, int F>
__global__ void __launch_bounds__(1024)
rows_kernel(const T* __restrict__ x, T* __restrict__ y, int C, long long ldx,
            long long ldy) {
  constexpr int N = Vec<T>::N;
  constexpr int V = F / N;  // vectors a thread owns
  __shared__ float red_m[32];
  __shared__ float red_l[32];

  const T* xr = x + (long long)blockIdx.x * ldx;
  T* yr = y + (long long)blockIdx.x * ldy;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int n_warps = blockDim.x / 32;
  const int n_vec = C / N;

  // Every load first: vector i of this thread is vector i*threads + tid.
  float v[F];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int j = i * blockDim.x + tid;
    if (j < n_vec) Vec<T>::load(xr + (long long)j * N, v + i * N);
  }

  // The exact row max, from the reference's -1e30.
  float m = kNegInf;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    if (i * blockDim.x + tid < n_vec) {
#pragma unroll
      for (int e = 0; e < N; ++e) m = fmaxf(m, v[i * N + e]);
    }
  }
  m = warp_max(m);
  if (lane == 0) red_m[warp] = m;
  __syncthreads();
  m = warp_max(lane < n_warps ? red_m[lane] : kNegInf);

  // One exponential per element, kept in place of x.
  float l = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    if (i * blockDim.x + tid < n_vec) {
#pragma unroll
      for (int e = 0; e < N; ++e) {
        v[i * N + e] = expf(v[i * N + e] - m);
        l += v[i * N + e];
      }
    }
  }
  l = warp_sum(l);
  if (lane == 0) red_l[warp] = l;
  __syncthreads();
  const float inv = 1.f / fmaxf(warp_sum(lane < n_warps ? red_l[lane] : 0.f), 1e-30f);

#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int j = i * blockDim.x + tid;
    if (j < n_vec) {
#pragma unroll
      for (int e = 0; e < N; ++e) v[i * N + e] *= inv;
      Vec<T>::store(yr + (long long)j * N, v + i * N);
    }
  }
}

template <typename T, int F>
cudaError_t launch_rows_at(const T* x, T* y, int R, int C, long long ldx, long long ldy,
                           int threads, cudaStream_t stream) {
  rows_kernel<T, F><<<R, threads, 0, stream>>>(x, y, C, ldx, ldy);
  return cudaGetLastError();
}

// Threads (a multiple of 32) for C columns at F floats a thread.
template <typename T>
int threads_for(int C, int F) {
  const int per_thread = F / Vec<T>::N;
  const int t = (C / Vec<T>::N + per_thread - 1) / per_thread;
  return (t + 31) / 32 * 32;
}

template <typename T>
cudaError_t launch_rows(const void* xv, void* yv, int R, int C, long long ldx,
                        long long ldy, cudaStream_t stream) {
  constexpr int N = Vec<T>::N;
  const T* x = static_cast<const T*>(xv);
  T* y = static_cast<T*>(yv);
  // A single row never uses its stride.
  if (C <= 0 || C % N || C > kMaxCols || (R > 1 && (ldx % N || ldy % N)) ||
      reinterpret_cast<unsigned long long>(x) % 16 ||
      reinterpret_cast<unsigned long long>(y) % 16)
    return cudaErrorInvalidValue;
  if constexpr (N == 4) {
    if (threads_for<T>(C, 4) <= 512)
      return launch_rows_at<T, 4>(x, y, R, C, ldx, ldy, threads_for<T>(C, 4), stream);
  }
  if (threads_for<T>(C, 8) <= 512)
    return launch_rows_at<T, 8>(x, y, R, C, ldx, ldy, threads_for<T>(C, 8), stream);
  if (threads_for<T>(C, 16) <= 512)
    return launch_rows_at<T, 16>(x, y, R, C, ldx, ldy, threads_for<T>(C, 16), stream);
  return launch_rows_at<T, 32>(x, y, R, C, ldx, ldy, threads_for<T>(C, 32), stream);
}

// ------------------------------------------------------ the online kernel

// Rows up to this many bytes (as f32) are cached in dynamic shared memory for
// the second pass; 96 KB leaves room for two blocks on one SM.
constexpr int kSmemRowBytes = 96 * 1024;

// Merge two online-softmax states (m, l) into (m, l).
__device__ __forceinline__ void merge(float& m, float& l, float mo, float lo) {
  const float mn = fmaxf(m, mo);
  l = l * expf(m - mn) + lo * expf(mo - mn);
  m = mn;
}

template <typename T>
__global__ void online_kernel(const T* __restrict__ x, T* __restrict__ y, int C,
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
cudaError_t launch_online(const void* x, void* y, int R, int C, long long ldx,
                          long long ldy, cudaStream_t stream) {
  // Set on every launch: the attribute is per device, and the call is a
  // cheap host-side update.
  const cudaError_t err = cudaFuncSetAttribute(
      online_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemRowBytes);
  if (err != cudaSuccess) return err;
  const long long row_bytes = (long long)C * sizeof(float);
  const int cache_row = row_bytes <= kSmemRowBytes ? 1 : 0;
  int threads = ((C + 31) / 32) * 32;
  if (threads > 512) threads = 512;
  online_kernel<T><<<R, threads, cache_row ? (size_t)row_bytes : 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), C, ldx, ldy, cache_row);
  return cudaGetLastError();
}

}  // namespace

// C entry points (bound with ctypes): x is R rows of C columns with row
// stride ldx and unit column stride; y likewise with ldy. Each returns
// cudaGetLastError() after its launch; the register entries return
// cudaErrorInvalidValue, launching nothing, for a layout they do not take.

extern "C" int softmax_f32(const void* x, void* y, int R, int C, long long ldx,
                           long long ldy, void* stream) {
  return launch_rows<float>(x, y, R, C, ldx, ldy, static_cast<cudaStream_t>(stream));
}

extern "C" int softmax_bf16(const void* x, void* y, int R, int C, long long ldx,
                            long long ldy, void* stream) {
  return launch_rows<__nv_bfloat16>(x, y, R, C, ldx, ldy,
                                    static_cast<cudaStream_t>(stream));
}

extern "C" int softmax_f32_online(const void* x, void* y, int R, int C, long long ldx,
                                  long long ldy, void* stream) {
  return launch_online<float>(x, y, R, C, ldx, ldy, static_cast<cudaStream_t>(stream));
}

extern "C" int softmax_bf16_online(const void* x, void* y, int R, int C, long long ldx,
                                   long long ldy, void* stream) {
  return launch_online<__nv_bfloat16>(x, y, R, C, ldx, ldy,
                                      static_cast<cudaStream_t>(stream));
}
