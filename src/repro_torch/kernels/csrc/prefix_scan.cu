// Inclusive prefix sum of a 1-D f32 array for Hopper (sm_90a), accumulated
// in f32: a single-pass scan with decoupled look-back.
//
// Replaces: src/repro/kernels/prefix_scan.py::prefix_scan_pallas (body
// _scan_kernel). A TPU core walks the grid in order, so the TPU kernel
// carries the running total from one block to the next in an SMEM scalar.
// Blocks of a GPU grid run at once and in no order, so that carry would read
// a total that is not there yet. Here each block takes the next tile number
// from a counter in device memory (so a tile only ever waits on tiles whose
// blocks are already running), scans its tile, and publishes the tile's sum
// in a status word at once. Warp 0 then walks back over its predecessors'
// status words, 32 at a time, adding their sums until it meets one that
// already holds its inclusive prefix, and publishes its own inclusive prefix
// in turn. Status and value share one 64-bit word (flag in the high half,
// the f32 sum in the low), so a reader sees a flag with its own value.
//
// The order in which a tile's predecessors are added depends on how far
// they have got, so on random floats two runs may differ in the last bits.
// Integer-valued inputs whose sums stay below 2^24 (the Where benchmark's
// 0/1 flags) are exact in any order.
//
// Bound on an H100 SXM: 8 bytes per element (one read, one write) against
// one add, so bytes bound it: 2^24 elements in 0.040 ms at 3.35 TB/s. What
// the design does about it: every element crosses device memory once each
// way (the look-back reads one 8-byte word per predecessor it needs, most
// often one or two), loads and stores are coalesced through shared memory,
// and the scratch is one word per tile of kTile elements.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;  // elements a thread scans
constexpr int kTile = kThreads * kItems;  // 2048, the reference's default block_n
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kAggregate = 1ull;  // the tile's own sum
constexpr unsigned long long kPrefix = 2ull;     // the sum up to and including the tile
// A predecessor that never publishes is a fault: stop the kernel with an
// error after this many polls (seconds) rather than spin forever.
constexpr long long kSpinLimit = 1ll << 26;

__device__ __forceinline__ unsigned long long pack(unsigned long long flag, float v) {
  return (flag << 32) | __float_as_uint(v);
}

__device__ __forceinline__ void publish(unsigned long long* word, unsigned long long flag,
                                        float v) {
  atomicExch(word, pack(flag, v));
}

__device__ __forceinline__ unsigned long long poll(const unsigned long long* word) {
  return *reinterpret_cast<const volatile unsigned long long*>(word);
}

// Index of element i of the tile in shared memory: one pad word per 32
// spreads a thread's run of kItems consecutive elements over the banks.
__device__ __forceinline__ int padded(int i) { return i + i / 32; }

// The exclusive prefix of the tile's predecessors, by warp 0 (all lanes).
__device__ float look_back(const unsigned long long* status, int tile, int lane) {
  float exclusive = 0.f;
  for (long long look = tile - 1;; look -= 32) {
    const long long idx = look - lane;  // lane 0 takes the nearest predecessor
    unsigned long long flag = kPrefix;
    float value = 0.f;
    if (idx >= 0) {
      unsigned long long word;
      long long spins = 0;
      while (((word = poll(status + idx)) >> 32) == 0) {
        if (++spins > kSpinLimit) __trap();
        __nanosleep(64);
      }
      flag = word >> 32;
      value = __uint_as_float(static_cast<unsigned>(word));
    }
    const unsigned prefix_lanes = __ballot_sync(kFull, flag == kPrefix);
    // Add the predecessors up to the nearest one that holds its prefix.
    const int stop = prefix_lanes ? __ffs(prefix_lanes) - 1 : 31;
    float part = lane <= stop ? value : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(kFull, part, off);
    exclusive += part;
    if (prefix_lanes) return exclusive;
  }
}

__global__ void __launch_bounds__(kThreads)
scan_kernel(const float* __restrict__ x, float* __restrict__ y, long long n,
            unsigned long long* __restrict__ status, unsigned* __restrict__ next_tile) {
  __shared__ float buf[kTile + kTile / 32];
  __shared__ float warp_prefix[kWarps];
  __shared__ float tile_prefix;
  __shared__ int tile_s;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  if (tid == 0) tile_s = static_cast<int>(atomicAdd(next_tile, 1u));
  __syncthreads();
  const int tile = tile_s;
  const long long base = static_cast<long long>(tile) * kTile;

  // Coalesced load (thread t takes elements t, t + 256, ...); past n, zeros.
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int i = j * kThreads + tid;
    buf[padded(i)] = base + i < n ? x[base + i] : 0.f;
  }
  __syncthreads();

  // Thread t scans its own kItems consecutive elements.
  float v[kItems];
  float run = 0.f;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    run += buf[padded(tid * kItems + j)];
    v[j] = run;
  }
  // Inclusive scan of the thread sums inside each warp, then across warps.
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += o;
  }
  const float up = __shfl_up_sync(kFull, incl, 1);
  const float thread_excl = lane == 0 ? 0.f : up;
  if (lane == 31) warp_prefix[warp] = incl;
  __syncthreads();

  if (warp == 0) {
    float w = lane < kWarps ? warp_prefix[lane] : 0.f;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_up_sync(kFull, w, off);
      if (lane >= off) w += o;
    }
    const float w_up = __shfl_up_sync(kFull, w, 1);
    const float aggregate = __shfl_sync(kFull, w, kWarps - 1);
    if (lane < kWarps) warp_prefix[lane] = lane == 0 ? 0.f : w_up;
    float exclusive = 0.f;
    if (tile == 0) {
      if (lane == 0) publish(status, kPrefix, aggregate);
    } else {
      if (lane == 0) publish(status + tile, kAggregate, aggregate);
      exclusive = look_back(status, tile, lane);
      if (lane == 0) publish(status + tile, kPrefix, exclusive + aggregate);
    }
    if (lane == 0) tile_prefix = exclusive;
  }
  __syncthreads();

  const float prefix = tile_prefix + (warp_prefix[warp] + thread_excl);
#pragma unroll
  for (int j = 0; j < kItems; ++j) buf[padded(tid * kItems + j)] = prefix + v[j];
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int i = j * kThreads + tid;
    if (base + i < n) y[base + i] = buf[padded(i)];
  }
}

}  // namespace

// C entry point (bound with ctypes): y[i] = x[0] + ... + x[i] for contiguous
// f32 x and y of n elements on the device, one block per tile of 2048
// elements. scratch holds ceil(n / 2048) + 1 64-bit words, zeroed here on
// the stream before the launch. Returns cudaGetLastError() after the launch.
extern "C" int prefix_scan_f32(const void* x, void* y, long long n, void* scratch,
                               void* stream) {
  if (n <= 0) return n == 0 ? (int)cudaSuccess : (int)cudaErrorInvalidValue;
  const long long tiles = (n + kTile - 1) / kTile;
  if (tiles > 0x7fffffffll) return (int)cudaErrorInvalidValue;
  auto* status = static_cast<unsigned long long*>(scratch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // scratch[0, tiles): the tiles' status words; scratch[tiles]: the counter.
  cudaError_t err =
      cudaMemsetAsync(status, 0, (tiles + 1) * sizeof(unsigned long long), st);
  if (err != cudaSuccess) return (int)err;
  scan_kernel<<<static_cast<unsigned>(tiles), kThreads, 0, st>>>(
      static_cast<const float*>(x), static_cast<float*>(y), n, status,
      reinterpret_cast<unsigned*>(status + tiles));
  return (int)cudaGetLastError();
}
