// Ascending, stable key-value sort of 32-bit keys (int32 or f32) carrying
// 32-bit values, for Hopper (sm_90a): an LSD radix sort, 8-bit digits, four
// passes between ping-pong buffers.
//
// Replaces: src/repro/kernels/bitonic_sort.py::bitonic_sort_pallas (body
// _bitonic_kernel). The TPU kernel sorts the whole array as one VMEM block
// with a bitonic network of reshape-swap compare-exchanges, because the
// TPU's vector unit has no fast gather or scatter; the length must be a
// power of two, padded by ops.sort_kv. A GPU scatters well, and one block
// cannot hold the Sort benchmark's 2^24 keys, so this is the paper's own
// radix sort (Satish et al.), with no padding and any length. Each pass
// takes one digit, from the lowest to the highest, in three launches:
//
// 1. upsweep: each block counts the digits of its tile of 4096 keys into a
//    (digit x tile) table, digit-major;
// 2. scan: one block per digit turns its row of the table into exclusive
//    offsets across tiles and writes the digit's total;
// 3. scatter: each block ranks its tile's keys among equal digits in input
//    order (warp by warp, __match_any_sync per 32 keys), sorts the tile by
//    digit in shared memory, and writes each digit's run to the digit's
//    offset (the scan of the totals over digits) plus the tile's offset.
//    Runs of equal digits leave in order, so the writes coalesce.
//
// Ranks follow input order, so every pass is stable and the sort equals a
// stable comparison sort (torch.sort(stable=True)) to the bit, keys and
// values. Keys are compared through an order-preserving map to unsigned
// bits, applied as each digit is read (the keys themselves move
// unchanged): int32 flips the sign bit; f32 flips the sign bit of a
// non-negative key and every bit of a negative one, after giving -0.0 the
// bits of +0.0 (the two compare equal, so they keep their input order) and
// mapping every NaN above +inf (torch.sort puts NaN last).
//
// Bound on an H100 SXM: each pair read once and written once, 16 bytes, so
// 2^24 pairs take at least 0.080 ms at 3.35 TB/s. This kernel moves each
// pair four times (and reads the keys once more per pass for the counts,
// 80 bytes a pair in all); fusing the passes (a onesweep with decoupled
// look-back over the tile offsets) is the known way down.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // one thread per digit value in the per-digit steps
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;  // keys per thread
constexpr int kTile = kThreads * kItems;
constexpr int kRadix = 256;
constexpr int kPasses = 4;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kPast = kRadix;  // the digit of a slot past the end of the array

enum KeyKind { kInt32 = 0, kFloat32 = 1 };

template <int KIND>
__device__ __forceinline__ unsigned order_bits(unsigned k) {
  if constexpr (KIND == kInt32) {
    return k ^ 0x80000000u;
  } else {
    if ((k & 0x7fffffffu) > 0x7f800000u) return 0xffffffffu;  // NaN
    if (k == 0x80000000u) k = 0u;                              // -0.0 ties with +0.0
    return (k & 0x80000000u) ? ~k : (k | 0x80000000u);
  }
}

template <int KIND>
__device__ __forceinline__ unsigned digit_of(unsigned k, int shift) {
  return (order_bits<KIND>(k) >> shift) & (kRadix - 1);
}

// Exclusive scan of one value per thread over the block. scratch holds
// kWarps + 1 words; every thread must call it; total gets the block's sum.
__device__ unsigned block_exclusive_scan(unsigned v, unsigned* scratch, unsigned* total) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  unsigned incl = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned o = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += o;
  }
  if (lane == 31) scratch[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const unsigned w = lane < kWarps ? scratch[lane] : 0u;
    unsigned wi = w;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned o = __shfl_up_sync(kFull, wi, off);
      if (lane >= off) wi += o;
    }
    if (lane < kWarps) scratch[lane] = wi - w;
    if (lane == kWarps - 1) scratch[kWarps] = wi;
  }
  __syncthreads();
  const unsigned excl = scratch[warp] + incl - v;
  *total = scratch[kWarps];
  __syncthreads();  // the caller may reuse scratch at once
  return excl;
}

template <int KIND>
__global__ void __launch_bounds__(kThreads)
upsweep_kernel(const unsigned* __restrict__ keys, long long n, int shift,
               unsigned* __restrict__ counts, int tiles) {
  __shared__ unsigned hist[kRadix];
  const int lane = threadIdx.x % 32;
  hist[threadIdx.x] = 0u;
  __syncthreads();
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
#pragma unroll 4
  for (int j = 0; j < kItems; ++j) {
    const long long g = base + j * kThreads + threadIdx.x;
    const unsigned d = g < n ? digit_of<KIND>(keys[g], shift) : kPast;
    // One shared-memory add per distinct digit of the warp.
    const unsigned peers = __match_any_sync(kFull, d);
    if (d != kPast && lane == __ffs(peers) - 1) atomicAdd(&hist[d], __popc(peers));
  }
  __syncthreads();
  counts[static_cast<long long>(threadIdx.x) * tiles + blockIdx.x] = hist[threadIdx.x];
}

// Block d: counts[d][0, tiles) -> exclusive offsets across tiles; totals[d].
__global__ void __launch_bounds__(kThreads)
scan_kernel(unsigned* __restrict__ counts, int tiles, unsigned* __restrict__ totals) {
  __shared__ unsigned scratch[kWarps + 1];
  unsigned* row = counts + static_cast<long long>(blockIdx.x) * tiles;
  unsigned carry = 0u;
  for (int start = 0; start < tiles; start += kThreads) {
    const int i = start + threadIdx.x;
    const unsigned v = i < tiles ? row[i] : 0u;
    unsigned sum;
    const unsigned excl = block_exclusive_scan(v, scratch, &sum);
    if (i < tiles) row[i] = carry + excl;
    carry += sum;
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = carry;
}

template <int KIND>
__global__ void __launch_bounds__(kThreads)
scatter_kernel(const unsigned* __restrict__ keys_in, const unsigned* __restrict__ vals_in,
               unsigned* __restrict__ keys_out, unsigned* __restrict__ vals_out, long long n,
               int shift, const unsigned* __restrict__ counts,
               const unsigned* __restrict__ totals, int tiles) {
  __shared__ unsigned s_keys[kTile];
  __shared__ unsigned s_vals[kTile];
  __shared__ unsigned warp_hist[kWarps][kRadix];  // counts, then offsets, per warp
  __shared__ unsigned tile_off[kRadix];    // where digit d starts in the sorted tile
  __shared__ unsigned global_off[kRadix];  // where the tile's digit-d run goes
  __shared__ unsigned scratch[kWarps + 1];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  for (int i = tid; i < kWarps * kRadix; i += kThreads) (&warp_hist[0][0])[i] = 0u;
  __syncthreads();

  // Warp w owns keys [w * 32 * kItems, (w + 1) * 32 * kItems) of the tile,
  // taken 32 at a time: input order is (warp, round, lane).
  const long long base = static_cast<long long>(blockIdx.x) * kTile + warp * 32 * kItems;
  unsigned key[kItems], val[kItems], dig[kItems], rank[kItems];
  const unsigned lanes_below = (1u << lane) - 1u;
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const long long g = base + r * 32 + lane;
    const bool in = g < n;
    key[r] = in ? keys_in[g] : 0u;
    val[r] = in ? vals_in[g] : 0u;
    dig[r] = in ? digit_of<KIND>(key[r], shift) : kPast;
  }
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const unsigned d = dig[r];
    const unsigned peers = __match_any_sync(kFull, d);
    const unsigned earlier = __popc(peers & lanes_below);
    const unsigned seen = d != kPast ? warp_hist[warp][d] : 0u;
    rank[r] = seen + earlier;
    __syncwarp();
    if (d != kPast && earlier == 0u) warp_hist[warp][d] = seen + __popc(peers);
    __syncwarp();
  }
  __syncthreads();

  // Thread d: digit d's offsets per warp, its count in the tile, and where
  // its run starts in the tile and in the output.
  const int d = tid;
  unsigned tile_count = 0u;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const unsigned c = warp_hist[w][d];
    warp_hist[w][d] = tile_count;
    tile_count += c;
  }
  unsigned sum;
  tile_off[d] = block_exclusive_scan(tile_count, scratch, &sum);
  const unsigned digit_base = block_exclusive_scan(totals[d], scratch, &sum);
  global_off[d] = digit_base + counts[static_cast<long long>(d) * tiles + blockIdx.x];
  __syncthreads();

#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const unsigned dd = dig[r];
    if (dd != kPast) {
      const unsigned local = tile_off[dd] + warp_hist[warp][dd] + rank[r];
      s_keys[local] = key[r];
      s_vals[local] = val[r];
    }
  }
  __syncthreads();

  const long long tile_base = static_cast<long long>(blockIdx.x) * kTile;
  const int valid = n - tile_base < kTile ? static_cast<int>(n - tile_base) : kTile;
  for (int i = tid; i < valid; i += kThreads) {
    const unsigned k = s_keys[i];
    const unsigned dd = digit_of<KIND>(k, shift);
    const long long pos = static_cast<long long>(global_off[dd]) + (i - tile_off[dd]);
    keys_out[pos] = k;
    vals_out[pos] = s_vals[i];
  }
}

template <int KIND>
cudaError_t sort(const unsigned* keys, const unsigned* vals, unsigned* keys_out,
                 unsigned* vals_out, unsigned* tmp_keys, unsigned* tmp_vals,
                 unsigned* counts, unsigned* totals, long long n, cudaStream_t stream) {
  const long long tiles64 = (n + kTile - 1) / kTile;
  if (n <= 0 || n > 0x7fffffffll) return cudaErrorInvalidValue;
  const int tiles = static_cast<int>(tiles64);
  // Passes 0..3 read keys -> tmp -> out -> tmp -> out: the input is left as
  // it was and the result lands in out.
  const unsigned* src_k = keys;
  const unsigned* src_v = vals;
  for (int pass = 0; pass < kPasses; ++pass) {
    unsigned* dst_k = pass % 2 == 0 ? tmp_keys : keys_out;
    unsigned* dst_v = pass % 2 == 0 ? tmp_vals : vals_out;
    const int shift = 8 * pass;
    upsweep_kernel<KIND><<<tiles, kThreads, 0, stream>>>(src_k, n, shift, counts, tiles);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    scan_kernel<<<kRadix, kThreads, 0, stream>>>(counts, tiles, totals);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    scatter_kernel<KIND><<<tiles, kThreads, 0, stream>>>(src_k, src_v, dst_k, dst_v, n, shift,
                                                         counts, totals, tiles);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    src_k = dst_k;
    src_v = dst_v;
  }
  return cudaSuccess;
}

}  // namespace

// C entry points (bound with ctypes). keys and vals: n contiguous 32-bit
// elements on the device, left unchanged; keys_out and vals_out receive the
// sorted pairs; tmp_keys and tmp_vals are n-element scratch; counts holds
// 256 * ceil(n / 4096) and totals 256 32-bit words of scratch. 0 < n < 2^31.
// Each returns the first launch error, or cudaSuccess after the last launch.

extern "C" int radix_sort_tile() { return kTile; }

extern "C" int sort_kv_i32(const void* keys, const void* vals, void* keys_out, void* vals_out,
                           void* tmp_keys, void* tmp_vals, void* counts, void* totals,
                           long long n, void* stream) {
  return (int)sort<kInt32>(
      static_cast<const unsigned*>(keys), static_cast<const unsigned*>(vals),
      static_cast<unsigned*>(keys_out), static_cast<unsigned*>(vals_out),
      static_cast<unsigned*>(tmp_keys), static_cast<unsigned*>(tmp_vals),
      static_cast<unsigned*>(counts), static_cast<unsigned*>(totals), n,
      static_cast<cudaStream_t>(stream));
}

extern "C" int sort_kv_f32(const void* keys, const void* vals, void* keys_out, void* vals_out,
                           void* tmp_keys, void* tmp_vals, void* counts, void* totals,
                           long long n, void* stream) {
  return (int)sort<kFloat32>(
      static_cast<const unsigned*>(keys), static_cast<const unsigned*>(vals),
      static_cast<unsigned*>(keys_out), static_cast<unsigned*>(vals_out),
      static_cast<unsigned*>(tmp_keys), static_cast<unsigned*>(tmp_vals),
      static_cast<unsigned*>(counts), static_cast<unsigned*>(totals), n,
      static_cast<cudaStream_t>(stream));
}
