// Ascending, stable key-value sort of 32-bit keys (int32 or f32) carrying
// 32-bit values, for Hopper (sm_90a): an LSD radix sort, 8-bit digits, four
// passes between ping-pong buffers, each pass one launch with decoupled
// look-back (Adinets and Merrill, "Onesweep", 2022).
//
// Replaces: src/repro/kernels/bitonic_sort.py::bitonic_sort_pallas (body
// _bitonic_kernel). The TPU kernel sorts the whole array as one VMEM block
// with a bitonic network of reshape-swap compare-exchanges, because the
// TPU's vector unit has no fast gather or scatter; the length must be a
// power of two, padded by ops.sort_kv. A GPU scatters well, and one block
// cannot hold the Sort benchmark's 2^24 keys, so this is a radix sort, with
// no padding and any length. Five launches a sort:
//
// 1. histogram: one sweep over the keys builds all four 256-bin digit
//    histograms, per block in shared memory, then atomics into a 4 x 256
//    table in device memory.
// 2. four onesweep passes, one per digit from the lowest. Each CTA takes its
//    tile of 4096 keys from an atomic counter (not blockIdx, so every
//    earlier tile has started and the look-back always progresses), loads
//    it, counts its digits (shared atomics) and publishes each digit's
//    count at once in the tile's status word for that digit, so the tiles
//    after it can pass over it early. It then ranks its keys stably among
//    equal digits in input order: warp by warp, 32 keys at a time, a key's
//    peers found with 8 ballots (one per bit); each warp runs two chains of
//    8 rounds on their own 16-bit counters, so the two read-then-write
//    steps overlap. Thread d then looks back over its predecessors' words
//    for d, 8 words at a time, adding counts until it meets one that holds
//    its inclusive prefix, which it then publishes in turn: 256 digits in
//    parallel. Where the tile's run of digit d goes is the digit's start
//    (the exclusive scan over digits of the pass's histogram, which every
//    CTA scans itself from the 1 KB table, so no launch between the
//    histogram and the passes) plus that prefix. The tile is sorted by
//    digit in shared memory and leaves in runs of equal digits, so the
//    writes coalesce. Two CTAs an SM (their registers cap it). Tried on an
//    H100 and not kept, each slower or no faster: three or four CTAs an SM
//    (registers capped, spills), one ranking chain a warp, tiles of 2048
//    or 3072 keys, a look-back one word at a time, the look-back before
//    the ranking, and loading the values only after it.
//
// A status word is 64 bits: a flag in the high half, the count in the low
// (a count reaches 2^31 - 1, past what a word of 32 bits shares with a
// flag). Flags carry the pass: 2p + 1 is the tile's own count in pass p,
// 2p + 2 its inclusive prefix; anything less is a word of an earlier pass,
// read as "not yet". So one array of 256 words a tile serves all four
// passes and is cleared once a sort. A tile that never sees its predecessor
// publish traps after seconds instead of hanging the card.
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
// 2^24 pairs take at least 0.080 ms at 3.35 TB/s. Four passes of 8-bit
// digits must move each pair four times: with the histogram's read of the
// keys that is 68 bytes a pair, 0.34 ms at 2^24, the floor of this design
// (the three-launch passes it replaced moved 80 bytes a pair in 12
// launches).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // one thread per digit value in the per-digit steps
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;  // keys per thread
constexpr int kChains = 2;  // independent ranking chains per warp
constexpr int kRounds = kItems / kChains;
constexpr int kTile = kThreads * kItems;
constexpr int kRadix = 256;
constexpr int kPasses = 4;
constexpr int kHistBlocksPerSm = 4;
constexpr int kPassBlocksPerSm = 2;  // onesweep CTAs resident per SM (registers)
constexpr unsigned kFull = 0xffffffffu;
// A predecessor that never publishes is a fault: stop the kernel with an
// error after this many polls (seconds) rather than spin forever.
constexpr long long kSpinLimit = 1ll << 26;

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

// hist[p][d] += the number of keys whose digit p is d, p = 0..3.
template <int KIND>
__global__ void __launch_bounds__(kThreads)
histogram_kernel(const unsigned* __restrict__ keys, long long n, unsigned* __restrict__ hist) {
  __shared__ unsigned h[kPasses * kRadix];
  for (int i = threadIdx.x; i < kPasses * kRadix; i += kThreads) h[i] = 0u;
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  // Four independent loads in flight per thread, then their 16 counts.
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += 4 * stride) {
    unsigned u[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long g = i + j * stride;
      u[j] = g < n ? order_bits<KIND>(keys[g]) : 0u;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (i + j * stride >= n) break;
#pragma unroll
      for (int p = 0; p < kPasses; ++p) {
        atomicAdd(&h[p * kRadix + ((u[j] >> (8 * p)) & 0xffu)], 1u);
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kPasses * kRadix; i += kThreads) {
    if (h[i] != 0u) atomicAdd(&hist[i], h[i]);
  }
}

__device__ __forceinline__ void publish(unsigned long long* word, unsigned flag, unsigned count) {
  atomicExch(word, (static_cast<unsigned long long>(flag) << 32) | count);
}

__device__ __forceinline__ unsigned long long poll(const unsigned long long* word) {
  return *reinterpret_cast<const volatile unsigned long long*>(word);
}

constexpr int kWindow = 8;  // predecessors' words read at once

// Digit d's count over the tiles before `tile`: walk back over their words,
// kWindow at a time (independent loads, so a long walk costs a few round
// trips, not one per tile), adding counts until one holds its inclusive
// prefix; then publish this tile's. Tile 0 always holds its prefix, so the
// walk never passes it.
__device__ __forceinline__ unsigned look_back(const unsigned long long* status, int tile, int d,
                                              unsigned own_flag, unsigned prefix_flag,
                                              unsigned count, unsigned long long* own) {
  unsigned exclusive = 0u;
  bool done = false;
  for (long long look = tile - 1; !done; look -= kWindow) {
    unsigned long long w[kWindow];
#pragma unroll
    for (int j = 0; j < kWindow; ++j) {
      w[j] = look - j >= 0 ? poll(status + (look - j) * kRadix + d) : 0ull;
    }
#pragma unroll
    for (int j = 0; j < kWindow; ++j) {
      if (done) break;
      long long spins = 0;
      while (static_cast<unsigned>(w[j] >> 32) < own_flag) {
        if (++spins > kSpinLimit) __trap();
        __nanosleep(32);
        w[j] = poll(status + (look - j) * kRadix + d);
      }
      exclusive += static_cast<unsigned>(w[j]);
      done = static_cast<unsigned>(w[j] >> 32) == prefix_flag;
    }
  }
  publish(own, prefix_flag, exclusive + count);
  return exclusive;
}

// One pass: keys_in/vals_in sorted stably by digit `pass` into
// keys_out/vals_out. hist: this pass's 256 digit counts over all keys;
// status: 256 words a tile; next_tile: this pass's tile counter.
template <int KIND>
__global__ void __launch_bounds__(kThreads, kPassBlocksPerSm)
onesweep_kernel(const unsigned* __restrict__ keys_in, const unsigned* __restrict__ vals_in,
                unsigned* __restrict__ keys_out, unsigned* __restrict__ vals_out, long long n,
                int pass, const unsigned* __restrict__ hist,
                unsigned long long* __restrict__ status, unsigned* __restrict__ next_tile) {
  __shared__ unsigned s_keys[kTile];
  __shared__ unsigned s_vals[kTile];
  // Counts, then offsets, per (warp, chain): at most 4096, so 16 bits.
  __shared__ unsigned short warp_hist[kWarps * kChains][kRadix];
  __shared__ unsigned tile_off[kRadix];    // where digit d starts in the sorted tile
  __shared__ unsigned global_off[kRadix];  // where the tile's digit-d run goes
  __shared__ unsigned scratch[kWarps + 1];
  __shared__ int tile_s;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int shift = 8 * pass;
  const unsigned own_flag = 2u * pass + 1u, prefix_flag = 2u * pass + 2u;
  if (tid == 0) tile_s = static_cast<int>(atomicAdd(next_tile, 1u));
  for (int i = tid; i < kWarps * kChains * kRadix; i += kThreads) (&warp_hist[0][0])[i] = 0;
  global_off[tid] = 0u;  // the tile's digit counts, first
  __syncthreads();
  const int tile = tile_s;
  const int d = tid;
  unsigned long long* own = status + static_cast<long long>(tile) * kRadix + d;

  // Warp w owns keys [w * 32 * kItems, (w + 1) * 32 * kItems) of the tile,
  // taken 32 at a time: input order is (warp, round, lane).
  const long long tile_base = static_cast<long long>(tile) * kTile;
  const long long base = tile_base + warp * 32 * kItems;
  unsigned key[kItems], val[kItems], rank[kItems];
  const unsigned lanes_below = (1u << lane) - 1u;
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const long long g = base + r * 32 + lane;
    const bool in = g < n;
    key[r] = in ? keys_in[g] : 0u;
    val[r] = in ? vals_in[g] : 0u;
  }
  // The tile's count of each digit, published before the ranking, so the
  // tiles after this one can pass over it as soon as possible.
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    if (base + r * 32 + lane < n) atomicAdd(&global_off[digit_of<KIND>(key[r], shift)], 1u);
  }
  __syncthreads();
  publish(own, tile == 0 ? prefix_flag : own_flag, global_off[d]);
  // Chain c of warp w ranks rounds [c * kRounds, (c + 1) * kRounds) of its
  // keys against its own counters, so the chains' read-then-write steps
  // overlap; (warp, chain) is input order, so ranks stay stable.
#pragma unroll
  for (int rr = 0; rr < kRounds; ++rr) {
    unsigned peers[kChains], seen[kChains];
#pragma unroll
    for (int c = 0; c < kChains; ++c) {
      const int r = c * kRounds + rr;
      const bool in = base + r * 32 + lane < n;
      const unsigned dg = digit_of<KIND>(key[r], shift);
      // The lanes holding a key with this lane's digit: agree on all 8 bits.
      unsigned p = __ballot_sync(kFull, in);
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        const bool bit = (dg >> b) & 1u;
        const unsigned votes = __ballot_sync(kFull, bit);
        p &= bit ? votes : ~votes;
      }
      peers[c] = p;
      seen[c] = in ? warp_hist[warp * kChains + c][dg] : 0u;
      rank[r] = seen[c] + __popc(p & lanes_below);
    }
    __syncwarp();
#pragma unroll
    for (int c = 0; c < kChains; ++c) {
      const int r = c * kRounds + rr;
      const bool in = base + r * 32 + lane < n;
      if (in && __popc(peers[c] & lanes_below) == 0u) {
        warp_hist[warp * kChains + c][digit_of<KIND>(key[r], shift)] =
            static_cast<unsigned short>(seen[c] + __popc(peers[c]));
      }
    }
    __syncwarp();
  }
  __syncthreads();

  // Thread d: digit d's offsets per warp and its count in the tile.
  unsigned tile_count = 0u;
#pragma unroll
  for (int w = 0; w < kWarps * kChains; ++w) {
    const unsigned c = warp_hist[w][d];
    warp_hist[w][d] = static_cast<unsigned short>(tile_count);
    tile_count += c;
  }
  unsigned sum;
  tile_off[d] = block_exclusive_scan(tile_count, scratch, &sum);
  const unsigned digit_base = block_exclusive_scan(hist[d], scratch, &sum);

  // The tile sorted by digit in shared memory (tile_off is visible after
  // the second scan's barriers).
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    if (base + r * 32 + lane < n) {
      const unsigned dd = digit_of<KIND>(key[r], shift);
      const unsigned local = tile_off[dd] + warp_hist[warp * kChains + r / kRounds][dd] + rank[r];
      s_keys[local] = key[r];
      s_vals[local] = val[r];
    }
  }

  // Looked up last, while the tiles before it had time to publish.
  const unsigned exclusive =
      tile > 0 ? look_back(status, tile, d, own_flag, prefix_flag, tile_count, own) : 0u;
  global_off[d] = digit_base + exclusive;
  __syncthreads();

  const int valid = n - tile_base < kTile ? static_cast<int>(n - tile_base) : kTile;
  for (int i = tid; i < valid; i += kThreads) {
    const unsigned k = s_keys[i];
    const unsigned dd = digit_of<KIND>(k, shift);
    const long long pos = static_cast<long long>(global_off[dd]) + (i - tile_off[dd]);
    keys_out[pos] = k;
    vals_out[pos] = s_vals[i];
  }
}

// Scratch layout (bytes, in this order): the status words, 256 x 8 a tile;
// the histogram table, 4 x 256 x 4; the four passes' tile counters, 4 x 4.
long long tiles_of(long long n) { return (n + kTile - 1) / kTile; }
long long scratch_bytes(long long n) {
  return tiles_of(n) * kRadix * 8 + kPasses * kRadix * 4 + kPasses * 4;
}

template <int KIND>
cudaError_t sort(const unsigned* keys, const unsigned* vals, unsigned* keys_out,
                 unsigned* vals_out, unsigned* tmp_keys, unsigned* tmp_vals, void* scratch,
                 long long n, cudaStream_t stream) {
  if (n <= 0 || n > 0x7fffffffll) return cudaErrorInvalidValue;
  const long long tiles = tiles_of(n);
  auto* status = static_cast<unsigned long long*>(scratch);
  auto* hist = reinterpret_cast<unsigned*>(status + tiles * kRadix);
  unsigned* counters = hist + kPasses * kRadix;
  cudaError_t err = cudaMemsetAsync(scratch, 0, scratch_bytes(n), stream);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long hist_blocks = kHistBlocksPerSm * static_cast<long long>(sms > 0 ? sms : 1);
  histogram_kernel<KIND><<<static_cast<unsigned>(tiles < hist_blocks ? tiles : hist_blocks),
                           kThreads, 0, stream>>>(keys, n, hist);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // Passes 0..3 read keys -> tmp -> out -> tmp -> out: the input is left as
  // it was and the result lands in out.
  const unsigned* src_k = keys;
  const unsigned* src_v = vals;
  for (int pass = 0; pass < kPasses; ++pass) {
    unsigned* dst_k = pass % 2 == 0 ? tmp_keys : keys_out;
    unsigned* dst_v = pass % 2 == 0 ? tmp_vals : vals_out;
    onesweep_kernel<KIND><<<static_cast<unsigned>(tiles), kThreads, 0, stream>>>(
        src_k, src_v, dst_k, dst_v, n, pass, hist + pass * kRadix, status, counters + pass);
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
// sorted pairs; tmp_keys and tmp_vals are n-element scratch; scratch holds
// radix_sort_scratch_bytes(n) bytes, 8-byte aligned, cleared here on the
// stream. 0 < n < 2^31. Each returns the first launch error, or
// cudaSuccess after the last launch.

extern "C" int radix_sort_tile() { return kTile; }

// Below 2^31 for every n the entry points take (1 GiB and 4112 bytes at
// 2^31 - 1), so an int carries it.
extern "C" int radix_sort_scratch_bytes(long long n) { return (int)scratch_bytes(n); }

extern "C" int sort_kv_i32(const void* keys, const void* vals, void* keys_out, void* vals_out,
                           void* tmp_keys, void* tmp_vals, void* scratch, long long n,
                           void* stream) {
  return (int)sort<kInt32>(
      static_cast<const unsigned*>(keys), static_cast<const unsigned*>(vals),
      static_cast<unsigned*>(keys_out), static_cast<unsigned*>(vals_out),
      static_cast<unsigned*>(tmp_keys), static_cast<unsigned*>(tmp_vals), scratch, n,
      static_cast<cudaStream_t>(stream));
}

extern "C" int sort_kv_f32(const void* keys, const void* vals, void* keys_out, void* vals_out,
                           void* tmp_keys, void* tmp_vals, void* scratch, long long n,
                           void* stream) {
  return (int)sort<kFloat32>(
      static_cast<const unsigned*>(keys), static_cast<const unsigned*>(vals),
      static_cast<unsigned*>(keys_out), static_cast<unsigned*>(vals_out),
      static_cast<unsigned*>(tmp_keys), static_cast<unsigned*>(tmp_vals), scratch, n,
      static_cast<cudaStream_t>(stream));
}
