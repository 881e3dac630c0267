// Split-KV ("flash-decoding") attention for Hopper (sm_90a), bf16: one
// launch per decode call, the merge of the splits' partial results folded
// into the kernel's epilogue.
//
// Replaces: src/repro/kernels/flash_attention.py:112 flash_attention_pallas
// (pallas_call at :151, body _flash_kernel at :39), for bf16 calls with at
// most 16 packed rows per KV head (group * T <= 16: a decode step, T = 1),
// D in {64, 128}, and k, v rows that start on 16-byte boundaries. Same
// semantics as the reference: query head h reads KV head h / group, the
// queries sit at the last T of the S positions, causal and window masks,
// masked probabilities 0, output acc / max(l, 1e-30).
//
// Bound on an H100 SXM: a decode step of granite-3-8b at batch 8 (Hq 32,
// Hkv 8, D 128) against a cache of 1088 positions reads 36 MB of K and V for
// 1.4e8 operations: 0.011 ms at 3.35 TB/s, bound by bytes. The card reaches
// its bandwidth only with enough loads in flight, and one CTA per (batch, KV
// head) gives 64 CTAs on 132 SMs, each walking its 17 key tiles one after
// another. So the keys are split:
// - Grid (splits, Hkv, B). Split i of a (b, KV head) takes a contiguous run
//   of whole 64-key tiles of the visible range [lo, hi): tiles lo +
//   floor(i * n / splits) up to lo + floor((i + 1) * n / splits). The
//   caller picks splits so that B * Hkv * splits >= 2 * 132 and every split
//   has a tile (5 at B8, S 1088); more splits than tiles leave some empty.
// - A CTA of 4 warps holds the KV head's rows (its group's query heads,
//   position-major) as f32 in shared memory, and streams its tiles through
//   two buffers by 16-byte cp.async: the next tile loads while this one is
//   reduced. 72.7 KB of shared memory at the path's shape, so three CTAs
//   share an SM and the step's 320 CTAs run in one wave (the launch bounds
//   say so, which gives ptxas room for the merge's registers: no spills).
//   Scores on the
//   CUDA cores (two threads a key, f32 FMAs), the online max and sum by
//   warp shuffles, p v by one thread a column.
//
// The merge has no launch of its own. A separate merge kernel (the design
// before) read some 10 KB of partials per (batch, KV head) from L2 and wrote
// 8 KB of output: its bound is 0.0002 ms, yet it took 0.003 ms on the device
// and a second launch, with its host time, per decode layer. So:
// - splits == 1: the CTA divides by its own row sums and writes bf16
//   through o's strides. No scratch, no counter.
// - splits > 1: each CTA writes its partial (m, l, acc[D]) in f32 (m in log2
//   units; a split that sees no key writes m = -1e30, l = 0, acc = 0) to the
//   caller's scratch, B * Hq * T * splits * (D + 2) * 4 bytes. The CTA
//   synchronises (ordering every thread's partial stores before thread 0's
//   next step), and thread 0 adds 1 to the arrival counter of its (b, KV
//   head) with an acquire-release atomic at device scope: its release half
//   is cumulative, so the CTA's partial is visible device-wide before the
//   count (the role of a __threadfence() before a plain atomicAdd, one
//   memory round trip less). The CTA that reads splits - 1 arrives last:
//   every other split's partial was released before its count, so after
//   the acquire (and a barrier, for the CTA's other threads) it reads them
//   all, through ld.global.cg (L2, never a stale L1 line). It merges them with
//   the arithmetic of flash_decode_combine_plain (kernels/flash_attention.py)
//   applied in split order: m* = max m_i; w_i = exp2f(m_i - m*); l = sum of
//   l_i * w_i and acc = sum of acc_i * w_i, each product and each sum rounded
//   on its own (__fmul_rn, __fadd_rn: no contraction into an FMA); o =
//   acc / fmaxf(l, 1e-30), rounded to bf16. So the fused output is bit-equal
//   to that merge applied to the kernel's own partials. One warp merges a
//   row, its lanes over the splits (the weights shared by shuffles) and
//   over d; the first 8 splits' partials are loaded together, one L2 round
//   trip. The merge's bound is its
//   partials read once from L2 and o written once; it runs on the last CTA
//   of each (b, KV head) while other heads' CTAs still stream their keys.
//   Then the last CTA sets its counter back to 0, so every launch leaves the
//   counters as it found them (zero), which a CUDA graph replay needs.
// - lse != nullptr: each row's log-sum-exp of its scaled scores, f32, laid
//   out (B, Hq, T), in natural-log units: (m* + log2 l) * ln 2 from the
//   row's final max and sum (at one split the CTA's own, else the merge's);
//   -inf for a row that sees no key. The row state is already in registers,
//   so this costs B * Hq * T * 4 bytes of stores and nothing else: the
//   launch, the counters and the scratch are those of the call without it.
//   Ranks that each hold a slice of a cache merge their outputs with it
//   (the split rule of kernels/ops.py::attention).
// - The counters are an int32 array of at least B * Hkv entries, zeroed
//   once. The wrapper keeps one array (and one scratch buffer) per (device,
//   stream): launches on one stream run in order, so they never see each
//   other's counts, while two decode calls in flight on two streams would
//   corrupt each other's arrival counts if they shared an array.
// - o == nullptr keeps the partials-only launch (the split-level tests and
//   flash_decode_partials_cuda): every split writes its partial, and nothing
//   is merged.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBlockN = 64;  // keys per tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr unsigned kFull = 0xffffffffu;

struct DecodeArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;  // nullptr: write the partials only
  float* lse;        // [B][Hq][T], or nullptr: no log-sum-exp
  float* part_o;     // [B][Hkv][splits][rows][D]
  float* part_ml;    // [B][Hkv][splits][rows][2]: m (log2 units), l
  int* counters;     // [B][Hkv] arrival counts, zero between launches
  int T, S, Hkv, group, rows, causal, window, splits;
  float scale_log2;
  long long sq[3], sk[3], sv[3], so[3];  // element strides over (b, h, t/s)
};

// K tile row in elements: 32 bytes of padding spread the rows over the banks
// for the score loop, which reads a row per thread pair. V needs none: its
// loop reads a row across the threads.
__host__ __device__ constexpr int pitch(int d) { return d + 16; }

template <int D, int kRows>
constexpr int decode_smem_bytes() {
  return kRows * D * 4 + 2 * kBlockN * (pitch(D) + D) * 2 + kRows * kBlockN * 4 + kRows * 4;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

__device__ __forceinline__ void widen8(const __nv_bfloat16* src, float* out) {
  const uint4 r = *reinterpret_cast<const uint4*>(src);
  const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const unsigned short lo = static_cast<unsigned short>(w[i] & 0xffffu);
    const unsigned short hi = static_cast<unsigned short>(w[i] >> 16);
    out[2 * i] = __bfloat162float(__ushort_as_bfloat16(lo));
    out[2 * i + 1] = __bfloat162float(__ushort_as_bfloat16(hi));
  }
}

// A row's log-sum-exp in natural-log units from its max m (log2 units of
// the scaled scores) and sum l; -inf where the row saw no key (l = 0).
__device__ __forceinline__ float row_lse(float m, float l) {
  return l > 0.f ? (m + log2f(l)) * kLn2 : -CUDART_INF_F;
}

__device__ __forceinline__ bool visible(int key, int qpos, int S, int causal, int window) {
  return key < S && (!causal || key <= qpos) && (window < 0 || key > qpos - window);
}

// The visible key tiles [lo, hi) of the call's rows (the same for every CTA).
__device__ __forceinline__ void tile_range(const DecodeArgs& a, int& lo, int& hi) {
  const int offset = a.S - a.T;
  const int n_tiles = (a.S + kBlockN - 1) / kBlockN;
  hi = n_tiles;
  if (a.causal) {
    const int last = offset + (a.rows - 1) / a.group;
    hi = last < 0 ? 0 : min(last / kBlockN + 1, n_tiles);
  }
  lo = 0;
  if (a.window >= 0) {
    const int first_key = offset - a.window + 1;  // may be negative
    lo = first_key > 0 ? first_key / kBlockN : 0;
  }
  if (hi < lo) hi = lo;
}

// The last CTA's merge of its (b, KV head)'s splits (see the note at the
// top), out of line so that the main loop's register allocation does not
// depend on it.
// part_o and part_ml are the kernel's scratch advanced to split 0 of row 0
// of this (b, KV head); orow0 is o advanced to (b, query head kvh * group,
// position 0). The fields it reads are passed by value: taking the address
// of the kernel's parameter would copy it to local memory.
// lse0, when not null, is the lse output advanced to (b, query head kvh *
// group, position 0); row r's entry lies (r % group) * T + r / group past it.
template <int D>
__device__ __noinline__ void merge_splits(const float* part_o, const float* part_ml,
                                          __nv_bfloat16* orow0, long long so_h, long long so_t,
                                          float* lse0, int T, int R, int group, int splits,
                                          int warp, int lane) {
  // The merge, warp w over rows w, w + 4, ...; lanes over the splits for m
  // and l, over d for acc. Sums in split order, each product and sum
  // rounded on its own. The first 8 splits' acc, and every lane's split's m
  // and l, are loaded before anything waits on them: one L2 round trip.
  constexpr int kCols = D / 32;  // columns per lane
  constexpr int kPre = 8;        // splits whose acc is loaded up front
  const long long ml_step = 2ll * R, po_step = static_cast<long long>(R) * D;
  for (int r = warp; r < R; r += kWarps) {
    const float* ml = part_ml + r * 2;        // split i at ml + i * ml_step
    const float* po = part_o + r * D + lane;  // split i at po + i * po_step
    float pre[kPre][kCols];
#pragma unroll
    for (int j = 0; j < kPre; ++j)
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        pre[j][c] = j < splits ? __ldcg(po + j * po_step + 32 * c) : 0.f;
      }
    float m_lane = -1e30f, l_lane = 0.f;  // split `lane`'s
    if (lane < splits) {
      m_lane = __ldcg(ml + lane * ml_step);
      l_lane = __ldcg(ml + lane * ml_step + 1);
    }
    float m_star = m_lane;
    for (int i = lane + 32; i < splits; i += 32) m_star = fmaxf(m_star, __ldcg(ml + i * ml_step));
    m_star = warp_max(m_star);
    float l_sum = 0.f, o_acc[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) o_acc[c] = 0.f;
    for (int i0 = 0; i0 < splits; i0 += 32) {
      float m_i = m_lane, l_i = l_lane;
      if (i0 > 0) {
        m_i = -1e30f;
        l_i = 0.f;
        if (i0 + lane < splits) {
          m_i = __ldcg(ml + (i0 + lane) * ml_step);
          l_i = __ldcg(ml + (i0 + lane) * ml_step + 1);
        }
      }
      const float w = exp2f(m_i - m_star);  // split i0 + lane's weight
      const float lw = __fmul_rn(l_i, w);
      const int n = min(32, splits - i0);
      int j = 0;
      if (i0 == 0) {
#pragma unroll
        for (int jj = 0; jj < kPre; ++jj) {
          if (jj < n) {
            const float wj = __shfl_sync(kFull, w, jj);
            l_sum = __fadd_rn(l_sum, __shfl_sync(kFull, lw, jj));
#pragma unroll
            for (int c = 0; c < kCols; ++c) o_acc[c] = __fadd_rn(o_acc[c], __fmul_rn(pre[jj][c], wj));
          }
        }
        j = min(n, kPre);
      }
#pragma unroll 4
      for (; j < n; ++j) {
        const float wj = __shfl_sync(kFull, w, j);
        l_sum = __fadd_rn(l_sum, __shfl_sync(kFull, lw, j));
        const float* pj = po + (i0 + j) * po_step;
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          o_acc[c] = __fadd_rn(o_acc[c], __fmul_rn(__ldcg(pj + 32 * c), wj));
        }
      }
    }
    __nv_bfloat16* orow = orow0 + (r % group) * so_h + static_cast<long long>(r / group) * so_t +
                          lane;
    const float denom = fmaxf(l_sum, 1e-30f);
#pragma unroll
    for (int c = 0; c < kCols; ++c) orow[32 * c] = __float2bfloat16(o_acc[c] / denom);
    // m_star and l_sum are the same on every lane (shuffled): lane 0 writes.
    if (lse0 != nullptr && lane == 0) lse0[(r % group) * T + r / group] = row_lse(m_star, l_sum);
  }
}

template <int D, int kRows>
__global__ void __launch_bounds__(kThreads, 3) flash_decode_kernel(const DecodeArgs a) {
  constexpr int LD = pitch(D);  // K rows; V rows are D apart
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  constexpr int kRowsPerWarp = kRows / kWarps > 0 ? kRows / kWarps : 1;
  extern __shared__ __align__(16) uint8_t smem[];
  float* sQ = reinterpret_cast<float*>(smem);                               // [kRows][D]
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(sQ + kRows * D);    // [2][kBlockN][LD]
  __nv_bfloat16* sV = sK + 2 * kBlockN * LD;                                // [2][kBlockN][D]
  float* sP = reinterpret_cast<float*>(sV + 2 * kBlockN * D);               // [kRows][kBlockN]
  float* sCorr = sP + kRows * kBlockN;                                      // [kRows]

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int R = a.rows;
  const int offset = a.S - a.T;
  int lo, hi;
  tile_range(a, lo, hi);
  const int n = hi - lo;
  const int tb = lo + static_cast<int>(static_cast<long long>(split) * n / a.splits);
  const int te = lo + static_cast<int>(static_cast<long long>(split + 1) * n / a.splits);

  // The rows, f32: row r is position r / group of query head kvh * group + r % group.
  for (int e = tid; e < kRows * D; e += kThreads) {
    const int r = e / D, d = e % D;
    float x = 0.f;
    if (r < R) {
      const int h = kvh * a.group + r % a.group;
      const long long t = r / a.group;
      x = __bfloat162float(a.q[b * a.sq[0] + h * a.sq[1] + t * a.sq[2] + d]);
    }
    sQ[e] = x;
  }
  const __nv_bfloat16* kbase = a.k + b * a.sk[0] + kvh * a.sk[1];
  const __nv_bfloat16* vbase = a.v + b * a.sv[0] + kvh * a.sv[1];
  auto load = [&](int tile, int buf) {
    const int key0 = tile * kBlockN;
    __nv_bfloat16* dk = sK + buf * kBlockN * LD;
    __nv_bfloat16* dv = sV + buf * kBlockN * D;
    for (int c = tid; c < kBlockN * kChunks; c += kThreads) {
      const int row = c / kChunks, col = (c % kChunks) * 8;
      const int key = key0 + row;
      const bool in = key < a.S;
      cp_async16(dk + row * LD + col, in ? kbase + key * a.sk[2] + col : kbase, in ? 16 : 0);
      cp_async16(dv + row * D + col, in ? vbase + key * a.sv[2] + col : vbase, in ? 16 : 0);
    }
    cp_async_commit();
  };

  float m[kRowsPerWarp], l[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = -1e30f;
    l[i] = 0.f;
  }
  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.f;

  if (tb < te) load(tb, 0);
  for (int it = tb; it < te; ++it) {
    const int buf = (it - tb) & 1;
    if (it + 1 < te) {
      load(it + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* tk = sK + buf * kBlockN * LD;
    const __nv_bfloat16* tv = sV + buf * kBlockN * D;

    // Scores: two threads a key, each over alternate 16-byte chunks of d.
    {
      const int key = tid >> 1, half = tid & 1;
      float sc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) sc[r] = 0.f;
#pragma unroll 4
      for (int c = half; c < kChunks; c += 2) {
        float kf[8];
        widen8(tk + key * LD + c * 8, kf);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (r < R) {
            const float4 q0 = *reinterpret_cast<const float4*>(sQ + r * D + c * 8);
            const float4 q1 = *reinterpret_cast<const float4*>(sQ + r * D + c * 8 + 4);
            sc[r] = fmaf(q0.x, kf[0], sc[r]);
            sc[r] = fmaf(q0.y, kf[1], sc[r]);
            sc[r] = fmaf(q0.z, kf[2], sc[r]);
            sc[r] = fmaf(q0.w, kf[3], sc[r]);
            sc[r] = fmaf(q1.x, kf[4], sc[r]);
            sc[r] = fmaf(q1.y, kf[5], sc[r]);
            sc[r] = fmaf(q1.z, kf[6], sc[r]);
            sc[r] = fmaf(q1.w, kf[7], sc[r]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        sc[r] += __shfl_xor_sync(kFull, sc[r], 1);
        if (half == 0 && r < R) sP[r * kBlockN + key] = sc[r] * a.scale_log2;
      }
    }
    __syncthreads();

    // Online softmax, warp w owning rows w, w + 4, ...
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp + kWarps * i;
      if (r < R) {
        const int qpos = offset + r / a.group;
        const int key0 = it * kBlockN + lane;
        const float* sr = sP + r * kBlockN;
        const float x0 = visible(key0, qpos, a.S, a.causal, a.window) ? sr[lane] : -CUDART_INF_F;
        const float x1 =
            visible(key0 + 32, qpos, a.S, a.causal, a.window) ? sr[lane + 32] : -CUDART_INF_F;
        const float mn = fmaxf(m[i], warp_max(fmaxf(x0, x1)));  // finite: m starts at -1e30
        const float corr = exp2f(m[i] - mn);
        const float p0 = exp2f(x0 - mn), p1 = exp2f(x1 - mn);
        sP[r * kBlockN + lane] = p0;
        sP[r * kBlockN + lane + 32] = p1;
        l[i] = l[i] * corr + warp_sum(p0 + p1);
        m[i] = mn;
        if (lane == 0) sCorr[r] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + p v, one column a thread.
    if (tid < D) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r < R) acc[r] *= sCorr[r];
      }
#pragma unroll 4
      for (int j = 0; j < kBlockN; ++j) {
        const float vv = __bfloat162float(tv[j * D + tid]);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (r < R) acc[r] = fmaf(sP[r * kBlockN + j], vv, acc[r]);
        }
      }
    }
    __syncthreads();  // the next iteration's load overwrites this buffer
  }

  const int h0 = kvh * a.group;  // the CTA's first query head
  if (a.o != nullptr && a.splits == 1) {
    // The whole visible range in one CTA: divide by the row sums (through
    // shared memory to the threads that own the columns) and write bf16.
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp + kWarps * i;
      if (r < R && lane == 0) {
        sCorr[r] = l[i];
        if (a.lse != nullptr) {
          a.lse[(static_cast<long long>(b) * a.Hkv * a.group + h0 + r % a.group) * a.T +
                r / a.group] = row_lse(m[i], l[i]);
        }
      }
    }
    __syncthreads();
    if (tid < D) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r < R) {
          a.o[b * a.so[0] + (h0 + r % a.group) * a.so[1] + static_cast<long long>(r / a.group) *
                  a.so[2] + tid] = __float2bfloat16(acc[r] / fmaxf(sCorr[r], 1e-30f));
        }
      }
    }
    return;
  }

  // The partial results of this split.
  const long long part0 = (static_cast<long long>(b) * a.Hkv + kvh) * a.splits * R;
  const long long row_base = part0 + static_cast<long long>(split) * R;
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp + kWarps * i;
    if (r < R && lane == 0) {
      a.part_ml[(row_base + r) * 2] = m[i];
      a.part_ml[(row_base + r) * 2 + 1] = l[i];
    }
  }
  if (tid < D) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < R) a.part_o[(row_base + r) * D + tid] = acc[r];
    }
  }
  if (a.o == nullptr) return;

  // Arrival: the barrier orders every thread's partial stores before thread
  // 0's count, an acquire-release atomic at device scope (cumulative: those
  // stores are visible device-wide before the count, and whatever the last
  // CTA reads after it sees every split that counted before). The CTA that
  // counts last merges every split's partial of its (b, KV head).
  // The flag lives in sCorr, free after the loop: a static __shared__
  // variable would add to each CTA's shared memory, and at three CTAs an SM
  // that cost 0.003 ms a call on an H100 (launch/compare.py --attention).
  int& is_last = *reinterpret_cast<int*>(sCorr);
  __syncthreads();
  if (tid == 0) {
    int* counter = a.counters + static_cast<long long>(b) * a.Hkv + kvh;
    int before;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
                 : "=r"(before)
                 : "l"(counter)
                 : "memory");
    is_last = before == a.splits - 1;
    if (is_last) *counter = 0;  // every split has arrived: ready for the next launch
  }
  __syncthreads();
  if (!is_last) return;

  merge_splits<D>(a.part_o + part0 * D, a.part_ml + part0 * 2,
                  a.o + b * a.so[0] + static_cast<long long>(h0) * a.so[1], a.so[1], a.so[2],
                  a.lse == nullptr
                      ? nullptr
                      : a.lse + (static_cast<long long>(b) * a.Hkv * a.group + h0) * a.T,
                  a.T, R, a.group, a.splits, warp, lane);
}

template <int D, int kRows>
cudaError_t launch(const DecodeArgs& a, int B, cudaStream_t stream) {
  constexpr int smem = decode_smem_bytes<D, kRows>();
  static std::atomic<bool> configured[kMaxDevices];
  const cudaError_t err = once_per_device(configured, [] {
    cudaError_t e = cudaFuncSetAttribute(flash_decode_kernel<D, kRows>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    // All of the SM's unified memory as shared memory: three CTAs of the
    // path's decode step (72.7 KB each) fit an SM, so its 320 CTAs run in
    // one wave.
    return cudaFuncSetAttribute(flash_decode_kernel<D, kRows>,
                                cudaFuncAttributePreferredSharedMemoryCarveout,
                                cudaSharedmemCarveoutMaxShared);
  });
  if (err != cudaSuccess) return err;
  flash_decode_kernel<D, kRows><<<dim3(a.splits, a.Hkv, B), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// C entry point (bound with ctypes). q and o (B, Hq, T, D), k and v (B,
// Hkv, S, D), bf16 with a unit last stride; `strides` holds 12 element
// strides (q's, k's, v's and o's over their first three axes); k and v rows
// 16-byte aligned. Hq / Hkv * T <= 16, D in {64, 128}, window < 0 is no
// window. `part` is the caller's f32 scratch: part_o (B * Hkv * splits *
// rows * D floats, rows = Hq / Hkv * T) then part_ml (B * Hkv * splits *
// rows * 2). `counters` holds at least B * Hkv int32 zeros, which the launch
// leaves zero. o non-null: one launch computes the output (splits == 1 needs
// neither part nor counters), and with lse non-null each row's log-sum-exp
// (f32, (B, Hq, T) contiguous). o null: only the partials are written (lse
// must be null). Returns cudaGetLastError() after the launch.
extern "C" int flash_decode_bf16(const void* q, const void* k, const void* v, void* o, void* lse,
                                 void* part, void* counters, int B, int Hq, int Hkv, int T, int S,
                                 int D, int causal, int window, float scale,
                                 const long long* strides, int splits, void* stream) {
  DecodeArgs a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.o = static_cast<__nv_bfloat16*>(o);
  a.lse = static_cast<float*>(lse);
  a.T = T;
  a.S = S;
  a.Hkv = Hkv;
  a.group = Hq / Hkv;
  a.rows = a.group * T;
  a.part_o = static_cast<float*>(part);
  a.part_ml = a.part_o == nullptr
                  ? nullptr
                  : a.part_o + static_cast<long long>(B) * Hkv * splits * a.rows * D;
  a.counters = static_cast<int*>(counters);
  a.causal = causal;
  a.window = window;
  a.splits = splits;
  a.scale_log2 = scale * kLog2e;
  for (int i = 0; i < 3; ++i) {
    a.sq[i] = strides[i];
    a.sk[i] = strides[3 + i];
    a.sv[i] = strides[6 + i];
    a.so[i] = strides[9 + i];
  }
  const bool needs_part = o == nullptr || splits > 1;
  if (a.rows < 1 || a.rows > 16 || splits < 1 || (needs_part && part == nullptr) ||
      (o != nullptr && splits > 1 && counters == nullptr) || (o == nullptr && lse != nullptr)) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool small = a.rows <= 4;
  switch (D) {
    case 64: return small ? launch<64, 4>(a, B, s) : launch<64, 16>(a, B, s);
    case 128: return small ? launch<128, 4>(a, B, s) : launch<128, 16>(a, B, s);
    default: return cudaErrorInvalidValue;
  }
}

// Dynamic shared memory of one decode CTA at head dim D and `rows` packed rows.
extern "C" int flash_decode_bf16_smem_bytes(int D, int rows) {
  if (D == 64) return rows <= 4 ? decode_smem_bytes<64, 4>() : decode_smem_bytes<64, 16>();
  if (D == 128) return rows <= 4 ? decode_smem_bytes<128, 4>() : decode_smem_bytes<128, 16>();
  return 0;
}
