// Flash (online-softmax) attention for Hopper (sm_90a) in true f32: every
// product an fmaf on the FP32 pipes, K and V brought in by TMA. Grouped-query
// heads, causal and sliding-window masks, queries at the end of the key
// timeline.
//
// Replaces: src/repro/kernels/flash_attention.py:112 flash_attention_pallas
// (pallas_call at :151, body _flash_kernel at :39), for f32 calls whose q,
// k and v have 16-byte aligned bases and strides (what TMA and float4 loads
// need), D in {8, 16, 32, 64, 128}. The rest stays on the SIMT kernel in
// flash_attention.cu (entry flash_attention_f32_simt). Semantics as the
// reference: query head h reads KV head h / group; the T queries sit at
// positions S - T .. S - 1; causal keeps keys p <= q_pos, a window keeps
// p > q_pos - window; q is multiplied by the scale in f32 first (the
// reference's q.astype(f32) * scale); the running max starts at -1e30,
// masked probabilities are 0, and the output is acc / max(l, 1e-30).
//
// Numerics: the reference holds f32 attention to 2e-4, which TF32 cannot
// meet, so no tensor core is used (as in the f32 GEMM, matmul_f32_tma.cu).
//
// Bound on an H100 SXM: the causal prefill at B8 Hq32 Hkv8 T=S=1024 D128
// does 4*D operations per visible pair (two products), 6.88e10 in all,
// against 168 MB of q, k, v and o: 1.027 ms at 67 TFLOP/s against 0.050 ms at
// 3.35 TB/s, bound by operations. So the FP32 pipes must issue without
// pause. What held the SIMT kernel back: every tile waited for its own
// loads; a fixed 64-key tile zero-filled past S by the threads; scores two
// keys by eight rows a lane, with K widened from shared memory for every
// 4-wide slice of D (about one shared load per FMA). The design:
//
// - A CTA owns kRows packed rows of ONE KV head, position-major over its
//   `group` query heads (row i is position i / group of head i % group), so
//   K and V are read once per CTA, never once per query head. The rows are
//   kWarps consumer warps of 16; a warp owns its rows through both products
//   and the softmax, so warps never wait for each other. Two variants of
//   the one kernel: 8 warps (128 rows) for prefill, 1 warp (16 rows, a ring
//   of 2 stages) when a KV head has at most 16 rows (a decode step).
// - One producer thread keeps K and V tiles of 64 keys in flight by TMA,
//   each with a full and an empty mbarrier. It fetches the two tensor maps
//   and starts the first tile's loads before the CTA's first barrier, while
//   the consumers load Q. In the 8-warp variant it sits in a warpgroup of
//   its own whose registers setmaxnreg hands to the consumers (232 a
//   thread, where 384 threads at launch get 168). K and V have
//   separate slots: the next K tile loads once every warp has built its
//   scores from this one, while the warps run the softmax and P V; the next
//   V tile once every warp is done with P V, while they build the next
//   scores. TMA fills keys past S with zeros, so those cost no DRAM bytes
//   (the smoke path's S of 16 and 32 reads one short tile). Tiles land with
//   TMA's 32/64/128-byte swizzle (a box row is min(D, 32) floats), so the
//   reads below hit distinct banks.
// - Q sits in shared memory, f32, pre-scaled, rows padded by 16 bytes.
// - S = Q K^T: lane (lr, lk) = (lane / 8, lane % 8) owns rows lr + 4i
//   (i < 4) and keys lk + 8j (j < 8) of its warp's 16 x 64 tile. Per four
//   d it reads 4 float4 of Q (4 distinct rows a warp, broadcast) and 8
//   float4 of K (8 distinct keys, distinct banks under the swizzle), one
//   key at a time, for 128 FMAs.
// - Softmax: scores scaled by log2(e), the row max over the 8 lanes of a
//   row by shuffles, exp2f, per-lane partial sums (the 8 lanes' sums are
//   added once, at the end). Masks only on tiles that cross
//   the diagonal, a window edge or S. P goes to the warp's own rows of a
//   shared buffer (pitch 72 floats, no bank conflicts either way).
// - O += P V: the lane owns rows lr + 4i and D / 8 columns (float4 chunks
//   lk + 8c for D >= 32). Per key it reads its columns of V (8 lanes over
//   128 bytes, broadcast over lr); per 8 keys two float4 of P a row: for D =
//   128, 40 shared loads for 512 FMAs.
// - Causal balance: the row block is the slowest grid index, counted down,
//   so the heaviest blocks (latest positions, most key tiles) start first.
// - Key groups past S on the last tile take no P V, and the one-warp
//   variant's softmax skips rows past the KV head's (their P is never
//   written, their output dropped). The products run whole, those rows and
//   keys included (zeros, then masked): guarding them per row and key made
//   a decode step of 2 rows and 32 keys slower, not faster (PERF.md).
//
// With an lse pointer the epilogue also writes each row's log-sum-exp of its
// scaled scores (f32, (B, Hq, T), natural-log units, (m + log2 l) * ln 2
// from the row state the loop keeps; -inf for a row that sees no key): a
// store a row, nothing else changes. The split rule of kernels/ops.py
// merges ranks' slices of a cache with it.
//
// Shared memory at D 128: 171 KB for 8 warps (one CTA an SM), 145 KB for the
// decode variant. On an H100 at 700 W the full-width prefill runs at about
// 0.48 of its bound (PERF.md, from chip_smoke.py phase 5). What holds it
// there is not isolated (ncu does not run on that machine); candidates:
// two consumer warps an SMSP to hide shared-load and exponential latency,
// about one shared load per 11 FMAs plus the softmax's issue, K and V
// single-buffered (a slow warp delays the next tile's load for all), 6% of
// masked work on the diagonal, and the last of 15.5 waves. At the smoke
// LM's decode step (2 rows, 32 keys) a one-warp chain of TMA, products,
// softmax and stores is the time, not the work.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kBlockN = 64;        // keys per tile
constexpr int kRowsPerWarp = 16;   // packed rows a consumer warp owns
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr unsigned kFull = 0xffffffffu;

template <int D, int kWarps, int kStages>
struct Layout {
  static constexpr int kRows = kWarps * kRowsPerWarp;  // packed rows per CTA
  // The producer: a warpgroup beside two consumer warpgroups (setmaxnreg
  // moves its registers to them), a warp beside one consumer warp.
  static constexpr int kProducerWarps = kWarps == 8 ? 4 : 1;
  static constexpr int kThreads = 32 * (kWarps + kProducerWarps);
  static constexpr int kBoxD = D < 32 ? D : 32;        // floats in a TMA box row
  static constexpr int kRowBytes = kBoxD * 4;          // 32, 64 or 128: the swizzle span
  static constexpr int kChunksPerRow = kRowBytes / 16;
  static constexpr int kBoxes = D / kBoxD;
  static constexpr int kBoxBytes = kBlockN * kRowBytes;
  static constexpr int kTileBytes = kBoxes * kBoxBytes;  // one K or V tile
  static constexpr int kQPitch = D + 4;                  // floats
  static constexpr int kPPitch = kBlockN + 8;            // floats
  static constexpr int kKOff = 0;
  static constexpr int kVOff = kStages * kTileBytes;
  static constexpr int kQOff = 2 * kStages * kTileBytes;
  static constexpr int kPOff = kQOff + kRows * kQPitch * 4;
  static constexpr int kBarOff = kPOff + kRows * kPPitch * 4;
  static constexpr int kSmemBytes = kBarOff + 4 * kStages * 8 + 1024;
  static constexpr int kCols = D / 8;                  // output columns per lane
  static constexpr int kVec = kCols < 4 ? kCols : 4;   // floats per V read
  static constexpr int kVecs = kCols / kVec;
};

struct Args {
  const float* q;
  float* o;
  float* lse;  // (B, Hq, T), or nullptr: no log-sum-exp
  int T, S, Hkv, B, group, causal, window, row_blocks;
  float scale;
  long long sq[3], so[3];  // element strides over (b, h, t)
};

template <int N>
__device__ __forceinline__ void load_vec(const uint8_t* p, float* out) {
  if constexpr (N == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  } else if constexpr (N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x;
    out[1] = v.y;
  } else {
    out[0] = *reinterpret_cast<const float*>(p);
  }
}

template <int N>
__device__ __forceinline__ void store_vec(float* p, const float* v) {
  if constexpr (N == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

__device__ __forceinline__ bool visible(int key, int qpos, int S, int causal, int window) {
  return key < S && (!causal || key <= qpos) && (window < 0 || key > qpos - window);
}

template <int D, int kWarps, int kStages>
__global__ void __launch_bounds__(Layout<D, kWarps, kStages>::kThreads, 1)
flash_f32_kernel(const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v, const Args a) {
  using L = Layout<D, kWarps, kStages>;
  constexpr int RB = L::kRowBytes;
  constexpr int kMask = L::kChunksPerRow - 1;  // the swizzle: chunk ^= (byte >> 7) & kMask
  extern __shared__ uint8_t smem_raw[];
  // 1024-byte aligned (the 128-byte swizzle's period) by pointer arithmetic,
  // so the compiler keeps every access below a shared-memory one.
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* sQ = reinterpret_cast<float*>(smem + L::kQOff);
  float* sP = reinterpret_cast<float*>(smem + L::kPOff);
  uint64_t* k_full = reinterpret_cast<uint64_t*>(smem + L::kBarOff);
  uint64_t* v_full = k_full + kStages;
  uint64_t* k_empty = v_full + kStages;
  uint64_t* v_empty = k_empty + kStages;

  // The row block is the slowest grid index, counted down: heaviest first.
  const int per_block = a.Hkv * a.B;
  const int rb = a.row_blocks - 1 - static_cast<int>(blockIdx.x) / per_block;
  const int rest = static_cast<int>(blockIdx.x) % per_block;
  const int kvh = rest % a.Hkv, b = rest / a.Hkv;
  const int n_rows = a.group * a.T;
  const int row0 = rb * L::kRows;
  const int offset = a.S - a.T;  // absolute position of query 0
  const int t_first = row0 / a.group;
  const int t_last = (min(row0 + L::kRows, n_rows) - 1) / a.group;
  const int n_tiles = (a.S + kBlockN - 1) / kBlockN;
  int hi = n_tiles;
  if (a.causal) {
    const int last = offset + t_last;
    hi = last < 0 ? 0 : min(last / kBlockN + 1, n_tiles);
  }
  int lo = 0;
  if (a.window >= 0) {
    const int first_key = offset + t_first - a.window + 1;  // may be negative
    lo = first_key > 0 ? first_key / kBlockN : 0;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  const int wrow = warp * kRowsPerWarp;  // a consumer warp's first row in the CTA
  const int lr = lane >> 3, lk = lane & 7;
  const bool producer = warp == kWarps && lane == 0;
  // Tile j of K (v = false) or V into `stage` of its ring.
  auto issue = [&](bool v, int j, int stage) {
    uint64_t* full = (v ? v_full : k_full) + stage;
    uint8_t* dst = smem + (v ? L::kVOff : L::kKOff) + stage * L::kTileBytes;
    mbar_arrive_expect_tx(full, L::kTileBytes);
#pragma unroll
    for (int c = 0; c < L::kBoxes; ++c) {
      tma_load_4d(dst + c * L::kBoxBytes, v ? &map_v : &map_k, full, c * L::kBoxD, j * kBlockN,
                  kvh, b);
    }
  };

  // The producer thread starts the first tile's loads at once (its slots
  // are free); the consumers load Q meanwhile. Then the barrier.
  if (producer) {
    prefetch_tensormap(&map_k);
    prefetch_tensormap(&map_v);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], kWarps);  // lane 0 of every consumer warp
      mbar_init(&v_empty[s], kWarps);
    }
    fence_barrier_init();
    if (lo < hi) {
      issue(false, lo, 0);
      issue(true, lo, 0);
    }
  }
  if (warp < kWarps) {
    // Q rows of this warp, f32 and pre-scaled; rows past the KV head's are 0.
    for (int e = lane; e < kRowsPerWarp * (D / 4); e += 32) {
      const int r = e / (D / 4), c = e % (D / 4);
      const int p = row0 + wrow + r;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (p < n_rows) {
        const int h = kvh * a.group + p % a.group;
        x = __ldg(reinterpret_cast<const float4*>(a.q + b * a.sq[0] + h * a.sq[1] +
                                                  static_cast<long long>(p / a.group) * a.sq[2] +
                                                  4 * c));
        x.x *= a.scale;
        x.y *= a.scale;
        x.z *= a.scale;
        x.w *= a.scale;
      }
      *reinterpret_cast<float4*>(sQ + (wrow + r) * L::kQPitch + 4 * c) = x;
    }
  }
  __syncthreads();

  if (warp >= kWarps) {
    // Producer: the later tiles, K once every warp has its scores from the
    // K in that slot, V once every warp is done with the V there.
    if constexpr (L::kProducerWarps == 4) setmaxnreg_dec<40>();
    if (producer) {
      int stage = 1 % kStages;
      uint32_t phase = kStages == 1 ? 1 : 0;
      for (int j = lo + 1; j < hi; ++j) {
        mbar_wait(&k_empty[stage], phase ^ 1);
        issue(false, j, stage);
        mbar_wait(&v_empty[stage], phase ^ 1);
        issue(true, j, stage);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }
  if constexpr (L::kProducerWarps == 4) setmaxnreg_inc<232>();

  // Rows lr + 4i of the warp: state and positions. Row i of Q and P lies
  // 4i rows past the lane's first (a constant offset from one base).
  float m[4], l[4], o[4][L::kCols];
  int qpos[4];
  const float* q_rows = sQ + (wrow + lr) * L::kQPitch;
  float* p_rows = sP + (wrow + lr) * L::kPPitch;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -1e30f;
    l[i] = 0.f;
    qpos[i] = offset + (row0 + wrow + lr + 4 * i) / a.group;
#pragma unroll
    for (int c = 0; c < L::kCols; ++c) o[i][c] = 0.f;
  }
  const int pos_min = offset + t_first, pos_max = offset + t_last;
  // The one-warp variant's softmax runs only rows i < n_i, those that hold
  // rows of the KV head (a decode step fills 2 of its 16 in the smoke LM).
  const int n_i = kWarps == 1 ? min(4, (n_rows - row0 - wrow + 3) / 4) : 4;

  // Per-lane byte offsets under the swizzle. K: key lk + 8j, 16-byte chunk
  // cb of a box row (the swizzle term depends on lk alone). V: key 8g + jj,
  // this lane's columns (the term depends on jj alone).
  const int xk = ((lk * RB) >> 7) & kMask;
  int kofs[L::kChunksPerRow];
#pragma unroll
  for (int cb = 0; cb < L::kChunksPerRow; ++cb) kofs[cb] = lk * RB + ((cb ^ xk) << 4);
  const int col_byte = D >= 32 ? 16 * lk : 4 * L::kCols * lk;  // in its box row
  int vofs[8];
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const int xv = ((jj * RB) >> 7) & kMask;
    vofs[jj] = jj * RB + ((((col_byte >> 4) ^ xv) << 4) | (col_byte & 15));
  }

  int stage = 0;
  uint32_t phase = 0;
  for (int j = lo; j < hi; ++j) {
    const int k0 = j * kBlockN;
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) s[i][jj] = 0.f;

    // S = Q K^T, four d at a time, every row and key (rows past the KV
    // head's and keys past S are zeros; the masks below drop them).
    mbar_wait(&k_full[stage], phase);
    const uint8_t* kt = smem + L::kKOff + stage * L::kTileBytes;
#pragma unroll 1
    for (int bx = 0; bx < L::kBoxes; ++bx) {
      const uint8_t* kb = kt + bx * L::kBoxBytes;
#pragma unroll
      for (int cb = 0; cb < L::kChunksPerRow; ++cb) {
        // The 4 rows' four d first, then one key's at a time: 16 + 4
        // registers of operands for 128 FMAs.
        const int d0 = bx * L::kBoxD + 4 * cb;
        float4 q4[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          q4[i] = *reinterpret_cast<const float4*>(q_rows + 4 * i * L::kQPitch + d0);
        }
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const float4 kf = *reinterpret_cast<const float4*>(kb + jj * 8 * RB + kofs[cb]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            s[i][jj] = fmaf(q4[i].x, kf.x, s[i][jj]);
            s[i][jj] = fmaf(q4[i].y, kf.y, s[i][jj]);
            s[i][jj] = fmaf(q4[i].z, kf.z, s[i][jj]);
            s[i][jj] = fmaf(q4[i].w, kf.w, s[i][jj]);
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&k_empty[stage]);

    // Masks, the online max and sum, P to shared memory, O rescaled.
    const bool whole = k0 + kBlockN <= a.S && (!a.causal || k0 + kBlockN - 1 <= pos_min) &&
                       (a.window < 0 || k0 > pos_max - a.window);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i >= n_i) continue;  // past the KV head's rows: its P stays unwritten, its output dropped
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        float x = s[i][jj] * kLog2e;
        if (!whole && !visible(k0 + lk + 8 * jj, qpos[i], a.S, a.causal, a.window)) {
          x = -CUDART_INF_F;
        }
        s[i][jj] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int sh = 1; sh < 8; sh <<= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, sh));
      // m stays finite (>= -1e30), so exp2(-inf - m) is 0, never NaN.
      const float mn = fmaxf(m[i], mx);
      const float corr = exp2f(m[i] - mn);
      m[i] = mn;
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float p = exp2f(s[i][jj] - mn);
        sum += p;
        p_rows[4 * i * L::kPPitch + lk + 8 * jj] = p;
      }
      l[i] = l[i] * corr + sum;  // this lane's partial; the 8 lanes add theirs at the end
#pragma unroll
      for (int c = 0; c < L::kCols; ++c) o[i][c] *= corr;
    }
    __syncwarp();

    // O += P V, eight keys at a time, over the groups that hold keys below
    // S (on the last tile, the rest have p = 0).
    const int n_g = (min(kBlockN, a.S - k0) + 7) / 8;
    mbar_wait(&v_full[stage], phase);
    const uint8_t* vt = smem + L::kVOff + stage * L::kTileBytes;
#pragma unroll 1
    for (int g = 0; g < n_g; ++g) {
      float p[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float* pr = p_rows + 4 * i * L::kPPitch + 8 * g;
        const float4 p0 = *reinterpret_cast<const float4*>(pr);
        const float4 p1 = *reinterpret_cast<const float4*>(pr + 4);
        p[i][0] = p0.x;
        p[i][1] = p0.y;
        p[i][2] = p0.z;
        p[i][3] = p0.w;
        p[i][4] = p1.x;
        p[i][5] = p1.y;
        p[i][6] = p1.z;
        p[i][7] = p1.w;
      }
      const uint8_t* vg = vt + g * 8 * RB;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
        for (int vv = 0; vv < L::kVecs; ++vv) {
          float vf[L::kVec];
          load_vec<L::kVec>(vg + vv * L::kBoxBytes + vofs[jj], vf);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < L::kVec; ++e) {
              o[i][vv * L::kVec + e] = fmaf(p[i][jj], vf[e], o[i][vv * L::kVec + e]);
            }
        }
      }
    }
    __syncwarp();  // P is rewritten by the next tile
    if (lane == 0) mbar_arrive(&v_empty[stage]);
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }

  // Epilogue: the 8 lanes' sums of a row, the division, f32 out through o's
  // strides; rows past the KV head's are dropped.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int sh = 1; sh < 8; sh <<= 1) l[i] += __shfl_xor_sync(kFull, l[i], sh);
    const int p = row0 + wrow + lr + 4 * i;
    if (p >= n_rows) continue;
    const int h = kvh * a.group + p % a.group;
    if (a.lse != nullptr && lk == 0) {  // m and l are the same on the row's 8 lanes
      a.lse[(static_cast<long long>(b) * a.Hkv * a.group + h) * a.T + p / a.group] =
          l[i] > 0.f ? (m[i] + log2f(l[i])) * kLn2 : -CUDART_INF_F;
    }
    float* orow = a.o + b * a.so[0] + h * a.so[1] + static_cast<long long>(p / a.group) * a.so[2];
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int vv = 0; vv < L::kVecs; ++vv) {
      float out[L::kVec];
#pragma unroll
      for (int e = 0; e < L::kVec; ++e) out[e] = o[i][vv * L::kVec + e] / denom;
      const int col = D >= 32 ? 4 * (lk + 8 * vv) : L::kCols * lk;
      store_vec<L::kVec>(orow + col, out);
    }
  }
}

CUtensorMapSwizzle swizzle_for(int row_bytes) {
  return row_bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
         : row_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                           : CU_TENSOR_MAP_SWIZZLE_32B;
}

// k, v (B, Hkv, S, D) through element strides st[0..2] (batch, head, key):
// a 4-D map over (D, S, Hkv, B), box (min(D, 32), 64, 1, 1).
template <int D>
bool encode_kv(CUtensorMap* map, const void* base, int B, int Hkv, int S, const long long* st) {
  constexpr int kBoxD = D < 32 ? D : 32;
  const uint64_t dims[4] = {static_cast<uint64_t>(D), static_cast<uint64_t>(S),
                            static_cast<uint64_t>(Hkv), static_cast<uint64_t>(B)};
  const uint64_t strides[3] = {4ull * st[2], 4ull * st[1], 4ull * st[0]};
  const uint32_t box[4] = {kBoxD, kBlockN, 1, 1};
  return encode_f32(map, swizzle_for(kBoxD * 4), 4, base, dims, strides, box);
}

template <int D, int kWarps, int kStages>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, int B, int Hq, int Hkv,
           int T, int S, int causal, int window, float scale, const long long* st,
           cudaStream_t stream) {
  using L = Layout<D, kWarps, kStages>;
  CUtensorMap mk, mv;
  if (!encode_kv<D>(&mk, k, B, Hkv, S, st + 3) || !encode_kv<D>(&mv, v, B, Hkv, S, st + 6)) {
    return kMapError;
  }
  Args a;
  a.q = static_cast<const float*>(q);
  a.o = static_cast<float*>(o);
  a.lse = static_cast<float*>(lse);
  a.T = T;
  a.S = S;
  a.Hkv = Hkv;
  a.B = B;
  a.group = Hq / Hkv;
  a.causal = causal;
  a.window = window;
  a.scale = scale;
  a.row_blocks = (a.group * T + L::kRows - 1) / L::kRows;
  for (int i = 0; i < 3; ++i) {
    a.sq[i] = st[i];
    a.so[i] = st[9 + i];
  }
  const long long grid = static_cast<long long>(a.row_blocks) * Hkv * B;
  if (grid < 1 || grid > 0x7fffffffll) return cudaErrorInvalidValue;
  static std::atomic<bool> configured[kMaxDevices];
  const cudaError_t err = once_per_device(configured, [] {
    return cudaFuncSetAttribute(flash_f32_kernel<D, kWarps, kStages>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmemBytes);
  });
  if (err != cudaSuccess) return err;
  flash_f32_kernel<D, kWarps, kStages>
      <<<static_cast<unsigned>(grid), L::kThreads, L::kSmemBytes, stream>>>(mk, mv, a);
  return cudaGetLastError();
}

// At most 16 packed rows per KV head: the one-warp variant with a 2-stage ring.
template <int D>
int route(const void* q, const void* k, const void* v, void* o, void* lse, int B, int Hq, int Hkv,
          int T, int S, int causal, int window, float scale, const long long* st, cudaStream_t s) {
  if (Hq / Hkv * T <= kRowsPerWarp) {
    return launch<D, 1, 2>(q, k, v, o, lse, B, Hq, Hkv, T, S, causal, window, scale, st, s);
  }
  return launch<D, 8, 1>(q, k, v, o, lse, B, Hq, Hkv, T, S, causal, window, scale, st, s);
}

}  // namespace

// C entry point (bound with ctypes): q (B, Hq, T, D), k and v (B, Hkv, S,
// D), o (B, Hq, T, D), f32, unit last stride, 16-byte aligned bases; lse
// null, or each row's log-sum-exp out (f32, (B, Hq, T) contiguous);
// `strides` holds 12 element strides (q's, k's, v's and o's over their
// first three axes), each a multiple of 4 (the caller substitutes one for an
// axis of extent 1). D in {8, 16, 32, 64, 128}; window < 0 is no window; S
// >= 1. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a call it does not take or a tensor map that
// cuTensorMapEncodeTiled refuses.
extern "C" int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                                   void* lse, int B, int Hq, int Hkv, int T, int S, int D,
                                   int causal, int window, float scale, const long long* strides,
                                   void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* st = strides;
  switch (D) {
    case 8: return route<8>(q, k, v, o, lse, B, Hq, Hkv, T, S, causal, window, scale, st, s);
    case 16: return route<16>(q, k, v, o, lse, B, Hq, Hkv, T, S, causal, window, scale, st, s);
    case 32: return route<32>(q, k, v, o, lse, B, Hq, Hkv, T, S, causal, window, scale, st, s);
    case 64: return route<64>(q, k, v, o, lse, B, Hq, Hkv, T, S, causal, window, scale, st, s);
    case 128: return route<128>(q, k, v, o, lse, B, Hq, Hkv, T, S, causal, window, scale, st, s);
    default: return cudaErrorInvalidValue;
  }
}

// Dynamic shared memory of one CTA at head dim D and `rows` packed rows per
// KV head (0 for a D it does not take).
extern "C" int flash_attention_f32_smem_bytes(int D, int rows) {
  const bool one = rows <= kRowsPerWarp;
  switch (D) {
    case 8: return one ? Layout<8, 1, 2>::kSmemBytes : Layout<8, 8, 1>::kSmemBytes;
    case 16: return one ? Layout<16, 1, 2>::kSmemBytes : Layout<16, 8, 1>::kSmemBytes;
    case 32: return one ? Layout<32, 1, 2>::kSmemBytes : Layout<32, 8, 1>::kSmemBytes;
    case 64: return one ? Layout<64, 1, 2>::kSmemBytes : Layout<64, 8, 1>::kSmemBytes;
    case 128: return one ? Layout<128, 1, 2>::kSmemBytes : Layout<128, 8, 1>::kSmemBytes;
    default: return 0;
  }
}
