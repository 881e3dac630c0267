// Flash (online-softmax) attention for Hopper (sm_90a), bf16, on the tensor
// cores: the prefill kernel. Grouped-query heads, causal and sliding-window
// masks, queries at the end of the key timeline, f32 softmax and
// accumulators, bf16 output.
//
// Replaces: src/repro/kernels/flash_attention.py:112 flash_attention_pallas
// (pallas_call at :151, body _flash_kernel at :39), for bf16 calls with D in
// {64, 80, 128}, at least 64 packed rows per KV head, a group (Hq / Hkv) of
// at most 128, and q, k, v whose base addresses and strides TMA can take
// (16-byte multiples). The rest stays on the SIMT kernel in
// flash_attention.cu (D 8, 16 and 32, fewer packed rows, views TMA cannot
// read); the decode steps (at most 16 rows per KV head) go to
// flash_decode.cu.
//
// Semantics as the reference: query head h reads KV head h / group; the T
// queries sit at positions S - T .. S - 1; causal keeps keys p <= q_pos, a
// window keeps p > q_pos - window; the running max starts at -1e30, masked
// probabilities are 0, and the output is acc / max(l, 1e-30).
//
// Bound on an H100 SXM: the causal prefill at B8 Hq32 Hkv8 T=S=1024 D128
// does 4*D operations per visible pair, 6.9e10 in all, against 168 MB of q,
// k, v and o: 0.070 ms at 989 TFLOP/s against 0.050 ms at 3.35 TB/s, bound
// by operations. At D 80 (B8 H16 T=S=4096, bidirectional) 6.9e11
// operations, 0.695 ms; both products issue exactly D columns there, so the
// work is the bound's. The design feeds the tensor cores:
// - A CTA owns rows = group * floor(128 / group) packed rows of ONE KV head
//   (128 for a group that divides 128, 126 at group 6), position-major over
//   its `group` query heads (row i is position i / group of head i % group),
//   so every CTA holds whole positions and K and V are read once per KV
//   head. The packing is a TMA box: q (B, Hq, T, D) is a 4-D tensor map over
//   (D, Hq, T, B) with box [64][group][128 / group][1], which lands the
//   packed rows in shared memory in order; the output leaves through the
//   same box. Rows `rows`..127 are never loaded or stored: they are zeroed
//   once, so no uninitialised value enters a wgmma. D > 64 is two 64-column
//   boxes (the 128-byte swizzle's width); at D 80 the tensor maps' inner
//   extent is 80, so TMA fills columns 80..127 with zeros and the store of
//   O drops them.
// - One producer thread and two consumer warpgroups of 64 rows (setmaxnreg
//   moves registers to them). Q loads once; K and V tiles of 128 keys go
//   through a ring of 2 stages, each with its own full barriers for K and
//   for V and one empty barrier, so the next tile streams in while this one
//   is multiplied.
// - S = Q K^T by wgmma m64n128k16 from shared memory (K rows are K-major,
//   as wgmma's B wants), ceil(D / 16) k-steps: 5 at D 80, none over the
//   zero columns. The scale multiplies the f32 accumulators (with log2 e,
//   for exp2); q is never rounded pre-scaled. The masks apply only on tiles
//   that some row cannot fully see; the online max and sum stay in
//   registers (a row lives in a quad of threads).
// - P goes to bf16 in registers, in the accumulator's own layout, which is
//   wgmma's register-A layout; O += P V by wgmma m64n{D}k16 with V from
//   shared memory, MN-major, through the transpose bit (n80 reads the
//   second 64-column box's first 16 columns).
// - The epilogue divides by max(l, 1e-30), writes bf16 into Q's buffer in
//   the swizzled layout and stores it by TMA, which drops rows past T.
// - Key tiles [lo, hi) from the causal and window masks as in the
//   reference, from the CTA's first and last positions; ragged T and S: TMA
//   fills zeros outside the tensors and the masks do the rest. CTAs run
//   latest positions first, so the causal grid's longest rows start first.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kBlockM = 128;  // packed rows per CTA
constexpr int kBlockN = 128;  // keys per tile
constexpr int kStages = 2;
constexpr int kThreads = 384;  // two consumer warpgroups + the producer's
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Layout {
  static constexpr int kWidth = D <= 64 ? 64 : 128;  // columns a row holds in shared memory
  static constexpr int kChunks = kWidth / 64;        // 64-column boxes per row
  static constexpr int kKSteps = (D + 15) / 16;      // k16 steps of S = Q K^T
  static constexpr int kQChunk = kBlockM * 128;     // bytes of one box of Q (and of O)
  static constexpr int kKVChunk = kBlockN * 128;    // bytes of one box of a K or V tile
  static constexpr int kQBytes = kChunks * kQChunk;
  static constexpr int kKVBytes = kChunks * kKVChunk;
  static constexpr int kBarriers = 1 + 3 * kStages;
  static constexpr int kSmemBytes = kQBytes + 2 * kStages * kKVBytes + kBarriers * 8 + 1024;
};

struct FwdArgs {
  int T, S, group, positions, causal, window;  // positions = floor(kBlockM / group) per CTA
  // ceil(2^16 / group): a packed row r < 128 is position (r * row_div) >> 16
  // of the CTA's, exactly (the error r * (row_div - 2^16 / group) / 2^16 <
  // 1/512 never reaches the next multiple of 1 / group >= 1/128). An integer
  // division there, once per thread, doubled the kernel's time: short of
  // registers, ptxas recomputes the quotient inside the tile loop.
  int row_div;
  float scale_log2;  // scale * log2(e)
};

// O (64 x N) += P (64 x 16, registers) V (16 x N, MN-major).
template <int N>
__device__ __forceinline__ void pv_mma(float (&o)[N / 2], const uint32_t (&p)[4], uint64_t dv) {
  if constexpr (N == 64) {
    wgmma_m64n64k16_rs<1>(o, p, dv, 1);
  } else if constexpr (N == 80) {
    wgmma_m64n80k16_rs<1>(o, p, dv, 1);
  } else {
    wgmma_m64n128k16_rs<1>(o, p, dv, 1);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       const __grid_constant__ CUtensorMap map_o, const FwdArgs a) {
  using L = Layout<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* sQ = smem;                                 // [chunk][128 rows][128 B]
  uint8_t* sK = sQ + L::kQBytes;                      // [stage][chunk][128 keys][128 B]
  uint8_t* sV = sK + kStages * L::kKVBytes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sV + kStages * L::kKVBytes);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* empty = v_full + kStages;

  const int b = blockIdx.z;
  const int kvh = blockIdx.y;
  const int rows = a.group * a.positions;                      // packed rows this CTA owns
  const int t0 = (gridDim.x - 1 - blockIdx.x) * a.positions;  // latest positions first
  const int t_last = min(t0 + a.positions, a.T) - 1;
  const int offset = a.S - a.T;  // absolute position of query 0
  const int n_tiles = (a.S + kBlockN - 1) / kBlockN;
  int hi = n_tiles;
  if (a.causal) {
    const int last = offset + t_last;
    hi = last < 0 ? 0 : min(last / kBlockN + 1, n_tiles);
  }
  int lo = 0;
  if (a.window >= 0) {
    const int first_key = offset + t0 - a.window + 1;  // may be negative
    lo = first_key > 0 ? first_key / kBlockN : 0;
  }
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], 8);  // lane 0 of every consumer warp
    }
    fence_barrier_init();
  }
  // Rows rows..127 (a group that does not divide 128) are never loaded:
  // zeros, made visible to the async proxy (wgmma) before the barrier.
#pragma unroll
  for (int c = 0; c < L::kChunks; ++c) {
    for (int i = rows * 8 + threadIdx.x; i < kBlockM * 8; i += kThreads) {  // 16 bytes each
      *reinterpret_cast<uint4*>(sQ + c * L::kQChunk + i * 16) = make_uint4(0, 0, 0, 0);
    }
  }
  fence_proxy_async();
  __syncthreads();

  if (wg == 2) {
    setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      mbar_arrive_expect_tx(q_full, L::kChunks * rows * 128);
#pragma unroll
      for (int c = 0; c < L::kChunks; ++c) {
        tma_load_4d(sQ + c * L::kQChunk, &map_q, q_full, 64 * c, kvh * a.group, t0, b);
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int j = lo; j < hi; ++j) {
        mbar_wait(&empty[stage], phase ^ 1);
        uint8_t* k_dst = sK + stage * L::kKVBytes;
        uint8_t* v_dst = sV + stage * L::kKVBytes;
        mbar_arrive_expect_tx(&k_full[stage], L::kKVBytes);
#pragma unroll
        for (int c = 0; c < L::kChunks; ++c) {
          tma_load_4d(k_dst + c * L::kKVChunk, &map_k, &k_full[stage], 64 * c, j * kBlockN, kvh, b);
        }
        mbar_arrive_expect_tx(&v_full[stage], L::kKVBytes);
#pragma unroll
        for (int c = 0; c < L::kChunks; ++c) {
          tma_load_4d(v_dst + c * L::kKVChunk, &map_v, &v_full[stage], 64 * c, j * kBlockN, kvh, b);
        }
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    setmaxnreg_inc<240>();
    const int t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32;
    const int r_box = wg * 64 + warp * 16 + lane / 4;  // this thread's first row in the block
    // This thread's two rows' positions (row_div: no division in device code).
    const int qpos0 = offset + t0 + ((r_box * a.row_div) >> 16);
    const int qpos1 = offset + t0 + (((r_box + 8) * a.row_div) >> 16);
    const int pos_min = offset + t0, pos_max = offset + t_last;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m0 = -1e30f, m1 = -1e30f, l0 = 0.f, l1 = 0.f;
    const uint32_t q_base = smem_u32(sQ) + wg * 64 * 128;

    mbar_wait(q_full, 0);
    int stage = 0;
    uint32_t phase = 0;
    for (int j = lo; j < hi; ++j) {
      const int k0 = j * kBlockN;
      float s[kBlockN / 2];
      mbar_wait(&k_full[stage], phase);
      const uint32_t k_base = smem_u32(sK + stage * L::kKVBytes);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < L::kKSteps; ++kk) {
        const uint32_t off = (kk % 4) * 32;  // 16 columns right in the 128-byte row
        const uint64_t dq = wgmma_desc(q_base + (kk / 4) * L::kQChunk + off, 16, 1024);
        const uint64_t dk = wgmma_desc(k_base + (kk / 4) * L::kKVChunk + off, 16, 1024);
        wgmma_m64n128k16_ss<0, 0>(s, dq, dk, kk > 0 ? 1 : 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);

      // Scale, mask, row max. A tile every row sees whole needs no mask.
      const bool whole = k0 + kBlockN <= a.S && (!a.causal || k0 + kBlockN - 1 <= pos_min) &&
                         (a.window < 0 || k0 > pos_max - a.window);
      float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
      for (int i = 0; i < kBlockN / 2; ++i) {
        float x = s[i] * a.scale_log2;
        const bool upper = (i % 4) < 2;  // row r_box, else r_box + 8
        if (!whole) {
          const int key = k0 + 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
          const int qp = upper ? qpos0 : qpos1;
          const bool vis = key < a.S && (!a.causal || key <= qp) &&
                           (a.window < 0 || key > qp - a.window);
          if (!vis) x = -CUDART_INF_F;
        }
        s[i] = x;
        if (upper) {
          mx0 = fmaxf(mx0, x);
        } else {
          mx1 = fmaxf(mx1, x);
        }
      }
#pragma unroll
      for (int sh = 1; sh <= 2; sh <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, sh));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, sh));
      }
      // m stays finite (>= -1e30), so exp2(-inf - m) is 0, never NaN.
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float corr0 = exp2f(m0 - mn0), corr1 = exp2f(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int i = 0; i < kBlockN / 2; ++i) {
        if ((i % 4) < 2) {
          s[i] = exp2f(s[i] - mn0);
          sum0 += s[i];
        } else {
          s[i] = exp2f(s[i] - mn1);
          sum1 += s[i];
        }
      }
      l0 = l0 * corr0 + sum0;  // per-thread partial sums; the quad adds them at the end
      l1 = l1 * corr1 + sum1;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= (i % 4) < 2 ? corr0 : corr1;
      uint32_t p[kBlockN / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk) {
        p[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
        p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }

      mbar_wait(&v_full[stage], phase);
      const uint32_t v_base = smem_u32(sV + stage * L::kKVBytes);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk) {
        // 16 keys down per slice; the 64-column boxes of V lie kKVChunk apart.
        pv_mma<D>(o, p[kk], wgmma_desc(v_base + kk * 2048, L::kKVChunk, 1024));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      if (lane == 0) mbar_arrive(&empty[stage]);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }

    // Epilogue: the quad's sums, the division, bf16 into Q's buffer in the
    // swizzled layout (this warpgroup's own 64 rows), then one TMA store.
#pragma unroll
    for (int sh = 1; sh <= 2; sh <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, sh);
      l1 += __shfl_xor_sync(0xffffffffu, l1, sh);
    }
    const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
      const int chunk = col / 64, dc = col % 64;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r_box + 8 * h;
        const float inv = h ? inv1 : inv0;
        const int byte =
            chunk * L::kQChunk + row * 128 + (((dc >> 3) ^ (row & 7)) << 4) + (dc & 7) * 2;
        *reinterpret_cast<uint32_t*>(sQ + byte) =
            pack_bf16(o[4 * j + 2 * h] * inv, o[4 * j + 2 * h + 1] * inv);
      }
    }
    fence_proxy_async();
    named_barrier_sync(1, 256);
    if (threadIdx.x == 0) {
#pragma unroll
      for (int c = 0; c < L::kChunks; ++c) {
        tma_store_4d(&map_o, sQ + c * L::kQChunk, 64 * c, kvh * a.group, t0, b);
      }
      bulk_commit();
      bulk_wait_read_all();
    }
  }
}

// q, o: (B, Hq, T, D) views; k, v: (B, Hkv, S, D) views. st holds 12 element
// strides, q's, k's, v's and o's over their first three axes, every one a
// multiple of 8 (the caller substitutes one for an axis of extent 1).
template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Hq, int Hkv, int T,
           int S, int causal, int window, float scale, const long long* st, cudaStream_t stream) {
  using L = Layout<D>;
  if (Hkv < 1 || Hq % Hkv != 0) return cudaErrorInvalidValue;
  const int group = Hq / Hkv;
  if (group > kBlockM) return cudaErrorInvalidValue;
  const int positions = kBlockM / group;
  CUtensorMap mq, mk, mv, mo;
  // The inner extent is D itself: at D 80 the second 64-column box reads
  // zeros past column 80 and the store drops them.
  const uint64_t q_dims[4] = {static_cast<uint64_t>(D), static_cast<uint64_t>(Hq),
                              static_cast<uint64_t>(T), static_cast<uint64_t>(B)};
  const uint64_t kv_dims[4] = {static_cast<uint64_t>(D), static_cast<uint64_t>(S),
                               static_cast<uint64_t>(Hkv), static_cast<uint64_t>(B)};
  const uint32_t q_box[4] = {64, static_cast<uint32_t>(group), static_cast<uint32_t>(positions),
                             1};
  const uint32_t kv_box[4] = {64, kBlockN, 1, 1};
  // Byte strides of (head, position, batch) for q and o; (key, head, batch)
  // for k and v.
  const uint64_t q_str[3] = {2ull * st[1], 2ull * st[2], 2ull * st[0]};
  const uint64_t k_str[3] = {2ull * st[5], 2ull * st[4], 2ull * st[3]};
  const uint64_t v_str[3] = {2ull * st[8], 2ull * st[7], 2ull * st[6]};
  const uint64_t o_str[3] = {2ull * st[10], 2ull * st[11], 2ull * st[9]};
  if (!encode_bf16(&mq, 4, q, q_dims, q_str, q_box) ||
      !encode_bf16(&mk, 4, k, kv_dims, k_str, kv_box) ||
      !encode_bf16(&mv, 4, v, kv_dims, v_str, kv_box) ||
      !encode_bf16(&mo, 4, o, q_dims, o_str, q_box)) {
    return kMapError;
  }
  FwdArgs a;
  a.T = T;
  a.S = S;
  a.group = group;
  a.positions = positions;
  a.row_div = (65536 + group - 1) / group;
  a.causal = causal;
  a.window = window;
  a.scale_log2 = scale * kLog2e;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + positions - 1) / positions, Hkv, B);
  flash_fwd_wgmma_kernel<D><<<grid, kThreads, L::kSmemBytes, stream>>>(mq, mk, mv, mo, a);
  return cudaGetLastError();
}

}  // namespace

// C entry point (bound with ctypes): q (B, Hq, T, D), k and v (B, Hkv, S,
// D), o (B, Hq, T, D), bf16, unit last stride, 16-byte aligned bases;
// `strides` holds 12 element strides (q's, k's, v's and o's over their
// first three axes), multiples of 8. D in {64, 80, 128}; Hq / Hkv an integer
// up to 128. window < 0 is no window. Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for a call it does not take or a tensor
// map the driver refuses.
extern "C" int flash_attention_bf16_wgmma(const void* q, const void* k, const void* v, void* o,
                                          int B, int Hq, int Hkv, int T, int S, int D, int causal,
                                          int window, float scale, const long long* strides,
                                          void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch<64>(q, k, v, o, B, Hq, Hkv, T, S, causal, window, scale, strides, s);
    case 80: return launch<80>(q, k, v, o, B, Hq, Hkv, T, S, causal, window, scale, strides, s);
    case 128: return launch<128>(q, k, v, o, B, Hq, Hkv, T, S, causal, window, scale, strides, s);
    default: return cudaErrorInvalidValue;
  }
}

// Dynamic shared memory of one CTA at head dim D (0 for a D it does not take).
extern "C" int flash_attention_bf16_wgmma_smem_bytes(int D) {
  switch (D) {
    case 64: return Layout<64>::kSmemBytes;
    case 80: return Layout<80>::kSmemBytes;
    case 128: return Layout<128>::kSmemBytes;
    default: return 0;
  }
}
