// Split-KV ("flash-decoding") attention for Hopper (sm_90a), bf16: the
// decode kernel and the launch that merges its partial results.
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
//   share an SM and the step's 320 CTAs run in one wave. Scores on the
//   CUDA cores (two threads a key, f32 FMAs), the online max and sum by
//   warp shuffles, p v by one thread a column.
// - Each CTA writes its partial (m, l, acc[D]) in f32 (m in log2 units) to
//   scratch the caller allocates: B * Hq * T * splits * (D + 2) * 4 bytes.
//   A split that sees no key writes m = -1e30, l = 0, acc = 0.
// - flash_decode_combine_bf16, a second small launch, merges them per row:
//   m* = max m_i, l = sum l_i 2^(m_i - m*), o = sum acc_i 2^(m_i - m*) /
//   max(l, 1e-30), written as bf16 through o's strides.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBlockN = 64;  // keys per tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

struct DecodeArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  float* part_o;   // [B][Hkv][splits][rows][D]
  float* part_ml;  // [B][Hkv][splits][rows][2]: m (log2 units), l
  int T, S, Hkv, group, rows, causal, window, splits;
  float scale_log2;
  long long sq[3], sk[3], sv[3];  // element strides over (b, h, t/s)
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

template <int D, int kRows>
__global__ void __launch_bounds__(kThreads) flash_decode_kernel(const DecodeArgs a) {
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

  // The partial results of this split.
  const long long row_base = ((static_cast<long long>(b) * a.Hkv + kvh) * a.splits + split) * R;
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
}

__global__ void flash_decode_combine_kernel(const float* __restrict__ part_o,
                                            const float* __restrict__ part_ml,
                                            __nv_bfloat16* __restrict__ o, int Hkv, int group,
                                            int rows, int D, int splits, long long so0,
                                            long long so1, long long so2, long long total) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int d = static_cast<int>(idx % D);
  long long rest = idx / D;
  const int r = static_cast<int>(rest % rows);
  rest /= rows;
  const int kvh = static_cast<int>(rest % Hkv);
  const int b = static_cast<int>(rest / Hkv);
  const long long first = (static_cast<long long>(b) * Hkv + kvh) * splits * rows + r;
  float m_star = -1e30f;
  for (int i = 0; i < splits; ++i) m_star = fmaxf(m_star, part_ml[(first + i * rows) * 2]);
  float l = 0.f, acc = 0.f;
  for (int i = 0; i < splits; ++i) {
    const long long row = first + static_cast<long long>(i) * rows;
    const float w = exp2f(part_ml[row * 2] - m_star);
    l += part_ml[row * 2 + 1] * w;
    acc += part_o[row * D + d] * w;
  }
  const int h = kvh * group + r % group;
  o[b * so0 + h * so1 + static_cast<long long>(r / group) * so2 + d] =
      __float2bfloat16(acc / fmaxf(l, 1e-30f));
}

template <int D, int kRows>
cudaError_t launch(const DecodeArgs& a, int B, cudaStream_t stream) {
  constexpr int smem = decode_smem_bytes<D, kRows>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_decode_kernel<D, kRows>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  // All of the SM's unified memory as shared memory: three CTAs of the
  // path's decode step (72.7 KB each) fit an SM, so its 320 CTAs run in one wave.
  err = cudaFuncSetAttribute(flash_decode_kernel<D, kRows>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  flash_decode_kernel<D, kRows><<<dim3(a.splits, a.Hkv, B), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// C entry points (bound with ctypes). q (B, Hq, T, D), k and v (B, Hkv, S,
// D), bf16 with a unit last stride; `strides` holds 9 element strides (q's,
// k's and v's over their first three axes); k and v rows 16-byte aligned.
// Hq / Hkv * T <= 16, D in {64, 128}, window < 0 is no window. part_o
// (B * Hkv * splits * rows * D floats) and part_ml (B * Hkv * splits * rows
// * 2 floats), rows = Hq / Hkv * T, are the caller's scratch. Each returns
// cudaGetLastError() after its launch.

extern "C" int flash_decode_bf16(const void* q, const void* k, const void* v, void* part_o,
                                 void* part_ml, int B, int Hq, int Hkv, int T, int S, int D,
                                 int causal, int window, float scale, const long long* strides,
                                 int splits, void* stream) {
  DecodeArgs a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.part_o = static_cast<float*>(part_o);
  a.part_ml = static_cast<float*>(part_ml);
  a.T = T;
  a.S = S;
  a.Hkv = Hkv;
  a.group = Hq / Hkv;
  a.rows = a.group * T;
  a.causal = causal;
  a.window = window;
  a.splits = splits;
  a.scale_log2 = scale * kLog2e;
  for (int i = 0; i < 3; ++i) {
    a.sq[i] = strides[i];
    a.sk[i] = strides[3 + i];
    a.sv[i] = strides[6 + i];
  }
  if (a.rows < 1 || a.rows > 16 || splits < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool small = a.rows <= 4;
  switch (D) {
    case 64: return small ? launch<64, 4>(a, B, s) : launch<64, 16>(a, B, s);
    case 128: return small ? launch<128, 4>(a, B, s) : launch<128, 16>(a, B, s);
    default: return cudaErrorInvalidValue;
  }
}

// o (B, Hq, T, D) bf16 through its element strides over (b, h, t).
extern "C" int flash_decode_combine_bf16(const void* part_o, const void* part_ml, void* o, int B,
                                         int Hq, int Hkv, int T, int D, int splits,
                                         long long so0, long long so1, long long so2,
                                         void* stream) {
  const int group = Hq / Hkv;
  const int rows = group * T;
  const long long total = static_cast<long long>(B) * Hkv * rows * D;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  flash_decode_combine_kernel<<<static_cast<unsigned>(blocks), threads, 0, s>>>(
      static_cast<const float*>(part_o), static_cast<const float*>(part_ml),
      static_cast<__nv_bfloat16*>(o), Hkv, group, rows, D, splits, so0, so1, so2, total);
  return cudaGetLastError();
}

// Dynamic shared memory of one decode CTA at head dim D and `rows` packed rows.
extern "C" int flash_decode_bf16_smem_bytes(int D, int rows) {
  if (D == 64) return rows <= 4 ? decode_smem_bytes<64, 4>() : decode_smem_bytes<64, 16>();
  if (D == 128) return rows <= 4 ? decode_smem_bytes<128, 4>() : decode_smem_bytes<128, 16>();
  return 0;
}
