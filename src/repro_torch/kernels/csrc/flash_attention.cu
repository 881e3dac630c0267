// Flash (online-softmax) attention for Hopper (sm_90a): grouped-query heads,
// causal and sliding-window masks, queries at the end of the key timeline.
// f32 inside, output in the input's dtype.
//
// Replaces: src/repro/kernels/flash_attention.py:112 flash_attention_pallas
// (pallas_call at :151, body _flash_kernel at :39). For q (B, Hq, T, D) and
// k, v (B, Hkv, S, D) it computes, for every query row, softmax(q k^T * scale)
// v over the keys the masks leave visible: query head h reads KV head
// h / (Hq / Hkv); the T queries sit at positions S - T .. S - 1; causal keeps
// keys p <= q_pos, a window keeps p > q_pos - window. The reference's
// constants are kept: the running max starts at -1e30 (exp(m - m_new) is
// never NaN), masked probabilities are 0, and the output is
// acc / max(l, 1e-30), so a fully masked row is 0.
//
// Design. One CTA of 4 warps owns 32 query rows of ONE KV head: the rows of
// its `group` query heads, position-major (row i is position i / group of
// head i % group). So the GQA map is an index computation, K and V are never
// repeated, and a decode step (T = 1, group 4) gives each warp one row while
// the CTA reads its KV head's cache once instead of once per query head. The
// CTA walks tiles of 64 keys; K and V tiles are staged in shared memory in
// the input dtype by 16-byte coalesced cp.async copies, all of a tile's in
// flight at once (rows padded by 16 bytes so the per-key reads below do not
// collide in banks). Each warp owns 8 rows, interleaved across warps. For a
// tile, lane j computes the scores of keys j and j + 32 against each of its
// warp's rows (q held in shared memory as f32, pre-scaled as the reference
// does), FMA on the CUDA cores; the row max and sum are warp shuffles; the
// probabilities go to the warp's slice of shared memory, and each lane then
// accumulates ceil(D / 32) output columns of p v: lane j owns columns
// j * ceil(D / 32) + c below D, so every column is written exactly once (at
// D = 80 lanes 0-25 own 3, lane 26 owns 2, lanes 27-31 none). bf16 inputs
// are widened with __bfloat162float, exactly as the reference's
// astype(float32), so kernel and plain version differ only in the order of
// their sums. The tile loop
// runs from lo to hi as in the reference: causal stops after the block
// holding the CTA's last position, a window starts at the block holding its
// first visible key (clamped at 0 before dividing), so a windowed decode
// step reads O(window) keys.
//
// Bound on an H100 SXM (989 TFLOP/s bf16, 67 TFLOP/s f32, 3.35 TB/s): a
// causal prefill at B8 Hq32 Hkv8 T=S=1024 D128 does 4*D operations per
// visible pair, 6.9e10 in all, against 168 MB of q, k, v and o: bound by
// operations (0.070 ms at the bf16 rate). A decode step, T=1 against S=1088,
// reads 36 MB of cache for 1.4e8 operations: bound by bytes (0.011 ms). This
// first kernel stays on the CUDA cores (no wgmma, no TMA, no overlap of a
// tile's loads with the previous tile's work), so prefill runs at the f32
// FMA rate at best; what the design does about the byte bound is to read
// each KV head's K and V once per CTA of 32 rows, never once per query head.
// Strides come from the caller: q, k, v and o may be any views with a unit
// last stride (the model hands in transposed activations and a cache sliced
// to its valid length).
//
// Head dims: 8, 16, 32, 64, 80 and 128 (the switch at the end). D = 80 is
// hubert-xlarge's (1280 / 16 heads), which no other entry takes. Every
// trip count divides there too: a tile row is D / kVec = 10 (bf16) or 20
// (f32) 16-byte chunks, so a tile's 640 or 1280 chunks are 5 or 10 per
// thread; the q load is kBlockQ * D / kThreads = 20 per thread; the score
// loop's 16-byte slices and the padded rows (88 bf16, 84 f32) stay 16-byte
// multiples. Bound at hubert's encoder shape, B8 H16/16 T=S=4096 D80
// bidirectional: 4*D operations per pair over 2.15e9 pairs, 6.87e11 in all,
// 0.695 ms at the bf16 rate, against 335.5 MB of q, k, v and o (0.100 ms at
// 3.35 TB/s): bound by operations, which this kernel issues on the CUDA
// cores in f32, far from that rate.
//
// Since the redesigns this kernel serves only the layouts its successors do
// not take: bf16 (flash_attention_bf16_simt) with D in {8, 16, 32, 80}, between
// 17 and 63 rows per KV head, a group that does not divide 128, or views
// whose base or strides are not 16-byte multiples; f32
// (flash_attention_f32_simt) views whose base or strides are not 16-byte
// multiples, or D = 80, which only this kernel compiles. bf16 prefill goes
// to flash_attention_wgmma.cu, bf16 decode to flash_decode.cu, and aligned
// f32 to flash_attention_f32_tma.cu.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockQ = 32;                      // query rows per CTA
constexpr int kBlockK = 64;                      // keys per tile
constexpr int kRowsPerWarp = kBlockQ / kWarps;   // 8
constexpr int kKeysPerLane = kBlockK / 32;       // 2
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int T, S, Hkv, group;
  int causal, window;  // window < 0: none
  float scale;
  int vec;             // k and v rows 16-byte aligned: vector tile loads
  long long sq[3], sk[3], sv[3], so[3];  // element strides over (b, h, t/s)
};

template <typename T>
struct Elem;
template <>
struct Elem<float> {
  static constexpr int kVec = 4;  // elements in 16 bytes
};
template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kVec = 8;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float x, float* p) { *p = x; }
__device__ __forceinline__ void store(float x, __nv_bfloat16* p) { *p = __float2bfloat16(x); }

// 16 bytes of shared memory -> floats.
__device__ __forceinline__ void widen(const float* src, float* out) {
  const float4 r = *reinterpret_cast<const float4*>(src);
  out[0] = r.x;
  out[1] = r.y;
  out[2] = r.z;
  out[3] = r.w;
}
__device__ __forceinline__ void widen(const __nv_bfloat16* src, float* out) {
  const uint4 r = *reinterpret_cast<const uint4*>(src);
  const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __bfloat162float(__ushort_as_bfloat16((unsigned short)(w[i] & 0xffffu)));
    out[2 * i + 1] = __bfloat162float(__ushort_as_bfloat16((unsigned short)(w[i] >> 16)));
  }
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

// 16 bytes global -> shared without passing through registers; src_bytes 0
// writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Stage keys j0 .. j0 + kBlockK - 1 of one (b, kv head) into a padded tile;
// rows past S are zeros (their probabilities are 0, and 0 * garbage could be
// NaN). Aligned rows go by cp.async, every copy of the tile in flight at
// once; the caller waits (cp_async_wait_all, then __syncthreads).
template <typename T, int D, int LD>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long row_stride,
                                          int j0, int S, int vec) {
  constexpr int kVec = Elem<T>::kVec;
  constexpr int kChunks = D / kVec;  // 16-byte chunks per row
  constexpr int kIters = (kBlockK * kChunks + kThreads - 1) / kThreads;
#pragma unroll
  for (int i = 0; i < kIters; ++i) {
    const int c = threadIdx.x + i * kThreads;
    if (kBlockK * kChunks % kThreads != 0 && c >= kBlockK * kChunks) break;
    const int row = c / kChunks;
    const int col = (c % kChunks) * kVec;
    T* d = dst + row * LD + col;
    const int key = j0 + row;
    if (vec) {
      const bool in = key < S;
      cp_async16(d, in ? src + key * row_stride + col : src, in ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        if (key < S) {
          d[e] = src[key * row_stride + col + e];
        } else {
          store(0.f, d + e);
        }
      }
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_kernel(const Args a) {
  constexpr int kVec = Elem<T>::kVec;
  constexpr int LD = D + kVec;                 // padded tile row (elements)
  constexpr int kCols = (D + 31) / 32;         // output columns per lane, the last below D
  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);                          // [kBlockQ][D]
  T* sK = reinterpret_cast<T*>(sQ + kBlockQ * D);                      // [kBlockK][LD]
  T* sV = sK + kBlockK * LD;                                           // [kBlockK][LD]
  float* sP = reinterpret_cast<float*>(sV + kBlockK * LD);             // [kWarps][rows][kBlockK]

  const T* q = static_cast<const T*>(a.q);
  const int b = blockIdx.z;
  const int kvh = blockIdx.y;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int n_rows = a.group * a.T;          // packed rows of this KV head
  const int row0 = blockIdx.x * kBlockQ;
  const int offset = a.S - a.T;              // absolute position of query 0

  // Query rows, f32 and pre-scaled (the reference's q.astype(f32) * scale).
  // A fixed trip count, unrolled, so each thread's loads are in flight together.
#pragma unroll 8
  for (int it = 0; it < kBlockQ * D / kThreads; ++it) {
    const int e = threadIdx.x + it * kThreads;
    const int i = e / D;
    const int d = e % D;
    const int p = row0 + i;
    float x = 0.f;
    if (p < n_rows) {
      const int h = kvh * a.group + p % a.group;
      x = to_f32(q[b * a.sq[0] + h * a.sq[1] + (long long)(p / a.group) * a.sq[2] + d]) *
          a.scale;
    }
    sQ[e] = x;
  }

  // This warp's rows are row0 + r * kWarps + warp for r < nv.
  const int rem = n_rows - row0 - warp;
  const int nv = rem <= 0 ? 0 : min((rem + kWarps - 1) / kWarps, kRowsPerWarp);

  // Key blocks [lo, hi) that any row of this CTA can see.
  const int n_blocks = (a.S + kBlockK - 1) / kBlockK;
  const int t_first = row0 / a.group;
  const int t_last = (min(row0 + kBlockQ, n_rows) - 1) / a.group;
  int hi = n_blocks;
  if (a.causal) {
    const int last = offset + t_last;
    hi = last < 0 ? 0 : min(last / kBlockK + 1, n_blocks);
  }
  int lo = 0;
  if (a.window >= 0) {
    const int first_key = offset + t_first - a.window + 1;  // may be negative
    lo = first_key > 0 ? first_key / kBlockK : 0;
  }

  const T* kbase = static_cast<const T*>(a.k) + b * a.sk[0] + kvh * a.sk[1];
  const T* vbase = static_cast<const T*>(a.v) + b * a.sv[0] + kvh * a.sv[1];
  float* sPw = sP + warp * kRowsPerWarp * kBlockK;

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kCols];
  int qpos[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
    qpos[r] = offset + (row0 + r * kWarps + warp) / a.group;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  }
  // Lane j owns columns j * kCols + c below D; a lane past them owns none.
  bool owns[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) owns[c] = lane * kCols + c < D;
  const bool owns_cols = owns[0];

  for (int kb = lo; kb < hi; ++kb) {
    const int j0 = kb * kBlockK;
    load_tile<T, D, LD>(sK, kbase, a.sk[2], j0, a.S, a.vec);
    load_tile<T, D, LD>(sV, vbase, a.sv[2], j0, a.S, a.vec);
    cp_async_wait_all();
    __syncthreads();

    // Scores of this lane's keys against the warp's rows.
    float s[kRowsPerWarp][kKeysPerLane];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
      for (int kk = 0; kk < kKeysPerLane; ++kk) s[r][kk] = 0.f;
#pragma unroll 4
    for (int d0 = 0; d0 < D; d0 += kVec) {
      float kf[kKeysPerLane][kVec];
#pragma unroll
      for (int kk = 0; kk < kKeysPerLane; ++kk) widen(sK + (lane + 32 * kk) * LD + d0, kf[kk]);
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        if (r < nv) {
          const float* qr = sQ + (r * kWarps + warp) * D + d0;
#pragma unroll
          for (int e = 0; e < kVec; e += 4) {
            const float4 q4 = *reinterpret_cast<const float4*>(qr + e);
#pragma unroll
            for (int kk = 0; kk < kKeysPerLane; ++kk) {
              s[r][kk] = fmaf(q4.x, kf[kk][e], s[r][kk]);
              s[r][kk] = fmaf(q4.y, kf[kk][e + 1], s[r][kk]);
              s[r][kk] = fmaf(q4.z, kf[kk][e + 2], s[r][kk]);
              s[r][kk] = fmaf(q4.w, kf[kk][e + 3], s[r][kk]);
            }
          }
        }
      }
    }

    // Masks and the online softmax update, one row at a time.
    float corr[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      corr[r] = 1.f;
      if (r < nv) {
        bool ok[kKeysPerLane];
        float mx = kNegInf;
#pragma unroll
        for (int kk = 0; kk < kKeysPerLane; ++kk) {
          const int key = j0 + lane + 32 * kk;
          ok[kk] = key < a.S && (!a.causal || key <= qpos[r]) &&
                   (a.window < 0 || key > qpos[r] - a.window);
          if (!ok[kk]) s[r][kk] = kNegInf;
          mx = fmaxf(mx, s[r][kk]);
        }
        const float m_new = fmaxf(m[r], warp_max(mx));
        float sum = 0.f;
#pragma unroll
        for (int kk = 0; kk < kKeysPerLane; ++kk) {
          const float p = ok[kk] ? expf(s[r][kk] - m_new) : 0.f;
          sPw[r * kBlockK + lane + 32 * kk] = p;
          sum += p;
        }
        corr[r] = expf(m[r] - m_new);
        l[r] = l[r] * corr[r] + warp_sum(sum);
        m[r] = m_new;
      }
    }
    __syncwarp();

    // acc = acc * corr + p v over this tile, kCols columns per lane.
    if (owns_cols) {
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[r][c] *= corr[r];
#pragma unroll 2
      for (int j = 0; j < kBlockK; j += 4) {
        float vf[4][kCols];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int c = 0; c < kCols; ++c)
            vf[jj][c] = owns[c] ? to_f32(sV[(j + jj) * LD + lane * kCols + c]) : 0.f;
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          if (r < nv) {
            const float4 p4 = *reinterpret_cast<const float4*>(sPw + r * kBlockK + j);
#pragma unroll
            for (int c = 0; c < kCols; ++c) {
              acc[r][c] = fmaf(p4.x, vf[0][c], acc[r][c]);
              acc[r][c] = fmaf(p4.y, vf[1][c], acc[r][c]);
              acc[r][c] = fmaf(p4.z, vf[2][c], acc[r][c]);
              acc[r][c] = fmaf(p4.w, vf[3][c], acc[r][c]);
            }
          }
        }
      }
    }
    __syncthreads();  // the next tile overwrites sK, sV and sP
  }

  T* o = static_cast<T*>(a.o);
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    if (r < nv && owns_cols) {
      const int p = row0 + r * kWarps + warp;
      const int h = kvh * a.group + p % a.group;
      T* orow = o + b * a.so[0] + h * a.so[1] + (long long)(p / a.group) * a.so[2];
      const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        if (owns[c]) store(acc[r][c] / denom, orow + lane * kCols + c);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  constexpr int LD = D + Elem<T>::kVec;
  const int smem = kBlockQ * D * (int)sizeof(float) + 2 * kBlockK * LD * (int)sizeof(T) +
                   kWarps * kRowsPerWarp * kBlockK * (int)sizeof(float);
  // Above 48 KB only as opted-in dynamic shared memory, an attribute per
  // device: set at the first launch on each.
  static std::atomic<bool> configured[hopper::kMaxDevices];
  const cudaError_t err = hopper::once_per_device(configured, [smem] {
    return cudaFuncSetAttribute(flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                smem);
  });
  if (err != cudaSuccess) return err;
  const int rows = a.group * a.T;
  const dim3 grid((rows + kBlockQ - 1) / kBlockQ, a.Hkv, B);
  flash_kernel<T, D><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename E>
int run(const void* q, const void* k, const void* v, void* o, int B, int Hq, int Hkv, int T,
        int S, int D, int causal, int window, float scale, const long long* strides, int vec,
        void* stream) {
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.T = T;
  a.S = S;
  a.Hkv = Hkv;
  a.group = Hq / Hkv;
  a.causal = causal;
  a.window = window;
  a.scale = scale;
  a.vec = vec;
  for (int i = 0; i < 3; ++i) {
    a.sq[i] = strides[i];
    a.sk[i] = strides[3 + i];
    a.sv[i] = strides[6 + i];
    a.so[i] = strides[9 + i];
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 8: return launch<E, 8>(a, B, s);
    case 16: return launch<E, 16>(a, B, s);
    case 32: return launch<E, 32>(a, B, s);
    case 64: return launch<E, 64>(a, B, s);
    case 80: return launch<E, 80>(a, B, s);
    case 128: return launch<E, 128>(a, B, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry points (bound with ctypes). q (B, Hq, T, D), k and v (B, Hkv, S, D),
// o (B, Hq, T, D), each with a unit last stride; `strides` holds 12 element
// strides: q's, k's, v's and o's over their first three axes. window < 0 is
// no window; vec = 1 when k and v rows may be read 16 bytes at a time. Each
// returns cudaGetLastError() after its launch.

extern "C" int flash_attention_f32_simt(const void* q, const void* k, const void* v, void* o,
                                        int B, int Hq, int Hkv, int T, int S, int D, int causal,
                                        int window, float scale, const long long* strides, int vec,
                                        void* stream) {
  return run<float>(q, k, v, o, B, Hq, Hkv, T, S, D, causal, window, scale, strides, vec, stream);
}

extern "C" int flash_attention_bf16_simt(const void* q, const void* k, const void* v, void* o,
                                         int B, int Hq, int Hkv, int T, int S, int D, int causal,
                                         int window, float scale, const long long* strides, int vec,
                                         void* stream) {
  return run<__nv_bfloat16>(q, k, v, o, B, Hq, Hkv, T, S, D, causal, window, scale, strides, vec,
                            stream);
}
