// f32 GEMM for Hopper (sm_90a): C = A @ B in true f32, every product an
// fmaf on the FP32 pipes, operands brought in by TMA through a ring of
// shared-memory stages.
//
// Replaces: src/repro/kernels/matmul.py:55 matmul_pallas (pallas_call at
// :76, body _matmul_kernel) for f32 operands that TMA can read: base
// addresses 16-byte aligned, B row-major (N contiguous), A row-major (the
// "nn" specs: K contiguous) or column-major (the "tn" specs pass a.T: M
// contiguous), every row and batch stride a multiple of 4 floats (16
// bytes). The rest (a ragged leading stride such as (1, 256, 33), a base
// off 16 bytes, a column-major B) stays on the SIMT kernel in matmul.cu
// (entry matmul_f32_simt).
//
// Numerics: the reference holds f32 GEMM to 1e-5, which TF32 cannot meet,
// so no tensor core is used. Each output is one thread's running sum of
// fmaf(a[m][k], b[k][n]) for k = 0, 1, ..., K - 1 in that order: no split-K,
// no atomics, the same bits on every run.
//
// Bound on an H100 SXM: 4096^3 is 137.4 GFLOP at 67 TFLOP/s = 2.051 ms
// against 201 MB at 3.35 TB/s = 0.060 ms; Convolution's im2col batch, 64 x
// (256 x 2304 . 2304 x 900), 67.95 GFLOP = 1.014 ms: bound by operations,
// so the FFMA pipes must issue without pause. What held the SIMT kernel
// back (8.31 ms at 4096^3 on the card, PERF.md): loads that finish before
// any product starts, a bounds test and a 64-bit stride multiply per
// element, scalar shared-memory reads (16 LDS.32 per 64 FFMA), and 64-bit
// batch offsets live through the main loop. The design:
//
// - Persistent CTAs, one per SM (the ring takes 192 KB), walk the output
//   tiles (batch entry, tile row, tile column) in a grouped order, 8 tile
//   rows at a time, so CTAs running at once share A rows and B columns in
//   L2. The batch is a tile coordinate, never a pointer offset.
// - One producer thread (its own warpgroup, whose registers setmaxnreg
//   hands to the consumers: 232 each, where 384 threads at launch get
//   168) keeps TMA loads of A (128 x 32) and B
//   (32 x BN) in flight through a ring of stages (6 for BN 128, 4 for BN
//   256, 192 KB either way), each a full/empty mbarrier pair. The ring runs
//   on across tiles, so the next tile's loads overlap this tile's products
//   and its epilogue. A batched operand is a 3-D tensor map (batch the
//   outer coordinate); a broadcast one (batch stride 0, the im2col shared
//   weight) a 2-D map. TMA fills what lies past M, N or K with zeros, which
//   add nothing, so the main loop has no masks; the epilogue masks stores.
// - Eight consumer warps, 2 (M) x 4 (N), each own a 64 x BN/4 warp tile;
//   lane (lm, ln) = (lane / 4, lane % 4) owns 8 rows x BN/16 columns, the
//   columns four at a time (ln * 4 + 16 j). Every shared-memory read of a
//   warp touches at most 8 distinct words or 16-byte chunks, in distinct
//   banks, so no read conflicts:
//   - B (N-major, unswizzled rows of BN floats): a k row's column chunks,
//     one float4 (LDS.128) per 4 columns;
//   - A M-major (the "tn" view; unswizzled rows of 128 floats): rows
//     lm * 4 + {0..3} and 32 more, one float4 per 4 rows;
//   - A K-major (the "nn" layout; 128-byte rows of 32 floats, TMA's 128B
//     swizzle: chunk c of row r lies at chunk c ^ (r % 8)): rows lm + 8 i,
//     i = 0..7, one float (LDS.32) per row per k; the 8 lane groups read
//     8 rows of distinct r % 8, hence distinct chunks. Reading a float4
//     per row per 4 k instead holds 32 registers more and ran slower at
//     128 x 256 on an H100; a float2 per 2 k ran no faster.
//   A's major is a template parameter; the row a thread owns follows it.
//   Per k, a thread issues 2 + BN/64 reads (M-major A) or 8 + BN/64
//   (K-major A) against 64 or 128 FFMA.
// - Tiles: 128 x 128 (64 accumulators a thread) and 128 x 256 (128), both
//   compiled, the wrapper's block_n picks one (kernels/matmul.py
//   tune_space()). ptxas' registers and spills per instantiation are in
//   chip_smoke.py's build phase and in PERF.md.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BM = 128, BK = 32;
constexpr int kConsumerWarps = 8;                    // two warpgroups
constexpr int kThreads = 32 * kConsumerWarps + 128;  // + the producer's warpgroup
constexpr int kTM = 8;                               // rows a thread owns
constexpr int kGroupM = 8;                           // tile rows per raster group
constexpr int kKcUnroll = 4;  // of a stage's 8 four-k steps (2 ran slower on an H100, 8 no faster)

template <int BN>
struct Tile {
  static constexpr int kTN = BN / 16;                // columns a thread owns
  static constexpr int kStages = BN == 128 ? 6 : 4;
  static constexpr int kABytes = BM * BK * 4;        // 16 KB
  static constexpr int kBBytes = BK * BN * 4;        // 16 or 32 KB
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kSmemBytes = kStages * kStageBytes + 2 * kStages * 8 + 1024;
};

struct Grid {
  int m_tiles, n_tiles, k_blocks, per_batch, tiles;
};

struct Operands {
  int M, N;
  bool a3, b3;  // A, B batched (3-D tensor maps), else broadcast (2-D)
  bool vec;     // N % 4 == 0: float4 stores
};

__device__ __forceinline__ void tile_coords(const Grid& g, int tile, int& z, int& mt, int& nt) {
  z = tile / g.per_batch;
  const int t = tile - z * g.per_batch;
  const int per_group = kGroupM * g.n_tiles;
  const int first = (t / per_group) * kGroupM;
  const int rows = min(g.m_tiles - first, kGroupM);
  const int in_group = t % per_group;
  mt = first + in_group % rows;
  nt = in_group / rows;
}

__device__ __forceinline__ float lds32(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ float4 lds128(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr));
  return v;
}

// A tile by TMA: a 3-D map takes the batch entry z as its outer coordinate.
__device__ __forceinline__ void load_tile(void* dst, const CUtensorMap* map, uint64_t* bar,
                                          bool rank3, int c0, int c1, int z) {
  if (rank3) {
    tma_load_3d(dst, map, bar, c0, c1, z);
  } else {
    tma_load_2d(dst, map, bar, c0, c1);
  }
}

template <int BN, bool kAMajorM>
__global__ void __launch_bounds__(kThreads, 1)
sgemm_tma_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_b, float* __restrict__ C, Operands op,
                 Grid g) {
  using T = Tile<BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::kStages * T::kStageBytes);
  uint64_t* empty = full + T::kStages;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < T::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);  // lane 0 of every consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    // Producer warpgroup: its registers go to the consumers; one thread
    // issues every load.
    setmaxnreg_dec<40>();
    if (threadIdx.x != 32 * kConsumerWarps) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < g.tiles; tile += gridDim.x) {
      int z, mt, nt;
      tile_coords(g, tile, z, mt, nt);
      for (int kb = 0; kb < g.k_blocks; ++kb) {
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_arrive_expect_tx(&full[stage], T::kStageBytes);
        uint8_t* sa = smem + stage * T::kStageBytes;
        if (kAMajorM) {  // (K, M) rows of M: box 128 (M) x 32 (K)
          load_tile(sa, &map_a, &full[stage], op.a3, mt * BM, kb * BK, z);
        } else {  // (M, K) rows of K: box 32 (K) x 128 (M), 128B swizzle
          load_tile(sa, &map_a, &full[stage], op.a3, kb * BK, mt * BM, z);
        }
        load_tile(sa + T::kABytes, &map_b, &full[stage], op.b3, nt * BN, kb * BK, z);
        if (++stage == T::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // Consumers.
  setmaxnreg_inc<232>();
  const int wm = warp / 4, wn = warp % 4;
  const int lm = lane / 4, ln = lane % 4;
  // A's row of accumulator row i; B's column chunk j starts at b_col + 16 j.
  auto row_of = [&](int i) {
    return kAMajorM ? wm * 64 + (i / 4) * 32 + lm * 4 + (i % 4) : wm * 64 + lm + 8 * i;
  };
  const int b_col = wn * (BN / 4) + ln * 4;
  float acc[kTM][T::kTN];
  int stage = 0;
  uint32_t phase = 0;
  for (int tile = blockIdx.x; tile < g.tiles; tile += gridDim.x) {
    int z, mt, nt;
    tile_coords(g, tile, z, mt, nt);
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < T::kTN; ++j) acc[i][j] = 0.f;

    for (int kb = 0; kb < g.k_blocks; ++kb) {
      mbar_wait(&full[stage], phase);
      const uint32_t sa = smem_u32(smem + stage * T::kStageBytes);
      const uint32_t sb = sa + T::kABytes;
#pragma unroll kKcUnroll
      for (int kc = 0; kc < BK / 4; ++kc) {  // four k at a time
        // K-major A: row r = wm*64 + lm + 8i holds its 16-byte chunk kc at
        // chunk kc ^ (r % 8) = kc ^ lm.
        const uint32_t chunk = static_cast<uint32_t>((kc ^ lm) * 16);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int k = kc * 4 + kk;
          float a[kTM], b[T::kTN];
          if (kAMajorM) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float4 v = lds128(sa + (k * BM + wm * 64 + h * 32 + lm * 4) * 4);
              a[4 * h + 0] = v.x;
              a[4 * h + 1] = v.y;
              a[4 * h + 2] = v.z;
              a[4 * h + 3] = v.w;
            }
          } else {
#pragma unroll
            for (int i = 0; i < kTM; ++i) a[i] = lds32(sa + row_of(i) * (BK * 4) + chunk + kk * 4);
          }
#pragma unroll
          for (int j = 0; j < T::kTN / 4; ++j) {
            const float4 v = lds128(sb + (k * BN + b_col + 16 * j) * 4);
            b[4 * j + 0] = v.x;
            b[4 * j + 1] = v.y;
            b[4 * j + 2] = v.z;
            b[4 * j + 3] = v.w;
          }
#pragma unroll
          for (int i = 0; i < kTM; ++i)
#pragma unroll
            for (int j = 0; j < T::kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
      if (++stage == T::kStages) {
        stage = 0;
        phase ^= 1;
      }
    }

    // Epilogue: straight from the accumulators, four columns at a time.
    float* c = C + static_cast<long long>(z) * op.M * op.N;
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int row = mt * BM + row_of(i);
      if (row >= op.M) continue;
      float* crow = c + static_cast<long long>(row) * op.N;
#pragma unroll
      for (int j = 0; j < T::kTN / 4; ++j) {
        const int col = nt * BN + b_col + 16 * j;
        if (op.vec && col + 3 < op.N) {
          *reinterpret_cast<float4*>(crow + col) =
              make_float4(acc[i][4 * j], acc[i][4 * j + 1], acc[i][4 * j + 2], acc[i][4 * j + 3]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (col + e < op.N) crow[col + e] = acc[i][4 * j + e];
          }
        }
      }
    }
  }
}

// A tensor map of an f32 operand stored as rows of `inner` contiguous
// elements, `outer` rows `ld` apart, and (sbatch > 0) `batch` such
// matrices sbatch apart; box `box_inner` x `box_outer` (x 1).
bool encode_operand(CUtensorMap* map, const void* base, CUtensorMapSwizzle swizzle, int inner,
                    int outer, long long ld, int batch, long long sbatch, int box_inner,
                    int box_outer) {
  const uint64_t dims[3] = {static_cast<uint64_t>(inner), static_cast<uint64_t>(outer),
                            static_cast<uint64_t>(batch)};
  const uint64_t strides[2] = {static_cast<uint64_t>(ld) * 4,
                               static_cast<uint64_t>(sbatch) * 4};
  const uint32_t box[3] = {static_cast<uint32_t>(box_inner), static_cast<uint32_t>(box_outer), 1};
  return encode_f32(map, swizzle, sbatch > 0 ? 3 : 2, base, dims, strides, box);
}

template <int BN, bool kAMajorM>
int launch(const void* a, const void* b, void* c, int batch, int M, int N, int K, long long lda,
           long long sab, long long ldb, long long sbb, cudaStream_t stream) {
  using T = Tile<BN>;
  CUtensorMap map_a, map_b;
  const bool ok =
      (kAMajorM ? encode_operand(&map_a, a, CU_TENSOR_MAP_SWIZZLE_NONE, M, K, lda, batch, sab, BM,
                                 BK)
                : encode_operand(&map_a, a, CU_TENSOR_MAP_SWIZZLE_128B, K, M, lda, batch, sab, BK,
                                 BM)) &&
      encode_operand(&map_b, b, CU_TENSOR_MAP_SWIZZLE_NONE, N, K, ldb, batch, sbb, BN, BK);
  if (!ok) return kMapError;
  Grid g;
  g.m_tiles = (M + BM - 1) / BM;
  g.n_tiles = (N + BN - 1) / BN;
  g.k_blocks = (K + BK - 1) / BK;
  g.per_batch = g.m_tiles * g.n_tiles;
  const long long tiles = static_cast<long long>(g.per_batch) * batch;
  if (tiles > 0x7fffffffll) return cudaErrorInvalidValue;
  g.tiles = static_cast<int>(tiles);
  Operands op;
  op.M = M;
  op.N = N;
  op.a3 = sab > 0;
  op.b3 = sbb > 0;
  op.vec = N % 4 == 0;
  const cudaError_t err = cudaFuncSetAttribute(
      sgemm_tma_kernel<BN, kAMajorM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::kSmemBytes);
  if (err != cudaSuccess) return err;
  const int grid = g.tiles < sm_count() ? g.tiles : sm_count();
  sgemm_tma_kernel<BN, kAMajorM><<<grid, kThreads, T::kSmemBytes, stream>>>(
      map_a, map_b, static_cast<float*>(c), op, g);
  return cudaGetLastError();
}

}  // namespace

// C entry point (bound with ctypes). a and b are device pointers, 16-byte
// aligned; C is a contiguous batch x M x N output. a_m_major = 0: A is
// row-major with row stride lda; 1: A is column-major (a transposed view)
// with column stride lda. B is row-major with row stride ldb. sab and sbb
// are the batch strides; 0 broadcasts that operand to every batch entry.
// Every stride is in elements, a multiple of 4. block_n is 128 or 256 (the
// tile is 128 x block_n). batch, M, N, K >= 1. Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue if a tensor map cannot be
// encoded or block_n is not compiled.
extern "C" int matmul_f32(const void* a, const void* b, void* c, int batch, int M, int N, int K,
                          int a_m_major, long long lda, long long sab, long long ldb,
                          long long sbb, int block_n, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (block_n == 128) {
    return a_m_major ? launch<128, true>(a, b, c, batch, M, N, K, lda, sab, ldb, sbb, s)
                     : launch<128, false>(a, b, c, batch, M, N, K, lda, sab, ldb, sbb, s);
  }
  if (block_n == 256) {
    return a_m_major ? launch<256, true>(a, b, c, batch, M, N, K, lda, sab, ldb, sbb, s)
                     : launch<256, false>(a, b, c, batch, M, N, K, lda, sab, ldb, sbb, s);
  }
  return cudaErrorInvalidValue;
}

// Dynamic shared memory of one CTA at tile 128 x block_n: the ring, its
// barriers, alignment.
extern "C" int matmul_f32_smem_bytes(int block_n) {
  return block_n == 128 ? Tile<128>::kSmemBytes : block_n == 256 ? Tile<256>::kSmemBytes : 0;
}
