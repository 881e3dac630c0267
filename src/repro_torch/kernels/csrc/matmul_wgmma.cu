// bf16 GEMM for Hopper (sm_90a): C = A @ B, bf16 in, f32 accumulate, bf16
// out, operands brought in by TMA and multiplied by wgmma.
//
// Replaces: src/repro/kernels/matmul.py:55 matmul_pallas (pallas_call at
// :76, body _matmul_kernel) for bf16 operands that TMA can read, 2-D or
// batched: base addresses 16-byte aligned, B row-major (N contiguous), A
// row-major (the "nn" specs) or column-major (the "tn" specs pass a.T, read
// in place), and every row and batch stride a multiple of 8 elements. The
// rest (ragged strides such as (1, 256, 33)) stays on the WMMA kernel in
// matmul.cu.
//
// Bound on an H100 SXM: 4096^3 is 137.4 GFLOP against 100.7 MB, 0.139 ms
// at 989 TFLOP/s against 0.030 ms at 3.35 TB/s: bound by operations, so
// the tensor cores must be fed without pause. The design:
// - Persistent CTAs, one per SM, walk the 128 x 256 output tiles in a
//   grouped order (8 tile rows at a time), so CTAs running at once share
//   their A rows and B columns in L2.
// - A batch (the served GEMM's members under torch.vmap, one product each)
//   is the outer tile coordinate, z = tile / per_batch, so one launch and
//   one persistent grid cover every product and the next product's loads
//   run on behind this one's epilogue. A batched operand is a 3-D tensor
//   map with z its outer coordinate; a broadcast one (batch stride 0) keeps
//   its 2-D map. A product of 1024^3 alone fills 32 of the 132 SMs; a
//   batch of four fills 128.
// - One producer thread keeps TMA loads of A (128 x 64) and B (64 x 256) in
//   flight through a ring of 4 stages of 48 KB, each stage a full/empty pair
//   of mbarriers. The ring runs on across tiles, so the next tile's loads
//   overlap this tile's last products and its epilogue.
// - Two consumer warpgroups each own 64 rows of the tile and issue wgmma
//   m64n256k16 from shared memory (four per 64-deep stage), f32
//   accumulators in registers (128 a thread; setmaxnreg moves registers
//   from the producer's warpgroup to them). One stage's products stay in
//   flight while the previous stage is released to the producer.
// - A is K-major (row-major A) or M-major (the transposed view: the
//   tensor map walks its columns and wgmma's transpose bit reads it); B is
//   N-major, read with the transpose bit, in four 64-column boxes.
// - Ragged M, N and K: TMA fills what lies outside the operands with
//   zeros, which add nothing, and the epilogue masks its stores.
// - The epilogue converts to bf16 and writes two columns at a time from the
//   accumulator registers.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BM = 128, BN = 256, BK = 64;
constexpr int kStages = 4;
constexpr int kConsumers = 2;                  // warpgroups of 64 rows each
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kABytes = BM * BK * 2;           // 16 KB
constexpr int kBBytes = BK * BN * 2;           // 32 KB
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kBox = 64 * 64 * 2;              // one 64 x 64 box, 8 KB
constexpr int kGroupM = 8;                     // tile rows per raster group
constexpr int kSmemBytes = kStages * kStageBytes + 2 * kStages * 8 + 1024;

struct Grid {
  int m_tiles, n_tiles, k_blocks, per_batch, tiles;
  bool a3, b3;  // A, B batched (3-D tensor maps), else broadcast (2-D)
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

// A box by TMA: a 3-D map takes the batch entry z as its outer coordinate.
__device__ __forceinline__ void load_box(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         bool rank3, int c0, int c1, int z) {
  if (rank3) {
    tma_load_3d(dst, map, bar, c0, c1, z);
  } else {
    tma_load_2d(dst, map, bar, c0, c1);
  }
}

template <bool kAMajorM>
__global__ void __launch_bounds__(kThreads, 1)
gemm_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                  const __grid_constant__ CUtensorMap map_b, __nv_bfloat16* __restrict__ C, int M,
                  int N, Grid g) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 4);  // lane 0 of every consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // Producer warpgroup: one thread issues every load.
    setmaxnreg_dec<40>();
    if (threadIdx.x == kConsumers * 128) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < g.tiles; tile += gridDim.x) {
        int z, mt, nt;
        tile_coords(g, tile, z, mt, nt);
        for (int kb = 0; kb < g.k_blocks; ++kb) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_arrive_expect_tx(&full[stage], kStageBytes);
          uint8_t* sa = smem + stage * kStageBytes;
          uint8_t* sb = sa + kABytes;
          if (kAMajorM) {  // two 64 (M) x 64 (K) boxes
            load_box(sa, &map_a, &full[stage], g.a3, mt * BM, kb * BK, z);
            load_box(sa + kBox, &map_a, &full[stage], g.a3, mt * BM + 64, kb * BK, z);
          } else {  // one 64 (K) x 128 (M) box
            load_box(sa, &map_a, &full[stage], g.a3, kb * BK, mt * BM, z);
          }
#pragma unroll
          for (int j = 0; j < BN / 64; ++j) {  // four 64 (N) x 64 (K) boxes
            load_box(sb + j * kBox, &map_b, &full[stage], g.b3, nt * BN + 64 * j, kb * BK, z);
          }
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const int t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32;
    float acc[BN / 2];
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < g.tiles; tile += gridDim.x) {
      int z, mt, nt;
      tile_coords(g, tile, z, mt, nt);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      int prev = -1;
      for (int kb = 0; kb < g.k_blocks; ++kb) {
        mbar_wait(&full[stage], phase);
        const uint32_t sa = smem_u32(smem + stage * kStageBytes) + wg * kBox;
        const uint32_t sb = smem_u32(smem + stage * kStageBytes + kABytes);
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          // A: K-major steps 32 bytes along its 128-byte rows; M-major steps
          // 16 rows of K. B (N-major) steps 16 rows; its 64-column boxes
          // lie kBox apart.
          const uint64_t da = kAMajorM ? wgmma_desc(sa + kk * 2048, kBox, 1024)
                                       : wgmma_desc(sa + kk * 32, 16, 1024);
          const uint64_t db = wgmma_desc(sb + kk * 2048, kBox, 1024);
          wgmma_m64n256k16_ss<kAMajorM ? 1 : 0, 1>(acc, da, db, 1);
        }
        wgmma_commit();
        // Keep this stage's products in flight; release the previous one.
        wgmma_wait<1>();
        fence_regs(acc);
        if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
        prev = stage;
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);

      // Epilogue: thread (warp, lane) holds rows r and r + 8 of its
      // warpgroup's 64, two adjacent columns in each 8-column group.
      const int r = mt * BM + wg * 64 + warp * 16 + lane / 4;
      const int c0 = nt * BN + 2 * (lane % 4);
      const bool pairs = (N % 2) == 0;
      __nv_bfloat16* Cz = C + static_cast<long long>(z) * M * N;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = c0 + 8 * j;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = r + 8 * h;
          if (row >= M || c >= N) continue;
          __nv_bfloat16* dst = Cz + static_cast<long long>(row) * N + c;
          const float x = acc[4 * j + 2 * h], y = acc[4 * j + 2 * h + 1];
          if (pairs) {
            *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x, y);
          } else {
            dst[0] = __float2bfloat16(x);
            if (c + 1 < N) dst[1] = __float2bfloat16(y);
          }
        }
      }
    }
  }
}

// A tensor map of a bf16 operand stored as rows of `inner` contiguous
// elements, `outer` rows `ld` apart, and (sbatch > 0) `batch` such matrices
// sbatch apart; box `box_inner` x `box_outer` (x 1).
bool encode_operand(CUtensorMap* map, const void* base, int inner, int outer, long long ld,
                    int batch, long long sbatch, int box_inner, int box_outer) {
  const uint64_t dims[3] = {static_cast<uint64_t>(inner), static_cast<uint64_t>(outer),
                            static_cast<uint64_t>(batch)};
  const uint64_t strides[2] = {static_cast<uint64_t>(ld) * 2,
                               static_cast<uint64_t>(sbatch) * 2};
  const uint32_t box[3] = {static_cast<uint32_t>(box_inner), static_cast<uint32_t>(box_outer), 1};
  return encode_bf16(map, sbatch > 0 ? 3 : 2, base, dims, strides, box);
}

template <bool kAMajorM>
int launch(const void* a, const void* b, void* c, int batch, int M, int N, int K, long long lda,
           long long sab, long long ldb, long long sbb, cudaStream_t stream) {
  CUtensorMap map_a, map_b;
  // A stored as (K, M) rows of M: box 64 (M) x 64 (K); as (M, K) rows of
  // K: box 64 (K) x 128 (M). B stored as (K, N) rows of N: box 64 (N) x 64.
  const bool ok =
      (kAMajorM ? encode_operand(&map_a, a, M, K, lda, batch, sab, 64, BK)
                : encode_operand(&map_a, a, K, M, lda, batch, sab, BK, BM)) &&
      encode_operand(&map_b, b, N, K, ldb, batch, sbb, 64, BK);
  if (!ok) return kMapError;
  Grid g;
  g.m_tiles = (M + BM - 1) / BM;
  g.n_tiles = (N + BN - 1) / BN;
  g.k_blocks = (K + BK - 1) / BK;
  g.per_batch = g.m_tiles * g.n_tiles;
  const long long tiles = static_cast<long long>(g.per_batch) * batch;
  if (tiles > 0x7fffffffll) return cudaErrorInvalidValue;
  g.tiles = static_cast<int>(tiles);
  g.a3 = sab > 0;
  g.b3 = sbb > 0;
  const cudaError_t err = cudaFuncSetAttribute(
      gemm_wgmma_kernel<kAMajorM>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  const int grid = g.tiles < sm_count() ? g.tiles : sm_count();
  gemm_wgmma_kernel<kAMajorM><<<grid, kThreads, kSmemBytes, stream>>>(
      map_a, map_b, static_cast<__nv_bfloat16*>(c), M, N, g);
  return cudaGetLastError();
}

}  // namespace

// C entry point (bound with ctypes). a and b are device pointers, 16-byte
// aligned; C is a contiguous batch x M x N output. a_m_major = 0: A is
// row-major with row stride lda; 1: A is column-major (a transposed view)
// with column stride lda. B is row-major with row stride ldb. sab and sbb
// are the batch strides; 0 broadcasts that operand to every batch entry.
// Every stride is in elements, a multiple of 8. batch, M, N, K >= 1.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue if
// a tensor map cannot be encoded or the tiles overflow an int.
extern "C" int matmul_bf16(const void* a, const void* b, void* c, int batch, int M, int N, int K,
                           int a_m_major, long long lda, long long sab, long long ldb,
                           long long sbb, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return a_m_major ? launch<true>(a, b, c, batch, M, N, K, lda, sab, ldb, sbb, s)
                   : launch<false>(a, b, c, batch, M, N, K, lda, sab, ldb, sbb, s);
}

// Dynamic shared memory of one CTA: the 4-stage ring, its barriers, alignment.
extern "C" int matmul_bf16_smem_bytes() { return kSmemBytes; }
