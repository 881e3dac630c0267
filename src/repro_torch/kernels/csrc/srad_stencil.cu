// One SRAD diffusion step on a 2-D f32 image for Hopper (sm_90a): phase 1
// takes clamped 4-neighbour differences and the diffusion coefficient c,
// clipped to [0, 1]; phase 2 writes img + 0.25 * lam * div, with div built
// from c at the pixel and at its south and east neighbours.
//
// Replaces: src/repro/kernels/srad_stencil.py::srad_step_fused (body
// _fused_kernel) and ::srad_step_split (bodies _phase1_kernel,
// _phase2_kernel). On the TPU both run as one whole-image block in VMEM: the
// fused kernel keeps the image and c on chip across both phases, the split
// one writes c to HBM between two pallas_calls. A 1024^2 f32 image is 4 MiB,
// far above the 227 KB of shared memory a block has, but the 132 SMs hold
// about 30 MB together. Five entries; kernels/srad_stencil.py::_route picks
// one from the image's shape and address:
//
// - srad_fused_f32 (band_kernel): the TPU kernel's idea carried to the whole
//   card. One cooperative launch of G <= SMs CTAs of up to 1024 threads, one
//   CTA an SM. CTA b owns the band of whole rows [b*R, min(b*R+R, H)); it
//   copies the band and one clamped halo row above and below into shared
//   memory with cp.async (16 bytes a copy where W % 4 == 0 and the base is
//   16-byte aligned, 4 bytes otherwise), computes the band's c into shared
//   memory, and writes the band's first row of c to a global halo buffer
//   (G x Wp floats), the south row the CTA above needs. One grid.sync() over
//   the G CTAs, the band below's first row of c copied in from L2, then
//   phase 2 from shared memory, stored as float4 where the rows allow it.
//   Device traffic: img read once, out written once, plus two halo rows a
//   band and the halo buffer (about 1/R more). Whole rows keep the east
//   neighbour in the band; threads are (quad, row) pairs from threadIdx, so
//   no pixel pays an integer division. Rows in shared memory are padded to
//   Wp = W rounded up to 4, the padding a copy of column W-1 (img, and c
//   after phase 1), so the quad at the right edge reads its clamped east
//   neighbour like any other. A band fits when (2R + 3) * Wp * 4 bytes fit
//   a CTA's shared memory: up to about 1800^2 at 132 SMs (1024^2: R = 8,
//   77.8 KB). TMA was the alternative for the copy-in; a band is one
//   contiguous run of rows, so cp.async of 16 bytes a thread already keeps
//   the whole band in flight at once, and the scalar path needs no tensor map.
// - srad_fused_f32_gridstride (the port's first design of the step): every
//   image. A cooperative launch of occupancy x SMs blocks of 256 walking the
//   image in a grid-stride loop, c through a device-memory scratch (in L2)
//   between the phases, i / W and i % W per pixel. The images no band fits
//   (2048^2 and 4096^2 among the suite's sizes) take it.
// - srad_phase1_f32 (walk_kernel): W % 4 == 0 on 16-byte aligned bases. Each
//   thread owns one float4 of columns and walks kWalkRows rows, its north,
//   centre and south float4s loaded ahead into registers; west and east come
//   from the neighbouring lanes' float4 by __shfl_sync, the warp's two edge
//   lanes reading one float from L1. c is stored as float4. The walk is
//   short because the kernel is issue-bound and wants warps more than it
//   wants the loads a longer walk saves. Throwaway builds timed side by side
//   on one H100 at 1024^2, back to back in a CUDA graph: 1, 2, 3, 4 and 8
//   rows a thread took 4.84, 5.01, 5.74, 5.45 and 8.15 us at 128 threads a
//   block, 4.83, 4.97 and 5.14 us for 1, 2 and 4 rows at 256; a rolling
//   window that loads row r+2 while row r computes (8, 16, 32 rows) was
//   slower still, and __frcp_rn in place of the last division slower too.
// - srad_phase1_f32_scalar (the first design of phase 1): every image, one
//   thread a pixel.
// - srad_phase2_f32: one thread a pixel; recomputes the differences, as
//   srad_stencil.py:218 and Rodinia's srad_v1 do.
//
// Every entry follows kernels/ref.py::srad_phase1_ref and srad_phase2_ref
// operation by operation, in the same order and with the same roundings (no
// FMA contraction: the _rn intrinsics), edges clamped the same way, so all
// five are bit-equal to the plain version. Division by the scalar q0sqr *
// (1 + q0sqr) is a multiplication by its f32 reciprocal, which is what
// PyTorch does on the card for a tensor divided by a Python scalar.
//
// Bound on an H100 SXM: at 1024^2 about 40 operations per pixel (0.6 us at
// 67 TFLOP/s) against 8 bytes per pixel for a fused step (img read, out
// written; 2.5 us at 3.35 TB/s), so bytes bound it; the split phases move
// 8 and 12 bytes per pixel. Issue is the nearer limit in practice: the four
// IEEE divisions of phase 1 cost some 10 instructions each, about 65
// instructions a pixel, some 2.5 us of issue on 132 SMs at 1024^2. The band
// kernel runs its parts one after the other (copy-in, phase 1, barrier,
// phase 2, stores drained at the end), and a cooperative launch with one
// grid.sync() costs 2.4 us back to back even when empty (an ordinary
// launch 1.1 us; throwaway empty kernels in a CUDA graph on one H100), so
// at 1024^2 a step takes some 8.7 us, against 16 for the grid-stride
// kernel (chip_smoke.py times every entry so).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;       // the grid-stride and one-pixel kernels
constexpr int kBandThreads = 1024;  // band_kernel's CTA, at most
constexpr int kWalkThreads = 256;   // walk_kernel: float4 columns per block
constexpr int kWalkRows = 2;        // walk_kernel: rows per thread
constexpr int kMaxDevices = 64;
constexpr unsigned kFullMask = 0xffffffffu;

struct Params {
  float q0sqr;     // q0^2
  float inv_qden;  // f32 reciprocal of q0^2 * (1 + q0^2)
  float coef;      // 0.25 * lam
};

struct Diffs {
  float J, dN, dS, dW, dE;
};

__device__ __forceinline__ Diffs diffs(float J, float n, float s, float w, float e) {
  return {J, __fsub_rn(n, J), __fsub_rn(s, J), __fsub_rn(w, J), __fsub_rn(e, J)};
}

// Phase 1 at one pixel: ref.py::srad_phase1_ref, operation by operation.
__device__ __forceinline__ float coefficient(Diffs d, Params p) {
  const float sq = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(d.dN, d.dN), __fmul_rn(d.dS, d.dS)),
                                       __fmul_rn(d.dW, d.dW)),
                             __fmul_rn(d.dE, d.dE));
  const float g2 = __fdiv_rn(sq, __fmul_rn(d.J, d.J));
  const float lap = __fdiv_rn(__fadd_rn(__fadd_rn(__fadd_rn(d.dN, d.dS), d.dW), d.dE), d.J);
  const float num = __fsub_rn(__fmul_rn(0.5f, g2), __fmul_rn(__fmul_rn(0.0625f, lap), lap));
  const float den = __fadd_rn(1.0f, __fmul_rn(0.25f, lap));
  const float qsqr = __fdiv_rn(num, __fmul_rn(den, den));
  const float c =
      __fdiv_rn(1.0f, __fadd_rn(1.0f, __fmul_rn(__fsub_rn(qsqr, p.q0sqr), p.inv_qden)));
  // torch.clamp(c, 0, 1): NaN stays NaN.
  return c != c ? c : fminf(fmaxf(c, 0.0f), 1.0f);
}

// Phase 2 at one pixel: ref.py::srad_phase2_ref, the divergence update by c
// at the pixel (cc), its south (cs) and east (ce) neighbours.
__device__ __forceinline__ float update(Diffs d, float cc, float cs, float ce, Params p) {
  const float div = __fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(cc, d.dN), __fmul_rn(cs, d.dS)), __fmul_rn(cc, d.dW)),
      __fmul_rn(ce, d.dE));
  return __fadd_rn(d.J, __fmul_rn(p.coef, div));
}

// The differences at pixel (r, col) of a whole image in device memory.
__device__ __forceinline__ Diffs diffs_at(const float* __restrict__ img, int H, int W, int r,
                                          int col) {
  const long long row = static_cast<long long>(r) * W;
  return diffs(img[row + col], img[(r > 0 ? row - W : row) + col],
               img[(r < H - 1 ? row + W : row) + col], img[row + (col > 0 ? col - 1 : col)],
               img[row + (col < W - 1 ? col + 1 : col)]);
}

__device__ __forceinline__ float update_at(const float* __restrict__ img,
                                           const float* __restrict__ c, int H, int W, int r,
                                           int col, Params p) {
  const long long row = static_cast<long long>(r) * W;
  return update(diffs_at(img, H, W, r, col), c[row + col],
                c[(r < H - 1 ? row + W : row) + col], c[row + (col < W - 1 ? col + 1 : col)],
                p);
}

// The four coefficients of a quad of columns: north, centre and south rows
// at the quad, the centre's west and east neighbours outside it.
__device__ __forceinline__ float4 coefficient4(float4 n, float4 j, float4 s, float w, float e,
                                               Params p) {
  return make_float4(coefficient(diffs(j.x, n.x, s.x, w, j.y), p),
                     coefficient(diffs(j.y, n.y, s.y, j.x, j.z), p),
                     coefficient(diffs(j.z, n.z, s.z, j.y, j.w), p),
                     coefficient(diffs(j.w, n.w, s.w, j.z, e), p));
}

// ------------------------------------------------------ the band kernel

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float4 ld4(const float* row, int q) {
  return reinterpret_cast<const float4*>(row)[q];
}

// kVec: W % 4 == 0 and img, out 16-byte aligned (16-byte copies and stores).
template <bool kVec>
__global__ void __launch_bounds__(kBandThreads, 1)
band_kernel(const float* __restrict__ img, float* __restrict__ halo, float* __restrict__ out,
            int H, int W, int R, Params p) {
  extern __shared__ float4 smem4[];
  cg::grid_group grid = cg::this_grid();
  const int wp = (W + 3) & ~3, wq = wp >> 2;
  const int band = blockIdx.x, r0 = band * R, rows = min(R, H - r0);
  const int tx = threadIdx.x, ty = threadIdx.y, bx = blockDim.x, by = blockDim.y;
  float* simg = reinterpret_cast<float*>(smem4);  // (rows + 2) x wp: rows r0-1 .. r0+rows
  float* sc = simg + static_cast<size_t>(R + 2) * wp;  // (rows + 1) x wp

  // Copy-in: shared row i is image row r0 - 1 + i, clamped to the image.
  for (int i = ty; i < rows + 2; i += by) {
    const int r = min(max(r0 - 1 + i, 0), H - 1);
    const float* src = img + static_cast<size_t>(r) * W;
    float* dst = simg + static_cast<size_t>(i) * wp;
    for (int q = tx; q < wq; q += bx) {
      if (kVec) {
        cp_async16(dst + 4 * q, src + 4 * q);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) cp_async4(dst + 4 * q + k, src + min(4 * q + k, W - 1));
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // Phase 1: c of the band into shared memory; its first row also to the
  // halo buffer for the band above.
  const int last_q = wq - 1, edge = W - 1 - 4 * last_q;  // W-1's place in the last quad
  for (int i = ty; i < rows; i += by) {
    const float* up = simg + static_cast<size_t>(i) * wp;
    const float* mid = up + wp;
    const float* dn = mid + wp;
    for (int q = tx; q < wq; q += bx) {
      float4 c = coefficient4(ld4(up, q), ld4(mid, q), ld4(dn, q), mid[max(4 * q - 1, 0)],
                              mid[min(4 * q + 4, wp - 1)], p);
      if (!kVec && q == last_q) {  // padding columns: a copy of c at W-1
        const float ce = edge == 0 ? c.x : edge == 1 ? c.y : c.z;
        if (edge < 1) c.y = ce;
        if (edge < 2) c.z = ce;
        if (edge < 3) c.w = ce;
      }
      reinterpret_cast<float4*>(sc + static_cast<size_t>(i) * wp)[q] = c;
      if (i == 0 && band > 0)
        reinterpret_cast<float4*>(halo + static_cast<size_t>(band) * wp)[q] = c;
    }
  }

  grid.sync();  // every band's first row of c is in the halo buffer

  // c of the row below the band: the next band's first row, or (last band)
  // the band's own last row, as the clamp at the image's bottom edge says.
  float* below = sc + static_cast<size_t>(rows) * wp;
  if (ty == 0) {
    if (band + 1 < gridDim.x) {
      const float* src = halo + static_cast<size_t>(band + 1) * wp;
      for (int q = tx; q < wq; q += bx) cp_async16(below + 4 * q, src + 4 * q);
    } else {
      const float* src = below - wp;
      for (int q = tx; q < wq; q += bx)
        reinterpret_cast<float4*>(below)[q] = reinterpret_cast<const float4*>(src)[q];
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // Phase 2: the update, from shared memory.
  for (int i = ty; i < rows; i += by) {
    const float* up = simg + static_cast<size_t>(i) * wp;
    const float* mid = up + wp;
    const float* dn = mid + wp;
    const float* crow = sc + static_cast<size_t>(i) * wp;
    float* orow = out + static_cast<size_t>(r0 + i) * W;
    for (int q = tx; q < wq; q += bx) {
      const float4 n = ld4(up, q), j = ld4(mid, q), s = ld4(dn, q);
      const float w = mid[max(4 * q - 1, 0)], e = mid[min(4 * q + 4, wp - 1)];
      const float4 cc = ld4(crow, q), cs = ld4(crow + wp, q);
      const float ce = crow[min(4 * q + 4, wp - 1)];
      const float4 o = make_float4(update(diffs(j.x, n.x, s.x, w, j.y), cc.x, cs.x, cc.y, p),
                                   update(diffs(j.y, n.y, s.y, j.x, j.z), cc.y, cs.y, cc.z, p),
                                   update(diffs(j.z, n.z, s.z, j.y, j.w), cc.z, cs.z, cc.w, p),
                                   update(diffs(j.w, n.w, s.w, j.z, e), cc.w, cs.w, ce, p));
      if (kVec) {
        reinterpret_cast<float4*>(orow)[q] = o;
      } else {
        const int col = 4 * q;
        orow[col] = o.x;
        if (col + 1 < W) orow[col + 1] = o.y;
        if (col + 2 < W) orow[col + 2] = o.z;
        if (col + 3 < W) orow[col + 3] = o.w;
      }
    }
  }
}

// ------------------------------------------------------ the phase-1 walk

// grid (ceil(wq / kWalkThreads), ceil(H / kWalkRows)); W % 4 == 0, img and c
// 16-byte aligned.
__global__ void __launch_bounds__(kWalkThreads)
walk_kernel(const float* __restrict__ img, float* __restrict__ c, int H, int W, Params p) {
  const int wq = W >> 2;
  const int q = blockIdx.x * kWalkThreads + threadIdx.x;
  const int qc = min(q, wq - 1);  // lanes past the edge mirror the last quad for the shuffles
  const int lane = threadIdx.x & 31;
  const int r_begin = blockIdx.y * kWalkRows;
  const float4* src = reinterpret_cast<const float4*>(img);
  // Rows r_begin - 1 .. r_begin + kWalkRows, clamped, all loaded ahead.
  float4 v[kWalkRows + 2];
#pragma unroll
  for (int k = 0; k < kWalkRows + 2; ++k) {
    const int r = min(max(r_begin - 1 + k, 0), H - 1);
    v[k] = __ldg(src + static_cast<size_t>(r) * wq + qc);
  }
#pragma unroll
  for (int k = 0; k < kWalkRows; ++k) {
    const int r = r_begin + k;
    if (r >= H) break;  // uniform across the block
    const float4 j = v[k + 1];
    float w = __shfl_up_sync(kFullMask, j.w, 1);
    float e = __shfl_down_sync(kFullMask, j.x, 1);
    const float* row = img + static_cast<size_t>(r) * W;
    if (lane == 0) w = qc > 0 ? __ldg(row + 4 * qc - 1) : j.x;
    if (qc == wq - 1) {
      e = j.w;
    } else if (lane == 31) {
      e = __ldg(row + 4 * qc + 4);
    }
    const float4 out = coefficient4(v[k], j, v[k + 2], w, e, p);
    if (q < wq) reinterpret_cast<float4*>(c + static_cast<size_t>(r) * W)[q] = out;
  }
}

// ------------------------------------------------ the one-pixel kernels

__global__ void __launch_bounds__(kThreads)
gridstride_kernel(const float* __restrict__ img, float* __restrict__ c,
                  float* __restrict__ out, int H, int W, Params p) {
  cg::grid_group grid = cg::this_grid();
  const long long total = static_cast<long long>(H) * W;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  for (long long i = first; i < total; i += stride)
    c[i] = coefficient(diffs_at(img, H, W, static_cast<int>(i / W), static_cast<int>(i % W)), p);
  grid.sync();  // every block's c is written before any block reads a neighbour's
  for (long long i = first; i < total; i += stride)
    out[i] = update_at(img, c, H, W, static_cast<int>(i / W), static_cast<int>(i % W), p);
}

__global__ void __launch_bounds__(kThreads)
phase1_scalar_kernel(const float* __restrict__ img, float* __restrict__ c, int H, int W,
                     Params p) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < static_cast<long long>(H) * W)
    c[i] = coefficient(diffs_at(img, H, W, static_cast<int>(i / W), static_cast<int>(i % W)), p);
}

__global__ void __launch_bounds__(kThreads)
phase2_kernel(const float* __restrict__ img, const float* __restrict__ c,
              float* __restrict__ out, int H, int W, Params p) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < static_cast<long long>(H) * W)
    out[i] = update_at(img, c, H, W, static_cast<int>(i / W), static_cast<int>(i % W), p);
}

// ------------------------------------------------------------ host side

// The device's SM count and the shared memory a CTA may opt in to, after
// checking that it runs cooperative launches and raising the band kernels'
// dynamic shared-memory limit to that size (queried once per device: the
// answer depends only on the card, and nothing here runs during a graph
// capture after the first call).
struct Limits {
  int sms = 0, smem = 0;
};

Limits band_limits(cudaError_t* err) {
  static Limits cached[kMaxDevices];
  int dev = 0;
  *err = cudaGetDevice(&dev);
  if (*err != cudaSuccess) return {};
  if (dev < kMaxDevices && cached[dev].sms > 0) return cached[dev];
  int coop = 0;
  Limits l;
  *err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (*err != cudaSuccess) return {};
  if (!coop) {
    *err = cudaErrorNotSupported;
    return {};
  }
  *err = cudaDeviceGetAttribute(&l.sms, cudaDevAttrMultiProcessorCount, dev);
  if (*err != cudaSuccess) return {};
  *err = cudaDeviceGetAttribute(&l.smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (*err != cudaSuccess) return {};
  *err = cudaFuncSetAttribute(band_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              l.smem);
  if (*err != cudaSuccess) return {};
  *err = cudaFuncSetAttribute(band_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              l.smem);
  if (*err != cudaSuccess) return {};
  if (dev < kMaxDevices) cached[dev] = l;
  return l;
}

// Blocks of the grid-stride kernel that fit on the device at once, per
// device (queried once).
int resident_blocks(cudaError_t* err) {
  static int cached[kMaxDevices] = {0};
  int dev = 0;
  *err = cudaGetDevice(&dev);
  if (*err != cudaSuccess) return 0;
  if (dev < kMaxDevices && cached[dev] > 0) return cached[dev];
  int coop = 0, sms = 0, per_sm = 0;
  *err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (*err != cudaSuccess) return 0;
  if (!coop) {
    *err = cudaErrorNotSupported;
    return 0;
  }
  *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (*err != cudaSuccess) return 0;
  *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gridstride_kernel, kThreads, 0);
  if (*err != cudaSuccess) return 0;
  if (per_sm == 0) {
    // Not one block fits on an SM: a cooperative launch cannot run at all.
    *err = cudaErrorCooperativeLaunchTooLarge;
    return 0;
  }
  if (dev < kMaxDevices) cached[dev] = per_sm * sms;
  return per_sm * sms;
}

bool valid(int H, int W) { return H > 0 && W > 0; }

// Dynamic shared memory of band_kernel for bands of R rows, Wp floats each:
// the image rows with a halo row above and below, then c of the band and of
// the next band's first row (kernels/srad_stencil.py::band_smem_bytes).
size_t band_smem_bytes(int R, int wp) {
  return static_cast<size_t>(2 * R + 3) * wp * sizeof(float);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

unsigned blocks_for(int H, int W) {
  return static_cast<unsigned>((static_cast<long long>(H) * W + kThreads - 1) / kThreads);
}

}  // namespace

// C entry points (bound with ctypes). img, c and out are contiguous (H, W)
// f32 buffers on the device. q0sqr is q0^2, inv_qden the f32 reciprocal of
// q0^2 * (1 + q0^2) and coef 0.25 * lam, all three rounded to f32 by the
// caller. Each returns cudaGetLastError() (or the launch's own error) after
// its launch.

// One step on bands of R rows: ceil(H / R) CTAs, at most one an SM. halo is
// the caller's scratch of ceil(H / R) x Wp floats (Wp = W rounded up to 4),
// 16-byte aligned.
extern "C" int srad_fused_f32(const void* img, void* halo, void* out, int H, int W, int R,
                              float q0sqr, float inv_qden, float coef, void* stream) {
  if (!valid(H, W) || R <= 0 || !aligned16(halo)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  const Limits l = band_limits(&err);
  if (l.sms == 0) return (int)err;
  const int bands = (H + R - 1) / R, wp = (W + 3) & ~3, wq = wp / 4;
  const size_t smem = band_smem_bytes(R, wp);
  if (bands > l.sms || smem > static_cast<size_t>(l.smem))
    return (int)cudaErrorCooperativeLaunchTooLarge;
  const int bx = min((wq + 31) / 32 * 32, kBandThreads);
  const int by = max(1, min(kBandThreads / bx, R + 2));
  const bool vec = W % 4 == 0 && aligned16(img) && aligned16(out);
  const float* img_f = static_cast<const float*>(img);
  float* halo_f = static_cast<float*>(halo);
  float* out_f = static_cast<float*>(out);
  Params p{q0sqr, inv_qden, coef};
  void* args[] = {&img_f, &halo_f, &out_f, &H, &W, &R, &p};
  const void* kernel = vec ? reinterpret_cast<const void*>(band_kernel<true>)
                           : reinterpret_cast<const void*>(band_kernel<false>);
  err = cudaLaunchCooperativeKernel(kernel, dim3(bands), dim3(bx, by), args, smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The band kernels' limits on the current device: SMs and the shared memory
// a CTA may opt in to, into out[0] and out[1]. Returns 0 or the CUDA error.
extern "C" int srad_band_limits(int* out) {
  cudaError_t err = cudaSuccess;
  const Limits l = band_limits(&err);
  if (l.sms == 0) return (int)err;
  out[0] = l.sms;
  out[1] = l.smem;
  return 0;
}

// c is the coefficient's scratch, (H, W).
extern "C" int srad_fused_f32_gridstride(const void* img, void* c, void* out, int H, int W,
                                         float q0sqr, float inv_qden, float coef,
                                         void* stream) {
  if (!valid(H, W)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  const int resident = resident_blocks(&err);
  if (resident == 0) return (int)err;
  const unsigned needed = blocks_for(H, W);
  const unsigned grid = needed < static_cast<unsigned>(resident) ? needed : resident;
  const float* img_f = static_cast<const float*>(img);
  float* c_f = static_cast<float*>(c);
  float* out_f = static_cast<float*>(out);
  Params p{q0sqr, inv_qden, coef};
  void* args[] = {&img_f, &c_f, &out_f, &H, &W, &p};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(gridstride_kernel), dim3(grid),
                                    dim3(kThreads), args, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// How many blocks of the grid-stride kernel the current device holds at once
// (its cooperative grid's limit), or minus the CUDA error that prevented an
// answer.
extern "C" int srad_fused_resident_blocks() {
  cudaError_t err = cudaSuccess;
  const int resident = resident_blocks(&err);
  return resident > 0 ? resident : -static_cast<int>(err);
}

// W % 4 == 0, img and c 16-byte aligned; H <= 65535 * kWalkRows.
extern "C" int srad_phase1_f32(const void* img, void* c, int H, int W, float q0sqr,
                               float inv_qden, void* stream) {
  if (!valid(H, W) || W % 4 || !aligned16(img) || !aligned16(c) ||
      (H + kWalkRows - 1) / kWalkRows > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((W / 4 + kWalkThreads - 1) / kWalkThreads, (H + kWalkRows - 1) / kWalkRows);
  walk_kernel<<<grid, kWalkThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<float*>(c), H, W,
      Params{q0sqr, inv_qden, 0.f});
  return (int)cudaGetLastError();
}

extern "C" int srad_phase1_f32_scalar(const void* img, void* c, int H, int W, float q0sqr,
                                      float inv_qden, void* stream) {
  if (!valid(H, W)) return (int)cudaErrorInvalidValue;
  phase1_scalar_kernel<<<blocks_for(H, W), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<float*>(c), H, W,
      Params{q0sqr, inv_qden, 0.f});
  return (int)cudaGetLastError();
}

extern "C" int srad_phase2_f32(const void* img, const void* c, void* out, int H, int W,
                               float coef, void* stream) {
  if (!valid(H, W)) return (int)cudaErrorInvalidValue;
  phase2_kernel<<<blocks_for(H, W), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<const float*>(c), static_cast<float*>(out),
      H, W, Params{0.f, 0.f, coef});
  return (int)cudaGetLastError();
}
