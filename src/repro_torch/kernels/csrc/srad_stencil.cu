// One SRAD diffusion step on a 2-D f32 image for Hopper (sm_90a): phase 1
// takes clamped 4-neighbour differences and the diffusion coefficient c,
// clipped to [0, 1]; phase 2 writes img + 0.25 * lam * div, with div built
// from c at the pixel and at its south and east neighbours.
//
// Replaces: src/repro/kernels/srad_stencil.py::srad_step_fused (body
// _fused_kernel) and ::srad_step_split (bodies _phase1_kernel,
// _phase2_kernel). On the TPU both run as one whole-image block in VMEM: the
// fused kernel keeps the image on chip across both phases, the split one
// writes c to HBM between two pallas_calls. A 1024^2 f32 image is 4 MiB, far
// above the 227 KB of shared memory a block has, so the whole-image block
// does not carry over. Here:
//
// - srad_fused_f32 is one cooperative launch (the paper's Cooperative Groups
//   feature): no more blocks than can be resident at once (occupancy x SMs),
//   each walking the image's 256-pixel tiles in a grid-stride loop; phase 1
//   writes c to a scratch buffer in device memory, cooperative_groups'
//   grid.sync() waits for every block, and phase 2 reads c at the pixel and
//   at its south and east neighbours, which other blocks wrote. At the
//   suite's sizes c stays in the 50 MB L2 between the phases.
// - srad_phase1_f32 and srad_phase2_f32 are two ordinary launches with one
//   thread per pixel; phase 2 recomputes the differences, as
//   srad_stencil.py:218 and Rodinia's srad_v1 do.
//
// Both follow kernels/ref.py::srad_phase1_ref and srad_phase2_ref operation
// by operation, in the same order and with the same roundings (no FMA
// contraction: the _rn intrinsics), edges clamped the same way. Division by
// the scalar q0sqr * (1 + q0sqr) is a multiplication by its f32 reciprocal,
// which is what PyTorch does on the card for a tensor divided by a Python
// scalar, so the kernel and its plain version agree to the bit there.
//
// Bound on an H100 SXM: at 1024^2 about 40 operations per pixel (0.6 us at
// 67 TFLOP/s) against 8 bytes per pixel for a fused step (img read, out
// written; 2.5 us at 3.35 TB/s), so bytes bound it; the split phases move
// 8 and 12 bytes per pixel. A step at that size is shorter than the time to
// launch it: launches and the grid barrier, not bytes, set its time.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;

struct Params {
  float q0sqr;     // q0^2
  float inv_qden;  // f32 reciprocal of q0^2 * (1 + q0^2)
  float coef;      // 0.25 * lam
};

struct Diffs {
  float J, dN, dS, dW, dE;
};

__device__ __forceinline__ Diffs diffs(const float* __restrict__ img, int H, int W, int r,
                                       int col) {
  const long long row = static_cast<long long>(r) * W;
  const float J = img[row + col];
  const float n = img[(r > 0 ? row - W : row) + col];
  const float s = img[(r < H - 1 ? row + W : row) + col];
  const float w = img[row + (col > 0 ? col - 1 : col)];
  const float e = img[row + (col < W - 1 ? col + 1 : col)];
  return {J, __fsub_rn(n, J), __fsub_rn(s, J), __fsub_rn(w, J), __fsub_rn(e, J)};
}

// Phase 1 at pixel (r, col): ref.py::srad_phase1_ref, operation by operation.
__device__ __forceinline__ float coefficient(const float* __restrict__ img, int H, int W,
                                             int r, int col, Params p) {
  const Diffs d = diffs(img, H, W, r, col);
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

// Phase 2 at pixel (r, col): ref.py::srad_phase2_ref, the divergence update.
__device__ __forceinline__ float update(const float* __restrict__ img,
                                        const float* __restrict__ c, int H, int W, int r,
                                        int col, Params p) {
  const Diffs d = diffs(img, H, W, r, col);
  const long long row = static_cast<long long>(r) * W;
  const float cc = c[row + col];
  const float cs = c[(r < H - 1 ? row + W : row) + col];
  const float ce = c[row + (col < W - 1 ? col + 1 : col)];
  const float div = __fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(cc, d.dN), __fmul_rn(cs, d.dS)), __fmul_rn(cc, d.dW)),
      __fmul_rn(ce, d.dE));
  return __fadd_rn(d.J, __fmul_rn(p.coef, div));
}

__global__ void __launch_bounds__(kThreads)
srad_fused_kernel(const float* __restrict__ img, float* __restrict__ c,
                  float* __restrict__ out, int H, int W, Params p) {
  cg::grid_group grid = cg::this_grid();
  const long long total = static_cast<long long>(H) * W;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  for (long long i = first; i < total; i += stride)
    c[i] = coefficient(img, H, W, static_cast<int>(i / W), static_cast<int>(i % W), p);
  grid.sync();  // every block's c is written before any block reads a neighbour's
  for (long long i = first; i < total; i += stride)
    out[i] = update(img, c, H, W, static_cast<int>(i / W), static_cast<int>(i % W), p);
}

__global__ void __launch_bounds__(kThreads)
srad_phase1_kernel(const float* __restrict__ img, float* __restrict__ c, int H, int W,
                   Params p) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < static_cast<long long>(H) * W)
    c[i] = coefficient(img, H, W, static_cast<int>(i / W), static_cast<int>(i % W), p);
}

__global__ void __launch_bounds__(kThreads)
srad_phase2_kernel(const float* __restrict__ img, const float* __restrict__ c,
                   float* __restrict__ out, int H, int W, Params p) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < static_cast<long long>(H) * W)
    out[i] = update(img, c, H, W, static_cast<int>(i / W), static_cast<int>(i % W), p);
}

// Blocks of the fused kernel that fit on the device at once, per device
// (queried once: the answer depends only on the kernel and the card).
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
  *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, srad_fused_kernel, kThreads, 0);
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

unsigned blocks_for(int H, int W) {
  return static_cast<unsigned>((static_cast<long long>(H) * W + kThreads - 1) / kThreads);
}

}  // namespace

// C entry points (bound with ctypes). img, c and out are contiguous (H, W)
// f32 buffers on the device; c is the coefficient (scratch for the fused
// step). q0sqr is q0^2, inv_qden the f32 reciprocal of q0^2 * (1 + q0^2) and
// coef 0.25 * lam, all three rounded to f32 by the caller. Each returns
// cudaGetLastError() (or the launch's own error) after its launch.

extern "C" int srad_fused_f32(const void* img, void* c, void* out, int H, int W,
                              float q0sqr, float inv_qden, float coef, void* stream) {
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
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(srad_fused_kernel), dim3(grid),
                                    dim3(kThreads), args, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// How many blocks of the fused kernel the current device holds at once (the
// cooperative grid's limit), or minus the CUDA error that prevented an answer.
extern "C" int srad_fused_resident_blocks() {
  cudaError_t err = cudaSuccess;
  const int resident = resident_blocks(&err);
  return resident > 0 ? resident : -static_cast<int>(err);
}

extern "C" int srad_phase1_f32(const void* img, void* c, int H, int W, float q0sqr,
                               float inv_qden, void* stream) {
  if (!valid(H, W)) return (int)cudaErrorInvalidValue;
  srad_phase1_kernel<<<blocks_for(H, W), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<float*>(c), H, W,
      Params{q0sqr, inv_qden, 0.f});
  return (int)cudaGetLastError();
}

extern "C" int srad_phase2_f32(const void* img, const void* c, void* out, int H, int W,
                               float coef, void* stream) {
  if (!valid(H, W)) return (int)cudaErrorInvalidValue;
  srad_phase2_kernel<<<blocks_for(H, W), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<const float*>(c), static_cast<float*>(out),
      H, W, Params{0.f, 0.f, coef});
  return (int)cudaGetLastError();
}
