// Managed (unified) memory for the Unified Memory study: C entry points over
// cudaMallocManaged, cudaMemAdvise, cudaMemPrefetchAsync and cudaFree, and
// the card's cudaDevAttrConcurrentManagedAccess. PyTorch has no managed
// allocator; kernels/managed.py wraps an allocation as a tensor.
//
// No TPU kernel stands behind these: the reference imitates demand paging
// with jax.device_put on first use (src/repro/core/features.py:63).
//
// A device of -1 (cudaCpuDeviceId) names the host. CUDA 13 gives
// cudaMemAdvise and cudaMemPrefetchAsync a cudaMemLocation in place of the
// device number (and the prefetch a flags word), hence the two forms.

#include <cuda_runtime.h>

namespace {

#if CUDART_VERSION >= 13000
cudaMemLocation location(int device) {
  cudaMemLocation loc{};
  if (device == cudaCpuDeviceId) {
    loc.type = cudaMemLocationTypeHost;
    loc.id = 0;
  } else {
    loc.type = cudaMemLocationTypeDevice;
    loc.id = device;
  }
  return loc;
}
#endif

}  // namespace

extern "C" int managed_alloc(void** out, size_t bytes) {
  return static_cast<int>(cudaMallocManaged(out, bytes, cudaMemAttachGlobal));
}

extern "C" int managed_free(void* ptr) { return static_cast<int>(cudaFree(ptr)); }

extern "C" int managed_advise(void* ptr, size_t bytes, int advice, int device) {
#if CUDART_VERSION >= 13000
  return static_cast<int>(
      cudaMemAdvise(ptr, bytes, static_cast<cudaMemoryAdvise>(advice), location(device)));
#else
  return static_cast<int>(cudaMemAdvise(ptr, bytes, static_cast<cudaMemoryAdvise>(advice), device));
#endif
}

extern "C" int managed_prefetch(void* ptr, size_t bytes, int device, void* stream) {
#if CUDART_VERSION >= 13000
  return static_cast<int>(
      cudaMemPrefetchAsync(ptr, bytes, location(device), 0, static_cast<cudaStream_t>(stream)));
#else
  return static_cast<int>(
      cudaMemPrefetchAsync(ptr, bytes, device, static_cast<cudaStream_t>(stream)));
#endif
}

extern "C" int managed_concurrent_access(int device, int* out) {
  return static_cast<int>(
      cudaDeviceGetAttribute(out, cudaDevAttrConcurrentManagedAccess, device));
}
