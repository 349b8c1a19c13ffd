// Host-side helpers for entry points that keep their launch path lean.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int MAX_DEVICES = 64;

// Make `device` current, calling cudaSetDevice only when it is not already.
inline cudaError_t use_device(int device) {
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err != cudaSuccess) return err;
  return cur == device ? cudaSuccess : cudaSetDevice(device);
}

// Raise `kernel`'s dynamic shared-memory limit to `bytes` on `device`, once:
// `granted` is the caller's per-kernel record of what each device allows.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, int bytes, int device,
                              int (&granted)[MAX_DEVICES]) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (granted[device] >= bytes) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) granted[device] = bytes;
  return err;
}

}  // namespace
