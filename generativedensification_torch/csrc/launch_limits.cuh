// Host-side launch helpers shared by the slot-gradient kernels
// (reduce_slots.cu, transpose_rows.cu): the per-device limits a launcher
// sizes its grid and shared memory by, read from the runtime once per
// device, and a kernel's dynamic shared-memory limit raised only when a
// launch needs more than was set before.  A launch on a known device then
// makes one runtime call besides the launch itself (cudaGetDevice).

#pragma once

#include <cuda_runtime.h>

#include <atomic>
#include <mutex>

namespace gd {

constexpr int MAX_DEVICES = 64;   // devices past this are queried every time

struct Limits {
  int sms = 0;          // multiprocessors
  int smem_optin = 0;   // opt-in shared memory per block, bytes
};

inline cudaError_t device_limits(int dev, Limits* out) {
  static std::atomic<int> sms[MAX_DEVICES], cap[MAX_DEVICES];   // 0: not read
  const bool cached = dev >= 0 && dev < MAX_DEVICES;
  if (cached) {
    out->sms = sms[dev].load(std::memory_order_relaxed);
    out->smem_optin = cap[dev].load(std::memory_order_relaxed);
    if (out->sms > 0 && out->smem_optin > 0) return cudaSuccess;
  }
  cudaError_t err =
      cudaDeviceGetAttribute(&out->sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&out->smem_optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess && cached) {
    sms[dev].store(out->sms, std::memory_order_relaxed);
    cap[dev].store(out->smem_optin, std::memory_order_relaxed);
  }
  return err;
}

// Lets `kernel` launch with `bytes` of dynamic shared memory on device
// `dev`.  `set` is the kernel's own record, per device, of the largest size
// set so far (one array per kernel, zero-initialised).
template <typename Kernel>
cudaError_t allow_dynamic_smem(Kernel* kernel, int dev, int bytes,
                               std::atomic<int>* set) {
  const bool cached = dev >= 0 && dev < MAX_DEVICES;
  if (cached && set[dev].load(std::memory_order_acquire) >= bytes)
    return cudaSuccess;
  static std::mutex lock;
  const std::lock_guard<std::mutex> guard(lock);
  if (cached && set[dev].load(std::memory_order_relaxed) >= bytes)
    return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && cached)
    set[dev].store(bytes, std::memory_order_release);
  return err;
}

}  // namespace gd
