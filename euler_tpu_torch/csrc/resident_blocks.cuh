// Grid sizing shared by the port's CUDA kernels (gather_rows.cu,
// ell_agg.cu): how many blocks of a kernel the current device holds at
// once.
#pragma once

#include <atomic>
#include <cstdint>

#include <cuda_runtime.h>

namespace etpu {

constexpr int kMaxDevices = 64;  // devices whose occupancy is remembered

// Blocks of `Kernel` at `kThreads` threads a block that the current
// device runs at once: asked of the runtime on the first call on each
// device, then remembered (one cache a kernel), so that a launch makes no
// query beyond cudaGetDevice.
template <auto Kernel, int kThreads>
int64_t resident_blocks() {
  static std::atomic<int64_t> known[kMaxDevices];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) dev = -1;
  const bool keep = dev >= 0 && dev < kMaxDevices;
  if (keep) {
    const int64_t got = known[dev].load(std::memory_order_relaxed);
    if (got > 0) return got;
  }
  int sms = 0, per_sm = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess || sms <= 0) {
    sms = 132;  // H100 SXM; only sizes the grid
  }
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, Kernel,
                                                    kThreads, 0) !=
          cudaSuccess || per_sm <= 0) {
    per_sm = 1;
  }
  const int64_t n = static_cast<int64_t>(sms) * per_sm;
  if (keep) known[dev].store(n, std::memory_order_relaxed);
  return n;
}

}  // namespace etpu
