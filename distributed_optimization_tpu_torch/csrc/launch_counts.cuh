// Launch counts kept on the card: one 64-bit slot per kernel of a library.
//
// A kernel calls launch_counts::add(slot) first thing; the first thread of
// the launch's first block adds one to the slot. So a count rises where the
// kernel runs on the card: once for an eager launch, and once for each
// replay of a CUDA graph that holds the launch (capture itself runs nothing).
// The Python wrappers read the slots through launch_counts_read and zero
// them through launch_counts_reset; both synchronise the current device, so
// neither is called inside a capture.
//
// Included by each csrc/*.cu source, which is its own shared library with
// its own slots.

#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace launch_counts {

constexpr int kSlots = 8;

__device__ unsigned long long slots[kSlots];

__device__ __forceinline__ void add(int slot) {
  if ((blockIdx.x | blockIdx.y | blockIdx.z | threadIdx.x | threadIdx.y | threadIdx.z) == 0) {
    atomicAdd(&slots[slot], 1ULL);
  }
}

}  // namespace launch_counts

extern "C" {

// Copies the first n slots of the current device into out.
int launch_counts_read(unsigned long long* out, int n) {
  if (n < 0 || n > launch_counts::kSlots) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess) {
    err = cudaMemcpyFromSymbol(out, launch_counts::slots, n * sizeof(unsigned long long));
  }
  return static_cast<int>(err);
}

// Zeroes every slot of the current device.
int launch_counts_reset() {
  static const unsigned long long zeros[launch_counts::kSlots] = {};
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(launch_counts::slots, zeros, sizeof(zeros));
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  return static_cast<int>(err);
}

}  // extern "C"
