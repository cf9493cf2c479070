// Threefry-2x32 with 20 rounds (Salmon et al., SC'11), the generator behind
// jax.random (jax 0.9.0, partitionable): the device function the sampling
// and the compression kernels draw with. The twin in PyTorch ops is
// distributed_optimization_tpu_torch/ops/prng.py::threefry2x32.
//
//   fold_in(key, data)   = threefry2x32(key, (0, data mod 2^32))
//   element i of a draw  = threefry2x32(key, (i >> 32, i mod 2^32)), the flat
//                          index's two words (jax's iota_2x32_shape); its 32
//                          bits x0 ^ x1, its 64 bits x0 << 32 | x1
//   uniform in float32   = the top 23 of the 32 bits as m, u = m * 2^-23
//   uniform in float64   = the top 52 of the 64 bits as m, u = m * 2^-52

#pragma once

#include <cuda_runtime.h>
#include <cstdint>

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// Threefry-2x32, 20 rounds: (x0, x1) for the counter (c0, c1) under (k0, k1).
__device__ __forceinline__ uint2 threefry2x32(uint32_t k0, uint32_t k1, uint32_t c0,
                                              uint32_t c1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  constexpr int kRot[8] = {13, 15, 26, 6, 17, 29, 16, 24};
  uint32_t x0 = c0 + ks[0];
  uint32_t x1 = c1 + ks[1];
#pragma unroll
  for (int group = 0; group < 5; ++group) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x0 += x1;
      x1 = rotl32(x1, kRot[4 * (group % 2) + i]) ^ x0;
    }
    x0 += ks[(group + 1) % 3];
    x1 += ks[(group + 2) % 3] + static_cast<uint32_t>(group + 1);
  }
  return make_uint2(x0, x1);
}

// Element i of a draw under (k0, k1): the counter's high and low words.
__device__ __forceinline__ uint2 threefry_at(uint32_t k0, uint32_t k1, uint64_t i) {
  return threefry2x32(k0, k1, static_cast<uint32_t>(i >> 32), static_cast<uint32_t>(i));
}
