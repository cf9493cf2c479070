// Per-worker mini-batch sampling for Hopper (sm_90a), with a plain C interface.
//
// No Pallas kernel stands behind this one: it is the counterpart of the XLA
// code that distributed_optimization_tpu/ops/sampling.py compiles to,
// sample_worker_batch_weights (the dense form) and sample_worker_batches
// (the gather form), on the JAX package's random stream. The plain version
// is distributed_optimization_tpu_torch/ops/sampling.py (on the twin of
// jax.random in ops/prng.py); the kernels equal it bit for bit.
//
// One launch draws every worker's batch for one gradient call:
//   step key   = threefry2x32(slot key, (0, t mod 2^32))   t read from device memory
//   worker key = threefry2x32(step key, (0, worker))
//   row score  = threefry2x32(worker key, (0, row))        uniform's bits
// then ranks each worker's rows by score, stable descending (ties to the
// lower row), and writes
//   sample_weights:  w[N, L] = 1/b_eff on the rows of rank < b_eff, else 0;
//   sample_indices:  idx[N, b] = the rows of rank 0 .. min(b, L) - 1, tiled
//                    up to b, and w[N, b] = 1/b_eff on the first b_eff;
// with b_eff = min(b, n_valid, L).
//
// Bound: operations. A Threefry call is 20 rounds of add, rotate, xor and 5
// key injections, about 75 integer operations; the rank compares each row
// with every row of its worker, about 3 operations a pair. At the main
// path's N=256, L=49 that is 256 * (2 * 75 + 49 * 75 + 49 * 49 * 3), 2.8
// million operations, against 50 KB written. Both are far below what one
// launch costs, so the launch sets the time.
//
// Design:
// - One block a worker; its threads take rows l, l + blockDim, ... Each
//   thread derives the step and worker keys itself (two Threefry calls, no
//   barrier for them). t comes from the int64 counter on the device that
//   the run loop advances in place, never from a launch argument, so one
//   captured CUDA graph serves every iteration; the slot key is two host
//   words.
// - The rank runs on the integer mantissa that uniform keeps, in place of
//   the float: (x0 ^ x1) >> 9 for float32 and (x0 << 32 | x1) >> 12 for
//   float64. uniform maps the mantissa m to m * 2^-nmant, strictly
//   increasing, so order and ties are the float's. The score in shared
//   memory is m + 1, and 0 on padding rows (the plain version's -inf), below
//   every valid row.
// - rank[l] = #{m : s[m] > s[l], or s[m] == s[l] and m < l}, counted from
//   shared memory by the thread of row l: O(L^2 / threads) a block, every
//   thread of a warp reading the same s[m] (a broadcast).
// - The weight is 1/max(b_eff, 1) in the run's type, rounded to float32 and
//   back (the JAX sampler returns float32 weights, which the run casts),
//   with the round-to-nearest intrinsics.
//
// Each launch adds one to its kernel's slot of launch_counts.cuh (slot 0
// sample_weights, 1 sample_indices: the order of KERNELS in
// ops/sampling_kernels.py). The kernels allocate nothing, launch on the
// caller's stream and return cudaGetLastError(); a shard too long for
// shared memory returns cudaErrorInvalidValue.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "launch_counts.cuh"

namespace {

constexpr int kSlotWeights = 0;
constexpr int kSlotIndices = 1;
constexpr int kMaxThreads = 1024;
constexpr size_t kDefaultSharedBytes = 48 * 1024;
constexpr size_t kMaxSharedBytes = 232448;  // 227 KB, the most a block takes on sm_90

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

// The mantissa uniform keeps, plus one (0 is the padding rows' score).
template <typename Real>
struct Score;

template <>
struct Score<float> {
  using type = uint32_t;
  static __device__ __forceinline__ type of(uint2 w) { return ((w.x ^ w.y) >> 9) + 1u; }
  static __device__ __forceinline__ float weight(int eff) {
    return __fdiv_rn(1.0f, static_cast<float>(eff));
  }
};

template <>
struct Score<double> {
  using type = uint64_t;
  static __device__ __forceinline__ type of(uint2 w) {
    return ((static_cast<uint64_t>(w.x) << 20) | (w.y >> 12)) + 1ull;
  }
  static __device__ __forceinline__ double weight(int eff) {
    return static_cast<double>(__double2float_rn(__ddiv_rn(1.0, static_cast<double>(eff))));
  }
};

template <typename Real, bool kIndices>
__global__ void sample_kernel(const int64_t* __restrict__ t, uint32_t k0, uint32_t k1,
                              const int64_t* __restrict__ n_valid, int L, int b,
                              Real* __restrict__ w, int64_t* __restrict__ idx) {
  launch_counts::add(kIndices ? kSlotIndices : kSlotWeights);
  using S = typename Score<Real>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  S* score = reinterpret_cast<S*>(smem);
  const int worker = blockIdx.x;
  const uint2 step = threefry2x32(k0, k1, 0u, static_cast<uint32_t>(*t));
  const uint2 key = threefry2x32(step.x, step.y, 0u, static_cast<uint32_t>(worker));
  const int64_t nv = n_valid[worker];
  for (int l = threadIdx.x; l < L; l += blockDim.x) {
    score[l] = l < nv ? Score<Real>::of(threefry2x32(key.x, key.y, 0u, static_cast<uint32_t>(l)))
                      : S(0);
  }
  __syncthreads();
  const int eff = static_cast<int>(nv < b ? (nv < L ? nv : L) : min(b, L));
  const Real inv = Score<Real>::weight(max(eff, 1));
  const int k = min(b, L);
  int* top = reinterpret_cast<int*>(score + L);
  for (int l = threadIdx.x; l < L; l += blockDim.x) {
    const S s = score[l];
    int rank = 0;
#pragma unroll 4
    for (int m = 0; m < L; ++m) {
      const S v = score[m];
      rank += (v > s) | ((v == s) & (m < l));
    }
    if (kIndices) {
      if (rank < k) top[rank] = l;
    } else {
      w[static_cast<int64_t>(worker) * L + l] = (l < nv && rank < eff) ? inv : Real(0);
    }
  }
  if (kIndices) {
    __syncthreads();
    for (int j = threadIdx.x; j < b; j += blockDim.x) {
      const int64_t at = static_cast<int64_t>(worker) * b + j;
      idx[at] = top[j % k];
      w[at] = j < eff ? inv : Real(0);
    }
  }
}

template <typename Real, bool kIndices>
int launch_sample(const void* t, uint32_t k0, uint32_t k1, const void* n_valid, int64_t n,
                  int64_t L, int64_t b, void* w, void* idx, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (L <= 0 || b <= 0 || n > 0x7FFFFFFF || L > 0x7FFFFFFF || b > 0x7FFFFFFF) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  using S = typename Score<Real>::type;
  const size_t bytes = L * sizeof(S) + (kIndices ? std::min(b, L) * sizeof(int) : 0);
  if (bytes > kMaxSharedBytes) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = sample_kernel<Real, kIndices>;
  if (bytes > kDefaultSharedBytes) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = static_cast<int>(std::min<int64_t>(kMaxThreads, (L + 31) / 32 * 32));
  kernel<<<static_cast<unsigned>(n), threads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(t), k0, k1, static_cast<const int64_t*>(n_valid),
      static_cast<int>(L), static_cast<int>(b), static_cast<Real*>(w),
      static_cast<int64_t*>(idx));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int sample_weights_f32(const void* t, uint32_t k0, uint32_t k1, const void* n_valid, int64_t n,
                       int64_t L, int64_t b, void* w, void* stream) {
  return launch_sample<float, false>(t, k0, k1, n_valid, n, L, b, w, nullptr, stream);
}
int sample_weights_f64(const void* t, uint32_t k0, uint32_t k1, const void* n_valid, int64_t n,
                       int64_t L, int64_t b, void* w, void* stream) {
  return launch_sample<double, false>(t, k0, k1, n_valid, n, L, b, w, nullptr, stream);
}
int sample_indices_f32(const void* t, uint32_t k0, uint32_t k1, const void* n_valid, int64_t n,
                       int64_t L, int64_t b, void* idx, void* w, void* stream) {
  return launch_sample<float, true>(t, k0, k1, n_valid, n, L, b, w, idx, stream);
}
int sample_indices_f64(const void* t, uint32_t k0, uint32_t k1, const void* n_valid, int64_t n,
                       int64_t L, int64_t b, void* idx, void* w, void* stream) {
  return launch_sample<double, true>(t, k0, k1, n_valid, n, L, b, w, idx, stream);
}

}  // extern "C"
