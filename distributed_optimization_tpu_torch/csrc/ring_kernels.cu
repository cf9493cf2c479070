// Ring gossip kernels for Hopper (sm_90a), with a plain C interface.
//
// Replaces the Pallas TPU kernels of distributed_optimization_tpu/ops/
// pallas_kernels.py:
//   fused_ring_dsgd_step  <- fused_ring_dsgd_step (:143)
//       out = (x + roll(x,+1) + roll(x,-1)) * THIRD - eta * g
//   ring_mix              <- ring_mix (:137)
//       out = (x + roll(x,+1) + roll(x,-1)) * THIRD
//   ring_neighbor_sum     <- ring_neighbor_sum (:177)
//       out = roll(x,+1) + roll(x,-1)
// on a row-major [N, d] array, N >= 3, where roll(x,+1)[i] = x[i-1].
//
// Bound: memory. The fused step reads x and g once and writes out once:
// 3·N·d elements for 4 floating-point operations each. At the main path's
// N=256, d=81 in float32 that is 248,832 bytes, 0.074 us at 3.35 TB/s, so
// at this shape the launch itself sets the time, not the bandwidth.
//
// Design: one thread per element of the flattened array; the neighbouring
// rows are (i - 1 + N) % N and (i + 1) % N, whose reads hit the same cache
// lines as the neighbouring threads' own rows. The kernels allocate
// nothing, launch on the caller's stream and return cudaGetLastError().
//
// Rounding: every operation uses the round-to-nearest intrinsics, in the
// order of the plain PyTorch version ((x_i + x_{i-1}) + x_{i+1}) * THIRD,
// then - eta * g as a separate multiply and subtract. nvcc would otherwise
// contract the last two into one FMA, which rounds differently. With the
// intrinsics the kernels are bitwise equal to the plain version.
// THIRD is 1/3 rounded once to the working type. eta is read from a
// one-element device array in the working type (no host synchronisation).

#include <cuda_runtime.h>
#include <cstdint>

namespace {

template <typename T> struct Rn;

template <> struct Rn<float> {
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float third() { return static_cast<float>(1.0 / 3.0); }
};

template <> struct Rn<double> {
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double third() { return 1.0 / 3.0; }
};

constexpr int kThreads = 256;

struct RingIndex {
  int64_t self, prev, next;
};

__device__ __forceinline__ bool ring_index(int64_t n, int64_t d, RingIndex* r) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= n * d) return false;
  const int64_t i = e / d;
  const int64_t j = e - i * d;
  r->self = e;
  r->prev = ((i - 1 + n) % n) * d + j;
  r->next = ((i + 1) % n) * d + j;
  return true;
}

template <typename T>
__global__ void fused_ring_dsgd_step_kernel(const T* __restrict__ x, const T* __restrict__ g,
                                            const T* __restrict__ eta, T* __restrict__ out,
                                            int64_t n, int64_t d) {
  RingIndex r;
  if (!ring_index(n, d, &r)) return;
  const T mixed = Rn<T>::mul(Rn<T>::add(Rn<T>::add(x[r.self], x[r.prev]), x[r.next]), Rn<T>::third());
  out[r.self] = Rn<T>::sub(mixed, Rn<T>::mul(eta[0], g[r.self]));
}

template <typename T>
__global__ void ring_mix_kernel(const T* __restrict__ x, T* __restrict__ out, int64_t n, int64_t d) {
  RingIndex r;
  if (!ring_index(n, d, &r)) return;
  out[r.self] = Rn<T>::mul(Rn<T>::add(Rn<T>::add(x[r.self], x[r.prev]), x[r.next]), Rn<T>::third());
}

template <typename T>
__global__ void ring_neighbor_sum_kernel(const T* __restrict__ x, T* __restrict__ out, int64_t n,
                                         int64_t d) {
  RingIndex r;
  if (!ring_index(n, d, &r)) return;
  out[r.self] = Rn<T>::add(x[r.prev], x[r.next]);
}

inline unsigned blocks_for(int64_t n, int64_t d) {
  return static_cast<unsigned>((n * d + kThreads - 1) / kThreads);
}

template <typename T>
int launch_fused(const void* x, const void* g, const void* eta, void* out, int64_t n, int64_t d,
                 void* stream) {
  if (n * d > 0) {
    fused_ring_dsgd_step_kernel<T><<<blocks_for(n, d), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x), static_cast<const T*>(g), static_cast<const T*>(eta),
        static_cast<T*>(out), n, d);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_mix(const void* x, void* out, int64_t n, int64_t d, void* stream) {
  if (n * d > 0) {
    ring_mix_kernel<T><<<blocks_for(n, d), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x), static_cast<T*>(out), n, d);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_neighbor_sum(const void* x, void* out, int64_t n, int64_t d, void* stream) {
  if (n * d > 0) {
    ring_neighbor_sum_kernel<T><<<blocks_for(n, d), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x), static_cast<T*>(out), n, d);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int fused_ring_dsgd_step_f32(const void* x, const void* g, const void* eta, void* out, int64_t n,
                             int64_t d, void* stream) {
  return launch_fused<float>(x, g, eta, out, n, d, stream);
}
int fused_ring_dsgd_step_f64(const void* x, const void* g, const void* eta, void* out, int64_t n,
                             int64_t d, void* stream) {
  return launch_fused<double>(x, g, eta, out, n, d, stream);
}
int ring_mix_f32(const void* x, void* out, int64_t n, int64_t d, void* stream) {
  return launch_mix<float>(x, out, n, d, stream);
}
int ring_mix_f64(const void* x, void* out, int64_t n, int64_t d, void* stream) {
  return launch_mix<double>(x, out, n, d, stream);
}
int ring_neighbor_sum_f32(const void* x, void* out, int64_t n, int64_t d, void* stream) {
  return launch_neighbor_sum<float>(x, out, n, d, stream);
}
int ring_neighbor_sum_f64(const void* x, void* out, int64_t n, int64_t d, void* stream) {
  return launch_neighbor_sum<double>(x, out, n, d, stream);
}

}  // extern "C"
