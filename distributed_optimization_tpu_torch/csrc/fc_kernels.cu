// Fully-connected gossip kernels for Hopper (sm_90a), with a plain C interface.
//
// Replaces the Pallas TPU kernels of distributed_optimization_tpu/ops/
// pallas_kernels.py:
//   fc_mix           <- fc_mix (:172, body _fc_mix_kernel :119)
//       out[i, :] = (sum_k x[k, :]) / N           (W x, W = 11^T / N)
//   fc_neighbor_sum  <- fc_neighbor_sum (:183, body _fc_neighbor_sum_kernel :132)
//       out[i, :] = (sum_k x[k, :]) - x[i, :]     (A x, A = 11^T - I)
// on a row-major [N, d] array.
//
// Bound: memory. Each reads x once and writes out once, 2·N·d elements for
// about 2 operations each. At the reference study's N=25, d=81 in float32
// that is 16,200 bytes, so the launch sets the time; at N=4096, d=1024 it
// is 33.5 MB, 10 us at 3.35 TB/s.
//
// Design: one block per strip of 32 columns, 32 x 8 threads. Thread (c, r)
// sums rows r, r+8, ... of its column into a register; the 8 partial sums
// of a column are added in row-group order from shared memory, and the
// block then writes its strip of every row (the second read of x for the
// neighbour sum mostly hits L2). The column sum has a fixed order here but
// not the plain version's, so the two agree to N·eps·max|x|, not bitwise.
// Every operation is a round-to-nearest intrinsic (no FMA contraction).

#include <cuda_runtime.h>
#include <cstdint>

namespace {

template <typename T> struct Rn;

template <> struct Rn<float> {
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
};

template <> struct Rn<double> {
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ double div(double a, double b) { return __ddiv_rn(a, b); }
};

constexpr int kCols = 32;
constexpr int kRowGroups = 8;

// kMean: out = sum / N (fc_mix); otherwise out = sum - x (fc_neighbor_sum).
template <typename T, bool kMean>
__global__ void fc_kernel(const T* __restrict__ x, T* __restrict__ out, int64_t n, int64_t d) {
  __shared__ T partial[kRowGroups][kCols];
  __shared__ T total[kCols];
  const int c = threadIdx.x;
  const int r = threadIdx.y;
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kCols + c;
  T s = T(0);
  if (j < d) {
    for (int64_t i = r; i < n; i += kRowGroups) s = Rn<T>::add(s, x[i * d + j]);
  }
  partial[r][c] = s;
  __syncthreads();
  if (r == 0) {
    T t = partial[0][c];
    for (int k = 1; k < kRowGroups; ++k) t = Rn<T>::add(t, partial[k][c]);
    total[c] = t;
  }
  __syncthreads();
  if (j >= d) return;
  const T col = total[c];
  const T rows = static_cast<T>(n);
  for (int64_t i = r; i < n; i += kRowGroups) {
    out[i * d + j] = kMean ? Rn<T>::div(col, rows) : Rn<T>::sub(col, x[i * d + j]);
  }
}

template <typename T, bool kMean>
int launch(const void* x, void* out, int64_t n, int64_t d, void* stream) {
  if (n * d > 0) {
    const dim3 block(kCols, kRowGroups);
    const unsigned grid = static_cast<unsigned>((d + kCols - 1) / kCols);
    fc_kernel<T, kMean><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x), static_cast<T*>(out), n, d);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int fc_mix_f32(const void* x, void* out, int64_t n, int64_t d, void* stream) {
  return launch<float, true>(x, out, n, d, stream);
}
int fc_mix_f64(const void* x, void* out, int64_t n, int64_t d, void* stream) {
  return launch<double, true>(x, out, n, d, stream);
}
int fc_neighbor_sum_f32(const void* x, void* out, int64_t n, int64_t d, void* stream) {
  return launch<float, false>(x, out, n, d, stream);
}
int fc_neighbor_sum_f64(const void* x, void* out, int64_t n, int64_t d, void* stream) {
  return launch<double, false>(x, out, n, d, stream);
}

}  // extern "C"
