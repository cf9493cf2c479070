// Fused robust gossip kernels for Hopper (sm_90a), with a plain C interface.
//
// Replaces the Pallas TPU kernels of distributed_optimization_tpu/ops/
// pallas_kernels.py:
//   make_fused_robust_aggregator  <- make_fused_robust_aggregator (:410)
//       out = screen(x)                    (_make_fused_robust :316, with_sgd=False)
//   make_fused_robust_dsgd_step   <- make_fused_robust_dsgd_step (:430)
//       out = screen(x) - eta * g          (_make_fused_robust :316, with_sgd=True)
// where screen is _fused_robust_body (:263) over the closed neighbourhood of
// each row i: x[i] and the rows x[nbr[i, s]] whose slot is live
// (live[i, s] > 0), for s < k_max. x, g and out are row-major [N, d]; nbr is
// [N, k_max] int32 (padded slots point at i); live is [N, k_max] float32.
// Math runs in the working type (promote(float32, T) is T for both types).
//
// Count rules (trimmed_mean, median), one thread per element (i, j): the
// k_max + 1 values of the closed neighbourhood (a dead slot is +inf) sit in
// a register array of compile-time width W = k_max + 1 <= 16 and go through
// the odd-even transposition network of _sort_columns (:227): W passes of
// compare-exchanges. trimmed_mean sums the sorted positions [b, count - b)
// in slot order and divides by max(kept, 1), or keeps x[i] when kept < 1
// (:277-286); median is 0.5 * (s[lo] + s[hi]) with lo = floor((c-1)/2),
// hi = floor(c/2) as float one-hot picks (:289-298). Counts, positions, lo
// and hi are floats in the working type, as in the Pallas body.
//
// clipped_gossip, one block per row i: each warp takes slots s = warp,
// warp + 8, ... and reduces the squared neighbour difference over d with
// shuffles; the realized degrees are row sums of live gathered through nbr;
// the adaptive radius ranks the masked norms by the same network and picks
// the (deg - b)-th smallest (_kernel_adaptive_clip_tau :248), a fixed one
// is read from tau; then out[i, j] = x[i, j] + sum_s (w_s * diff_sj) *
// factor_s in slot order, w_s = live / (1 + max(deg_i, deg_nbr)), factor_s =
// min(1, tau / max(norm_s, tiny)) (:300-313).
//
// Rounding: every operation is a round-to-nearest intrinsic in the order of
// the plain PyTorch version (ops/robust_kernels.py), so no FMA contraction;
// the D-SGD variant rounds eta * g and the subtraction separately. min and
// max return NaN when either operand is NaN, else fmin/fmax, which is what
// torch.minimum and torch.maximum compute on the card. So the count rules
// are bitwise equal to the plain version; clipping's norm is a reduction
// over d in another order, so there the two agree to a tolerance.
//
// Bound: memory for the count rules on a ring (x, g and out once, nbr and
// live once: at N=256, d=41, k_max=2 in float32 about 130 KB, 0.04 us); the
// sort network's 2 * (compare-exchanges) operations per element bound it at
// k_max = 15 in float64. The kernels allocate nothing, launch on the
// caller's stream and return cudaGetLastError(). eta and tau are one-element
// device arrays (no host synchronisation).

#include <cuda_runtime.h>
#include <cstdint>
#include <cfloat>

namespace {

template <typename T> struct Num;

template <> struct Num<float> {
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
  static __device__ __forceinline__ float sqrt(float a) { return __fsqrt_rn(a); }
  static __device__ __forceinline__ float floor(float a) { return floorf(a); }
  static __device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }
  static __device__ __forceinline__ float nan() { return __int_as_float(0x7fc00000); }
  static __device__ __forceinline__ float tiny() { return FLT_MIN; }
  static __device__ __forceinline__ float fmin(float a, float b) { return fminf(a, b); }
  static __device__ __forceinline__ float fmax(float a, float b) { return fmaxf(a, b); }
};

template <> struct Num<double> {
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double div(double a, double b) { return __ddiv_rn(a, b); }
  static __device__ __forceinline__ double sqrt(double a) { return __dsqrt_rn(a); }
  static __device__ __forceinline__ double floor(double a) { return ::floor(a); }
  static __device__ __forceinline__ double inf() { return __longlong_as_double(0x7ff0000000000000LL); }
  static __device__ __forceinline__ double nan() { return __longlong_as_double(0x7ff8000000000000LL); }
  static __device__ __forceinline__ double tiny() { return DBL_MIN; }
  static __device__ __forceinline__ double fmin(double a, double b) { return ::fmin(a, b); }
  static __device__ __forceinline__ double fmax(double a, double b) { return ::fmax(a, b); }
};

// torch.minimum / torch.maximum on the card: NaN if either operand is NaN.
template <typename T>
__device__ __forceinline__ T vmin(T a, T b) {
  return (a != a || b != b) ? Num<T>::nan() : Num<T>::fmin(a, b);
}
template <typename T>
__device__ __forceinline__ T vmax(T a, T b) {
  return (a != a || b != b) ? Num<T>::nan() : Num<T>::fmax(a, b);
}

// The odd-even transposition network of _sort_columns over v[0..width).
template <typename T>
__device__ __forceinline__ void sort_network(T* v, int width) {
  for (int p = 0; p < width; ++p) {
    for (int a = p & 1; a < width - 1; a += 2) {
      const T lo = vmin(v[a], v[a + 1]);
      const T hi = vmax(v[a], v[a + 1]);
      v[a] = lo;
      v[a + 1] = hi;
    }
  }
}

enum Rule { kTrimmedMean = 0, kMedian = 1 };

constexpr int kThreads = 256;

template <typename T, int W>
__global__ void count_rule_kernel(int rule, int budget, const int32_t* __restrict__ nbr,
                                  const float* __restrict__ live, const T* __restrict__ x,
                                  const T* __restrict__ g, const T* __restrict__ eta,
                                  T* __restrict__ out, int64_t n, int64_t d) {
  constexpr int K = W - 1;
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= n * d) return;
  const int64_t i = e / d;
  const int64_t j = e - i * d;
  const T self = x[e];
  T v[W];
  v[0] = self;
  T deg = T(0);
#pragma unroll
  for (int s = 0; s < K; ++s) {
    const T lv = static_cast<T>(live[i * K + s]);
    deg = Num<T>::add(deg, lv);
    v[s + 1] = lv > T(0) ? x[static_cast<int64_t>(nbr[i * K + s]) * d + j] : Num<T>::inf();
  }
#pragma unroll
  for (int p = 0; p < W; ++p) {
#pragma unroll
    for (int a = p & 1; a < W - 1; a += 2) {
      const T lo = vmin(v[a], v[a + 1]);
      const T hi = vmax(v[a], v[a + 1]);
      v[a] = lo;
      v[a + 1] = hi;
    }
  }
  const T counts = Num<T>::add(deg, T(1));
  T agg;
  if (rule == kTrimmedMean) {
    const T upper = Num<T>::sub(counts, T(budget));
    const T kept = vmax(Num<T>::sub(counts, T(2 * budget)), T(0));
    T total = T(0);
#pragma unroll
    for (int s = 0; s < W; ++s) {
      const bool keep = T(s) >= T(budget) && T(s) < upper;
      total = Num<T>::add(total, keep ? v[s] : T(0));
    }
    const T mean = Num<T>::div(total, vmax(kept, T(1)));
    agg = kept >= T(1) ? mean : self;
  } else {
    const T lo = vmax(Num<T>::floor(Num<T>::div(Num<T>::sub(counts, T(1)), T(2))), T(0));
    const T hi = vmax(Num<T>::floor(Num<T>::div(counts, T(2))), T(0));
    T pick_lo = T(0), pick_hi = T(0);
#pragma unroll
    for (int s = 0; s < W; ++s) {
      pick_lo = Num<T>::add(pick_lo, T(s) == lo ? v[s] : T(0));
      pick_hi = Num<T>::add(pick_hi, T(s) == hi ? v[s] : T(0));
    }
    agg = Num<T>::mul(T(0.5), Num<T>::add(pick_lo, pick_hi));
  }
  out[e] = g == nullptr ? agg : Num<T>::sub(agg, Num<T>::mul(eta[0], g[e]));
}

// Shared memory of the clipping kernel: five [k_max] arrays of T, then the
// [k_max] neighbour indices.
template <typename T>
size_t clip_smem_bytes(int k_max) {
  return static_cast<size_t>(k_max) * (5 * sizeof(T) + sizeof(int32_t));
}

template <typename T>
__global__ void clip_kernel(int budget, int adaptive, int k_max, const int32_t* __restrict__ nbr,
                            const float* __restrict__ live, const T* __restrict__ x,
                            const T* __restrict__ tau_in, const T* __restrict__ g,
                            const T* __restrict__ eta, T* __restrict__ out, int64_t n,
                            int64_t d) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_lv = reinterpret_cast<T*>(smem);
  T* s_norm = s_lv + k_max;
  T* s_w = s_norm + k_max;
  T* s_fac = s_w + k_max;
  T* s_rank = s_fac + k_max;
  int32_t* s_nbr = reinterpret_cast<int32_t*>(s_rank + k_max);
  __shared__ T s_tau;

  const int64_t i = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const T* xi = x + i * d;

  for (int s = tid; s < k_max; s += blockDim.x) {
    s_nbr[s] = nbr[i * k_max + s];
    s_lv[s] = static_cast<T>(live[i * k_max + s]);
  }
  __syncthreads();

  // Neighbour-difference norms, one warp per slot.
  for (int s = warp; s < k_max; s += n_warps) {
    const T* xs = x + static_cast<int64_t>(s_nbr[s]) * d;
    T sq = T(0);
    for (int64_t j = lane; j < d; j += 32) {
      const T diff = Num<T>::sub(xs[j], xi[j]);
      sq = Num<T>::add(sq, Num<T>::mul(diff, diff));
    }
    for (int off = 16; off > 0; off >>= 1) sq = Num<T>::add(sq, __shfl_xor_sync(0xffffffffu, sq, off));
    if (lane == 0) s_norm[s] = Num<T>::sqrt(sq);
  }
  __syncthreads();

  // The realized degree of i: a row sum of live, in slot order.
  T deg = T(0);
  for (int s = 0; s < k_max; ++s) deg = Num<T>::add(deg, s_lv[s]);

  if (tid == 0) {
    if (adaptive) {
      for (int s = 0; s < k_max; ++s) s_rank[s] = s_lv[s] > T(0) ? s_norm[s] : Num<T>::inf();
      sort_network(s_rank, k_max);
      const T k = vmin(vmax(Num<T>::sub(Num<T>::sub(deg, T(budget)), T(1)), T(0)), T(k_max - 1));
      T kth = T(0);
      for (int s = 0; s < k_max; ++s) kth = Num<T>::add(kth, T(s) == k ? s_rank[s] : T(0));
      s_tau = Num<T>::sub(deg, T(budget)) >= T(1) ? kth : T(0);
    } else {
      s_tau = tau_in[0];
    }
  }
  __syncthreads();

  for (int s = tid; s < k_max; s += blockDim.x) {
    const float* lj = live + static_cast<int64_t>(s_nbr[s]) * k_max;
    T deg_j = T(0);
    for (int u = 0; u < k_max; ++u) deg_j = Num<T>::add(deg_j, static_cast<T>(lj[u]));
    s_w[s] = Num<T>::div(s_lv[s], Num<T>::add(T(1), vmax(deg, deg_j)));
    s_fac[s] = vmin(T(1), Num<T>::div(s_tau, vmax(s_norm[s], Num<T>::tiny())));
  }
  __syncthreads();

  for (int64_t j = tid; j < d; j += blockDim.x) {
    const T xij = xi[j];
    T moved = T(0);
    for (int s = 0; s < k_max; ++s) {
      const T diff = Num<T>::sub(x[static_cast<int64_t>(s_nbr[s]) * d + j], xij);
      moved = Num<T>::add(moved, Num<T>::mul(Num<T>::mul(s_w[s], diff), s_fac[s]));
    }
    const T agg = Num<T>::add(xij, moved);
    out[i * d + j] = g == nullptr ? agg : Num<T>::sub(agg, Num<T>::mul(eta[0], g[i * d + j]));
  }
}

template <typename T, int W>
void launch_count(int rule, int budget, const int32_t* nbr, const float* live, const T* x,
                  const T* g, const T* eta, T* out, int64_t n, int64_t d, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((n * d + kThreads - 1) / kThreads);
  count_rule_kernel<T, W><<<blocks, kThreads, 0, stream>>>(rule, budget, nbr, live, x, g, eta, out, n, d);
}

template <typename T>
int fused_robust(int rule, int budget, int adaptive, int k_max, const void* nbr_v,
                 const void* live_v, const void* x_v, const void* tau_v, const void* g_v,
                 const void* eta_v, void* out_v, int64_t n, int64_t d, void* stream_v) {
  const auto* nbr = static_cast<const int32_t*>(nbr_v);
  const auto* live = static_cast<const float*>(live_v);
  const auto* x = static_cast<const T*>(x_v);
  const auto* tau = static_cast<const T*>(tau_v);
  const auto* g = static_cast<const T*>(g_v);
  const auto* eta = static_cast<const T*>(eta_v);
  auto* out = static_cast<T*>(out_v);
  auto stream = static_cast<cudaStream_t>(stream_v);
  if (n * d <= 0) return static_cast<int>(cudaGetLastError());
  if (rule == kTrimmedMean || rule == kMedian) {
    switch (k_max + 1) {
#define ROBUST_WIDTH(W) \
  case W: launch_count<T, W>(rule, budget, nbr, live, x, g, eta, out, n, d, stream); break;
      ROBUST_WIDTH(2) ROBUST_WIDTH(3) ROBUST_WIDTH(4) ROBUST_WIDTH(5) ROBUST_WIDTH(6)
      ROBUST_WIDTH(7) ROBUST_WIDTH(8) ROBUST_WIDTH(9) ROBUST_WIDTH(10) ROBUST_WIDTH(11)
      ROBUST_WIDTH(12) ROBUST_WIDTH(13) ROBUST_WIDTH(14) ROBUST_WIDTH(15) ROBUST_WIDTH(16)
#undef ROBUST_WIDTH
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  } else {
    // The wrapper keeps smem within the 48 KiB default.
    const size_t smem = clip_smem_bytes<T>(k_max);
    clip_kernel<T><<<static_cast<unsigned>(n), kThreads, smem, stream>>>(
        budget, adaptive, k_max, nbr, live, x, tau, g, eta, out, n, d);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// rule: 0 trimmed_mean, 1 median, 2 clipped_gossip. g and eta are null for
// the aggregator; tau is read only by fixed-radius clipping.
int fused_robust_f32(int rule, int budget, int adaptive, int k_max, const void* nbr,
                     const void* live, const void* x, const void* tau, const void* g,
                     const void* eta, void* out, int64_t n, int64_t d, void* stream) {
  return fused_robust<float>(rule, budget, adaptive, k_max, nbr, live, x, tau, g, eta, out, n, d,
                             stream);
}
int fused_robust_f64(int rule, int budget, int adaptive, int k_max, const void* nbr,
                     const void* live, const void* x, const void* tau, const void* g,
                     const void* eta, void* out, int64_t n, int64_t d, void* stream) {
  return fused_robust<double>(rule, budget, adaptive, k_max, nbr, live, x, tau, g, eta, out, n, d,
                              stream);
}

}  // extern "C"
