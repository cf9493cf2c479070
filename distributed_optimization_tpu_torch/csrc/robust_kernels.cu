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
// Count rules (trimmed_mean, median): a block holds a few rows and a strip
// of up to 128 columns, one thread per element (i, j). The row's slots are
// read once into shared memory (a dead slot as index -1), and one thread a
// row turns its degree into the selection once: the kept positions
// [b, stop) and the divisor for trimmed_mean (:277-286), the picked
// positions lo and hi for median (:289-298), from counts, upper, kept, lo
// and hi computed as floats in the working type, as the Pallas body does.
// Each element then holds its k_max + 1 values (a dead slot is +inf) in a
// register array of compile-time width W = k_max + 1 <= 16 and sorts them
// by Batcher's odd-even merge network generated for W at compile time (63
// compare-exchanges at W = 16 against the 120 of the transposition network
// of _sort_columns :227), by fminf/fmaxf in float32 and by one compare and
// two selects in float64 (where fmin and fmax each expand to a run of
// compares and selects for their NaN rules). A column that holds a NaN
// (one OR over its W values) instead runs the transposition network with
// NaN-propagating min/max, as the plain version does. Without a NaN every
// correct network gives the same sorted values, up to the places of +0 and
// -0; both selections start from +0 and add in slot order, so they never
// give -0 and the output bits do not depend on those places. For the same
// reason trimmed_mean adds only the kept positions: adding the +0 of a
// dropped one to a sum that is never -0 changes nothing.
//
// clipped_gossip, one warp per row, eight rows a block, for k_max <= 32:
// lane s holds slot s, and the kernel is instantiated for slot counts KB =
// 2, 4, 8, 16, 32 (the smallest power of two >= k_max), so that each lane
// keeps one register a slot. The realized degree of i is a sum of the
// lanes' live values in slot order, lane s sums its neighbour's live row
// for deg_nbr, and one pass of the lanes over d sums every slot's squared
// neighbour difference, which a reduce-scatter across the lanes (KB - 1
// shuffles, then one a remaining butterfly) leaves one slot a lane. The
// adaptive radius, the (deg - b)-th smallest live norm
// (_kernel_adaptive_clip_tau :248), is the norm whose stable rank across
// the lanes is that position: no sort and no block barrier. When a live norm is NaN, lane 0 runs the transposition
// network over the warp's norms instead, so the radius is the plain
// version's. A fixed radius is read from tau. Then out[i, j] = x[i, j] +
// sum_s (w_s * diff_sj) * factor_s in slot order, w_s = live / (1 +
// max(deg_i, deg_nbr)), factor_s = min(1, tau / max(norm_s, tiny))
// (:300-313). Fixed-radius tables wider than a warp (k_max up to 1,116)
// take one block a row with the slots in shared memory.
//
// Rounding: every operation is a round-to-nearest intrinsic in the order of
// the plain PyTorch version (ops/robust_kernels.py), so no FMA contraction;
// the D-SGD variant rounds eta * g and the subtraction separately. So the
// count rules are bitwise equal to the plain version; clipping's norm is a
// reduction over d in another order, so there the two agree to a tolerance.
//
// bfloat16 (fused_robust_bf16): the rows are stored in bfloat16 and the
// screen runs in float32, as _fused_robust_body does (promote(float32,
// bfloat16) is float32): every load widens to float32, the sort network,
// the trimmed sum and divisor, the median's 0.5 * (lo + hi), the clipping
// norms, radius, weights and factors are the float32 instance's operations,
// and tau is float32. The aggregate is rounded once to bfloat16; the D-SGD
// form then computes bf16(agg) - bf16(eta * g) with eta bfloat16, each
// operation in float32 and rounded to bfloat16 at once, as the Pallas
// kernel's agg.astype(dtype) - eta_ref[0] * g_ref[:] rounds (and as
// ring_kernels.cu's Rn<__nv_bfloat16>). Where a row allows it (d % 8 == 0
// and x, g and out 16-byte aligned), a thread moves 8 elements a 16-byte
// access: the count rules take 8 columns a thread (sort width <= 8), and
// warp clipping 8 consecutive columns a lane; otherwise one element an
// access. The float32 and float64 instances take one element an access.
//
// Bound: memory for the count rules on a ring (x, g and out once, nbr and
// live once: at N=256, d=41, k_max=2 in float32 about 130 KB, 0.04 us); the
// sort network's 2 * (compare-exchanges) operations per element bound them
// at k_max = 15, and the neighbour reads bound clipping there. The kernels
// allocate nothing, launch on the caller's stream and return
// cudaGetLastError(). eta and tau are one-element device arrays (no host
// synchronisation). Each launch adds one to its form's slot of
// launch_counts.cuh: slot 0 the aggregator (g null), 1 the D-SGD step (the
// order of KERNELS in ops/robust_kernels.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>
#include <cfloat>
#include <cstring>
#include <type_traits>
#include <utility>

#include "launch_counts.cuh"

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
  // Ascending compare-exchange of two values that are not NaN.
  static __device__ __forceinline__ void order(float& a, float& b) {
    const float lo = fminf(a, b);
    b = fmaxf(a, b);
    a = lo;
  }
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
  // One compare and selects: fmin and fmax on doubles each expand to a run
  // of compares and selects for their NaN and signed-zero rules, which a
  // column without NaN does not need. Equal values may leave swapped; the
  // multiset stays.
  static __device__ __forceinline__ void order(double& a, double& b) {
    const bool swap = b < a;
    const double lo = swap ? b : a;
    b = swap ? a : b;
    a = lo;
  }
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

// The stored element type S and the working type T the screen runs in:
// promote(float32, S), so S itself for float and double, and float for
// bfloat16. load widens an element, store rounds a working value to S, and
// step is the D-SGD form's agg - eta * g, each operation rounded as the
// plain version rounds it.
template <typename S> struct Storage {
  using T = S;
  static __device__ __forceinline__ T load(S a) { return a; }
  static __device__ __forceinline__ S store(T a) { return a; }
  static __device__ __forceinline__ S step(T agg, S eta, S g) {
    return Num<T>::sub(agg, Num<T>::mul(eta, g));
  }
};

template <> struct Storage<__nv_bfloat16> {
  using S = __nv_bfloat16;
  using T = float;
  static __device__ __forceinline__ T load(S a) { return __bfloat162float(a); }
  static __device__ __forceinline__ S store(T a) { return __float2bfloat16_rn(a); }
  // bf16(agg) - bf16(eta * g): the product of two bfloat16 values is exact
  // in float32, so each operation rounds once.
  static __device__ __forceinline__ S step(T agg, S eta, S g) {
    const float prod = __bfloat162float(__float2bfloat16_rn(__fmul_rn(load(eta), load(g))));
    return __float2bfloat16_rn(__fsub_rn(load(store(agg)), prod));
  }
};

// V consecutive elements at p as working values, and back: one 16-byte
// access when V * sizeof(S) == 16 (p then 16-byte aligned), else V loads.
template <typename S, int V>
__device__ __forceinline__ void load_vec(const S* p, typename Storage<S>::T* out) {
  if constexpr (V * sizeof(S) == 16) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    S e[V];
    memcpy(e, &raw, sizeof(raw));
#pragma unroll
    for (int q = 0; q < V; ++q) out[q] = Storage<S>::load(e[q]);
  } else {
#pragma unroll
    for (int q = 0; q < V; ++q) out[q] = Storage<S>::load(p[q]);
  }
}

template <typename S, int V>
__device__ __forceinline__ void store_vec(S* p, const S* in) {
  if constexpr (V * sizeof(S) == 16) {
    uint4 raw;
    memcpy(&raw, in, sizeof(raw));
    *reinterpret_cast<uint4*>(p) = raw;
  } else {
#pragma unroll
    for (int q = 0; q < V; ++q) p[q] = in[q];
  }
}

// The aggregate of V columns written as S: itself, or with g the D-SGD
// step agg - eta * g.
template <typename S, int V>
__device__ __forceinline__ void write_out(S* out, const S* g, const S* eta,
                                          const typename Storage<S>::T* agg) {
  S res[V];
  if (g == nullptr) {
#pragma unroll
    for (int q = 0; q < V; ++q) res[q] = Storage<S>::store(agg[q]);
  } else {
    S gv[V];
    if constexpr (V * sizeof(S) == 16) {
      const uint4 raw = *reinterpret_cast<const uint4*>(g);
      memcpy(gv, &raw, sizeof(raw));
    } else {
#pragma unroll
      for (int q = 0; q < V; ++q) gv[q] = g[q];
    }
    const S e = eta[0];
#pragma unroll
    for (int q = 0; q < V; ++q) res[q] = Storage<S>::step(agg[q], e, gv[q]);
  }
  store_vec<S, V>(out, res);
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

// Batcher's odd-even merge sort network for width w as a list of
// compare-exchanges (lo[c], hi[c]), generated at compile time; at most 63
// for w <= 16. ops/robust_kernels.py::merge_network is its Python mirror.
struct Network {
  int lo[64];
  int hi[64];
  int size;
};

constexpr Network merge_network(int w) {
  Network net{};
  for (int p = 1; p < w; p <<= 1) {
    for (int k = p; k >= 1; k >>= 1) {
      for (int j = k % p; j + k < w; j += 2 * k) {
        for (int i = 0; i < k && i + j + k < w; ++i) {
          if ((i + j) / (2 * p) == (i + j + k) / (2 * p)) {
            net.lo[net.size] = i + j;
            net.hi[net.size] = i + j + k;
            ++net.size;
          }
        }
      }
    }
  }
  return net;
}

template <int W>
constexpr Network kMerge = merge_network(W);

template <int A, int B, typename T>
__device__ __forceinline__ void exchange(T* v) {
  Num<T>::order(v[A], v[B]);
}

template <int W, typename T, int... C>
__device__ __forceinline__ void merge_sort(T* v, std::integer_sequence<int, C...>) {
  (exchange<kMerge<W>.lo[C], kMerge<W>.hi[C]>(v), ...);
}

enum Rule { kTrimmedMean = 0, kMedian = 1 };

// A count-rule block is 128 threads: a strip of 32 to 128 columns times
// 128 / strip rows, so at most this many rows.
constexpr int kCountRows = 4;

// V columns a thread (V = 8 for 16-byte bfloat16 accesses, else 1); the
// block's x extent counts V-column units.
template <typename S, int W, int V>
__global__ void count_rule_kernel(int rule, int budget, const int32_t* __restrict__ nbr,
                                  const float* __restrict__ live, const S* __restrict__ x,
                                  const S* __restrict__ g, const S* __restrict__ eta,
                                  S* __restrict__ out, int64_t n, int64_t d) {
  launch_counts::add(g == nullptr ? 0 : 1);
  using T = typename Storage<S>::T;
  constexpr int K = W - 1;
  __shared__ int32_t s_nbr[kCountRows][K];
  __shared__ T s_live[kCountRows][K];
  __shared__ int s_pos[kCountRows][2];  // trimmed_mean: stop, kept >= 1; median: lo, hi
  __shared__ T s_den[kCountRows];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.y + ty;
  const bool in_rows = i < n;

  const int64_t j = (static_cast<int64_t>(blockIdx.y) * blockDim.x + tx) * V;
  const bool in_cols = in_rows && j < d;
  const int64_t e = i * d + j;
  if (in_rows && tx < K) {
    // Both loads at once: a load of nbr under the test of live would wait
    // for live.
    const float lf = live[i * K + tx];
    const int32_t nb = nbr[i * K + tx];
    s_live[ty][tx] = static_cast<T>(lf);
    s_nbr[ty][tx] = lf > 0.0f ? nb : -1;
  }
  T self[V];
  if (in_cols) {
    load_vec<S, V>(x + e, self);
  } else {
#pragma unroll
    for (int q = 0; q < V; ++q) self[q] = T(0);
  }
  __syncthreads();
  // Every element's neighbour loads are in flight while one thread a row
  // turns its degree into the selection.
  T v[V][W];
#pragma unroll
  for (int q = 0; q < V; ++q) v[q][0] = self[q];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    const int32_t nb = s_nbr[ty][s];
    T col[V];
    if (in_cols && nb >= 0) {
      load_vec<S, V>(x + static_cast<int64_t>(nb) * d + j, col);
    } else {
#pragma unroll
      for (int q = 0; q < V; ++q) col[q] = Num<T>::inf();
    }
#pragma unroll
    for (int q = 0; q < V; ++q) v[q][s + 1] = col[q];
  }
  if (in_rows && tx == 0) {
    T deg = T(0);
#pragma unroll
    for (int s = 0; s < K; ++s) deg = Num<T>::add(deg, s_live[ty][s]);
    const T counts = Num<T>::add(deg, T(1));
    if (rule == kTrimmedMean) {
      const T upper = Num<T>::sub(counts, T(budget));
      const T kept = vmax(Num<T>::sub(counts, T(2 * budget)), T(0));
      int stop = 0;  // T(s) < upper exactly for s < stop
#pragma unroll
      for (int s = 0; s < W; ++s) stop = T(s) < upper ? s + 1 : stop;
      s_pos[ty][0] = stop;
      s_pos[ty][1] = kept >= T(1);
      s_den[ty] = vmax(kept, T(1));
    } else {
      const T lo = vmax(Num<T>::floor(Num<T>::div(Num<T>::sub(counts, T(1)), T(2))), T(0));
      const T hi = vmax(Num<T>::floor(Num<T>::div(counts, T(2))), T(0));
      int lo_at = -1, hi_at = -1;  // -1: no position picked, the pick is +0
#pragma unroll
      for (int s = 0; s < W; ++s) {
        lo_at = T(s) == lo ? s : lo_at;
        hi_at = T(s) == hi ? s : hi_at;
      }
      s_pos[ty][0] = lo_at;
      s_pos[ty][1] = hi_at;
    }
  }
  __syncthreads();
  if (!in_cols) return;

  T agg[V];
#pragma unroll
  for (int q = 0; q < V; ++q) {
    T* c = v[q];
    bool has_nan = false;
#pragma unroll
    for (int s = 0; s < W; ++s) has_nan |= c[s] != c[s];
    if (has_nan) {
#pragma unroll
      for (int p = 0; p < W; ++p) {
#pragma unroll
        for (int a = p & 1; a < W - 1; a += 2) {
          const T lo = vmin(c[a], c[a + 1]);
          const T hi = vmax(c[a], c[a + 1]);
          c[a] = lo;
          c[a + 1] = hi;
        }
      }
    } else {
      merge_sort<W>(c, std::make_integer_sequence<int, kMerge<W>.size>{});
    }

    if (rule == kTrimmedMean) {
      const int stop = s_pos[ty][0];
      T total = T(0);
#pragma unroll
      for (int s = 0; s < W; ++s) {
        if (s >= budget && s < stop) total = Num<T>::add(total, c[s]);
      }
      agg[q] = s_pos[ty][1] ? Num<T>::div(total, s_den[ty]) : self[q];
    } else {
      const int lo_at = s_pos[ty][0];
      const int hi_at = s_pos[ty][1];
      T pick_lo = T(0), pick_hi = T(0);
#pragma unroll
      for (int s = 0; s < W; ++s) {
        pick_lo = s == lo_at ? c[s] : pick_lo;
        pick_hi = s == hi_at ? c[s] : pick_hi;
      }
      // +0 + pick: the one-hot sum of the plain version, which turns -0 into +0.
      agg[q] = Num<T>::mul(T(0.5), Num<T>::add(Num<T>::add(T(0), pick_lo),
                                              Num<T>::add(T(0), pick_hi)));
    }
  }
  write_out<S, V>(out + e, g == nullptr ? nullptr : g + e, eta, agg);
}

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kClipWarps = 8;  // rows of a clipping block, one warp each
constexpr int kWarpSlots = 32;

// KB values a lane, KB a power of two <= 32: the sum of value s over the
// warp's lanes, reduced by halving (each step sends the half the partner
// keeps), then by plain butterflies; ends in lane s << (5 - log2 KB).
template <int KB, typename T>
__device__ __forceinline__ T reduce_scatter(T* v, int lane) {
  int c = KB;
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) {
    if (c > 1) {
      c >>= 1;
      const bool upper = lane & o;
#pragma unroll
      for (int q = 0; q < KB / 2; ++q) {
        if (q < c) {
          const T keep = upper ? v[q + c] : v[q];
          const T send = upper ? v[q] : v[q + c];
          v[q] = Num<T>::add(keep, __shfl_xor_sync(kFullMask, send, o));
        }
      }
    } else {
      v[0] = Num<T>::add(v[0], __shfl_xor_sync(kFullMask, v[0], o));
    }
  }
  return v[0];
}

template <int KB> struct Log2 { static constexpr int value = 1 + Log2<KB / 2>::value; };
template <> struct Log2<1> { static constexpr int value = 0; };

// k_max <= KB: the slots sit in registers, unrolled over KB. A lane past
// k_max stands for a padded slot that points at i, with live 0 and factor
// 1: its norm is never read, and it adds exact zeros to deg and to moved,
// whose sums start at +0 and so are never -0. A lane takes V consecutive
// columns an access (V = 8 for 16-byte bfloat16 accesses, else 1).
template <typename S, int KB, int V>
__global__ void clip_warp_kernel(int budget, int adaptive, int k_max,
                                 const int32_t* __restrict__ nbr, const float* __restrict__ live,
                                 const S* __restrict__ x,
                                 const typename Storage<S>::T* __restrict__ tau_in,
                                 const S* __restrict__ g, const S* __restrict__ eta,
                                 S* __restrict__ out, int64_t n, int64_t d) {
  launch_counts::add(g == nullptr ? 0 : 1);
  using T = typename Storage<S>::T;
  __shared__ T s_rank[kClipWarps][kWarpSlots];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kClipWarps + warp;
  if (i >= n) return;  // the whole warp: nothing below waits on the block
  const bool slot = lane < k_max;
  const int32_t nb = slot ? nbr[i * k_max + lane] : static_cast<int32_t>(i);
  const T lv = slot ? static_cast<T>(live[i * k_max + lane]) : T(0);
  const int dd = static_cast<int>(d);  // the host keeps d below 2^31
  const S* xi = x + i * d;
  const S* xs[KB];
#pragma unroll
  for (int s = 0; s < KB; ++s) xs[s] = x + static_cast<int64_t>(__shfl_sync(kFullMask, nb, s)) * d;

  // The realized degree of i, in slot order, and that of slot s's neighbour.
  T deg = T(0);
#pragma unroll
  for (int s = 0; s < KB; ++s) deg = Num<T>::add(deg, __shfl_sync(kFullMask, lv, s));
  T deg_nbr = T(0);
  if (slot) {
    const float* lj = live + static_cast<int64_t>(nb) * k_max;
#pragma unroll
    for (int u = 0; u < KB; ++u) {
      if (u < k_max) deg_nbr = Num<T>::add(deg_nbr, static_cast<T>(lj[u]));
    }
  }

  // Squared neighbour differences, every slot in one pass over d; lane s
  // ends with the norm of slot s.
  T part[KB];
#pragma unroll
  for (int s = 0; s < KB; ++s) part[s] = T(0);
  for (int j = lane * V; j < dd; j += 32 * V) {
    T xij[V];
    load_vec<S, V>(xi + j, xij);
#pragma unroll
    for (int s = 0; s < KB; ++s) {
      T xsj[V];
      load_vec<S, V>(xs[s] + j, xsj);
#pragma unroll
      for (int q = 0; q < V; ++q) {
        const T diff = Num<T>::sub(xsj[q], xij[q]);
        part[s] = Num<T>::add(part[s], Num<T>::mul(diff, diff));
      }
    }
  }
  const T sq = reduce_scatter<KB>(part, lane);
  const T norm = Num<T>::sqrt(__shfl_sync(kFullMask, sq, (lane & (KB - 1)) << (5 - Log2<KB>::value)));

  T tau;
  if (adaptive) {
    const T val = slot && lv > T(0) ? norm : Num<T>::inf();
    const T k = vmin(vmax(Num<T>::sub(Num<T>::sub(deg, T(budget)), T(1)), T(0)), T(k_max - 1));
    T kth = T(0);
    if (__any_sync(kFullMask, slot && val != val)) {
      s_rank[warp][lane] = val;
      __syncwarp();
      if (lane == 0) {
        sort_network(s_rank[warp], k_max);
        for (int s = 0; s < k_max; ++s) kth = Num<T>::add(kth, T(s) == k ? s_rank[warp][s] : T(0));
      }
      kth = __shfl_sync(kFullMask, kth, 0);
    } else {
      // Stable rank: the sorted position of this lane's norm.
      int rank = 0;
#pragma unroll
      for (int t = 0; t < KB; ++t) {  // a lane past k_max holds +inf after every slot
        const T other = __shfl_sync(kFullMask, val, t);
        rank += other < val || (other == val && t < lane);
      }
      const unsigned hit = __ballot_sync(kFullMask, slot && T(rank) == k);
      const T picked = __shfl_sync(kFullMask, val, hit ? __ffs(hit) - 1 : 0);
      kth = hit ? picked : T(0);
    }
    tau = Num<T>::sub(deg, T(budget)) >= T(1) ? kth : T(0);
  } else {
    tau = tau_in[0];
  }

  const T w_mine = Num<T>::div(lv, Num<T>::add(T(1), vmax(deg, deg_nbr)));
  const T fac_mine = slot ? vmin(T(1), Num<T>::div(tau, vmax(norm, Num<T>::tiny()))) : T(1);
  T w[KB], fac[KB];
#pragma unroll
  for (int s = 0; s < KB; ++s) {
    w[s] = __shfl_sync(kFullMask, w_mine, s);
    fac[s] = __shfl_sync(kFullMask, fac_mine, s);
  }
  S* oi = out + i * d;
  const S* gi = g == nullptr ? nullptr : g + i * d;
  for (int j = lane * V; j < dd; j += 32 * V) {
    T xij[V], moved[V];
    load_vec<S, V>(xi + j, xij);
#pragma unroll
    for (int q = 0; q < V; ++q) moved[q] = T(0);
#pragma unroll
    for (int s = 0; s < KB; ++s) {
      T xsj[V];
      load_vec<S, V>(xs[s] + j, xsj);
#pragma unroll
      for (int q = 0; q < V; ++q) {
        const T diff = Num<T>::sub(xsj[q], xij[q]);
        moved[q] = Num<T>::add(moved[q], Num<T>::mul(Num<T>::mul(w[s], diff), fac[s]));
      }
    }
    T agg[V];
#pragma unroll
    for (int q = 0; q < V; ++q) agg[q] = Num<T>::add(xij[q], moved[q]);
    write_out<S, V>(oi + j, gi == nullptr ? nullptr : gi + j, eta, agg);
  }
}

// Shared memory of the wide clipping kernel: four [k_max] arrays of T, then
// the [k_max] neighbour indices.
template <typename T>
size_t clip_smem_bytes(int k_max) {
  return static_cast<size_t>(k_max) * (4 * sizeof(T) + sizeof(int32_t));
}

constexpr int kThreads = 256;

// Fixed-radius clipping for k_max > 32: one block a row, each warp taking
// slots s = warp, warp + 8, ... for the norms; one element an access.
template <typename S>
__global__ void clip_wide_kernel(int k_max, const int32_t* __restrict__ nbr,
                                 const float* __restrict__ live, const S* __restrict__ x,
                                 const typename Storage<S>::T* __restrict__ tau_in,
                                 const S* __restrict__ g, const S* __restrict__ eta,
                                 S* __restrict__ out, int64_t n, int64_t d) {
  launch_counts::add(g == nullptr ? 0 : 1);
  using T = typename Storage<S>::T;
  using St = Storage<S>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_lv = reinterpret_cast<T*>(smem);
  T* s_norm = s_lv + k_max;
  T* s_w = s_norm + k_max;
  T* s_fac = s_w + k_max;
  int32_t* s_nbr = reinterpret_cast<int32_t*>(s_fac + k_max);

  const int64_t i = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const S* xi = x + i * d;

  for (int s = tid; s < k_max; s += blockDim.x) {
    s_nbr[s] = nbr[i * k_max + s];
    s_lv[s] = static_cast<T>(live[i * k_max + s]);
  }
  __syncthreads();

  for (int s = warp; s < k_max; s += n_warps) {
    const S* xs = x + static_cast<int64_t>(s_nbr[s]) * d;
    T sq = T(0);
    for (int64_t j = lane; j < d; j += 32) {
      const T diff = Num<T>::sub(St::load(xs[j]), St::load(xi[j]));
      sq = Num<T>::add(sq, Num<T>::mul(diff, diff));
    }
    for (int off = 16; off > 0; off >>= 1) sq = Num<T>::add(sq, __shfl_xor_sync(kFullMask, sq, off));
    if (lane == 0) s_norm[s] = Num<T>::sqrt(sq);
  }
  __syncthreads();

  T deg = T(0);
  for (int s = 0; s < k_max; ++s) deg = Num<T>::add(deg, s_lv[s]);
  const T tau = tau_in[0];
  for (int s = tid; s < k_max; s += blockDim.x) {
    const float* lj = live + static_cast<int64_t>(s_nbr[s]) * k_max;
    T deg_nbr = T(0);
    for (int u = 0; u < k_max; ++u) deg_nbr = Num<T>::add(deg_nbr, static_cast<T>(lj[u]));
    s_w[s] = Num<T>::div(s_lv[s], Num<T>::add(T(1), vmax(deg, deg_nbr)));
    s_fac[s] = vmin(T(1), Num<T>::div(tau, vmax(s_norm[s], Num<T>::tiny())));
  }
  __syncthreads();

  for (int64_t j = tid; j < d; j += blockDim.x) {
    const T xij = St::load(xi[j]);
    T moved = T(0);
    for (int s = 0; s < k_max; ++s) {
      const T diff = Num<T>::sub(St::load(x[static_cast<int64_t>(s_nbr[s]) * d + j]), xij);
      moved = Num<T>::add(moved, Num<T>::mul(Num<T>::mul(s_w[s], diff), s_fac[s]));
    }
    const T agg = Num<T>::add(xij, moved);
    out[i * d + j] = g == nullptr ? St::store(agg) : St::step(agg, eta[0], g[i * d + j]);
  }
}

// 8 bfloat16 elements a 16-byte access where every row and pointer allows
// it; else one.
template <typename S>
bool vectorized(const void* x, const void* g, const void* out, int64_t d) {
  if constexpr (!std::is_same_v<S, __nv_bfloat16>) {
    return false;
  } else {
    auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; };
    return d % 8 == 0 && aligned(x) && aligned(out) && (g == nullptr || aligned(g));
  }
}

template <typename S, int W, int V>
int launch_count(int rule, int budget, const int32_t* nbr, const float* live, const S* x,
                 const S* g, const S* eta, S* out, int64_t n, int64_t d, cudaStream_t stream) {
  // Strips of at most 128 units of V columns, as even as d allows, rounded
  // up to whole warps; the rest of 128 threads take further rows.
  const int64_t units = d / V;
  const int64_t strips = (units + 127) / 128;
  if (strips > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int cols = static_cast<int>((units + strips - 1) / strips);
  const int tx = (cols + 31) / 32 * 32;
  const int ty = 128 / tx;
  const dim3 block(tx, ty);
  const dim3 grid(static_cast<unsigned>((n + ty - 1) / ty), static_cast<unsigned>(strips));
  count_rule_kernel<S, W, V><<<grid, block, 0, stream>>>(rule, budget, nbr, live, x, g, eta, out,
                                                          n, d);
  return static_cast<int>(cudaSuccess);
}

// The count rules' instance for sort width W: 8 columns a thread for
// vectorized bfloat16 rows up to W = 8 (64 working values a thread), else 1.
template <typename S, int W>
int launch_count(int rule, int budget, const int32_t* nbr, const float* live, const S* x,
                 const S* g, const S* eta, S* out, int64_t n, int64_t d, cudaStream_t stream) {
  if constexpr (std::is_same_v<S, __nv_bfloat16> && W <= 8) {
    if (vectorized<S>(x, g, out, d)) {
      return launch_count<S, W, 8>(rule, budget, nbr, live, x, g, eta, out, n, d, stream);
    }
  }
  return launch_count<S, W, 1>(rule, budget, nbr, live, x, g, eta, out, n, d, stream);
}

template <typename S>
int fused_robust(int rule, int budget, int adaptive, int k_max, const void* nbr_v,
                 const void* live_v, const void* x_v, const void* tau_v, const void* g_v,
                 const void* eta_v, void* out_v, int64_t n, int64_t d, void* stream_v) {
  using T = typename Storage<S>::T;
  const auto* nbr = static_cast<const int32_t*>(nbr_v);
  const auto* live = static_cast<const float*>(live_v);
  const auto* x = static_cast<const S*>(x_v);
  const auto* tau = static_cast<const T*>(tau_v);
  const auto* g = static_cast<const S*>(g_v);
  const auto* eta = static_cast<const S*>(eta_v);
  auto* out = static_cast<S*>(out_v);
  auto stream = static_cast<cudaStream_t>(stream_v);
  if (n * d <= 0) return static_cast<int>(cudaGetLastError());
  if (rule == kTrimmedMean || rule == kMedian) {
    int err;
    switch (k_max + 1) {
#define ROBUST_WIDTH(W) \
  case W: err = launch_count<S, W>(rule, budget, nbr, live, x, g, eta, out, n, d, stream); break;
      ROBUST_WIDTH(2) ROBUST_WIDTH(3) ROBUST_WIDTH(4) ROBUST_WIDTH(5) ROBUST_WIDTH(6)
      ROBUST_WIDTH(7) ROBUST_WIDTH(8) ROBUST_WIDTH(9) ROBUST_WIDTH(10) ROBUST_WIDTH(11)
      ROBUST_WIDTH(12) ROBUST_WIDTH(13) ROBUST_WIDTH(14) ROBUST_WIDTH(15) ROBUST_WIDTH(16)
#undef ROBUST_WIDTH
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
    if (err != 0) return err;
  } else if (k_max <= kWarpSlots) {
    if (d >= (int64_t{1} << 31)) return static_cast<int>(cudaErrorInvalidValue);
    const unsigned blocks = static_cast<unsigned>((n + kClipWarps - 1) / kClipWarps);
    const bool vec = vectorized<S>(x, g, out, d);
#define CLIP_SLOTS(KB)                                                                      \
  do {                                                                                      \
    if (vec) {                                                                              \
      clip_warp_kernel<S, KB, 8><<<blocks, kClipWarps * 32, 0, stream>>>(                  \
          budget, adaptive, k_max, nbr, live, x, tau, g, eta, out, n, d);                   \
    } else {                                                                                \
      clip_warp_kernel<S, KB, 1><<<blocks, kClipWarps * 32, 0, stream>>>(                  \
          budget, adaptive, k_max, nbr, live, x, tau, g, eta, out, n, d);                   \
    }                                                                                       \
  } while (0)
    if (k_max <= 2) CLIP_SLOTS(2);
    else if (k_max <= 4) CLIP_SLOTS(4);
    else if (k_max <= 8) CLIP_SLOTS(8);
    else if (k_max <= 16) CLIP_SLOTS(16);
    else CLIP_SLOTS(32);
#undef CLIP_SLOTS
  } else {
    // Only a fixed radius is taken this wide; the wrapper keeps smem within
    // the 48 KiB default.
    if (adaptive) return static_cast<int>(cudaErrorInvalidValue);
    clip_wide_kernel<S><<<static_cast<unsigned>(n), kThreads, clip_smem_bytes<T>(k_max), stream>>>(
        k_max, nbr, live, x, tau, g, eta, out, n, d);
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
// tau is float32 (the working type); x, g, eta and out bfloat16.
int fused_robust_bf16(int rule, int budget, int adaptive, int k_max, const void* nbr,
                      const void* live, const void* x, const void* tau, const void* g,
                      const void* eta, void* out, int64_t n, int64_t d, void* stream) {
  return fused_robust<__nv_bfloat16>(rule, budget, adaptive, k_max, nbr, live, x, tau, g, eta,
                                     out, n, d, stream);
}

}  // extern "C"
