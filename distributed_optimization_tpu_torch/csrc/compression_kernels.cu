// Error-feedback gossip compression for Hopper (sm_90a), with a plain C interface.
//
// No Pallas kernel stands behind it: it is the counterpart of the XLA code
// that distributed_optimization_tpu/ops/compression.py compiles to, the
// estimate update of one compressed exchange (ErrorFeedbackGossip.exchange,
// :176-189) with the top_k, random_k and qsgd operators (:59-123), on the JAX
// package's random stream:
//
//   memory' = memory + Q(v - memory)          v, memory, memory' all [N, d]
//
// The plain version is distributed_optimization_tpu_torch/ops/compression.py
// (ef_compress_plain), which the kernel equals bit for bit.
//
// Randomness (random_k, qsgd): the host passes the two words of
// fold_in(key(seed), 0xC0C0) and the exchange's round; t comes from the
// run's int64 counter in device memory, so one captured CUDA graph serves
// every iteration. The kernel derives
//   step key  = fold_in(tag key, t mod 2^32), then fold_in(., round) if round != 0
//   element (r, c) draws threefry2x32(step key, (0, r * d + c)) (threefry.cuh):
//   float32 keeps the top 23 bits of x0 ^ x1, float64 the top 52 of x0 << 32 | x1,
//   as the mantissa m of the uniform u = m * 2^-nmant.
//
// Operators, per row:
// - top_k / random_k: keep the k largest scores, ties to the lower column
//   (jax.lax.top_k's order; the twin's stable descending sort). The scores
//   are |v - memory| for top_k, compared by their bits (non-negative floats
//   order as their bits; NaN above +inf, as the sort puts it), and m for
//   random_k (u's order, ties where the draws tie). Then
//   memory' = memory + diff * mask, a multiply, as the JAX code masks.
// - qsgd with s = 2^bits: ||diff|| summed in a fixed order, lane j of warp 0
//   adding the squares of columns j, j + 32, ... in turn, then a butterfly
//   over the 32 lanes (lane j adds lane j ^ o, o = 16 ... 1), then the
//   correctly rounded square root: the order of ops/compression.py's
//   row_norm. level = |diff| / scale * s (scale = the norm, 1 on a zero
//   row), low = floor(level), q = (low + (u < level - low)) / s, and
//   memory' = memory + ((omega * norm) * sign(diff)) * q, sign as
//   (diff > 0) - (diff < 0), omega rounded to the run's type.
// Every operation is the _rn intrinsic of its IEEE operation (built with
// --fmad=false), so every bit that reaches the mask or a rounding decision
// is the twin's, and so is every output bit.
//
// Bound: at the main path's N=256, d=81 in float32, reading v and memory and
// writing memory' is 248,832 bytes, 0.0743 us at 3.35 TB/s; the draws are
// N * d + 2 Threefry calls and the selection d * ceil(log2 k) compares a
// row, below the bytes on the INT32 lanes for random_k at k <= 27. A launch
// is latency: the load of t, two dependent Threefry calls for the step key,
// one for the element, a barrier and the rank loop.
//
// Design (simple and correct first; making it fast is later work): one
// block a row, a thread a column (up to 1,024 threads, 4 columns a thread
// up to d = 4,096). top_k / random_k: each thread writes its columns'
// scores into shared memory; after a barrier it counts, for each of its
// columns, the row's scores above its own (ties: lower columns) and stops
// as soon as the count reaches k; k >= d keeps every column without a
// count. qsgd: warp 0 sums the row's squares in the order above and puts
// the norm in shared memory; after a barrier every thread quantizes its
// columns.
//
// Each launch of ef_compress_* adds one to slot 0 of launch_counts.cuh
// (compress_exchange, the order of KERNELS in ops/compression_kernels.py);
// ef_levels_*, an entry point for the tests that also writes each element's
// mask bit (top_k, random_k) or level low + (u < p_up) (qsgd), counts
// nothing. The kernels allocate nothing, launch on the caller's stream and
// return cudaGetLastError(); d above 4,096, N * d of 2^32 or more, an
// unknown operator or k outside its range returns cudaErrorInvalidValue.

#include <cuda_runtime.h>

#include <cstdint>

#include "launch_counts.cuh"
#include "threefry.cuh"

namespace {

constexpr int kSlotCompress = 0;
constexpr int kNoSlot = -1;
constexpr int kMaxThreads = 1024;
constexpr int kColumnsPerThread = 4;
constexpr int64_t kMaxD = int64_t{kMaxThreads} * kColumnsPerThread;  // 4,096
constexpr int kLanes = 32;

enum Mode : int { kTopK = 0, kRandK = 1, kQsgd = 2 };

template <typename Real>
struct Ops;

template <>
struct Ops<float> {
  using Key = uint32_t;
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
  static __device__ __forceinline__ float sqrt(float a) { return __fsqrt_rn(a); }
  static __device__ __forceinline__ float of(double a) { return __double2float_rn(a); }
  static __device__ __forceinline__ Key magnitude(float a) { return __float_as_uint(fabsf(a)); }
  // The mantissa uniform keeps, and u itself.
  static __device__ __forceinline__ Key mantissa(uint2 w) { return (w.x ^ w.y) >> 9; }
  static __device__ __forceinline__ float uniform(Key m) {
    return __uint_as_float(m | 0x3F800000u) - 1.0f;
  }
};

template <>
struct Ops<double> {
  using Key = uint64_t;
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double div(double a, double b) { return __ddiv_rn(a, b); }
  static __device__ __forceinline__ double sqrt(double a) { return __dsqrt_rn(a); }
  static __device__ __forceinline__ double of(double a) { return a; }
  static __device__ __forceinline__ Key magnitude(double a) {
    return static_cast<Key>(__double_as_longlong(fabs(a)));
  }
  static __device__ __forceinline__ Key mantissa(uint2 w) {
    return ((static_cast<uint64_t>(w.x) << 32) | w.y) >> 12;
  }
  static __device__ __forceinline__ double uniform(Key m) {
    return __longlong_as_double(static_cast<long long>(m | 0x3FF0000000000000ull)) - 1.0;
  }
};

template <typename Real>
struct Args {
  const Real* v;
  const Real* memory;
  Real* out;
  int32_t* levels;  // ef_levels_* only; null on the run's path
  int d;
  int k;            // coordinates kept, or qsgd's bits
  const int64_t* t;
  uint32_t k0, k1, round;
  double omega;
  int slot;
};

template <typename Real>
__device__ __forceinline__ uint2 step_key(const Args<Real>& a) {
  const uint32_t tt = static_cast<uint32_t>(*a.t);  // t mod 2^32
  uint2 key = threefry2x32(a.k0, a.k1, 0u, tt);
  if (a.round != 0u) key = threefry2x32(key.x, key.y, 0u, a.round);
  return key;
}

// top_k and random_k: the row's scores in shared memory, a rank by counting.
template <typename Real, Mode kMode>
__global__ void __launch_bounds__(kMaxThreads) select_kernel(Args<Real> a) {
  if (a.slot >= 0) launch_counts::add(a.slot);
  using O = Ops<Real>;
  using Key = typename O::Key;
  extern __shared__ __align__(16) unsigned char shared_bytes[];
  Key* scores = reinterpret_cast<Key*>(shared_bytes);
  const int d = a.d;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * d;
  uint2 key = make_uint2(0u, 0u);
  if (kMode == kRandK) key = step_key(a);
  Real diff[kColumnsPerThread];
  Real mem[kColumnsPerThread];
#pragma unroll
  for (int i = 0; i < kColumnsPerThread; ++i) {
    const int c = threadIdx.x + i * blockDim.x;
    if (c < d) {
      mem[i] = a.memory[base + c];
      diff[i] = O::sub(a.v[base + c], mem[i]);
      if (kMode == kTopK) {
        scores[c] = O::magnitude(diff[i]);
      } else {
        const uint32_t counter = static_cast<uint32_t>(base + c);
        scores[c] = O::mantissa(threefry2x32(key.x, key.y, 0u, counter));
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kColumnsPerThread; ++i) {
    const int c = threadIdx.x + i * blockDim.x;
    if (c >= d) continue;
    bool keep = true;
    if (a.k < d) {
      const Key own = scores[c];
      int rank = 0;
      for (int j = 0; j < d && rank < a.k; ++j) {
        const Key other = scores[j];
        rank += (other > own) | ((other == own) & (j < c));
      }
      keep = rank < a.k;
    }
    a.out[base + c] = O::add(mem[i], O::mul(diff[i], keep ? Real(1) : Real(0)));
    if (a.levels != nullptr) a.levels[base + c] = keep ? 1 : 0;
  }
}

// qsgd: warp 0 takes the row norm in the twin's order, then each thread
// quantizes its columns.
template <typename Real>
__global__ void __launch_bounds__(kMaxThreads) qsgd_kernel(Args<Real> a) {
  if (a.slot >= 0) launch_counts::add(a.slot);
  using O = Ops<Real>;
  __shared__ Real norm_shared;
  const int d = a.d;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * d;
  const uint2 key = step_key(a);
  if (threadIdx.x < kLanes) {
    Real acc = Real(0);
    for (int c = threadIdx.x; c < d; c += kLanes) {
      const Real x = O::sub(a.v[base + c], a.memory[base + c]);
      acc = O::add(acc, O::mul(x, x));
    }
#pragma unroll
    for (int offset = kLanes / 2; offset > 0; offset /= 2) {
      acc = O::add(acc, __shfl_xor_sync(0xFFFFFFFFu, acc, offset));
    }
    if (threadIdx.x == 0) norm_shared = O::sqrt(acc);
  }
  __syncthreads();
  const Real norm = norm_shared;
  const Real scale = norm > Real(0) ? norm : Real(1);
  const Real s = static_cast<Real>(1u << a.k);
  const Real weight = O::mul(O::of(a.omega), norm);
#pragma unroll
  for (int i = 0; i < kColumnsPerThread; ++i) {
    const int c = threadIdx.x + i * blockDim.x;
    if (c >= d) continue;
    const Real mem = a.memory[base + c];
    const Real diff = O::sub(a.v[base + c], mem);
    const Real level = O::mul(O::div(fabs(diff), scale), s);
    const Real low = floor(level);
    const uint32_t counter = static_cast<uint32_t>(base + c);
    const Real u = O::uniform(O::mantissa(threefry2x32(key.x, key.y, 0u, counter)));
    const Real up = u < O::sub(level, low) ? Real(1) : Real(0);
    const Real lev = O::add(low, up);
    const Real sign = static_cast<Real>(static_cast<int>(diff > Real(0)) -
                                        static_cast<int>(diff < Real(0)));
    const Real q = O::mul(O::mul(weight, sign), O::div(lev, s));
    a.out[base + c] = O::add(mem, q);
    if (a.levels != nullptr) a.levels[base + c] = static_cast<int32_t>(lev);
  }
}

template <typename Real>
int launch(const void* v, const void* memory, void* out, void* levels, int64_t n, int64_t d,
           int64_t mode, int64_t k, const void* t, uint32_t k0, uint32_t k1, uint32_t round,
           double omega, int slot, void* stream) {
  if (n <= 0 || d <= 0) return static_cast<int>(cudaSuccess);
  if (d > kMaxD || n > 0x7FFFFFFF || n * d >= (int64_t{1} << 32)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool selects = mode == kTopK || mode == kRandK;
  if ((selects && (k < 1 || k > d)) || (mode == kQsgd && (k < 1 || k > 16)) ||
      (!selects && mode != kQsgd) || (mode != kTopK && t == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args<Real> a = {};
  a.v = static_cast<const Real*>(v);
  a.memory = static_cast<const Real*>(memory);
  a.out = static_cast<Real*>(out);
  a.levels = static_cast<int32_t*>(levels);
  a.d = static_cast<int>(d);
  a.k = static_cast<int>(k);
  a.t = static_cast<const int64_t*>(t);
  a.k0 = k0;
  a.k1 = k1;
  a.round = round;
  a.omega = omega;
  a.slot = slot;
  // A thread a column up to 1,024 columns; past that 1,024 threads, each
  // taking up to kColumnsPerThread.
  const int threads = static_cast<int>(d < kMaxThreads ? (d + kLanes - 1) / kLanes * kLanes
                                                       : kMaxThreads);
  const dim3 grid(static_cast<unsigned>(n));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using Key = typename Ops<Real>::Key;
  const size_t shared = static_cast<size_t>(d) * sizeof(Key);
  if (mode == kTopK) {
    select_kernel<Real, kTopK><<<grid, threads, shared, s>>>(a);
  } else if (mode == kRandK) {
    select_kernel<Real, kRandK><<<grid, threads, shared, s>>>(a);
  } else {
    qsgd_kernel<Real><<<grid, threads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int ef_compress_f32(const void* v, const void* memory, void* out, int64_t n, int64_t d,
                    int64_t mode, int64_t k, const void* t, uint32_t k0, uint32_t k1,
                    uint32_t round, double omega, void* stream) {
  return launch<float>(v, memory, out, nullptr, n, d, mode, k, t, k0, k1, round, omega,
                       kSlotCompress, stream);
}
int ef_compress_f64(const void* v, const void* memory, void* out, int64_t n, int64_t d,
                    int64_t mode, int64_t k, const void* t, uint32_t k0, uint32_t k1,
                    uint32_t round, double omega, void* stream) {
  return launch<double>(v, memory, out, nullptr, n, d, mode, k, t, k0, k1, round, omega,
                        kSlotCompress, stream);
}
// For the tests and chip_smoke.py: the same update, and each element's mask
// bit or qsgd level into levels ([N, d] int32); counts no launch.
int ef_levels_f32(const void* v, const void* memory, void* out, void* levels, int64_t n,
                  int64_t d, int64_t mode, int64_t k, const void* t, uint32_t k0, uint32_t k1,
                  uint32_t round, double omega, void* stream) {
  return launch<float>(v, memory, out, levels, n, d, mode, k, t, k0, k1, round, omega, kNoSlot,
                       stream);
}
int ef_levels_f64(const void* v, const void* memory, void* out, void* levels, int64_t n,
                  int64_t d, int64_t mode, int64_t k, const void* t, uint32_t k0, uint32_t k1,
                  uint32_t round, double omega, void* stream) {
  return launch<double>(v, memory, out, levels, n, d, mode, k, t, k0, k1, round, omega, kNoSlot,
                        stream);
}

}  // extern "C"
