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
//   element (r, c) draws threefry2x32(step key, (hi, lo)), (hi, lo) the two
//   words of the 64-bit flat index r * d + c (threefry_at, threefry.cuh):
//   float32 keeps the top 23 bits of x0 ^ x1, float64 the top 52 of x0 << 32 | x1,
//   as the mantissa m of the uniform u = m * 2^-nmant.
//
// Operators, per row:
// - top_k / random_k: keep the k largest scores, ties to the lower column
//   (jax.lax.top_k's order; the twin's stable descending sort). The scores
//   are |v - memory| for top_k, compared by their bits (non-negative floats
//   order as their bits; every NaN as one value above +inf, as the sort puts
//   them), and m for random_k (u's order, ties where the draws tie). Then
//   memory' = memory + diff * mask, a multiply, as the JAX code masks.
// - qsgd with s = 2^bits: ||diff|| summed in a fixed order, lane j of a warp
//   adding the squares of columns j, j + 32, ... in turn, then a butterfly
//   over the 32 lanes (lane j adds lane j ^ o, o = 16 ... 1; each step adds
//   the same pair in either order, so every lane ends with the same bits),
//   then the correctly rounded square root: the order of
//   ops/compression.py's row_norm. level = |diff| / scale * s (scale = the
//   norm, 1 on a zero row), low = floor(level), q = (low + (u < level -
//   low)) / s, and memory' = memory + ((omega * norm) * sign(diff)) * q, sign
//   as (diff > 0) - (diff < 0), omega rounded to the run's type.
// Every operation is the _rn intrinsic of its IEEE operation (built with
// --fmad=false), so every bit that reaches the mask or a rounding decision
// is the twin's, and so is every output bit.
//
// Bound: at the main path's N=256, d=81 in float32, reading v and memory and
// writing memory' is 248,832 bytes, 0.0743 us at 3.35 TB/s; the draws are
// N * d + 2 Threefry calls and the selection d * ceil(log2 k) compares a
// row, 0.104 us on the INT32 lanes for random_k at k = 27. A launch is
// latency: the load of t, two dependent Threefry calls for the step key,
// one for the element, and the rank.
//
// Design: one launch an exchange, of one of three kernels.
// - warp_select_kernel (top_k, random_k, d <= kWarpMaxD): a warp a row, 4
//   rows a block, no shared memory and no barrier. Lane i holds columns i,
//   i + 32, ... in registers. Each column's key packs its score above
//   kWarpColMask - c, so keys are distinct and a strict > orders them as
//   the sort (32 bits for float32 random_k, 64 for float32 top_k and
//   float64 random_k); a float64 magnitude takes 63 bits, so its key is the
//   magnitude alone and a tie goes to the lower column. A column's rank
//   counts the warp's keys above its own, broadcast by __shfl_sync; it is
//   kept when its rank is below k. The step key's Threefry calls are issued
//   with the loads of v and memory, so their latencies overlap.
// - block_select_kernel (top_k, random_k, wider rows): a block a row and a
//   radix select (radix_select.cuh, shared with the gather sampler) over
//   keys that pack the score above d - 1 - c, left-aligned in 64 bits
//   (float32) or 128 (float64). The passes go on until the keys at or above
//   the bin of the k-th key number exactly k, so that bin's lower bound is
//   an exact threshold: keep = key >= threshold, and no order among the kept
//   columns, no survivors in shared memory and no limit on k or d. Keys are
//   held in registers, one a thread up to 1,024 columns and 4 a thread up to
//   4,096; past that each pass recomputes them (top_k rereads v and memory,
//   random_k redraws its Threefry).
// - warp_qsgd_kernel: a warp a row at every width, 4 rows a block: the
//   lanes' sums and the butterfly above, then each lane quantizes its
//   columns. Up to kWarpMaxD columns they stay in registers, and their
//   uniforms are drawn before the sum (they need only the step key); past
//   that a second pass rereads them and draws as it goes.
// k >= d keeps every column without a rank.
//
// bfloat16 (the *_bf16 entry points): v, memory and memory' are bfloat16,
// and each operation is computed in float32 and rounded to bfloat16 at
// once, as the JAX package's bfloat16 run rounds it on the CPU, except
// where that run computes in float32: random_k and qsgd draw float32
// uniforms (jax.random.uniform's default type; the warp and radix keys
// then rank float32 mantissas), so qsgd's u < p_up compares in float32;
// qsgd's norm sums the float32 squares in float32 (the order above) and
// rounds the sum once to bfloat16 before the rounded square root
// (jnp.linalg.norm's fused reduction). top_k ranks the 15 magnitude bits of
// bf16(v - memory), ties to the lower column. omega is rounded to
// bfloat16, as a weak-typed scalar.
//
// Each launch of ef_compress_* adds one to slot 0 of launch_counts.cuh
// (compress_exchange, the order of KERNELS in ops/compression_kernels.py);
// ef_levels_*, an entry point for the tests that also writes each element's
// mask bit (top_k, random_k) or level low + (u < p_up) (qsgd), counts
// nothing. The kernels allocate nothing, launch on the caller's stream and
// return cudaGetLastError(); N or d of 2^31 or more, an unknown operator or
// k outside its range returns cudaErrorInvalidValue.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "launch_counts.cuh"
#include "radix_select.cuh"
#include "threefry.cuh"

namespace {

constexpr int kSlotCompress = 0;
constexpr int kNoSlot = -1;
constexpr int kLanes = 32;
constexpr unsigned kFullMask = 0xFFFFFFFFu;
constexpr int kWarpsPerBlock = 4;  // the warp kernels: rows a block
constexpr int kWarpMaxD = 128;     // top_k / random_k: a warp a row up to this width
constexpr int kWarpColBits = 9;    // the warp path's reversed column: kWarpMaxD <= 512
constexpr int kWarpColMask = (1 << kWarpColBits) - 1;
constexpr int kMaxThreads = 1024;  // the block path: a block a row
constexpr int kHeldColumns = 4;    // keys a thread in registers, up to 4,096 columns
constexpr int kRecomputed = 0;     // past that: keys recomputed at each pass

enum Mode : int { kTopK = 0, kRandK = 1, kQsgd = 2 };

template <typename Real>
struct Ops;

template <>
struct Ops<float> {
  using WideKey = uint64_t;
  using Draw = float;  // the uniforms' type
  using Sum = float;   // qsgd's sum of squares
  static constexpr int kMagnitudeBits = 31;
  static constexpr int kMantissaBits = 23;
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
  static __device__ __forceinline__ float of(double a) { return __double2float_rn(a); }
  static __device__ __forceinline__ float abs(float a) { return fabsf(a); }
  static __device__ __forceinline__ float floor(float a) { return floorf(a); }
  static __device__ __forceinline__ bool positive(float a) { return a > 0.0f; }
  static __device__ __forceinline__ bool below(float u, float p) { return u < p; }
  static __device__ __forceinline__ float sign(float a) {
    return static_cast<float>(static_cast<int>(a > 0.0f) - static_cast<int>(a < 0.0f));
  }
  static __device__ __forceinline__ int32_t level(float a) { return static_cast<int32_t>(a); }
  static __device__ __forceinline__ float add_square(float acc, float a) { return add(acc, mul(a, a)); }
  static __device__ __forceinline__ float root(float sum) { return __fsqrt_rn(sum); }
  // |a|'s bits, every NaN as the one value just above +inf.
  static __device__ __forceinline__ uint32_t magnitude(float a) {
    return min(__float_as_uint(fabsf(a)), 0x7F800001u);
  }
  // The mantissa uniform keeps, and u itself.
  static __device__ __forceinline__ uint32_t mantissa(uint2 w) { return (w.x ^ w.y) >> 9; }
  static __device__ __forceinline__ float uniform(uint32_t m) {
    return __uint_as_float(m | 0x3F800000u) - 1.0f;
  }
};

template <>
struct Ops<double> {
  using WideKey = u128;
  using Draw = double;
  using Sum = double;
  static constexpr int kMagnitudeBits = 63;
  static constexpr int kMantissaBits = 52;
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double div(double a, double b) { return __ddiv_rn(a, b); }
  static __device__ __forceinline__ double of(double a) { return a; }
  static __device__ __forceinline__ double abs(double a) { return fabs(a); }
  static __device__ __forceinline__ double floor(double a) { return ::floor(a); }
  static __device__ __forceinline__ bool positive(double a) { return a > 0.0; }
  static __device__ __forceinline__ bool below(double u, double p) { return u < p; }
  static __device__ __forceinline__ double sign(double a) {
    return static_cast<double>(static_cast<int>(a > 0.0) - static_cast<int>(a < 0.0));
  }
  static __device__ __forceinline__ int32_t level(double a) { return static_cast<int32_t>(a); }
  static __device__ __forceinline__ double add_square(double acc, double a) { return add(acc, mul(a, a)); }
  static __device__ __forceinline__ double root(double sum) { return __dsqrt_rn(sum); }
  static __device__ __forceinline__ uint64_t magnitude(double a) {
    const uint64_t bits = static_cast<uint64_t>(__double_as_longlong(fabs(a)));
    return bits < 0x7FF0000000000001ull ? bits : 0x7FF0000000000001ull;
  }
  static __device__ __forceinline__ uint64_t mantissa(uint2 w) {
    return ((static_cast<uint64_t>(w.x) << 32) | w.y) >> 12;
  }
  static __device__ __forceinline__ double uniform(uint64_t m) {
    return __longlong_as_double(static_cast<long long>(m | 0x3FF0000000000000ull)) - 1.0;
  }
};

// bfloat16: each operation in float32, rounded to bfloat16 at once; the
// draws, uniforms and qsgd's sum are float32's.
template <>
struct Ops<__nv_bfloat16> {
  using B = __nv_bfloat16;
  using WideKey = uint64_t;
  using Draw = float;
  using Sum = float;
  static constexpr int kMagnitudeBits = 15;
  static constexpr int kMantissaBits = Ops<float>::kMantissaBits;
  static __device__ __forceinline__ float f(B a) { return __bfloat162float(a); }
  static __device__ __forceinline__ B rn(float a) { return __float2bfloat16_rn(a); }
  static __device__ __forceinline__ B add(B a, B b) { return rn(__fadd_rn(f(a), f(b))); }
  static __device__ __forceinline__ B sub(B a, B b) { return rn(__fsub_rn(f(a), f(b))); }
  static __device__ __forceinline__ B mul(B a, B b) { return rn(__fmul_rn(f(a), f(b))); }
  static __device__ __forceinline__ B div(B a, B b) { return rn(__fdiv_rn(f(a), f(b))); }
  // A double (omega, s) through float32, as PyTorch rounds a Python float
  // to bfloat16.
  static __device__ __forceinline__ B of(double a) { return rn(__double2float_rn(a)); }
  static __device__ __forceinline__ B abs(B a) { return rn(fabsf(f(a))); }
  static __device__ __forceinline__ B floor(B a) { return rn(floorf(f(a))); }
  static __device__ __forceinline__ bool positive(B a) { return f(a) > 0.0f; }
  static __device__ __forceinline__ bool below(float u, B p) { return u < f(p); }
  static __device__ __forceinline__ B sign(B a) { return rn(Ops<float>::sign(f(a))); }
  static __device__ __forceinline__ int32_t level(B a) { return static_cast<int32_t>(f(a)); }
  // The square of a bfloat16 value is exact in float32; the sum is not
  // rounded to bfloat16 until root.
  static __device__ __forceinline__ float add_square(float acc, B a) {
    return __fadd_rn(acc, __fmul_rn(f(a), f(a)));
  }
  static __device__ __forceinline__ B root(float sum) { return rn(__fsqrt_rn(f(rn(sum)))); }
  static __device__ __forceinline__ uint32_t magnitude(B a) {
    return min(static_cast<uint32_t>(__bfloat16_as_ushort(a) & 0x7FFFu), 0x7F81u);
  }
  static __device__ __forceinline__ uint32_t mantissa(uint2 w) { return Ops<float>::mantissa(w); }
  static __device__ __forceinline__ float uniform(uint32_t m) { return Ops<float>::uniform(m); }
};

// Bits of a selection score: the magnitude (top_k) or the mantissa (random_k).
template <typename Real, Mode kMode>
constexpr int kScoreBits =
    kMode == kTopK ? Ops<Real>::kMagnitudeBits : Ops<Real>::kMantissaBits;

// The warp path's key of column c: its score above kWarpColMask - c where
// they fit in 64 bits, else the score alone with the column as tie-break.
// Columns past d take key 0 (and, unpacked, a column past every valid one),
// which beats no valid column: a packed valid key is at least
// kWarpColMask - kWarpMaxD + 1 > 0.
template <typename Real, Mode kMode>
struct WarpKey {
  static constexpr int kBits = kScoreBits<Real, kMode> + kWarpColBits;
  static constexpr bool kPacked = kBits <= 64;
  using Key = std::conditional_t<kBits <= 32, uint32_t, uint64_t>;
  static __device__ __forceinline__ Key make(uint64_t score, int c) {
    if constexpr (kPacked) {
      return (static_cast<Key>(score) << kWarpColBits) | static_cast<Key>(kWarpColMask - c);
    } else {
      return static_cast<Key>(score);
    }
  }
  // Column other_c's key comes before column c's in the sort.
  static __device__ __forceinline__ bool beats(Key other, int other_c, Key mine, int c) {
    if constexpr (kPacked) {
      return other > mine;
    } else {
      return (other > mine) | ((other == mine) & (other_c < c));
    }
  }
};

static_assert(kWarpMaxD <= kWarpColMask + 1, "the warp path's columns fit kWarpColBits");

template <typename Real>
struct Args {
  const Real* v;
  const Real* memory;
  Real* out;
  int32_t* levels;  // ef_levels_* only; null on the run's path
  int64_t n;
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

// memory' of a top_k / random_k element, and its mask bit.
template <typename Real>
__device__ __forceinline__ void write_masked(const Args<Real>& a, int64_t at, Real mem, Real diff,
                                             bool keep) {
  using O = Ops<Real>;
  a.out[at] = O::add(mem, O::mul(diff, O::of(keep ? 1.0 : 0.0)));
  if (a.levels != nullptr) a.levels[at] = keep ? 1 : 0;
}

// top_k and random_k, a warp a row: J columns a lane in registers, each
// ranked by counting the warp's keys above its own.
template <typename Real, Mode kMode, int J>
__global__ void __launch_bounds__(kWarpsPerBlock * kLanes) warp_select_kernel(Args<Real> a) {
  if (a.slot >= 0) launch_counts::add(a.slot);
  using O = Ops<Real>;
  using W = WarpKey<Real, kMode>;
  using Key = typename W::Key;
  const int lane = threadIdx.x & (kLanes - 1);
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= a.n) return;
  const int d = a.d;
  const int64_t base = row * d;
  Real mem[J], diff[J];
#pragma unroll
  for (int h = 0; h < J; ++h) {
    const int c = lane + kLanes * h;
    mem[h] = c < d ? a.memory[base + c] : O::of(0.0);
    diff[h] = c < d ? O::sub(a.v[base + c], mem[h]) : O::of(0.0);
  }
  uint2 key = make_uint2(0u, 0u);
  if (kMode == kRandK) key = step_key(a);
  Key keys[J];
#pragma unroll
  for (int h = 0; h < J; ++h) {
    const int c = lane + kLanes * h;
    uint64_t score;
    if constexpr (kMode == kTopK) {
      score = O::magnitude(diff[h]);
    } else {
      score = O::mantissa(threefry_at(key.x, key.y, static_cast<uint64_t>(base + c)));
    }
    keys[h] = c < d ? W::make(score, c) : Key(0);
  }
  bool keep[J];
#pragma unroll
  for (int h = 0; h < J; ++h) keep[h] = true;
  if (a.k < d) {
    int rank[J] = {};
#pragma unroll
    for (int src = 0; src < kLanes; ++src) {
#pragma unroll
      for (int g = 0; g < J; ++g) {
        const Key other = __shfl_sync(kFullMask, keys[g], src);
#pragma unroll
        for (int h = 0; h < J; ++h) {
          rank[h] += W::beats(other, src + kLanes * g, keys[h], lane + kLanes * h);
        }
      }
    }
#pragma unroll
    for (int h = 0; h < J; ++h) keep[h] = rank[h] < a.k;
  }
#pragma unroll
  for (int h = 0; h < J; ++h) {
    const int c = lane + kLanes * h;
    if (c < d) write_masked(a, base + c, mem[h], diff[h], keep[h]);
  }
}

// top_k and random_k, a block a row: a radix select to the exact k-th key.
// R keys a thread in registers, or with R = kRecomputed each recomputed
// where it is read.
template <typename Real, Mode kMode, int R>
__global__ void __launch_bounds__(kMaxThreads) block_select_kernel(Args<Real> a) {
  if (a.slot >= 0) launch_counts::add(a.slot);
  using O = Ops<Real>;
  using Key = typename O::WideKey;
  constexpr int kWidth = 8 * sizeof(Key);
  __shared__ State<Key> st;
  const int d = a.d;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * d;
  uint2 key = make_uint2(0u, 0u);
  if (kMode == kRandK) key = step_key(a);
  const int rbits = row_bits(d);
  auto key_of = [&](int c) -> Key {
    uint64_t score;
    if constexpr (kMode == kTopK) {
      score = O::magnitude(O::sub(a.v[base + c], a.memory[base + c]));
    } else {
      score = O::mantissa(threefry_at(key.x, key.y, static_cast<uint64_t>(base + c)));
    }
    return pack<Key, kScoreBits<Real, kMode>>(score, static_cast<uint32_t>(d - 1 - c), rbits);
  };
  // f(c, key) for each of this thread's columns.
  Key keys[R > 0 ? R : 1];
  auto each = [&](auto&& f) {
    if constexpr (R > 0) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int c = threadIdx.x + r * blockDim.x;
        if (c < d) f(c, keys[r]);
      }
    } else {
      for (int64_t c = threadIdx.x; c < d; c += blockDim.x) {
        f(static_cast<int>(c), key_of(static_cast<int>(c)));
      }
    }
  };
  auto write = [&](int c, bool keep) {
    const Real mem = a.memory[base + c];
    write_masked(a, base + c, mem, O::sub(a.v[base + c], mem), keep);
  };
  if (a.k >= d) {
    for (int64_t c = threadIdx.x; c < d; c += blockDim.x) write(static_cast<int>(c), true);
    return;
  }
  for (int i = threadIdx.x; i < kBins; i += blockDim.x) st.hist[i] = 0;
  if (threadIdx.x == 0) {
    st.prefix = 0;
    st.p = kWidth - 8;
    st.krem = a.k;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int c = threadIdx.x + r * blockDim.x;
    if (c < d) keys[r] = key_of(c);
  }
  __syncthreads();
  for (;;) {
    const int p = st.p;
    const Key prefix = st.prefix;
    each([&](int, Key k) {
      if (((k >> p) >> 8) == prefix) atomicAdd(&st.hist[static_cast<unsigned>(k >> p) & 0xFFu], 1u);
    });
    __syncthreads();
    // The survivors' room is k: the passes end when exactly k keys lie at or
    // above the k-th key's bin.
    if (threadIdx.x < kLanes) scan_histogram(&st, a.k, a.k);
    __syncthreads();
    if (st.done) break;
  }
  const int p = st.p;
  const Key lower = st.lower;
  each([&](int c, Key k) { write(c, (k >> p) >= lower); });
}

// qsgd, a warp a row: J columns a lane in registers, or with J = 0 a loop
// over the row in two passes.
template <typename Real, int J>
__global__ void __launch_bounds__(kWarpsPerBlock * kLanes) warp_qsgd_kernel(Args<Real> a) {
  if (a.slot >= 0) launch_counts::add(a.slot);
  using O = Ops<Real>;
  const int lane = threadIdx.x & (kLanes - 1);
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= a.n) return;
  const int d = a.d;
  const int64_t base = row * d;
  constexpr int kHeld = J > 0 ? J : 1;
  Real mem[kHeld], diff[kHeld];
  typename O::Draw u[kHeld];
  if constexpr (J > 0) {
#pragma unroll
    for (int h = 0; h < J; ++h) {
      const int c = lane + kLanes * h;
      mem[h] = c < d ? a.memory[base + c] : O::of(0.0);
      diff[h] = c < d ? O::sub(a.v[base + c], mem[h]) : O::of(0.0);
    }
  }
  const uint2 key = step_key(a);
  auto uniform_at = [&](int64_t at) {
    return O::uniform(O::mantissa(threefry_at(key.x, key.y, static_cast<uint64_t>(at))));
  };
  typename O::Sum acc = 0;
  if constexpr (J > 0) {
    // The draws need only the step key: drawn first, their Threefry calls
    // overlap the sum and the butterfly.
#pragma unroll
    for (int h = 0; h < J; ++h) u[h] = uniform_at(base + lane + kLanes * h);
#pragma unroll
    for (int h = 0; h < J; ++h) {
      if (lane + kLanes * h < d) acc = O::add_square(acc, diff[h]);
    }
  } else {
#pragma unroll 4
    for (int64_t c = lane; c < d; c += kLanes) {
      acc = O::add_square(acc, O::sub(a.v[base + c], a.memory[base + c]));
    }
  }
#pragma unroll
  for (int offset = kLanes / 2; offset > 0; offset /= 2) {
    acc = Ops<typename O::Sum>::add(acc, __shfl_xor_sync(kFullMask, acc, offset));
  }
  const Real norm = O::root(acc);
  const Real scale = O::positive(norm) ? norm : O::of(1.0);
  const Real s = O::of(static_cast<double>(1u << a.k));
  const Real weight = O::mul(O::of(a.omega), norm);
  auto quantize = [&](int64_t at, Real m, Real df, typename O::Draw uu) {
    const Real level = O::mul(O::div(O::abs(df), scale), s);
    const Real low = O::floor(level);
    const Real up = O::of(O::below(uu, O::sub(level, low)) ? 1.0 : 0.0);
    const Real lev = O::add(low, up);
    a.out[at] = O::add(m, O::mul(O::mul(weight, O::sign(df)), O::div(lev, s)));
    if (a.levels != nullptr) a.levels[at] = O::level(lev);
  };
  if constexpr (J > 0) {
#pragma unroll
    for (int h = 0; h < J; ++h) {
      const int c = lane + kLanes * h;
      if (c < d) quantize(base + c, mem[h], diff[h], u[h]);
    }
  } else {
#pragma unroll 4
    for (int64_t c = lane; c < d; c += kLanes) {
      const Real m = a.memory[base + c];
      quantize(base + c, m, O::sub(a.v[base + c], m), uniform_at(base + c));
    }
  }
}

// The warp kernels' instance: the fewest columns a lane that hold the row
// (J * 32 >= d), up to kWarpMaxD; past that, qsgd's loop (J = 0).
template <typename Real, Mode kMode, int J = 1>
void launch_warp(const Args<Real>& a, cudaStream_t s) {
  if constexpr (J * kLanes < kWarpMaxD) {
    if (a.d > J * kLanes) {
      launch_warp<Real, kMode, J + 1>(a, s);
      return;
    }
  }
  const dim3 grid(static_cast<unsigned>((a.n + kWarpsPerBlock - 1) / kWarpsPerBlock));
  const dim3 block(kWarpsPerBlock * kLanes);
  if constexpr (kMode == kQsgd) {
    if (a.d > kWarpMaxD) {
      warp_qsgd_kernel<Real, 0><<<grid, block, 0, s>>>(a);
    } else {
      warp_qsgd_kernel<Real, J><<<grid, block, 0, s>>>(a);
    }
  } else {
    warp_select_kernel<Real, kMode, J><<<grid, block, 0, s>>>(a);
  }
}

// top_k and random_k: a warp a row up to kWarpMaxD columns, else a block a
// row (a thread a column up to 1,024, then kHeldColumns a thread up to
// 4,096, then 1,024 threads recomputing).
template <typename Real, Mode kMode>
void launch_select(const Args<Real>& a, cudaStream_t s) {
  if (a.d <= kWarpMaxD) {
    launch_warp<Real, kMode>(a, s);
    return;
  }
  const dim3 grid(static_cast<unsigned>(a.n));
  if (a.d <= kMaxThreads) {
    const dim3 block(static_cast<unsigned>((a.d + kLanes - 1) / kLanes * kLanes));
    block_select_kernel<Real, kMode, 1><<<grid, block, 0, s>>>(a);
  } else if (a.d <= kMaxThreads * kHeldColumns) {
    block_select_kernel<Real, kMode, kHeldColumns><<<grid, kMaxThreads, 0, s>>>(a);
  } else {
    block_select_kernel<Real, kMode, kRecomputed><<<grid, kMaxThreads, 0, s>>>(a);
  }
}

template <typename Real>
int launch(const void* v, const void* memory, void* out, void* levels, int64_t n, int64_t d,
           int64_t mode, int64_t k, const void* t, uint32_t k0, uint32_t k1, uint32_t round,
           double omega, int slot, void* stream) {
  if (n <= 0 || d <= 0) return static_cast<int>(cudaSuccess);
  if (n > 0x7FFFFFFF || d > 0x7FFFFFFF) {
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
  a.n = n;
  a.d = static_cast<int>(d);
  a.k = static_cast<int>(k);
  a.t = static_cast<const int64_t*>(t);
  a.k0 = k0;
  a.k1 = k1;
  a.round = round;
  a.omega = omega;
  a.slot = slot;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == kTopK) {
    launch_select<Real, kTopK>(a, s);
  } else if (mode == kRandK) {
    launch_select<Real, kRandK>(a, s);
  } else {
    launch_warp<Real, kQsgd>(a, s);
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
int ef_compress_bf16(const void* v, const void* memory, void* out, int64_t n, int64_t d,
                     int64_t mode, int64_t k, const void* t, uint32_t k0, uint32_t k1,
                     uint32_t round, double omega, void* stream) {
  return launch<__nv_bfloat16>(v, memory, out, nullptr, n, d, mode, k, t, k0, k1, round, omega,
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
int ef_levels_bf16(const void* v, const void* memory, void* out, void* levels, int64_t n,
                   int64_t d, int64_t mode, int64_t k, const void* t, uint32_t k0, uint32_t k1,
                   uint32_t round, double omega, void* stream) {
  return launch<__nv_bfloat16>(v, memory, out, levels, n, d, mode, k, t, k0, k1, round, omega,
                               kNoSlot, stream);
}

}  // extern "C"
