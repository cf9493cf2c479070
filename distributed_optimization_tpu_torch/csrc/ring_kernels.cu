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
// Bound: memory. The fused step reads x and g once and writes out once,
// 3·N·d elements for 4 floating-point operations each; ring_mix and
// ring_neighbor_sum move 2·N·d, for 3 and 1. At the main path's N=256, d=81
// in float32 that is 248,832 bytes, 0.074 us at 3.35 TB/s, so there the
// launch sets the time; at the million-worker ring (N=1,000,000, d=17) it is
// 204 MB, 60.9 us, and 136 MB, 40.6 us, for the two-array kernels.
//
// Design (ring_stencil_kernel, one template for the three, Op picks what a
// thread computes):
//
// - A flat stencil with no division. On the row-major array, roll(x, ±1, 0)
//   is a shift by ∓d on the flat array of total = N·d elements, wrapping
//   modulo total: prev(e) = e >= d ? e - d : e + (total - d) and
//   next(e) = e < total - d ? e + d : e - (total - d). No '/' or '%' runs
//   on the device (a 64-bit integer division is a software routine of
//   dozens of dependent instructions on sm_90). The index type is uint32_t
//   when total < 2^31 and uint64_t otherwise, chosen once on the host.
// - V elements per thread with 16-byte accesses: V = 4 in float32, 2 in
//   float64, 8 in bfloat16 (one uint4). A thread loads its x and g as one float4/double2 through the
//   read-only path and stores one; ring_neighbor_sum loads no x of its own,
//   only the two neighbours. The neighbour vectors x[e ± d, +V) are 16-byte
//   aligned only when d % V == 0, and only then can they not straddle the
//   wrap: that instance loads them as vectors too; otherwise each lane
//   loads its neighbours as scalars, each with its own wrap. The last
//   total % V elements are done one per thread. A pointer that is not
//   16-byte aligned (a view at an odd storage offset) gets the scalar
//   instance of the same kernel: one element per thread.
// - A grid sized for the card: 256 threads a block, one vector a thread,
//   as many blocks as the vectors need up to 64 full waves of 8 blocks a
//   multiprocessor (the count read once per device from
//   cudaDevAttrMultiProcessorCount: 67,584 blocks, 17.3 million vectors, on
//   132), and a grid-stride loop beyond that. At the main path's 20,736
//   elements (5,184 vectors) that is 21 blocks, one wave, one trip. On the
//   H100 a grid of one wave that loops was 8-12% slower at the
//   million-worker ring (PERF.md). Neighbour rows are other threads' own
//   rows, so their second and third reads come from L1/L2, and device
//   memory sees x once. out is stored evict-first (st.global.cs): nothing
//   here reads it, and x's lines stay cached for the neighbour reads.
// - Staging a block's segment and a d-element halo in shared memory with
//   cp.async (so that a misaligned d would cost no scalar loads) measured
//   slower than this at the million-worker ring, and no faster at N=4096,
//   d=1024, in both dtypes, so there is no shared-memory instance.
// - No tensor-core form: W is three weights of 1/3 a row, a product with no
//   reuse to feed wgmma, and a matrix product would sum x_i/3 + x_{i-1}/3 +
//   x_{i+1}/3 in its own order, which breaks the bitwise contract below.
//
// Rounding: every operation uses the round-to-nearest intrinsics, in the
// order of the plain PyTorch version ((x_i + x_{i-1}) + x_{i+1}) * THIRD,
// then - (eta * g) as a separate multiply and subtract. nvcc would otherwise
// contract the last two into one FMA, which rounds differently (the build
// also passes --fmad=false; nothing here calls fma). The neighbour sum is
// one add, x_{i-1} + x_{i+1}, as roll(x,+1) + roll(x,-1) rounds it. With
// the intrinsics the kernels are bitwise equal to the plain version. THIRD
// is 1/3 rounded once to the working type. eta is read from a one-element
// device array in the working type (no host synchronisation).
//
// bfloat16 (the *_bf16 entry points): the same stencil on 2-byte elements,
// each operation computed in float32 with the intrinsics and rounded to
// bfloat16 at once, in the same order: ((x_i + x_{i-1}) + x_{i+1}) *
// bf16(1/3), then - bf16(eta * g). That is what PyTorch's bfloat16
// operations compute, and what the JAX package's ring stencil and Pallas
// kernels compute in bfloat16 on the CPU (its accumulation in float32,
// rounded once, would differ in about a third of the elements). The bound
// halves with the bytes; rows of d % 8 != 0 elements take the vector
// instance with scalar neighbours.
//
// Each launch adds one to its kernel's slot of launch_counts.cuh (slot 0
// fused_ring_dsgd_step, 1 ring_mix, 2 ring_neighbor_sum: the order of
// KERNELS in ops/ring_kernels.py). The kernels allocate nothing, launch on
// the caller's stream and return cudaGetLastError(). ring_launch_floor launches an empty kernel through
// the same interface, for measuring what a launch costs; it is on no path.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "launch_counts.cuh"

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

// bfloat16: each operation in float32, rounded to bfloat16 at once, as
// PyTorch's bfloat16 operations (and the JAX package's on the CPU) round.
// A product of two bfloat16 values is exact in float32, so it rounds once.
template <> struct Rn<__nv_bfloat16> {
  using T = __nv_bfloat16;
  static __device__ __forceinline__ float f(T a) { return __bfloat162float(a); }
  static __device__ __forceinline__ T add(T a, T b) { return __float2bfloat16_rn(__fadd_rn(f(a), f(b))); }
  static __device__ __forceinline__ T sub(T a, T b) { return __float2bfloat16_rn(__fsub_rn(f(a), f(b))); }
  static __device__ __forceinline__ T mul(T a, T b) { return __float2bfloat16_rn(__fmul_rn(f(a), f(b))); }
  // bfloat16(1/3) = 0.333984375, as the JAX package's weak-typed 1/3 rounds.
  static __device__ __forceinline__ T third() { return __float2bfloat16_rn(static_cast<float>(1.0 / 3.0)); }
};

constexpr int kThreads = 256;

constexpr int kBlocksPerSm = 8;  // 8 x 256 threads fill a multiprocessor
constexpr int kWaves = 64;       // full waves launched at most
constexpr int kMaxDevices = 64;

// The most blocks a launch takes on the current device: kWaves full waves,
// from the multiprocessor count read once per device.
int max_blocks() {
  static int cached[kMaxDevices] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= kMaxDevices) dev = 0;
  if (cached[dev] == 0) {
    int sms = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cached[dev] = (sms > 0 ? sms : 1) * kBlocksPerSm * kWaves;
  }
  return cached[dev];
}

template <typename T> struct Vec;
template <> struct Vec<float> { using type = float4; static constexpr int kWidth = 4; };
template <> struct Vec<double> { using type = double2; static constexpr int kWidth = 2; };
template <> struct Vec<__nv_bfloat16> { using type = uint4; static constexpr int kWidth = 8; };

// The type a scalar access moves the element's bits as.
template <typename T> struct Raw { using type = T; };
template <> struct Raw<__nv_bfloat16> { using type = unsigned short; };

template <typename T>
__device__ __forceinline__ T ldg1(const T* p) {
  using R = typename Raw<T>::type;
  const R r = __ldg(reinterpret_cast<const R*>(p));
  return *reinterpret_cast<const T*>(&r);
}

template <typename T>
__device__ __forceinline__ void stcs1(T* p, T v) {
  using R = typename Raw<T>::type;
  __stcs(reinterpret_cast<R*>(p), *reinterpret_cast<const R*>(&v));
}

// How a thread loads: one element (kScalar); V elements as one vector with
// scalar neighbour loads (kVector); or neighbours as vectors too
// (kVectorAligned, d % V == 0).
enum class Layout { kScalar, kVector, kVectorAligned };

// What a thread computes: x_prev + x_next (ring_neighbor_sum); W x
// (ring_mix); or W x - eta * g (fused_ring_dsgd_step).
enum class Op { kNeighborSum, kMix, kStep };

// The launch-count slot of each Op's kernel.
__host__ __device__ constexpr int count_slot(Op op) {
  return op == Op::kStep ? 0 : op == Op::kMix ? 1 : 2;
}

template <typename T, int V> struct alignas(sizeof(T) * V) Pack { T v[V]; };

template <typename T, int V>
__device__ __forceinline__ Pack<T, V> load(const T* p) {
  Pack<T, V> r;
  if constexpr (V == 1) {
    r.v[0] = ldg1(p);
  } else {
    using VT = typename Vec<T>::type;
    *reinterpret_cast<VT*>(r.v) = __ldg(reinterpret_cast<const VT*>(p));
  }
  return r;
}

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const Pack<T, V>& r) {
  if constexpr (V == 1) {
    stcs1(p, r.v[0]);
  } else {
    using VT = typename Vec<T>::type;
    __stcs(reinterpret_cast<VT*>(p), *reinterpret_cast<const VT*>(r.v));
  }
}

// For the V elements from e: x_prev + x_next, or ((x_e + x_prev) + x_next)
// * THIRD [- eta * g_e]; far = total - d.
template <typename T, typename I, int V, bool kVecNbr, Op kOp>
__device__ __forceinline__ void stencil(const T* __restrict__ x, const T* __restrict__ g, T step,
                                        T* __restrict__ out, I e, I d, I far) {
  Pack<T, V> self;
  if constexpr (kOp != Op::kNeighborSum) self = load<T, V>(x + e);
  Pack<T, V> prev, next;
  if constexpr (kVecNbr) {
    prev = load<T, V>(x + (e >= d ? e - d : e + far));
    next = load<T, V>(x + (e >= far ? e - far : e + d));
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const I k = e + j;
      prev.v[j] = ldg1(x + (k >= d ? k - d : k + far));
      next.v[j] = ldg1(x + (k >= far ? k - far : k + d));
    }
  }
  Pack<T, V> grad;
  if constexpr (kOp == Op::kStep) grad = load<T, V>(g + e);
  Pack<T, V> r;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    if constexpr (kOp == Op::kNeighborSum) {
      r.v[j] = Rn<T>::add(prev.v[j], next.v[j]);
    } else {
      const T mixed = Rn<T>::mul(Rn<T>::add(Rn<T>::add(self.v[j], prev.v[j]), next.v[j]),
                                 Rn<T>::third());
      if constexpr (kOp == Op::kStep) {
        r.v[j] = Rn<T>::sub(mixed, Rn<T>::mul(step, grad.v[j]));
      } else {
        r.v[j] = mixed;
      }
    }
  }
  store<T, V>(out + e, r);
}

template <typename T, typename I, Layout L, Op kOp>
__global__ void __launch_bounds__(kThreads)
ring_stencil_kernel(const T* __restrict__ x, const T* __restrict__ g, const T* __restrict__ eta,
                    T* __restrict__ out, I total, I d) {
  launch_counts::add(count_slot(kOp));
  constexpr int V = L == Layout::kScalar ? 1 : Vec<T>::kWidth;
  const I far = total - d;
  T step{};
  if constexpr (kOp == Op::kStep) step = ldg1(eta);
  const I first = static_cast<I>(blockIdx.x) * kThreads + threadIdx.x;
  const I stride = static_cast<I>(gridDim.x) * kThreads;
  const I nvec = total / V;  // V is a power of two: a shift
  for (I v = first; v < nvec; v += stride) {
    stencil<T, I, V, L == Layout::kVectorAligned, kOp>(x, g, step, out, v * V, d, far);
  }
  if constexpr (V > 1) {
    const I e = nvec * V + first;  // the last total % V elements
    if (e < total) stencil<T, I, 1, false, kOp>(x, g, step, out, e, d, far);
  }
}

template <typename T, Layout L, Op kOp>
void launch_stencil(const T* x, const T* g, const T* eta, T* out, int64_t total, int64_t d,
                    cudaStream_t stream) {
  constexpr int64_t V = L == Layout::kScalar ? 1 : Vec<T>::kWidth;
  const int64_t threads = total / V + (total % V > 0 ? 1 : 0);
  const int64_t wanted = (threads + kThreads - 1) / kThreads;
  const unsigned blocks = static_cast<unsigned>(wanted < max_blocks() ? wanted : max_blocks());
  if (total < (int64_t{1} << 31)) {
    ring_stencil_kernel<T, uint32_t, L, kOp><<<blocks, kThreads, 0, stream>>>(
        x, g, eta, out, static_cast<uint32_t>(total), static_cast<uint32_t>(d));
  } else {
    ring_stencil_kernel<T, uint64_t, L, kOp><<<blocks, kThreads, 0, stream>>>(
        x, g, eta, out, static_cast<uint64_t>(total), static_cast<uint64_t>(d));
  }
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T, Op kOp>
int launch_ring(const void* x, const void* g, const void* eta, void* out, int64_t n, int64_t d,
                void* stream) {
  const int64_t total = n * d;
  if (total > 0) {
    const T* tx = static_cast<const T*>(x);
    const T* tg = static_cast<const T*>(g);
    const T* te = static_cast<const T*>(eta);
    T* to = static_cast<T*>(out);
    const auto s = static_cast<cudaStream_t>(stream);
    if (!aligned16(x) || !aligned16(out) || (kOp == Op::kStep && !aligned16(g))) {
      launch_stencil<T, Layout::kScalar, kOp>(tx, tg, te, to, total, d, s);
    } else if (d % Vec<T>::kWidth == 0) {
      launch_stencil<T, Layout::kVectorAligned, kOp>(tx, tg, te, to, total, d, s);
    } else {
      launch_stencil<T, Layout::kVector, kOp>(tx, tg, te, to, total, d, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

__global__ void empty_kernel() {}

}  // namespace

extern "C" {

int fused_ring_dsgd_step_f32(const void* x, const void* g, const void* eta, void* out, int64_t n,
                             int64_t d, void* stream) {
  return launch_ring<float, Op::kStep>(x, g, eta, out, n, d, stream);
}
int fused_ring_dsgd_step_f64(const void* x, const void* g, const void* eta, void* out, int64_t n,
                             int64_t d, void* stream) {
  return launch_ring<double, Op::kStep>(x, g, eta, out, n, d, stream);
}
int ring_mix_f32(const void* x, void* out, int64_t n, int64_t d, void* stream) {
  return launch_ring<float, Op::kMix>(x, nullptr, nullptr, out, n, d, stream);
}
int ring_mix_f64(const void* x, void* out, int64_t n, int64_t d, void* stream) {
  return launch_ring<double, Op::kMix>(x, nullptr, nullptr, out, n, d, stream);
}
int ring_neighbor_sum_f32(const void* x, void* out, int64_t n, int64_t d, void* stream) {
  return launch_ring<float, Op::kNeighborSum>(x, nullptr, nullptr, out, n, d, stream);
}
int ring_neighbor_sum_f64(const void* x, void* out, int64_t n, int64_t d, void* stream) {
  return launch_ring<double, Op::kNeighborSum>(x, nullptr, nullptr, out, n, d, stream);
}
int fused_ring_dsgd_step_bf16(const void* x, const void* g, const void* eta, void* out,
                              int64_t n, int64_t d, void* stream) {
  return launch_ring<__nv_bfloat16, Op::kStep>(x, g, eta, out, n, d, stream);
}
int ring_mix_bf16(const void* x, void* out, int64_t n, int64_t d, void* stream) {
  return launch_ring<__nv_bfloat16, Op::kMix>(x, nullptr, nullptr, out, n, d, stream);
}
int ring_neighbor_sum_bf16(const void* x, void* out, int64_t n, int64_t d, void* stream) {
  return launch_ring<__nv_bfloat16, Op::kNeighborSum>(x, nullptr, nullptr, out, n, d, stream);
}
int ring_launch_floor(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
