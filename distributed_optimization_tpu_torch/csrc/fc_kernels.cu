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
// Design: one block a column strip.
//
// - The array is cut into column strips of lanes·V columns, V = 4 float32
//   or 2 float64 elements a thread as one 16-byte access where x, out and d
//   allow it (V = 1 otherwise). One block of lanes x groups threads, up to
//   1024, owns a strip and all N rows. Narrow strips give many blocks.
// - Thread (l, g) adds rows g, g + groups, ... of its V columns into
//   registers, in row order from +0, eight loads in flight; the groups'
//   partial sums meet in shared memory, and after one block barrier each
//   thread adds its own columns' partials in group order 0..groups-1, so
//   every thread of a column holds bitwise the same total.
// - fc_mix divides each total by N once a thread (round to nearest, as
//   jnp.mean does) and stores the mean to each of the thread's rows.
//   fc_neighbor_sum stores total - x[i, j]: from the thread's registers
//   where its rows fit one batch of eight loads (x read from device memory
//   once), else from x read again.
// - The plan (V, lanes, groups, where the rows stay) is chosen on the host
//   (ops/fc_kernels.py, from N, d, the item size and the alignment) and
//   passed in; ops/fc_kernels.py also holds a PyTorch mirror of this
//   summation order, which the kernel matches bit for bit. The order is
//   fixed, so launches are deterministic, but it is not torch.sum's: the
//   kernel agrees with the plain version to N·eps·max|x|.
//
// bfloat16 (the *_bf16 entry points): 8 elements a 16-byte access, the
// column sums in float32 in the same order, rounded once: the mean after
// its float32 division (jnp.mean and torch.mean sum in float32 and round
// once), the neighbour sum as bf16(total) - x[i, j], that difference
// rounded (jnp.sum rounds the total to bfloat16 before the subtraction).
// ops/fc_kernels.py's mirror repeats this order bit for bit.
//
// Every operation is a round-to-nearest intrinsic (no FMA contraction; the
// build also passes --fmad=false). Each launch adds one to its kernel's slot
// of launch_counts.cuh (slot 0 fc_mix, 1 fc_neighbor_sum: the order of
// KERNELS in ops/fc_kernels.py). The kernels allocate nothing, launch on
// the caller's stream and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "launch_counts.cuh"

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

template <typename T> struct Vec;
template <> struct Vec<float> { using type = float4; static constexpr int kWidth = 4; };
template <> struct Vec<double> { using type = double2; static constexpr int kWidth = 2; };
template <> struct Vec<__nv_bfloat16> { using type = uint4; static constexpr int kWidth = 8; };

// The type the column sums accumulate in (float for bfloat16, else the
// element's own), and the conversions to and from it.
template <typename T> struct Acc {
  using type = T;
  static __device__ __forceinline__ T up(T a) { return a; }
  static __device__ __forceinline__ T down(T a) { return a; }
};
template <> struct Acc<__nv_bfloat16> {
  using type = float;
  static __device__ __forceinline__ float up(__nv_bfloat16 a) { return __bfloat162float(a); }
  static __device__ __forceinline__ __nv_bfloat16 down(float a) { return __float2bfloat16_rn(a); }
};

// The type a scalar access moves the element's bits as.
template <typename T> struct Raw { using type = T; };
template <> struct Raw<__nv_bfloat16> { using type = unsigned short; };

template <typename T, int V> struct alignas(sizeof(T) * V) Pack { T v[V]; };

template <typename T, int V>
__device__ __forceinline__ Pack<T, V> load_global(const T* p) {
  Pack<T, V> r;
  if constexpr (V == 1) {
    using R = typename Raw<T>::type;
    const R raw = __ldg(reinterpret_cast<const R*>(p));
    r.v[0] = *reinterpret_cast<const T*>(&raw);
  } else {
    using VT = typename Vec<T>::type;
    *reinterpret_cast<VT*>(r.v) = __ldg(reinterpret_cast<const VT*>(p));
  }
  return r;
}

template <typename T, int V>
__device__ __forceinline__ void store_global(T* p, const Pack<T, V>& r) {
  if constexpr (V == 1) {
    using R = typename Raw<T>::type;
    __stcs(reinterpret_cast<R*>(p), *reinterpret_cast<const R*>(r.v));
  } else {
    using VT = typename Vec<T>::type;
    __stcs(reinterpret_cast<VT*>(p), *reinterpret_cast<const VT*>(r.v));
  }
}

constexpr int kMaxThreads = 1024;
constexpr int kUnroll = 8;  // rows loaded before they are added

// fc_mix, or fc_neighbor_sum reading x again or keeping its rows in
// registers; the order of the last two is the C interface's tile code.
enum class Mode { kMean, kNeighbor, kNeighborRegisters };

// Dynamic shared memory: the groups' partial sums, [groups][lanes·V], in
// the accumulation type A.
template <typename T, int V, Mode M>
__global__ void __launch_bounds__(kMaxThreads)
fc_kernel(const T* __restrict__ x, T* __restrict__ out, int64_t n, int64_t d) {
  launch_counts::add(M == Mode::kMean ? 0 : 1);
  using A = typename Acc<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const int groups = blockDim.y;
  const int width = blockDim.x * V;
  A* partial = reinterpret_cast<A*>(smem);

  const int lane_col = threadIdx.x * V;
  const int64_t j = static_cast<int64_t>(blockIdx.x) * width + lane_col;
  const bool active = j < d;  // V > 1 only when d % V == 0
  const int64_t step = static_cast<int64_t>(groups) * d;

  // Pass 1: this thread's rows, in row order, kUnroll loads in flight. A
  // row past N reads as +0: a sum started from +0 is never -0, so adding
  // +0 leaves its bits as they are. kNeighborRegisters runs one batch
  // (n <= kUnroll·groups) and keeps it in v for pass 2.
  Pack<A, V> s;
  Pack<T, V> v[kUnroll];
#pragma unroll
  for (int k = 0; k < V; ++k) s.v[k] = A{};
  if (active) {
    const T* p = x + threadIdx.y * d + j;
    for (int64_t i = threadIdx.y; i < n; i += kUnroll * groups, p += kUnroll * step) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (i + u * groups < n) {
          v[u] = load_global<T, V>(p + u * step);
        } else {
#pragma unroll
          for (int k = 0; k < V; ++k) v[u].v[k] = T{};
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int k = 0; k < V; ++k) s.v[k] = Rn<A>::add(s.v[k], Acc<T>::up(v[u].v[k]));
      }
    }
  }
  *reinterpret_cast<Pack<A, V>*>(partial + threadIdx.y * width + lane_col) = s;
  __syncthreads();

  // The column totals: every thread adds its own columns' group sums in
  // group order.
  Pack<A, V> sum;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    A t = partial[lane_col + k];
#pragma unroll 8
    for (int g = 1; g < groups; ++g) t = Rn<A>::add(t, partial[g * width + lane_col + k]);
    sum.v[k] = t;
  }

  // Pass 2: this thread's rows of out, kUnroll at a time. The totals round
  // once to T: the mean after its division, the neighbour sum's total
  // before its subtraction.
  if (active) {
    Pack<T, V> tot;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      tot.v[k] = Acc<T>::down(M == Mode::kMean ? Rn<A>::div(sum.v[k], static_cast<A>(n))
                                               : sum.v[k]);
    }
    for (int64_t i = threadIdx.y, e = threadIdx.y * d + j; i < n;
         i += kUnroll * groups, e += kUnroll * step) {
      if constexpr (M == Mode::kNeighbor) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (i + u * groups < n) v[u] = load_global<T, V>(x + e + u * step);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (i + u * groups < n) {
          if constexpr (M == Mode::kMean) {
            store_global<T, V>(out + e + u * step, tot);
          } else {
            Pack<T, V> r;
#pragma unroll
            for (int k = 0; k < V; ++k) {
              r.v[k] = Acc<T>::down(Rn<A>::sub(Acc<T>::up(tot.v[k]), Acc<T>::up(v[u].v[k])));
            }
            store_global<T, V>(out + e + u * step, r);
          }
        }
      }
    }
  }
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T, int V, Mode M>
int launch_plan(const T* x, T* out, int64_t n, int64_t d, int lanes, int groups,
                cudaStream_t stream) {
  const int64_t width = static_cast<int64_t>(lanes) * V;
  const int64_t strips = (d + width - 1) / width;
  if (strips > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem = static_cast<size_t>(groups * width) * sizeof(typename Acc<T>::type);
  const dim3 block(static_cast<unsigned>(lanes), static_cast<unsigned>(groups));
  fc_kernel<T, V, M><<<static_cast<unsigned>(strips), block, smem, stream>>>(x, out, n, d);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, Mode M>
int launch_vec(const void* x, void* out, int64_t n, int64_t d, int vec, int lanes, int groups,
               cudaStream_t stream) {
  const T* tx = static_cast<const T*>(x);
  T* to = static_cast<T*>(out);
  constexpr int kV = Vec<T>::kWidth;
  return vec == 1 ? launch_plan<T, 1, M>(tx, to, n, d, lanes, groups, stream)
                  : launch_plan<T, kV, M>(tx, to, n, d, lanes, groups, stream);
}

// vec is V (1, or the 16-byte width of T); tile (fc_neighbor_sum) is where
// a thread's rows stay between the passes: 0 nowhere (x read again), 1 in
// its registers. A plan the kernel cannot run returns cudaErrorInvalidValue
// before any launch.
template <typename T, bool kMean>
int launch(const void* x, void* out, int64_t n, int64_t d, int vec, int lanes, int groups,
           int tile, void* stream) {
  if (n * d == 0) return static_cast<int>(cudaGetLastError());
  constexpr int kV = Vec<T>::kWidth;
  const bool plan_ok =
      (vec == 1 || (vec == kV && d % kV == 0 && aligned16(x) && aligned16(out))) && lanes > 0 &&
      groups > 0 && lanes * groups <= kMaxThreads && (tile == 0 || tile == 1) &&
      (tile == 0 || n <= static_cast<int64_t>(kUnroll) * groups);
  if (!plan_ok) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if constexpr (kMean) {
    return launch_vec<T, Mode::kMean>(x, out, n, d, vec, lanes, groups, s);
  } else if (tile == 1) {
    return launch_vec<T, Mode::kNeighborRegisters>(x, out, n, d, vec, lanes, groups, s);
  }
  return launch_vec<T, Mode::kNeighbor>(x, out, n, d, vec, lanes, groups, s);
}

}  // namespace

extern "C" {

int fc_mix_f32(const void* x, void* out, int64_t n, int64_t d, int vec, int lanes, int groups,
               int tile, void* stream) {
  return launch<float, true>(x, out, n, d, vec, lanes, groups, tile, stream);
}
int fc_mix_f64(const void* x, void* out, int64_t n, int64_t d, int vec, int lanes, int groups,
               int tile, void* stream) {
  return launch<double, true>(x, out, n, d, vec, lanes, groups, tile, stream);
}
int fc_neighbor_sum_f32(const void* x, void* out, int64_t n, int64_t d, int vec, int lanes,
                        int groups, int tile, void* stream) {
  return launch<float, false>(x, out, n, d, vec, lanes, groups, tile, stream);
}
int fc_neighbor_sum_f64(const void* x, void* out, int64_t n, int64_t d, int vec, int lanes,
                        int groups, int tile, void* stream) {
  return launch<double, false>(x, out, n, d, vec, lanes, groups, tile, stream);
}
int fc_mix_bf16(const void* x, void* out, int64_t n, int64_t d, int vec, int lanes, int groups,
                int tile, void* stream) {
  return launch<__nv_bfloat16, true>(x, out, n, d, vec, lanes, groups, tile, stream);
}
int fc_neighbor_sum_bf16(const void* x, void* out, int64_t n, int64_t d, int vec, int lanes,
                         int groups, int tile, void* stream) {
  return launch<__nv_bfloat16, false>(x, out, n, d, vec, lanes, groups, tile, stream);
}

}  // extern "C"
