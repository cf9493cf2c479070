// The fault and noise draws for Hopper (sm_90a), with a plain C interface.
//
// No Pallas kernel stands behind these: they are the counterpart of the XLA
// code that jax.random compiles to inside distributed_optimization_tpu's
// fault layer and large-noise attack, on the JAX package's random stream:
//   realize_kernel   one round's realized graph at the device counter t
//                    (parallel/faults.py :223-246 sample_surviving_adjacency
//                    and its directed twin, :334-348 the one-peer scores,
//                    :962-990 active / realized_adjacency): A_t [N, N]
//                    float32 with the node mask applied, active [N] float32,
//                    and the one-peer proposal scores u * A_t where asked;
//   timeline_kernel  build_fault_timeline (:419-587): the per-edge
//                    Gilbert-Elliott chains, the crash-recovery node chains
//                    and the participation stream, unrolled over t;
//   noise_kernel     the large_noise payload (parallel/adversary.py
//                    :118-130): x + s * sqrt(2) * erf_inv(u) on the
//                    Byzantine rows, u jax.random.normal's uniform.
// The plain versions are distributed_optimization_tpu_torch/ops/draw_kernels.py
// (on the twin of jax.random in ops/prng.py); the kernels equal them bit for
// bit on the card.
//
// The draws:
//   round key      = threefry2x32(tag key, (0, t mod 2^32))
//   float32 u      = ((x0 ^ x1) >> 9) * 2^-23 at counter c, (x0, x1) =
//                    threefry2x32(round key, (0, c))
//   edge (i, j)    counter i * N + j; an undirected edge reads its i < j
//                  entry from both ends (the triu(u, 1) + its transpose)
//   node i         counter i of the node key's round draw
// An edge survives iff u >= p; a node is up iff u >= q (float32 thresholds).
// The timeline starts every chain from its stationary threshold at t = 0
// and then compares against P(down | up) or P(down | down); rejoin is up
// and not up the round before (all nodes up before t = 0).
//
// The normal: u = max(lo, f * (1 - lo) + lo), f the uniform's [0, 1) float
// of its bits (32, or 64 in float64) and lo the float after -1 toward 0;
// then sqrt(2) * erf_inv(u), erf_inv the polynomial XLA lowers lax.erf_inv
// to (Giles: 9 coefficients in float32; 23, 19 or 17 in float64), every
// product and sum rounded on its own (the _rn intrinsics; the build passes
// --fmad=false), log1p and sqrt the CUDA math library's.
//
// Design: simple. realize_kernel: a thread an entry of A_t in 32 x 8
// blocks; the round keys and the node draws of the block's 8 rows and 32
// columns go to shared memory first. timeline_kernel: a thread an edge or
// a node, looping over t with its chain state in a register; its writes
// [t, entity] are coalesced across a warp. noise_kernel: a thread an element;
// honest rows copy x.
//
// Each launch adds one to its kernel's slot of launch_counts.cuh (0 realize,
// 1 timeline, 2 noise: the order of KERNELS in ops/draw_kernels.py). The
// kernels allocate nothing, launch on the caller's stream and return
// cudaGetLastError(); arguments they cannot take return cudaErrorInvalidValue.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "launch_counts.cuh"
#include "threefry.cuh"

namespace {

constexpr int kSlotRealize = 0;
constexpr int kSlotTimeline = 1;
constexpr int kSlotNoise = 2;
constexpr int kCols = 32;  // realize_kernel: a block's columns
constexpr int kRows = 8;   // and rows
constexpr int kThreads = 256;

__device__ __forceinline__ uint2 round_key(uint2 tag, const int64_t* t) {
  return threefry2x32(tag.x, tag.y, 0u, static_cast<uint32_t>(static_cast<uint64_t>(*t)));
}

__device__ __forceinline__ uint2 round_key_at(uint2 tag, int64_t t) {
  return threefry2x32(tag.x, tag.y, 0u, static_cast<uint32_t>(static_cast<uint64_t>(t)));
}

// The float32 uniform on [0, 1) at counter c: its 23 mantissa bits times 2^-23.
__device__ __forceinline__ float uniform32(uint2 key, uint32_t c) {
  const uint2 w = threefry2x32(key.x, key.y, 0u, c);
  return __fsub_rn(__uint_as_float(((w.x ^ w.y) >> 9) | 0x3F800000u), 1.0f);
}

// ---- one round ------------------------------------------------------------

// keys: fault, node, match tag keys. base: [N, N] uint8 adjacency. given:
// a realized A_t to score instead of drawing one (or null). Writes a [N, N]
// and active [N] unless given; scores [N, N] where non-null.
__global__ void realize_kernel(const int64_t* __restrict__ t, uint2 fault_tag, uint2 node_tag,
                               uint2 match_tag, const uint8_t* __restrict__ base,
                               const float* __restrict__ given, int n, float p, float q,
                               int drop, int strag, int directed, float* __restrict__ a,
                               float* __restrict__ active, float* __restrict__ scores) {
  launch_counts::add(kSlotRealize);
  __shared__ uint2 keys[3];
  __shared__ unsigned char row_up[kRows];
  __shared__ unsigned char col_up[kCols];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kCols + tx;
  const int i = blockIdx.y * kRows + ty;
  const int j = blockIdx.x * kCols + tx;
  if (tid == 0) {
    keys[0] = round_key(fault_tag, t);
    keys[1] = round_key(node_tag, t);
    keys[2] = round_key(match_tag, t);
  }
  __syncthreads();
  if (given == nullptr && strag) {
    if (tid < kRows) {
      const int r = blockIdx.y * kRows + tid;
      row_up[tid] = r < n && uniform32(keys[1], static_cast<uint32_t>(r)) >= q;
    } else if (tid < kRows + kCols) {
      const int c = blockIdx.x * kCols + (tid - kRows);
      col_up[tid - kRows] = c < n && uniform32(keys[1], static_cast<uint32_t>(c)) >= q;
    }
  }
  __syncthreads();
  if (i >= n || j >= n) return;
  const size_t at = static_cast<size_t>(i) * n + j;
  float live;
  if (given != nullptr) {
    live = given[at];
  } else {
    bool up = base[at] != 0;
    if (up && drop) {
      const int lo = directed ? i : min(i, j);
      const int hi = directed ? j : max(i, j);
      up = uniform32(keys[0], static_cast<uint32_t>(lo) * static_cast<uint32_t>(n) +
                                  static_cast<uint32_t>(hi)) >= p;
    }
    if (strag) up = up && row_up[ty] && col_up[tx];
    live = up ? 1.0f : 0.0f;
    a[at] = live;
    if (j == 0) active[i] = (!strag || row_up[ty]) ? 1.0f : 0.0f;
  }
  if (scores != nullptr) {
    const float u = uniform32(keys[2], static_cast<uint32_t>(i) * static_cast<uint32_t>(n) +
                                           static_cast<uint32_t>(j));
    scores[at] = live != 0.0f ? u : 0.0f;
  }
}

// ---- the timeline -----------------------------------------------------------

struct Chain {
  float init, enter, stay;  // thresholds at t = 0, after up, after down
};

// Entities: [0, n_edges) the edge chains (counter of edge e: ei * n + ej),
// then n_nodes node chains, then n_part participation streams.
__global__ void timeline_kernel(uint2 fault_tag, uint2 node_tag, uint2 part_tag, int n,
                                const int32_t* __restrict__ edges, int n_edges, Chain edge,
                                int n_nodes, Chain node, int n_part, float p_out, int64_t horizon,
                                uint8_t* __restrict__ edge_up, uint8_t* __restrict__ node_up,
                                uint8_t* __restrict__ rejoin, uint8_t* __restrict__ part_up) {
  launch_counts::add(kSlotTimeline);
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e < n_edges) {
    const uint32_t c = static_cast<uint32_t>(edges[2 * e]) * static_cast<uint32_t>(n) +
                       static_cast<uint32_t>(edges[2 * e + 1]);
    bool up = true;
    for (int64_t s = 0; s < horizon; ++s) {
      const float u = uniform32(round_key_at(fault_tag, s), c);
      up = u >= (s == 0 ? edge.init : (up ? edge.enter : edge.stay));
      edge_up[s * n_edges + e] = up;
    }
    return;
  }
  const int64_t k = e - n_edges;
  if (k < n_nodes) {
    const uint32_t c = static_cast<uint32_t>(k);
    bool up = true;
    for (int64_t s = 0; s < horizon; ++s) {
      const float u = uniform32(round_key_at(node_tag, s), c);
      const bool now = u >= (s == 0 ? node.init : (up ? node.enter : node.stay));
      node_up[s * n_nodes + k] = now;
      rejoin[s * n_nodes + k] = now && !up;
      up = now;
    }
    return;
  }
  const int64_t m = k - n_nodes;
  if (m < n_part) {
    for (int64_t s = 0; s < horizon; ++s) {
      part_up[s * n_part + m] = uniform32(round_key_at(part_tag, s), static_cast<uint32_t>(m)) >=
                                p_out;
    }
  }
}

// ---- the large-noise payload ------------------------------------------------

template <typename Real>
struct Normal;

template <>
struct Normal<float> {
  static __device__ __forceinline__ float lower() { return nextafterf(-1.0f, 0.0f); }
  static __device__ __forceinline__ float uniform(uint2 key, uint32_t c) {
    const float lo = lower();
    const float f = uniform32(key, c);
    return fmaxf(lo, __fadd_rn(__fmul_rn(f, __fsub_rn(1.0f, lo)), lo));
  }
  static __device__ float erf_inv(float x) {
    const float small[9] = {2.81022636e-08f,  3.43273939e-07f, -3.5233877e-06f,
                            -4.39150654e-06f, 0.00021858087f,  -0.00125372503f,
                            -0.00417768164f,  0.246640727f,    1.50140941f};
    const float large[9] = {-0.000200214257f, 0.000100950558f, 0.00134934322f,
                            -0.00367342844f,  0.00573950773f,  -0.0076224613f,
                            0.00943887047f,   1.00167406f,     2.83297682f};
    float w = -log1pf(__fmul_rn(x, -x));
    const bool lt = w < 5.0f;
    w = lt ? __fsub_rn(w, 2.5f) : __fsub_rn(__fsqrt_rn(w), 3.0f);
    float p = lt ? small[0] : large[0];
#pragma unroll
    for (int i = 1; i < 9; ++i) p = __fadd_rn(lt ? small[i] : large[i], __fmul_rn(p, w));
    return fabsf(x) == 1.0f ? __fmul_rn(x, INFINITY) : __fmul_rn(p, x);
  }
  static __device__ __forceinline__ float sqrt2() { return 1.41421354f; }
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
};

template <>
struct Normal<double> {
  static __device__ __forceinline__ double lower() { return nextafter(-1.0, 0.0); }
  static __device__ __forceinline__ double uniform(uint2 key, uint32_t c) {
    const double lo = lower();
    const uint2 w = threefry2x32(key.x, key.y, 0u, c);
    const uint64_t bits = (static_cast<uint64_t>(w.x) << 32) | w.y;
    const double f =
        __dsub_rn(__longlong_as_double(static_cast<long long>((bits >> 12) |
                                                              0x3FF0000000000000ull)),
                  1.0);
    return fmax(lo, __dadd_rn(__dmul_rn(f, __dsub_rn(1.0, lo)), lo));
  }
  static __device__ double erf_inv(double x) {
    const double c625[23] = {
        -3.6444120640178196996e-21, -1.685059138182016589e-19, 1.2858480715256400167e-18,
        1.115787767802518096e-17,   -1.333171662854620906e-16, 2.0972767875968561637e-17,
        6.6376381343583238325e-15,  -4.0545662729752068639e-14, -8.1519341976054721522e-14,
        2.6335093153082322977e-12,  -1.2975133253453532498e-11, -5.4154120542946279317e-11,
        1.051212273321532285e-09,   -4.1126339803469836976e-09, -2.9070369957882005086e-08,
        4.2347877827932403518e-07,  -1.3654692000834678645e-06, -1.3882523362786468719e-05,
        0.0001867342080340571352,   -0.00074070253416626697512, -0.0060336708714301490533,
        0.24015818242558961693,     1.6536545626831027356};
    const double c16[19] = {
        2.2137376921775787049e-09,  9.0756561938885390979e-08,  -2.7517406297064545428e-07,
        1.8239629214389227755e-08,  1.5027403968909827627e-06,  -4.013867526981545969e-06,
        2.9234449089955446044e-06,  1.2475304481671778723e-05,  -4.7318229009055733981e-05,
        6.8284851459573175448e-05,  2.4031110387097893999e-05,  -0.0003550375203628474796,
        0.00095328937973738049703,  -0.0016882755560235047313, 0.0024914420961078508066,
        -0.0037512085075692412107,  0.005370914553590063617,    1.0052589676941592334,
        3.0838856104922207635};
    const double cbig[17] = {
        -2.7109920616438573243e-11, -2.5556418169965252055e-10, 1.5076572693500548083e-09,
        -3.7894654401267369937e-09, 7.6157012080783393804e-09,  -1.4960026627149240478e-08,
        2.9147953450901080826e-08,  -6.7711997758452339498e-08, 2.2900482228026654717e-07,
        -9.9298272942317002539e-07, 4.5260625972231537039e-06,  -1.9681778105531670567e-05,
        7.5995277030017761139e-05,  -0.00021503011930044477347, -0.00013871931833623122026,
        1.0103004648645343977,      4.8499064014085844221};
    double w = -log1p(__dmul_rn(x, -x));
    const bool lt625 = w < 6.25, lt16 = w < 16.0;
    w = lt625 ? __dsub_rn(w, 3.125) : __dsub_rn(__dsqrt_rn(w), lt16 ? 3.25 : 5.0);
    auto coef = [&](int i) {
      double v = c625[i];
      if (i < 19) v = lt625 ? v : c16[i];
      if (i < 17) v = lt16 ? v : cbig[i];
      return v;
    };
    double p = coef(0);
    for (int i = 1; i < 17; ++i) p = __dadd_rn(coef(i), __dmul_rn(p, w));
    for (int i = 17; i < 19; ++i) p = lt16 ? __dadd_rn(coef(i), __dmul_rn(p, w)) : p;
    for (int i = 19; i < 23; ++i) p = lt625 ? __dadd_rn(coef(i), __dmul_rn(p, w)) : p;
    return fabs(x) == 1.0 ? __dmul_rn(x, INFINITY) : __dmul_rn(p, x);
  }
  static __device__ __forceinline__ double sqrt2() { return 1.4142135623730951; }
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
};

template <typename Real>
__global__ void noise_kernel(const int64_t* __restrict__ t, uint2 tag,
                             const uint8_t* __restrict__ byzantine, const Real* __restrict__ x,
                             Real scale, Real* __restrict__ out, int64_t n, int64_t d) {
  launch_counts::add(kSlotNoise);
  __shared__ uint2 key;
  if (threadIdx.x == 0) key = round_key(tag, t);
  __syncthreads();
  const int64_t k = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (k >= n * d) return;
  const Real v = x[k];
  if (!byzantine[k / d]) {
    out[k] = v;
    return;
  }
  using N = Normal<Real>;
  const Real z = N::mul(N::sqrt2(), N::erf_inv(N::uniform(key, static_cast<uint32_t>(k))));
  out[k] = N::add(v, N::mul(scale, z));
}

inline int finish() { return static_cast<int>(cudaGetLastError()); }

template <typename Real>
int launch_noise(const void* t, uint32_t k0, uint32_t k1, const void* byzantine, const void* x,
                 double scale, void* out, int64_t n, int64_t d, void* stream) {
  if (n <= 0 || d <= 0 || n * d > (int64_t{1} << 32)) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (n * d + kThreads - 1) / kThreads;
  noise_kernel<Real><<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(t), make_uint2(k0, k1),
      static_cast<const uint8_t*>(byzantine), static_cast<const Real*>(x),
      static_cast<Real>(scale), static_cast<Real*>(out), n, d);
  return finish();
}

}  // namespace

extern "C" {

// One round at the counter *t. keys: k[0..5] = fault, node, match tag keys
// as word pairs. given (nullable): a realized A_t to score; a/active are
// then not written. scores (nullable): the one-peer proposal scores.
int realize_round(const void* t, const uint32_t* keys, const void* base, const void* given,
                  int64_t n, float p, float q, int drop, int strag, int directed, void* a,
                  void* active, void* scores, void* stream) {
  if (n <= 0 || n > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kCols, kRows);
  const dim3 grid(static_cast<unsigned>((n + kCols - 1) / kCols),
                  static_cast<unsigned>((n + kRows - 1) / kRows));
  realize_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(t), make_uint2(keys[0], keys[1]), make_uint2(keys[2], keys[3]),
      make_uint2(keys[4], keys[5]), static_cast<const uint8_t*>(base),
      static_cast<const float*>(given), static_cast<int>(n), p, q, drop, strag, directed,
      static_cast<float*>(a), static_cast<float*>(active), static_cast<float*>(scores));
  return finish();
}

// The timeline over t = 0 .. horizon - 1. keys: fault, node, participation
// tag keys. thresholds: edge (init, enter, stay), node (init, enter, stay),
// then p_out. A process with a count of 0 is off.
int fault_timeline(const uint32_t* keys, int64_t n, const void* edges, int64_t n_edges,
                   int64_t n_nodes, int64_t n_part, const float* thresholds, int64_t horizon,
                   void* edge_up, void* node_up, void* rejoin, void* part_up, void* stream) {
  if (n <= 0 || n > 65535 || horizon <= 0 || n_edges < 0 || n_nodes < 0 || n_part < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t total = n_edges + n_nodes + n_part;
  if (total == 0) return 0;
  const Chain edge{thresholds[0], thresholds[1], thresholds[2]};
  const Chain node{thresholds[3], thresholds[4], thresholds[5]};
  const int threads = 128;
  timeline_kernel<<<static_cast<unsigned>((total + threads - 1) / threads), threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      make_uint2(keys[0], keys[1]), make_uint2(keys[2], keys[3]), make_uint2(keys[4], keys[5]),
      static_cast<int>(n), static_cast<const int32_t*>(edges), static_cast<int>(n_edges), edge,
      static_cast<int>(n_nodes), node, static_cast<int>(n_part), thresholds[6], horizon,
      static_cast<uint8_t*>(edge_up), static_cast<uint8_t*>(node_up),
      static_cast<uint8_t*>(rejoin), static_cast<uint8_t*>(part_up));
  return finish();
}

int large_noise_f32(const void* t, uint32_t k0, uint32_t k1, const void* byzantine, const void* x,
                    double scale, void* out, int64_t n, int64_t d, void* stream) {
  return launch_noise<float>(t, k0, k1, byzantine, x, scale, out, n, d, stream);
}
int large_noise_f64(const void* t, uint32_t k0, uint32_t k1, const void* byzantine, const void* x,
                    double scale, void* out, int64_t n, int64_t d, void* stream) {
  return launch_noise<double>(t, k0, k1, byzantine, x, scale, out, n, d, stream);
}

}  // extern "C"
