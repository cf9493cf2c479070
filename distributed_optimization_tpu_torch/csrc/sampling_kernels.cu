// Per-worker mini-batch sampling for Hopper (sm_90a), with a plain C interface.
//
// No Pallas kernel stands behind these: they are the counterpart of the XLA
// code that distributed_optimization_tpu/ops/sampling.py compiles to, on the
// JAX package's random stream:
//   dense_kernel   sample_worker_batch_weights (:79), [N, L] weights, where a
//                  shard has at most 64 rows (every path that resolves to the
//                  dense form);
//   select_kernel  sample_worker_batches (:122): the top min(b, L) rows of
//                  each worker by lax.top_k, tiled up to b, their weights and,
//                  gathered, the batch's rows Xb [N, b, d] and yb [N, b]; the
//                  indices alone for sample_batch_indices (:56); and the dense
//                  weights of a shard longer than 64 rows;
//                  in its event mode, the asynchronous event clock's batches
//                  of a block of events (backends/async_scan.py:514-519: one
//                  sample_batch_indices at a per-event key, and the gather,
//                  for each event of the block).
// The plain versions are distributed_optimization_tpu_torch/ops/sampling.py
// (on the twin of jax.random in ops/prng.py); the kernels equal them bit for
// bit.
//
// One launch draws every worker's batch for one gradient call:
//   step key   = threefry2x32(slot key, (0, t mod 2^32))   t read from device memory
//   worker key = threefry2x32(step key, (0, worker))
//   row score  = threefry2x32(worker key, (0, row))        uniform's bits
// and takes each worker's rows in stable descending order of score (ties to
// the lower row), with b_eff = min(b, n_valid, L) and weight 1/b_eff.
//
// Bound: far below what a launch costs. The function's need is 1 + N + N * L
// Threefry calls (about 80 integer operations each) and a top-k selection,
// 0.066 us at the INT32 rate at the main path's N=256, L=49; at the parity
// path's N=25, L=500 the gathered rows set it, 0.079 us of bytes. What a
// launch takes is its latency: the load of t, the dependent chain of three
// Threefry calls (step key, worker key, row score), the selection's
// barriers and the copy's loads.
//
// Design:
// - One selection key a row, shared by both kernels: the score m + 1 (m the
//   integer mantissa uniform keeps, (x0 ^ x1) >> 9 for float32, (x0 << 32 |
//   x1) >> 12 for float64; uniform maps m to m * 2^-nmant, strictly
//   increasing, so order and ties are the float's; 0 on padding rows, the
//   plain version's -inf, below every valid row) packed above L - 1 - row
//   in ceil(log2 L) bits, left-aligned in the key word. Keys are distinct,
//   the largest first in the twin's stable order, ties to the lower row. The
//   word is 32 bits (float32) or 64 (float64) in dense_kernel; in
//   select_kernel 64 bits, or 128 for float64 past L = 2,048 (53 + 11 bits).
// - dense_kernel: one warp a worker, 4 workers a block, no shared memory and
//   no barrier. n_valid and t are loaded before the key chain; lane i holds
//   rows i and i + 32 (both Threefry calls in flight together); a row's rank
//   counts the warp's keys above its own, 64 of them through __shfl_sync;
//   each worker's L weights are one coalesced row.
// - select_kernel: one block a worker, a thread a row up to L = 1,024 and 8
//   rows a thread up to 8,192; above, a thread block cluster of 8 blocks of
//   1,024 threads with 8 rows a thread (L <= 65,536), the blocks sharing the
//   leader's (rank 0's) shared memory. Keys stay in registers; past 65,536
//   rows each thread takes ceil(L / 8,192) rows and recomputes their keys
//   (Threefry of the worker key and the row, and the row's validity) at
//   each pass instead. The k-th largest key is found by a radix select over
//   8-bit digits from the top (radix_select.cuh, shared with the compression
//   kernel): a 256-bin histogram of the candidates' digit (shared-memory
//   atomics), one warp of the leader scans it from the top for the bin that
//   holds the k-th key. Scores are uniform, so one pass leaves about k +
//   L/128 survivors (every row at or above that bin's lower bound); passes
//   go on while the survivors exceed k + 128 (ties; at most one pass a
//   digit). Only valid rows
//   take part: padding rows follow them in ascending order. The survivors
//   are compacted into shared memory and each counts the
//   survivors' keys above its own: its rank, the row's global rank. Then the
//   indices (top[j mod k], k = min(b, L)), the weights and the gathered rows
//   of X and y are written: the batch's b * (d + 1) values, every thread
//   copying in turn with kCopy loads in flight.
// - t comes from the int64 counter on the device that the run loop advances
//   in place, never from a launch argument, so one captured CUDA graph
//   serves every iteration; the slot key is two host words.
// - The weight is 1/max(b_eff, 1) in the run's type, rounded to float32 and
//   back (the JAX sampler returns float32 weights, which the run casts),
//   with the round-to-nearest intrinsics.
// - bfloat16 (the *_bf16 entry points): a bfloat16 run is no x64 run, so its
//   keys, scores (24 bits) and selection are the float32 run's, and its
//   weight is the float32 weight rounded to bfloat16; the gathered rows are
//   2-byte copies. The score type follows the key, the output type the run.
// - Every gathered value is copied as its bits; a label is y_bytes wide (the
//   C argument): the run dtype's (2, 4 or 8 bytes), or softmax's int32
//   class indices, which are int32 in every run dtype (bfloat16 would round
//   every odd label above 256).
// - The replica axis (the *_batch entry points): R replicas' slot keys, an
//   [R, 2] int64 array of words in device memory, in one launch, the
//   replica on the grid's y axis. Every replica reads the same shards (X,
//   y, n_valid) and writes its own [N, L] weights, or [N, b] indices,
//   weights and rows, at replica r * N + worker of [R, N, ...] outputs (and
//   of the workspace): replica r's bits are a single launch's with slot key
//   r. The single-run entry points pass their two words by value and no
//   array (R = 1).
//
// - The event mode (sample_event_*): one launch for a block of B events of
//   the event clock's schedule, before the block's first event, at tau
//   draws an event (the local descents); select_kernel's selection, a
//   block (p) of the grid for each of the B * tau draws, so the launch
//   fills the card where a launch an event kept one SM of 132 busy. Block
//   p reads the event cursor c from device memory, then event e = c + p /
//   tau's worker[e] and local_step[e] (int64 schedule arrays), and derives
//   the key in the kernel:
//     worker key = threefry2x32(base key, (0, worker))   base key = fold_in(
//     step key   = threefry2x32(worker key, (0, step))     key(seed), 0xA57E)
//     (descent m = m0 + p % tau: threefry2x32(step key, (0, m)) once more)
//   the worker first, then its own step count (the rounds fold t first).
//   An event's batch never depends on the models, so the whole block's are
//   drawn at once, each the per-event launch's bits (the same key chain,
//   selection and tie order). It writes the b indices and weights and,
//   optionally, gathers Xb [b, d] and yb [b] from the worker's shard, into
//   output p of buffers whose outputs are xstride (Xb) and vstride (idx,
//   w, yb) elements apart (the event clock pads them to 256 bytes, the
//   alignment a fresh tensor of the per-event launch had). An event at or
//   past the schedule's end draws no row (weights 0); the event clock never
//   asks for one. The cursor lives on the card, so a CUDA graph of many
//   events replays with the current one.
//
// Each launch adds one to its kernel's slot of launch_counts.cuh (slot 0 the
// dense weights, either kernel; 1 the gather form; 2 the event mode: the
// order of KERNELS in ops/sampling_kernels.py); select_top, an entry point for the tests that
// ranks given scores, counts nothing. The kernels allocate nothing, launch on
// the caller's stream and return cudaGetLastError().
// - Where a worker's survivors (min(b, L) + 128 keys and rows, and the top
//   k rows) do not fit in a block's 227 KB of shared memory beside the
//   selection state, they live in a global-memory workspace that the caller
//   allocates once (select_workspace_bytes_*: a 16-byte-aligned region a
//   worker), with the same selection and the same bits; a launch that needs
//   one and is given none returns cudaErrorInvalidValue.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include "launch_counts.cuh"
#include "radix_select.cuh"
#include "threefry.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kSlotWeights = 0;
constexpr int kSlotBatches = 1;
constexpr int kSlotEvents = 2;
constexpr int kNoSlot = -1;
constexpr int kWarpsPerBlock = 4;        // dense_kernel: workers a block
constexpr int kDenseMaxRows = 64;        // dense_kernel: two rows a lane
constexpr int kMaxThreads = 1024;
constexpr int kMaxCluster = 8;           // the portable cluster size
constexpr int kWideRows = 8;             // rows a thread past 1,024 rows
constexpr int kRecomputed = 0;           // rows a thread past 65,536: keys recomputed each pass
constexpr int kSurvivorSlack = 128;      // survivors beyond k that end the radix passes
constexpr int kCopy = 4;                 // gathered values a thread loads at once
constexpr size_t kDefaultSharedBytes = 48 * 1024;
constexpr size_t kMaxSharedBytes = 232448;  // 227 KB, the most a block takes on sm_90

// The mantissa uniform keeps, plus one (0 is the padding rows' score), in
// kBits bits; the dense kernel's key word; the weight.
template <typename Real>
struct Score;

template <>
struct Score<float> {
  static constexpr int kBits = 24;
  using DenseKey = uint32_t;
  static __device__ __forceinline__ uint64_t of(uint2 w) { return ((w.x ^ w.y) >> 9) + 1u; }
  static __device__ __forceinline__ float weight(int eff) {
    return __fdiv_rn(1.0f, static_cast<float>(eff));
  }
};

template <>
struct Score<double> {
  static constexpr int kBits = 53;
  using DenseKey = uint64_t;
  static __device__ __forceinline__ uint64_t of(uint2 w) {
    return ((static_cast<uint64_t>(w.x) << 20) | (w.y >> 12)) + 1ull;
  }
  static __device__ __forceinline__ double weight(int eff) {
    return static_cast<double>(__double2float_rn(__ddiv_rn(1.0, static_cast<double>(eff))));
  }
};

// A bfloat16 run keys as a float32 run (it is no x64 run): float32 scores
// of 24 bits and the float32 weight, cast to bfloat16 (the JAX package's
// float32 sampler output, cast to the run dtype).
template <>
struct Score<__nv_bfloat16> {
  static constexpr int kBits = 24;
  using DenseKey = uint32_t;
  static __device__ __forceinline__ uint64_t of(uint2 w) { return Score<float>::of(w); }
  static __device__ __forceinline__ __nv_bfloat16 weight(int eff) {
    return __float2bfloat16_rn(Score<float>::weight(eff));
  }
};

// b_eff = min(b, n_valid, L), and 0 for a negative n_valid.
__device__ __forceinline__ int effective(int64_t nv, int L, int b) {
  const int k = b < L ? b : L;
  return nv < 0 ? 0 : (nv < k ? static_cast<int>(nv) : k);
}

template <typename Real>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    dense_kernel(const int64_t* __restrict__ t, uint32_t k0, uint32_t k1,
                 const int64_t* __restrict__ keys, const int64_t* __restrict__ n_valid, int n,
                 int L, int b, Real* __restrict__ w) {
  launch_counts::add(kSlotWeights);
  using S = Score<Real>;
  using Key = typename S::DenseKey;
  const int lane = threadIdx.x & 31;
  const int worker = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (worker >= n) return;
  const int rep = blockIdx.y;
  if (keys != nullptr) {
    k0 = static_cast<uint32_t>(keys[2 * rep]);
    k1 = static_cast<uint32_t>(keys[2 * rep + 1]);
  }
  const int64_t nv = n_valid[worker];
  const uint32_t tt = static_cast<uint32_t>(*t);
  const uint2 step = threefry2x32(k0, k1, 0u, tt);
  const uint2 key = threefry2x32(step.x, step.y, 0u, static_cast<uint32_t>(worker));
  const int rbits = row_bits(L);
  Key mine[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int l = lane + 32 * h;
    const uint64_t score =
        l < nv ? S::of(threefry2x32(key.x, key.y, 0u, static_cast<uint32_t>(l))) : 0;
    // A row past L keeps key 0: it beats no row (the comparison is strict).
    mine[h] = l < L ? pack<Key, S::kBits>(score, static_cast<uint32_t>(L - 1 - l), rbits) : 0;
  }
  int rank[2] = {0, 0};
#pragma unroll
  for (int j = 0; j < 32; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const Key other = __shfl_sync(0xFFFFFFFFu, mine[h], j);
      rank[0] += other > mine[0];
      rank[1] += other > mine[1];
    }
  }
  const int eff = effective(nv, L, b);
  const Real inv = S::weight(max(eff, 1));
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int l = lane + 32 * h;
    if (l < L) w[(static_cast<int64_t>(rep) * n + worker) * L + l] = rank[h] < eff ? inv : Real{};
  }
}

// What select_kernel reads and writes; every output may be null.
template <typename Real>
struct Args {
  const int64_t* t;
  uint32_t k0, k1;
  const int64_t* keys;     // non-null: [R, 2] slot-key words, replica blockIdx.y's in place of k0, k1
  // The event mode (non-null cursor): block p of the grid draws event e =
  // *cursor + p / tau (its worker ev_worker[e] and step ev_step[e]) at
  // descent descent + p % tau (none where descent < 0), into output p;
  // k0, k1 the base key. An event at or past n_events draws nothing. t is
  // null there.
  const int64_t* cursor;
  const int64_t* ev_worker;
  const int64_t* ev_step;
  int64_t n_events;
  int descent, tau;
  int n, replicas;         // workers; replicas (the grid's y)
  const int64_t* n_valid;  // null: every row valid
  const uint64_t* scores;  // non-null: [N, L] scores in place of the draw (select_top)
  int L, b, d, slot;
  const Real* X;  // [N, L, d]; null: no rows gathered
  const void* y;  // [N, L] labels of y_bytes each (the run dtype's, or int32 class indices)
  int64_t* idx;   // [N, b]
  Real* w;        // [N, b], or [N, L] in the weights form
  Real* Xb;       // [N, b, d]
  void* yb;       // [N, b], y's type
  int y_bytes;    // 2, 4 or 8: a label is copied as its bits
  int64_t xstride, vstride;  // elements from one output's Xb, and idx, w, yb, to the next
  unsigned char* workspace;  // survivors past shared memory, ws_stride bytes a worker; or null
  int64_t ws_stride;
};

// The leader's selection state (radix_select.cuh) in shared memory; its
// survivors' keys and rows and the top k rows, in that order, after it, or
// in the worker's region of the workspace where shared memory cannot hold
// them (rounded up to 16 bytes there).
template <typename Key>
size_t survivor_bytes(int cap, int k) {
  return static_cast<size_t>(cap) * (sizeof(Key) + sizeof(int)) +
         static_cast<size_t>(k) * sizeof(int);
}

template <typename Key>
bool survivors_in_shared(int cap, int k) {
  return sizeof(State<Key>) + survivor_bytes<Key>(cap, k) <= kMaxSharedBytes;
}

template <typename Key>
int64_t workspace_stride(int cap, int k) {
  return static_cast<int64_t>((survivor_bytes<Key>(cap, k) + 15) / 16 * 16);
}

// A worker in one block: __syncthreads, and the block's own shared memory.
struct Block {
  static __device__ __forceinline__ void sync() { __syncthreads(); }
  static __device__ __forceinline__ int rank() { return 0; }
  static __device__ __forceinline__ int size() { return 1; }
  template <typename T>
  static __device__ __forceinline__ T* leader(T* p) { return p; }
};

// A worker over a thread block cluster: the cluster's barrier, and the
// leader's (rank 0's) shared memory through distributed shared memory.
struct Cluster {
  static __device__ __forceinline__ void sync() { cg::this_cluster().sync(); }
  static __device__ __forceinline__ int rank() {
    return static_cast<int>(cg::this_cluster().block_rank());
  }
  static __device__ __forceinline__ int size() {
    return static_cast<int>(cg::this_cluster().num_blocks());
  }
  template <typename T>
  static __device__ __forceinline__ T* leader(T* p) {
    return cg::this_cluster().map_shared_rank(p, 0);
  }
};

// An element's bits as an unsigned integer of its size.
template <typename Real> struct RawBits;
template <> struct RawBits<float> { using type = uint32_t; };
template <> struct RawBits<double> { using type = uint64_t; };
template <> struct RawBits<__nv_bfloat16> { using type = uint16_t; };

// Label i of y, y_bytes wide, as its bits; and back into yb.
__device__ __forceinline__ uint64_t load_label(const void* y, int64_t i, int y_bytes) {
  if (y_bytes == 2) return static_cast<const uint16_t*>(y)[i];
  if (y_bytes == 4) return static_cast<const uint32_t*>(y)[i];
  return static_cast<const uint64_t*>(y)[i];
}

__device__ __forceinline__ void store_label(void* yb, int64_t i, uint64_t bits, int y_bytes) {
  if (y_bytes == 2) {
    static_cast<uint16_t*>(yb)[i] = static_cast<uint16_t>(bits);
  } else if (y_bytes == 4) {
    static_cast<uint32_t*>(yb)[i] = static_cast<uint32_t>(bits);
  } else {
    static_cast<uint64_t*>(yb)[i] = bits;
  }
}

// The row at position i of a worker's order: the selection's, or past the
// valid rows, the padding row i.
__device__ __forceinline__ int top_row(const int* top, int i, int need) {
  return i < need ? top[i] : i;
}

// The batch's rows, b of d + 1 values (X's, then the label), in order,
// kCopy loads a thread in flight; (row, column) advance by the stride. Every
// value moves as its bits: X's as Bits, a label as Bits where kSame (it is
// as wide as an element), else as its y_bytes.
template <typename Bits, bool kSame>
__device__ __forceinline__ void gather_rows(const Bits* __restrict__ X, Bits* __restrict__ Xb,
                                            const void* y, void* yb, int64_t y0, int64_t yb0,
                                            int y_bytes, const int* top, int k, int need, int d,
                                            int b, int first, int stride) {
  using Value = std::conditional_t<kSame, Bits, uint64_t>;
  const Bits* __restrict__ ys = static_cast<const Bits*>(y) + y0;
  Bits* __restrict__ ybs = static_cast<Bits*>(yb) + yb0;
  const int width = d + 1, total = b * width;
  const int step_j = stride / width, step_c = stride - step_j * width;
  int j = first / width, c = first - j * width;
  for (int base = first; base < total; base += kCopy * stride) {
    Value v[kCopy];
    int at[kCopy];
#pragma unroll
    for (int u = 0; u < kCopy; ++u) {
      at[u] = c < d ? j * d + c : -1 - j;  // Xb's element, or -1 - yb's
      if (base + u * stride < total) {
        const int row = top_row(top, j < k ? j : j % k, need);
        if constexpr (kSame) {
          v[u] = c < d ? X[static_cast<int64_t>(row) * d + c] : ys[row];
        } else {
          v[u] = c < d ? static_cast<uint64_t>(X[static_cast<int64_t>(row) * d + c])
                       : load_label(y, y0 + row, y_bytes);
        }
      }
      c += step_c;
      j += step_j;
      if (c >= width) {
        c -= width;
        ++j;
      }
    }
#pragma unroll
    for (int u = 0; u < kCopy; ++u) {
      if (base + u * stride < total) {
        if (at[u] >= 0) {
          Xb[at[u]] = static_cast<Bits>(v[u]);
        } else if constexpr (kSame) {
          ybs[-1 - at[u]] = v[u];
        } else {
          store_label(yb, yb0 - 1 - at[u], v[u], y_bytes);
        }
      }
    }
  }
}

template <typename Real, typename Key, int R, typename Group, bool kWeights>
__global__ void __launch_bounds__(kMaxThreads) select_kernel(Args<Real> a, int cap) {
  if (a.slot != kNoSlot) launch_counts::add(a.slot);
  using S = Score<Real>;
  constexpr int kWidth = 8 * sizeof(Key);
  extern __shared__ __align__(16) unsigned char smem[];
  State<Key>* st = Group::leader(reinterpret_cast<State<Key>*>(smem));
  const int rank = Group::rank();
  const int pair = static_cast<int>(blockIdx.x) / Group::size();
  const int64_t event = a.cursor != nullptr ? *a.cursor + pair / a.tau : -1;
  // An event past the schedule's end (none on the event clock's path) draws
  // no row: worker 0 with no valid row, weights 0.
  const bool drawn = event >= 0 && event < a.n_events;
  const int worker = event >= 0 ? (drawn ? static_cast<int>(a.ev_worker[event]) : 0) : pair;
  // The worker's place in the [R, N, ...] outputs and the workspace (the
  // event mode's: its (event, descent) pair's).
  const int64_t out = event >= 0 ? pair : static_cast<int64_t>(blockIdx.y) * a.n + worker;
  Key* skey = a.workspace != nullptr
                  ? reinterpret_cast<Key*>(a.workspace + out * a.ws_stride)
                  : reinterpret_cast<Key*>(st + 1);
  int* srow = reinterpret_cast<int*>(skey + cap);
  int* top = srow + cap;
  const int L = a.L, b = a.b;
  const int64_t nv = event >= 0 && !drawn ? 0 : a.n_valid != nullptr ? a.n_valid[worker] : L;
  const uint32_t tt = a.t != nullptr ? static_cast<uint32_t>(*a.t) : 0u;
  if (rank == 0) {
    for (int i = threadIdx.x; i < kBins; i += blockDim.x) st->hist[i] = 0;
    if (threadIdx.x == 0) {
      st->prefix = 0;
      st->p = kWidth - 8;
      st->count = 0;
    }
  }
  const int eff = effective(nv, L, b);
  const int k = min(b, L);
  // Rows that take part: the valid ones. Padding rows (l >= n_valid) follow
  // every valid row in ascending order, so top[j] = j for n_valid <= j < k.
  const int valid = a.scores != nullptr ? L : effective(nv, L, L);
  const int need = kWeights ? eff : min(k, valid);
  if (threadIdx.x == 0 && rank == 0) st->krem = need;

  // Each thread's rows: R of them, their keys in registers; or, with R =
  // kRecomputed, rows first, first + stride, ..., each key recomputed where
  // it is read.
  uint2 wkey = make_uint2(0u, 0u);
  if (drawn) {
    const uint2 wk = threefry2x32(a.k0, a.k1, 0u, static_cast<uint32_t>(worker));
    wkey = threefry2x32(wk.x, wk.y, 0u, static_cast<uint32_t>(a.ev_step[event]));
    if (a.descent >= 0) {
      wkey = threefry2x32(wkey.x, wkey.y, 0u, static_cast<uint32_t>(a.descent + pair % a.tau));
    }
  } else if (a.scores == nullptr) {
    uint32_t k0 = a.k0, k1 = a.k1;
    if (a.keys != nullptr) {
      k0 = static_cast<uint32_t>(a.keys[2 * blockIdx.y]);
      k1 = static_cast<uint32_t>(a.keys[2 * blockIdx.y + 1]);
    }
    const uint2 step = threefry2x32(k0, k1, 0u, tt);
    wkey = threefry2x32(step.x, step.y, 0u, static_cast<uint32_t>(worker));
  }
  const int stride = Group::size() * blockDim.x;
  const int first = rank * blockDim.x + threadIdx.x;
  const int rbits = row_bits(L);
  auto key_of = [&](int l) -> Key {
    uint64_t score = 0;
    if (l < L) {
      if (a.scores != nullptr) {
        score = a.scores[static_cast<int64_t>(worker) * L + l];
      } else if (l < nv) {
        score = S::of(threefry2x32(wkey.x, wkey.y, 0u, static_cast<uint32_t>(l)));
      }
    }
    return pack<Key, S::kBits>(score, static_cast<uint32_t>(L - 1 - l), rbits);
  };
  Key keys[R > 0 ? R : 1];
#pragma unroll
  for (int r = 0; r < R; ++r) keys[r] = key_of(first + r * stride);
  // f(l, key) for each of this thread's rows l below limit.
  auto each = [&](int limit, auto&& f) {
    if constexpr (R > 0) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int l = first + r * stride;
        if (l < limit) f(l, keys[r]);
      }
    } else {
      for (int64_t l = first; l < limit; l += stride) {
        f(static_cast<int>(l), key_of(static_cast<int>(l)));
      }
    }
  };

  if (need > 0) {  // the same for every block of a worker
    Group::sync();
    // Radix select: narrow the candidates a digit a pass.
    for (;;) {
      const int p = st->p;
      const Key prefix = st->prefix;
      each(valid, [&](int, Key key) {
        if (((key >> p) >> 8) == prefix) {
          atomicAdd(&st->hist[static_cast<unsigned>(key >> p) & 0xFFu], 1u);
        }
      });
      Group::sync();
      if (rank == 0 && threadIdx.x < 32) scan_histogram(st, need, cap);
      Group::sync();
      if (st->done) break;
    }
    // Compact the survivors, rank each among them (its global rank).
    const int p = st->p;
    const Key lower = st->lower;
    each(valid, [&](int l, Key key) {
      if ((key >> p) >= lower) {
        const int at = atomicAdd(&st->count, 1);
        skey[at] = key;
        srow[at] = l;
      }
    });
    Group::sync();
    if (rank == 0) {
      const int survivors = st->count;
      for (int i = threadIdx.x; i < survivors; i += blockDim.x) {
        const Key mine = skey[i];
        int above = 0;
        for (int j = 0; j < survivors; ++j) above += skey[j] > mine;
        if (above < need) top[above] = srow[i];
        if (kWeights && above == need - 1) st->threshold = mine;
      }
    }
    Group::sync();
  }

  const Real inv = S::weight(max(eff, 1));
  if (kWeights) {
    const Key threshold = need > 0 ? st->threshold : Key(0);
    each(L, [&](int l, Key key) {
      a.w[out * L + l] = need > 0 && key >= threshold ? inv : Real{};
    });
  } else {
    for (int j = first; j < b; j += stride) {
      const int64_t at = out * a.vstride + j;
      if (a.idx != nullptr) a.idx[at] = top_row(top, j % k, need);
      if (a.w != nullptr) a.w[at] = j < eff ? inv : Real{};
    }
    if (a.X != nullptr) {
      using Bits = typename RawBits<Real>::type;
      const Bits* X = reinterpret_cast<const Bits*>(a.X) + static_cast<int64_t>(worker) * L * a.d;
      Bits* Xb = reinterpret_cast<Bits*>(a.Xb) + out * a.xstride;
      const int64_t y0 = static_cast<int64_t>(worker) * L, yb0 = out * a.vstride;
      // Labels as wide as an element (the run dtype's, or int32 beside
      // float32) move with the rows as Bits; others (int32 beside float64
      // or bfloat16) as their own width. The test is uniform.
      if (a.y_bytes == static_cast<int>(sizeof(Real))) {
        gather_rows<Bits, true>(X, Xb, a.y, a.yb, y0, yb0, a.y_bytes, top, k, need, a.d, b,
                                first, stride);
      } else {
        gather_rows<Bits, false>(X, Xb, a.y, a.yb, y0, yb0, a.y_bytes, top, k, need, a.d, b,
                                 first, stride);
      }
    }
  }
  // The leader's shared memory outlives every read of it.
  if (Group::size() > 1) Group::sync();
}

template <typename Real>
int launch_kernel(void (*kernel)(Args<Real>, int), int blocks, int cluster, int threads,
                  size_t bytes, const Args<Real>& a, int cap, void* stream) {
  if (bytes > kDefaultSharedBytes) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(blocks), static_cast<unsigned>(a.replicas));
  config.blockDim = dim3(static_cast<unsigned>(threads));
  config.dynamicSmemBytes = bytes;
  config.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attribute[1];
  attribute[0].id = cudaLaunchAttributeClusterDimension;
  attribute[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attribute[0].val.clusterDim.y = 1;
  attribute[0].val.clusterDim.z = 1;
  config.attrs = attribute;
  config.numAttrs = cluster > 1 ? 1 : 0;
  cudaError_t err = cudaLaunchKernelEx(&config, kernel, a, cap);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename Real, typename Key, bool kWeights>
int launch_select_key(const Args<Real>& a, int64_t n, void* stream, int forced_cluster) {
  const int L = a.L;
  const int k = std::min(a.b, L);
  const int cap = k + kSurvivorSlack;
  const bool shared = survivors_in_shared<Key>(cap, k);
  if (!shared && a.workspace == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  Args<Real> run = a;
  run.n = static_cast<int>(n);
  if (shared) run.workspace = nullptr;
  run.ws_stride = workspace_stride<Key>(cap, k);
  const size_t bytes = sizeof(State<Key>) + (shared ? survivor_bytes<Key>(cap, k) : 0);
  // The plan: one block a worker, a thread a row up to 1,024 rows and 8 rows a
  // thread up to 8,192; past that a cluster of 8 blocks of 1,024 threads, 8 rows
  // a thread up to 65,536 and past that ceil(L / 8,192) rows a thread, their
  // keys recomputed at each pass. One block beats a cluster of a thread a row
  // from 1,100 to 7,000 rows (chip_smoke.py's sampling phase times both,
  // forcing the cluster).
  const int cluster =
      forced_cluster > 0 ? forced_cluster : (L <= kMaxThreads * kWideRows ? 1 : kMaxCluster);
  const int64_t held = int64_t{cluster} * kMaxThreads * kWideRows;
  const int rows = L <= cluster * kMaxThreads ? 1 : L <= held ? kWideRows : kRecomputed;
  const int per_block = rows == kRecomputed ? kMaxThreads
                                            : (L + cluster * rows - 1) / (cluster * rows);
  // Enough threads that a block copies its batch's rows in one round.
  const int64_t copy = a.X != nullptr ? (a.b * (a.d + 1LL) + kCopy - 1) / kCopy : 0;
  const int threads = static_cast<int>(
      (std::min<int64_t>(kMaxThreads, std::max<int64_t>(per_block, copy)) + 31) / 32 * 32);
  if (n * cluster > 0x7FFFFFFF || a.replicas < 1 || a.replicas > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = static_cast<int>(n * cluster);
  if (cluster == 1) {
    return rows == 1 ? launch_kernel<Real>(select_kernel<Real, Key, 1, Block, kWeights>, blocks,
                                           1, threads, bytes, run, cap, stream)
                     : launch_kernel<Real>(select_kernel<Real, Key, kWideRows, Block, kWeights>,
                                           blocks, 1, threads, bytes, run, cap, stream);
  }
  if (rows == kRecomputed) {
    return launch_kernel<Real>(select_kernel<Real, Key, kRecomputed, Cluster, kWeights>, blocks,
                               cluster, threads, bytes, run, cap, stream);
  }
  return rows == 1 ? launch_kernel<Real>(select_kernel<Real, Key, 1, Cluster, kWeights>, blocks,
                                         cluster, threads, bytes, run, cap, stream)
                   : launch_kernel<Real>(select_kernel<Real, Key, kWideRows, Cluster, kWeights>,
                                         blocks, cluster, threads, bytes, run, cap, stream);
}

// The select kernel's key word: 64 bits, or 128 where a float64 score (53
// bits) and L - 1 - row do not fit in 64. forced_cluster: 0, the plan; 2, 4
// or 8, a cluster of that many blocks (select_top, to measure the plan).
template <typename Real, bool kWeights>
int launch_select(const Args<Real>& a, int64_t n, void* stream, int forced_cluster = 0) {
  if constexpr (Score<Real>::kBits + 31 > 64) {
    if (Score<Real>::kBits + row_bits(a.L) > 64) {
      return launch_select_key<Real, u128, kWeights>(a, n, stream, forced_cluster);
    }
  }
  return launch_select_key<Real, uint64_t, kWeights>(a, n, stream, forced_cluster);
}

// The workspace a launch of n workers needs (0: the survivors fit in shared
// memory), under the same key word as launch_select.
template <typename Real>
int64_t workspace_bytes(int64_t n, int64_t L, int64_t b) {
  if (n <= 0 || L <= 0 || b <= 0 || L > 0x7FFFFFFF || b > 0x7FFFFFFF) return 0;
  const int k = static_cast<int>(std::min(b, L));
  const int cap = k + kSurvivorSlack;
  auto need = [&](auto key) -> int64_t {
    using Key = decltype(key);
    return survivors_in_shared<Key>(cap, k) ? 0 : n * workspace_stride<Key>(cap, k);
  };
  if (Score<Real>::kBits + row_bits(static_cast<int>(L)) > 64) return need(u128{});
  return need(uint64_t{});
}

bool label_bytes_ok(int64_t y_bytes) { return y_bytes == 2 || y_bytes == 4 || y_bytes == 8; }

bool refused(int64_t n, int64_t L, int64_t b) {
  return L <= 0 || b <= 0 || n > 0x7FFFFFFF || L > 0x7FFFFFFF || b > 0x7FFFFFFF;
}

// keys: null (one run, its slot key k0, k1) or [replicas, 2] slot-key words.
template <typename Real>
int sample_weights(const void* t, uint32_t k0, uint32_t k1, const void* keys, int64_t replicas,
                   const void* n_valid, int64_t n, int64_t L, int64_t b, void* w,
                   void* workspace, void* stream) {
  if (n <= 0 || replicas == 0) return static_cast<int>(cudaSuccess);
  if (refused(n, L, b) || replicas < 0 || replicas > 65535 || (replicas > 1 && keys == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (L <= kDenseMaxRows) {
    const dim3 blocks(static_cast<unsigned>((n + kWarpsPerBlock - 1) / kWarpsPerBlock),
                      static_cast<unsigned>(replicas));
    dense_kernel<Real><<<blocks, kWarpsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int64_t*>(t), k0, k1, static_cast<const int64_t*>(keys),
        static_cast<const int64_t*>(n_valid), static_cast<int>(n), static_cast<int>(L),
        static_cast<int>(b), static_cast<Real*>(w));
    return static_cast<int>(cudaGetLastError());
  }
  Args<Real> a = {};
  a.t = static_cast<const int64_t*>(t);
  a.k0 = k0;
  a.k1 = k1;
  a.keys = static_cast<const int64_t*>(keys);
  a.replicas = static_cast<int>(replicas);
  a.n_valid = static_cast<const int64_t*>(n_valid);
  a.L = static_cast<int>(L);
  a.b = static_cast<int>(b);
  a.slot = kSlotWeights;
  a.w = static_cast<Real*>(w);
  a.workspace = static_cast<unsigned char*>(workspace);
  return launch_select<Real, true>(a, n, stream);
}

template <typename Real>
int sample_batches(const void* t, uint32_t k0, uint32_t k1, const void* keys, int64_t replicas,
                   const void* n_valid, int64_t n, int64_t L, int64_t b, int64_t d,
                   const void* X, const void* y, void* idx, void* w, void* Xb, void* yb,
                   int64_t y_bytes, void* workspace, void* stream) {
  if (n <= 0 || replicas == 0) return static_cast<int>(cudaSuccess);
  if (refused(n, L, b) || (X != nullptr && (d <= 0 || d > 0x7FFFFFFF || b * (d + 1) > 0x7FFFFFFF ||
                                           !label_bytes_ok(y_bytes))) ||
      replicas < 0 || replicas > 65535 || (replicas > 1 && keys == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args<Real> a = {};
  a.t = static_cast<const int64_t*>(t);
  a.k0 = k0;
  a.k1 = k1;
  a.keys = static_cast<const int64_t*>(keys);
  a.replicas = static_cast<int>(replicas);
  a.n_valid = static_cast<const int64_t*>(n_valid);
  a.L = static_cast<int>(L);
  a.b = static_cast<int>(b);
  a.d = static_cast<int>(d);
  a.slot = kSlotBatches;
  a.xstride = b * d;
  a.vstride = b;
  a.X = static_cast<const Real*>(X);
  a.y = y;
  a.idx = static_cast<int64_t*>(idx);
  a.w = static_cast<Real*>(w);
  a.Xb = static_cast<Real*>(Xb);
  a.yb = yb;
  a.y_bytes = static_cast<int>(y_bytes);
  a.workspace = static_cast<unsigned char*>(workspace);
  return launch_select<Real, false>(a, n, stream);
}

// The event mode: the batches of the events *cursor .. *cursor + events - 1,
// tau draws an event (descents descent .. descent + tau - 1, or one draw
// with no descent folded where descent is -1), output p = event * tau +
// descent at p * xstride of Xb and p * vstride of idx, w and yb (see Args).
template <typename Real>
int sample_event(const void* cursor, const void* workers, const void* steps, int64_t n_events,
                 int64_t events, int64_t tau, int64_t descent, uint32_t k0, uint32_t k1,
                 const void* n_valid, int64_t L, int64_t b, int64_t d, const void* X,
                 const void* y, void* idx, void* w, void* Xb, void* yb, int64_t y_bytes,
                 int64_t xstride, int64_t vstride, void* workspace, void* stream) {
  if (cursor == nullptr || workers == nullptr || steps == nullptr || n_valid == nullptr ||
      refused(1, L, b) || events < 1 || tau < 1 || events * tau > 0x7FFFFFFF ||
      descent < -1 || (descent == -1 && tau != 1) || descent + tau > 0x7FFFFFFF ||
      n_events < 0 || vstride < b ||
      (X != nullptr && (d <= 0 || d > 0x7FFFFFFF || b * (d + 1) > 0x7FFFFFFF || xstride < b * d ||
                        !label_bytes_ok(y_bytes)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args<Real> a = {};
  a.k0 = k0;
  a.k1 = k1;
  a.replicas = 1;
  a.cursor = static_cast<const int64_t*>(cursor);
  a.ev_worker = static_cast<const int64_t*>(workers);
  a.ev_step = static_cast<const int64_t*>(steps);
  a.n_events = n_events;
  a.descent = static_cast<int>(descent);
  a.tau = static_cast<int>(tau);
  a.n_valid = static_cast<const int64_t*>(n_valid);
  a.L = static_cast<int>(L);
  a.b = static_cast<int>(b);
  a.d = static_cast<int>(d);
  a.slot = kSlotEvents;
  a.X = static_cast<const Real*>(X);
  a.y = y;
  a.idx = static_cast<int64_t*>(idx);
  a.w = static_cast<Real*>(w);
  a.Xb = static_cast<Real*>(Xb);
  a.yb = yb;
  a.y_bytes = static_cast<int>(y_bytes);
  a.xstride = xstride;
  a.vstride = vstride;
  a.workspace = static_cast<unsigned char*>(workspace);
  return launch_select<Real, false>(a, events * tau, stream);
}

template <typename Real>
int select_top(const void* scores, int64_t n, int64_t L, int64_t b, int64_t cluster, void* idx,
               void* workspace, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (refused(n, L, b) || (cluster != 0 && cluster != 2 && cluster != 4 && cluster != 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args<Real> a = {};
  a.replicas = 1;
  a.scores = static_cast<const uint64_t*>(scores);
  a.L = static_cast<int>(L);
  a.b = static_cast<int>(b);
  a.slot = kNoSlot;
  a.vstride = b;
  a.idx = static_cast<int64_t*>(idx);
  a.workspace = static_cast<unsigned char*>(workspace);
  return launch_select<Real, false>(a, n, stream, static_cast<int>(cluster));
}

}  // namespace

extern "C" {

// Each entry point's workspace (nullable): select_workspace_bytes_* of its
// (R * N, L, b) bytes on the card (sample_event: (1, L, b)), where that is
// not 0. The *_batch forms take the replica axis: keys, [R, 2] int64
// slot-key words on the card. sample_event's cursor, workers and steps are
// int64 on the card, its base key two words, descent -1 for none; any of
// idx, w, Xb (with yb) may be null, X null for no gather.
#define SAMPLING_ENTRY_POINTS(Real, suffix)                                                      \
  int sample_weights_##suffix(const void* t, uint32_t k0, uint32_t k1, const void* n_valid,      \
                              int64_t n, int64_t L, int64_t b, void* w, void* workspace,         \
                              void* stream) {                                                    \
    return sample_weights<Real>(t, k0, k1, nullptr, 1, n_valid, n, L, b, w, workspace, stream);  \
  }                                                                                              \
  int sample_weights_batch_##suffix(const void* t, const void* keys, int64_t replicas,           \
                                    const void* n_valid, int64_t n, int64_t L, int64_t b,        \
                                    void* w, void* workspace, void* stream) {                    \
    return sample_weights<Real>(t, 0u, 0u, keys, replicas, n_valid, n, L, b, w, workspace,       \
                                stream);                                                         \
  }                                                                                              \
  int sample_indices_##suffix(const void* t, uint32_t k0, uint32_t k1, const void* n_valid,      \
                              int64_t n, int64_t L, int64_t b, void* idx, void* w,               \
                              void* workspace, void* stream) {                                   \
    return sample_batches<Real>(t, k0, k1, nullptr, 1, n_valid, n, L, b, 0, nullptr, nullptr,    \
                                idx, w, nullptr, nullptr, 0, workspace, stream);                 \
  }                                                                                              \
  int sample_indices_batch_##suffix(const void* t, const void* keys, int64_t replicas,           \
                                    const void* n_valid, int64_t n, int64_t L, int64_t b,        \
                                    void* idx, void* w, void* workspace, void* stream) {         \
    return sample_batches<Real>(t, 0u, 0u, keys, replicas, n_valid, n, L, b, 0, nullptr,         \
                                nullptr, idx, w, nullptr, nullptr, 0, workspace, stream);        \
  }                                                                                              \
  int sample_batches_##suffix(const void* t, uint32_t k0, uint32_t k1, const void* n_valid,      \
                              int64_t n, int64_t L, int64_t b, int64_t d, const void* X,         \
                              const void* y, void* w, void* Xb, void* yb, int64_t y_bytes,       \
                              void* workspace, void* stream) {                                   \
    return sample_batches<Real>(t, k0, k1, nullptr, 1, n_valid, n, L, b, d, X, y, nullptr, w,    \
                                Xb, yb, y_bytes, workspace, stream);                             \
  }                                                                                              \
  int sample_batches_batch_##suffix(const void* t, const void* keys, int64_t replicas,           \
                                    const void* n_valid, int64_t n, int64_t L, int64_t b,        \
                                    int64_t d, const void* X, const void* y, void* w, void* Xb,  \
                                    void* yb, int64_t y_bytes, void* workspace, void* stream) {  \
    return sample_batches<Real>(t, 0u, 0u, keys, replicas, n_valid, n, L, b, d, X, y, nullptr,   \
                                w, Xb, yb, y_bytes, workspace, stream);                          \
  }

// The event mode: float32 and float64 (the event clock has no bfloat16 run).
#define SAMPLING_EVENT_ENTRY_POINT(Real, suffix)                                                 \
  int sample_event_##suffix(const void* cursor, const void* workers, const void* steps,          \
                            int64_t n_events, int64_t events, int64_t tau, int64_t descent,      \
                            uint32_t k0, uint32_t k1, const void* n_valid, int64_t L, int64_t b, \
                            int64_t d, const void* X, const void* y, void* idx, void* w,         \
                            void* Xb, void* yb, int64_t y_bytes, int64_t xstride,                \
                            int64_t vstride, void* workspace, void* stream) {                    \
    return sample_event<Real>(cursor, workers, steps, n_events, events, tau, descent, k0, k1,    \
                              n_valid, L, b, d, X, y, idx, w, Xb, yb, y_bytes, xstride, vstride, \
                              workspace, stream);                                                \
  }

SAMPLING_ENTRY_POINTS(float, f32)
SAMPLING_ENTRY_POINTS(double, f64)
SAMPLING_ENTRY_POINTS(__nv_bfloat16, bf16)
SAMPLING_EVENT_ENTRY_POINT(float, f32)
SAMPLING_EVENT_ENTRY_POINT(double, f64)

// For the tests and the plan's measurement: the top rows of given scores
// ([N, L] uint64, 0 for padding, at most 2^23 in f32 and 2^52 in f64),
// tiled to b, as the gather form selects them, under the launcher's plan
// (cluster 0) or a cluster of 2, 4 or 8 blocks; counts no launch.
int select_top_f32(const void* scores, int64_t n, int64_t L, int64_t b, int64_t cluster,
                   void* idx, void* workspace, void* stream) {
  return select_top<float>(scores, n, L, b, cluster, idx, workspace, stream);
}
int select_top_f64(const void* scores, int64_t n, int64_t L, int64_t b, int64_t cluster,
                   void* idx, void* workspace, void* stream) {
  return select_top<double>(scores, n, L, b, cluster, idx, workspace, stream);
}
int select_top_bf16(const void* scores, int64_t n, int64_t L, int64_t b, int64_t cluster,
                    void* idx, void* workspace, void* stream) {
  return select_top<__nv_bfloat16>(scores, n, L, b, cluster, idx, workspace, stream);
}
// The workspace bytes a launch over N workers of L rows and batch b needs in
// float32 / float64 (R * N workers on the replica axis): 0 where every
// worker's survivors fit in shared memory.
int64_t select_workspace_bytes_f32(int64_t n, int64_t L, int64_t b) {
  return workspace_bytes<float>(n, L, b);
}
int64_t select_workspace_bytes_f64(int64_t n, int64_t L, int64_t b) {
  return workspace_bytes<double>(n, L, b);
}
int64_t select_workspace_bytes_bf16(int64_t n, int64_t L, int64_t b) {
  return workspace_bytes<__nv_bfloat16>(n, L, b);
}

}  // extern "C"
