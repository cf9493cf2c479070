// The fault and noise draws for Hopper (sm_90a), with a plain C interface.
//
// No Pallas kernel stands behind these: they are the counterpart of the XLA
// code that jax.random compiles to inside distributed_optimization_tpu's
// fault layer and large-noise attack, on the JAX package's random stream:
//   round_kernel     one round's mixing operands at the device counter t:
//                    the whole of the JAX package's mix(t, x) up to the
//                    product (parallel/faults.py :1098-1101, with
//                    :951-986 realized_adjacency and active, :223-246
//                    sample_surviving_adjacency and its directed twin,
//                    :269-281 metropolis_hastings_weights, :248-266
//                    column_stochastic_weights, :334-348 the one-peer
//                    scores, :1109 realized_degree_sum): A_t [N, N]
//                    float32 with the node mask applied, W_t [N, N] in the
//                    run's accumulation type, active [N] float32, the
//                    round's realized degree count added to the run's
//                    float64 total, and the one-peer proposal scores u * A_t
//                    where asked; from the memoryless draws, or from a
//                    precomputed timeline's edge and node states at t (its
//                    row index clamped into [0, T) as JAX's dynamic index
//                    is: t < 0 counts from the end);
//   timeline_draw_kernel, timeline_scan_kernel
//                    build_fault_timeline (:419-587): the per-edge
//                    Gilbert-Elliott chains, the crash-recovery node chains
//                    and the participation stream, unrolled over t; the
//                    edge chains draw on the dense form's stream (edge
//                    (i, j) at i * N + j) or, for a matrix-free graph, on
//                    its per-edge stream (edge e at e, :489-503);
//   slot_live_kernel, slot_weight_kernel
//                    one round of the matrix-free (gather) fault form
//                    (_make_gather_faulty_mixing, :1133-1300) read from a
//                    timeline at t: the live slots [N, k] float32 of the
//                    neighbour table, active [N], the MH slot weights
//                    w [N, k] and w_self [N] in the run's accumulation type
//                    and the round's degree count, with no [N, N] object;
//                    the first alone, over any caller's table and mask, is
//                    make_neighbor_liveness (:1249-1283);
//   noise_kernel     the large_noise payload (parallel/adversary.py
//                    :118-130): x + s * sqrt(2) * erf_inv(u) on the
//                    Byzantine rows, u jax.random.normal's uniform at the
//                    element's 64-bit counter i * d + j.
// The plain versions are distributed_optimization_tpu_torch/ops/draw_kernels.py
// (on the twin of jax.random in ops/prng.py); the kernels equal them bit for
// bit on the card.
//
// The draws:
//   round key      = threefry2x32(tag key, (0, t mod 2^32))
//   float32 u      = ((x0 ^ x1) >> 9) * 2^-23 at counter c, (x0, x1) =
//                    threefry2x32(round key, (0, c))
//   counter c      Threefry's counter words (c >> 32, c mod 2^32), as
//                  jax's iota_2x32_shape splits a flat index: no size limit
//   edge (i, j)    counter i * N + j (64 bits; round_kernel forms it in
//                  32 bits up to N = 2^16, where it fits); an undirected
//                  edge reads its i < j entry from both ends (the
//                  triu(u, 1) + its transpose). The matrix-free per-edge
//                  stream: edge e of the [E, 2] edge list at counter e
//   node i         counter i of the node key's round draw
//   noise (i, j)   the words (k >> 32, k mod 2^32) of k = i * d + j, as
//                  jax's iota_2x32_shape gives them: no size limit
// An edge survives iff u >= p; a node is up iff u >= q (float32 thresholds).
// The timeline starts every chain from its stationary threshold at t = 0
// and then compares against P(down | up) or P(down | down); rejoin is up
// and not up the round before (all nodes up before t = 0).
//
// The round's weights. A slot of row i is live iff its base edge survives
// and both ends are up; d_i counts row i's live slots. Undirected (MH):
// W_ij = 1 / (1 + max(d_i, d_j)). Directed (adjacency[i, j] = 1 iff j sends
// to i): W_ij = 1 / (1 + outdeg_j), outdeg_j the live links out of j. The
// diagonal is 1 minus row i's sum (MH) or column i's (directed), summed in
// ascending neighbour order with each add rounded on its own, as the plain
// version's loop over the neighbour table's slots adds them. Divisions and
// adds are the _rn intrinsics (the build passes --fmad=false).
//
// The normal: u = max(lo, f * (1 - lo) + lo), f the uniform's [0, 1) float
// of its bits (32, or 64 in float64) and lo the float after -1 toward 0;
// then sqrt(2) * erf_inv(u), erf_inv the polynomial XLA lowers lax.erf_inv
// to (Giles: 9 coefficients in float32; 23, 19 or 17 in float64), every
// product and sum rounded on its own (the _rn intrinsics; the build passes
// --fmad=false), log1p and sqrt the CUDA math library's.
//
// Bound of round_kernel: bytes. At main's N=256 in float32 it writes A_t and
// W_t (2 x 256 KB) and reads the neighbour table, about 0.16 us at 3.35
// TB/s; its draws (k_max^2 + k_max a row) are far below the INT32 rate. What
// a launch takes is its latency: the load of t, the round keys, the slot
// draws and the neighbours' degrees, and the row writes.
//
// Design.
// - round_kernel: a warp a row. Each warp folds its own round keys, one lane
//   a key (lane 0 the fault key, 1 the node key, 2 the match key, each only
//   where its process is on), shared by __shfl_sync: no shared-memory round
//   trip and no barrier before the rows. The warp writes its rows of A_t,
//   W_t and the scores with zeros, then, lanes over the slots of a
//   neighbour table built once on the host (in-lists, and out-lists on a
//   directed graph; an edge-id table of the same shape on the timeline
//   path), draws only on base edges. d_i is a ballot count; the neighbours'
//   degrees d_j are recomputed from j's own slots, the warp's lanes spread
//   over the (slot, entry) pairs so that a chunk's draws run at once: an
//   edge's draw is keyed on its (lo, hi) counter, so both ends see the same
//   bit, at k_max^2 draws a row and with no grid-wide sync. A link's draw
//   and its ends' node draws are issued together (no short-circuit chain).
//   The diagonal's sum walks the slots in order through __shfl_sync. Each
//   block adds its rows' degree count to the run's total with one atomicAdd
//   (whole numbers, so exact in any order). A second form that shared the
//   degrees through a thread block cluster's distributed shared memory lost
//   or tied at every shape timed (PERF.md section 6) and was taken out.
//   Up to N = 2^16 the kernel's instance forms the pair counters in 32
//   bits (the same bits; the 64-bit products cost 3.5% at main's shape).
// - the timeline: a chain's draws do not depend on its state, only its
//   compare does. So round s of a chain is a map of {down, up} to itself
//   (two bits), maps compose associatively, and the chain is a scan over
//   maps drawn all at once. Two launches on the stream. The draw pass takes
//   a tile of 128 rounds and 32 entities of one stream a block: the tile's
//   round keys folded once, a thread each, into shared memory (one a
//   stream and round, not one a chain and round), then lane l draws entity
//   l over its warp's segment of 16 rounds (16 independent Threefry calls in
//   flight), writes each round's map into the output, and the block
//   composes its 8 segments into a byte a chain of the caller's carry
//   workspace; participation writes its states. The scan pass enters each
//   tile with the composition of the tiles before it (each warp composes an
//   eighth of them), each segment past the segments before it, and applies
//   its maps in order over the map bytes, writing the states and rejoin.
//   Every write [t, entity] is coalesced across a warp. Bound: operations
//   (a Threefry call an entity and round); at main's shape (ring N = 256,
//   T = 30,000, bursty edges and churn, 512 chains) ~74.6 us of integer
//   operations against ~23 MB of output.
// - the noise: an element a thread, each at its 64-bit counter k = i * d + j,
//   the grid as large as the stack (its y axis past the x axis's limit).
//   The block's first thread folds the round key while every thread loads
//   its element and its row's flag (a division by d) and stores an honest
//   element; then one barrier and the draw. At the path's 64 x 11 a launch
//   is its latency. Other layouts were measured and not kept (PERF.md
//   section 6): a warp a row with 16-byte packs and a 2-D grid an element a
//   thread were slower or tied at 64 x 11; a 2-D grid of row slices with
//   16-byte packs was faster only at stacks of 16 MiB and more, which no
//   path runs; a grid-stride loop (a second copy of the draw) was slower at
//   the wide stacks. Bound: bytes (x read, out written).
//
// - the slot round: two launches, the work following each row's real
//   slots (cnt[i]), not k_max. The live pass takes a group of 8 lanes a
//   row (2 where k_max <= 2), lane l at slots l, l + 8, ..., so a group's
//   table reads and live writes are contiguous and a warp serves 4 rows;
//   it reads only the real slots' table entries and gathers the
//   neighbours' node states and the edges' timeline states, 2 steps of
//   slots in flight a lane. A step's live flags are one ballot, which
//   gives the row's count d and its bit word with no atomics. It writes
//   live (every slot), active, d into an [R, N] int32 workspace and the
//   live bits into an [R, N, ceil(k / 32)] workspace, and adds the block's
//   degree count to the total. The weight pass takes a thread a row: it
//   walks the row's live slots off its bit words (8 bytes a row at k_max
//   38, not a float array of k_max), 8 at a time (their neighbours, then
//   those rows' counts, in flight together), writes w = 1 / (1 + max(d_i,
//   d_nbr)) into a zeroed [rows, k] tile in shared memory that the block
//   copies out coalesced, and adds them in ascending slot order in its
//   registers (a padded or dead slot's +0 is skipped: a sum of weights >=
//   +0 is the same with it), then w_self. d_nbr is another row's count,
//   and the grid has no global sync, hence the two launches; recounting
//   each neighbour's slots would take k_max^2 gathers a row. Measured at
//   [100,000, 38], in a graph (PERF.md section 6): the first design, a warp
//   a row over all k_max slots, lane 0's sum through k_max dependent shuffles, 79.670
//   us; a slot a thread over blocks of rows with shared-memory atomics,
//   54.716 us; a thread a row in both passes, 42.784 us (its live pass
//   bound by the L1 requests of 32 rows' table lines a load: it took as
//   long with no timeline); a group a row in both, 44.8 us (the weight
//   pass 17.7 against 13.3 a thread a row). With a caller's mask
//   (slot_liveness: any neighbour table, its real slots not a prefix) the
//   live pass alone runs and writes mask * [slot live] at every slot, the
//   JAX package's mask * edge_up * m_i * m_j bit for bit. Bound: bytes (the
//   tables' real slots, the timeline row's gathers and the [N, k] outputs).
//
// The replica axis (run_batch). round_kernel takes R replicas' rounds in one
// launch, the replica on the grid's y axis: replica r folds its own 6 key
// words and compares against its own drop threshold, both read from device
// memory ([R, 6] int64 words, [R] float32; a by-value table in the argument
// struct would cap R at the 4 KB parameter space), reads its own [T, E] /
// [T, N] slices of [R, T, ...] timeline states and writes its own [N, N]
// and [N] slices of [R, ...] outputs and its own float64 degree total.
// noise_kernel takes R tag keys ([R, 2] words) and [R, N] flags on the
// grid's z axis, each replica on blocks of its own, since a block folds one
// key and N * d need not be a multiple of the block. Replica r's bits are a
// single launch's with replica r's keys; the single run passes its keys by
// value and no arrays (R = 1). The timeline needs no axis: a run builds it
// once, a launch pair a replica.
//
// The slot round takes the replica on grid y the same way: [R, T, ...]
// timeline states, [R, ...] outputs and workspace, an [R] degree total.
//
// Each launch adds one to its kernel's slot of launch_counts.cuh (0 the
// round, 1 timeline (both passes), 2 noise, 3 the slot round (both
// passes): the order of KERNELS in ops/draw_kernels.py). The kernels allocate nothing, launch on the caller's
// stream and return cudaGetLastError(); arguments they cannot take return
// cudaErrorInvalidValue.

#include <cuda_runtime.h>

#include <algorithm>
#include <cmath>
#include <cstdint>

#include "launch_counts.cuh"
#include "threefry.cuh"

namespace {

constexpr int kSlotRealize = 0;
constexpr int kSlotTimeline = 1;
constexpr int kSlotNoise = 2;
constexpr int kSlotSlotRound = 3;
constexpr int kThreads = 256;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kRoundWarps = 4;  // round_kernel: rows (warps) a block
constexpr int kRoundThreads = 32 * kRoundWarps;
constexpr int64_t kMaxRows = 0x7FFFFFFF;  // int32 neighbour tables

__device__ __forceinline__ uint2 round_key_at(uint2 tag, int64_t t) {
  return threefry2x32(tag.x, tag.y, 0u, static_cast<uint32_t>(static_cast<uint64_t>(t)));
}

// The float32 uniform on [0, 1) of a draw's words: the top 23 bits of x0 ^ x1
// times 2^-23.
__device__ __forceinline__ float unit32(uint2 w) {
  return __fsub_rn(__uint_as_float(((w.x ^ w.y) >> 9) | 0x3F800000u), 1.0f);
}

// The float32 uniform at the 64-bit counter c (below 2^32 its high word is
// 0: the bits of the 32-bit counter).
__device__ __forceinline__ float uniform32(uint2 key, uint64_t c) {
  return unit32(threefry_at(key.x, key.y, c));
}

// ---- one round ------------------------------------------------------------

// What the round kernel reads and writes. ops/draw_kernels.py mirrors it
// field for field as a ctypes Structure.
struct RoundArgs {
  const int64_t* t;        // the round's counter, read from device memory
  const int32_t* in_nbr;   // [N, k_in]: row i's base neighbours j (senders), ascending
  const int32_t* in_cnt;   // [N]: row i's real slots
  const int32_t* in_eid;   // [N, k_in]: each slot's timeline edge id, or null
  const int32_t* out_nbr;  // [N, k_out]: node j's receivers, ascending (directed; else null)
  const int32_t* out_cnt;  // [N]
  const int32_t* out_eid;  // [N, k_out], or null
  const uint8_t* edge_up;  // [T, E] the timeline's edge states, or null
  const uint8_t* node_up;  // [T, N] the timeline's node chain, or null
  const uint8_t* part_up;  // [T, N] the participation stream, or null
  float* a;                // [N, N] A_t
  float* active;           // [N]
  void* w;                 // [N, N] W_t in Real, or null
  float* scores;           // [N, N] the one-peer proposal scores, or null
  double* degree_total;    // the run's sum of realized degrees, or null
  int64_t n, k_in, k_out, n_edges;
  int64_t horizon;         // T, the timeline's rows (0 without one)
  uint32_t keys[6];        // fault, node, match tag keys
  float p, q;              // the drop and straggler thresholds
  int32_t drop, strag, directed;
  const int64_t* rkeys;    // [R, 6] key words, replica blockIdx.y's in place of keys; or null
  const float* rp;         // [R] drop thresholds in place of p; or null
  int64_t replicas;        // R, the grid's y (1: the single run)
};

template <typename Real>
struct Rn;

template <>
struct Rn<float> {
  static __device__ __forceinline__ float add(float x, float y) { return __fadd_rn(x, y); }
  static __device__ __forceinline__ float sub(float x, float y) { return __fsub_rn(x, y); }
  static __device__ __forceinline__ float div(float x, float y) { return __fdiv_rn(x, y); }
};

template <>
struct Rn<double> {
  static __device__ __forceinline__ double add(double x, double y) { return __dadd_rn(x, y); }
  static __device__ __forceinline__ double sub(double x, double y) { return __dsub_rn(x, y); }
  static __device__ __forceinline__ double div(double x, double y) { return __ddiv_rn(x, y); }
};

__device__ __forceinline__ uint2 shfl2(uint2 v, int lane) {
  return make_uint2(__shfl_sync(kFull, v.x, lane), __shfl_sync(kFull, v.y, lane));
}

// The uniform of the pair (lo, hi) at the counter lo * N + hi: its 64-bit
// product (kWide), or, up to 2^16 nodes, the 32-bit product with the high
// word 0 (the same bits, without the 64-bit multiply and the high word's
// draw input: round_kernel takes this instance whenever N allows it).
template <bool kWide>
__device__ __forceinline__ float pair_uniform(uint2 key, int lo, int hi, int64_t n) {
  if constexpr (kWide) {
    return uniform32(key, static_cast<uint64_t>(lo) * static_cast<uint64_t>(n) +
                              static_cast<uint64_t>(hi));
  } else {
    return unit32(threefry2x32(key.x, key.y, 0u,
                               static_cast<uint32_t>(lo) * static_cast<uint32_t>(n) +
                                   static_cast<uint32_t>(hi)));
  }
}

// The widest N whose pair counters (N - 1) * N + N - 1 = N^2 - 1 fit 32 bits.
constexpr int64_t kNarrowNodes = 65536;

// The round at t: its keys, and the liveness of nodes and links. tt is the
// timeline's row at t.
template <bool kWide>
struct Round {
  RoundArgs a;
  uint2 fkey, nkey, mkey;
  int64_t tt;

  // Node i is up: the timeline's states at t, else its straggler draw.
  __device__ __forceinline__ bool up(int i) const {
    if (a.node_up != nullptr || a.part_up != nullptr) {
      const int64_t at = tt * a.n + i;
      return (a.node_up == nullptr || a.node_up[at] != 0) &&
             (a.part_up == nullptr || a.part_up[at] != 0);
    }
    return !a.strag || uniform32(nkey, static_cast<uint32_t>(i)) >= a.q;
  }

  // The base link into i from j survives: the timeline's edge e at t, else
  // the draw at (i, j) (directed) or (min, max) (undirected).
  __device__ __forceinline__ bool link(int i, int j, int e) const {
    if (a.edge_up != nullptr) return a.edge_up[tt * a.n_edges + e] != 0;
    if (!a.drop) return true;
    const int lo = a.directed ? i : min(i, j);
    const int hi = a.directed ? j : max(i, j);
    return pair_uniform<kWide>(fkey, lo, hi, a.n) >= a.p;
  }

  // The lists a node's degree counts: its slots (undirected) or its
  // out-links (directed), with their timeline edge ids.
  __device__ __forceinline__ int64_t deg_k() const { return a.directed ? a.k_out : a.k_in; }
  __device__ __forceinline__ const int32_t* deg_nbr() const {
    return a.directed ? a.out_nbr : a.in_nbr;
  }
  __device__ __forceinline__ const int32_t* deg_cnt() const {
    return a.directed ? a.out_cnt : a.in_cnt;
  }
  __device__ __forceinline__ const int32_t* deg_eid() const {
    return a.directed ? a.out_eid : a.in_eid;
  }

  // Entry m of up node j's list is live: the link between j and its
  // neighbour q survives and q is up (both draws issued together).
  __device__ __forceinline__ bool deg_live(int j, int m) const {
    const int64_t at = j * deg_k() + m;
    const int q = deg_nbr()[at];
    const int e = deg_eid() != nullptr ? deg_eid()[at] : 0;
    return (a.directed ? link(q, j, e) : link(j, q, e)) & up(q);
  }

  // Neighbours' degrees, recomputed from their draws: for a chunk of up to
  // 32 slots (lane l holding slot l, its neighbour live where bit l of
  // live_mask is set), each live neighbour's degree. The warp's lanes
  // spread over the (slot, entry) pairs, k_max entries a slot, kPairGroups
  // chunks of 32 pairs at once so that their draws are in flight together;
  // lane l adds the ballot bits of slot l's pairs.
  __device__ int slot_degrees(const int32_t* slots, int nslots, unsigned live_mask,
                              int lane) const;
};

// The timeline's row at t, as JAX indexes an array of T rows with a traced
// t: t < 0 counts from the end, then the index is clamped into [0, T).
__device__ __forceinline__ int64_t timeline_row(int64_t t, int64_t horizon) {
  if (t < 0) t += horizon;
  return t < 0 ? 0 : t < horizon ? t : horizon - 1;
}

// Each warp folds its own round keys, a lane a key. On the replica axis
// (kReplicas: rkeys non-null), replica blockIdx.y's keys and threshold, and
// its slices of the timeline and the outputs (W_t's, typed, in
// round_kernel); the single run's instance has none of that code.
template <bool kReplicas, bool kWide>
__device__ __forceinline__ Round<kWide> make_round(const RoundArgs& a, int lane) {
  Round<kWide> r;
  r.a = a;
  const int64_t t = *a.t;
  r.tt = a.horizon > 0 ? timeline_row(t, a.horizon) : 0;
  const bool want = lane == 0 ? a.drop != 0 : lane == 1 ? a.strag != 0
                                            : lane == 2 && a.scores != nullptr;
  uint2 k = make_uint2(0u, 0u);
  if (want) {
    uint2 tag = lane == 0   ? make_uint2(a.keys[0], a.keys[1])
                : lane == 1 ? make_uint2(a.keys[2], a.keys[3])
                            : make_uint2(a.keys[4], a.keys[5]);
    if constexpr (kReplicas) {
      const int64_t* w = a.rkeys + 6 * static_cast<int64_t>(blockIdx.y) + 2 * lane;
      tag = make_uint2(static_cast<uint32_t>(w[0]), static_cast<uint32_t>(w[1]));
    }
    k = round_key_at(tag, t);
  }
  if constexpr (kReplicas) {
    const int64_t rep = blockIdx.y;
    const int64_t nn = a.n * a.n, span = a.horizon * a.n;
    if (a.rp != nullptr) r.a.p = a.rp[rep];
    if (a.edge_up != nullptr) r.a.edge_up += rep * a.horizon * a.n_edges;
    if (a.node_up != nullptr) r.a.node_up += rep * span;
    if (a.part_up != nullptr) r.a.part_up += rep * span;
    r.a.a += rep * nn;
    r.a.active += rep * a.n;
    if (a.scores != nullptr) r.a.scores += rep * nn;
    if (a.degree_total != nullptr) r.a.degree_total += rep;
  }
  r.fkey = shfl2(k, 0);
  r.nkey = shfl2(k, 1);
  r.mkey = shfl2(k, 2);
  return r;
}

__device__ __forceinline__ unsigned low_bits(int n) { return n >= 32 ? kFull : (1u << n) - 1u; }

constexpr int kPairGroups = 4;

template <bool kWide>
__device__ int Round<kWide>::slot_degrees(const int32_t* slots, int nslots,
                                          unsigned live_mask, int lane) const {
  const int k = static_cast<int>(deg_k());
  const int pairs = nslots * k;
  int d = 0;
  for (int p0 = 0; p0 < pairs; p0 += 32 * kPairGroups) {
    bool live[kPairGroups];
#pragma unroll
    for (int g = 0; g < kPairGroups; ++g) {
      const int p = p0 + 32 * g + lane;
      const int s = p / k, m = p - s * k;
      live[g] = p < pairs && ((live_mask >> s) & 1u) && m < deg_cnt()[slots[s]] &&
                deg_live(slots[s], m);
    }
#pragma unroll
    for (int g = 0; g < kPairGroups; ++g) {
      const unsigned bits = __ballot_sync(kFull, live[g]);
      const int c0 = p0 + 32 * g;
      const int lo = max(lane * k, c0) - c0, hi = min(lane * k + k, c0 + 32) - c0;
      if (lo < hi) d += __popc(bits & (low_bits(hi - lo) << lo));
    }
  }
  return d;
}

// Row i of A_t, W_t and the scores, and active[i], by one warp. Returns d_i,
// the row's live slots. The first chunk of 32 slots is drawn and weighed
// before the row's first store.
template <typename Real, bool kWide>
__device__ int round_row(const Round<kWide>& r, int i, int lane) {
  using O = Rn<Real>;
  const RoundArgs& a = r.a;
  const int64_t n = a.n;
  const int64_t row = static_cast<int64_t>(i) * n;
  Real* w = static_cast<Real*>(a.w);
  const int cnt = a.in_cnt[i];
  const int32_t* nbr = a.in_nbr + i * a.k_in;
  const int32_t* eid = a.in_eid != nullptr ? a.in_eid + i * a.k_in : nullptr;
  const bool ui = r.up(i);
  // Slot s is live: its link survives and both ends are up (draws together).
  auto live_at = [&](int s) {
    const int j = nbr[s];
    return ui & r.link(i, j, eid != nullptr ? eid[s] : 0) & r.up(j);
  };
  const bool first = lane < cnt && live_at(lane);
  const unsigned first_mask = __ballot_sync(kFull, first);
  int di = __popc(first_mask);
  for (int s0 = 32; s0 < cnt; s0 += 32) {
    di += __popc(__ballot_sync(kFull, s0 + lane < cnt && live_at(s0 + lane)));
  }
  // A directed row's diagonal takes its column: outdeg_i, i's live out-links.
  int outdeg = 0;
  if (a.directed && w != nullptr) {
    const int ocnt = a.out_cnt[i];
    for (int m0 = 0; m0 < ocnt; m0 += 32) {
      outdeg += __popc(__ballot_sync(kFull, m0 + lane < ocnt && ui &&
                                                r.deg_live(i, m0 + lane)));
    }
  }
  const Real one = Real(1);
  // Slot s's weight (0 where it is dead) and one-peer score.
  auto weigh = [&](int s0, bool live, unsigned live_mask, Real& wv, float& score) {
    if (w != nullptr) {
      const int dj = r.slot_degrees(nbr + s0, min(32, cnt - s0), live_mask, lane);
      wv = live ? O::div(one, O::add(one, static_cast<Real>(a.directed ? dj : max(di, dj))))
                : Real(0);
    }
    if (a.scores != nullptr && live) {
      score = pair_uniform<kWide>(r.mkey, i, nbr[s0 + lane], n);
    }
  };
  Real w_first = Real(0);
  float score_first = 0.0f;
  weigh(0, first, first_mask, w_first, score_first);
  for (int64_t c = lane; c < n; c += 32) {
    a.a[row + c] = 0.0f;
    if (w != nullptr) w[row + c] = Real(0);
    if (a.scores != nullptr) a.scores[row + c] = 0.0f;
  }
  if (lane == 0) a.active[i] = ui ? 1.0f : 0.0f;
  __syncwarp();  // the zeros land before the slots' values
  Real sum = Real(0);
  for (int s0 = 0; s0 < cnt; s0 += 32) {
    bool live = first;
    Real wv = w_first;
    float score = score_first;
    if (s0 > 0) {
      live = s0 + lane < cnt && live_at(s0 + lane);
      weigh(s0, live, __ballot_sync(kFull, live), wv, score);
    }
    if (live) {
      const int j = nbr[s0 + lane];
      a.a[row + j] = 1.0f;
      if (w != nullptr) w[row + j] = wv;
      if (a.scores != nullptr) a.scores[row + j] = score;
    }
    if (w != nullptr && !a.directed) {
      // Row i's sum in slot order: lane l holds slot s0 + l.
      const int nslots = min(32, cnt - s0);
      for (int l = 0; l < nslots; ++l) sum = O::add(sum, __shfl_sync(kFull, wv, l));
    }
  }
  if (w != nullptr && lane == 0) {
    if (a.directed) {
      // Column i holds outdeg_i equal weights 1 / (1 + outdeg_i), in order.
      const Real c = O::div(one, O::add(one, static_cast<Real>(outdeg)));
      for (int m = 0; m < outdeg; ++m) sum = O::add(sum, c);
    }
    w[row + i] = O::sub(one, sum);
  }
  return di;
}

template <typename Real, bool kReplicas, bool kWide>
__global__ void __launch_bounds__(kRoundThreads) round_kernel(RoundArgs a) {
  launch_counts::add(kSlotRealize);
  __shared__ int warp_degrees[kRoundWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kRoundWarps + warp;
  Round<kWide> r = make_round<kReplicas, kWide>(a, lane);
  if constexpr (kReplicas) {
    if (a.w != nullptr) r.a.w = static_cast<Real*>(a.w) + blockIdx.y * a.n * a.n;
  }
  const int di = i < a.n ? round_row<Real, kWide>(r, static_cast<int>(i), lane) : 0;
  if (lane == 0) warp_degrees[warp] = di;
  __syncthreads();
  if (threadIdx.x == 0 && r.a.degree_total != nullptr) {
    int block = 0;
    for (int v = 0; v < kRoundWarps; ++v) block += warp_degrees[v];
    if (block != 0) atomicAdd(r.a.degree_total, static_cast<double>(block));
  }
}

// ---- the slot round (the matrix-free fault form) --------------------------

// What the slot round's two launches read and write. ops/draw_kernels.py
// mirrors it field for field as a ctypes Structure.
struct SlotArgs {
  const int64_t* t;        // the round's counter, read from device memory
  const int32_t* nbr;      // [N, k]: row i's neighbours, ascending, padded with i
  const int32_t* cnt;      // [N]: row i's real slots (the first cnt[i]); unread with a mask
  const int32_t* eid;      // [N, k]: each slot's timeline edge id, or null
  const float* mask;       // [N, k]: a caller's slot mask (a slot is real where != 0), or null
  const uint8_t* edge_up;  // [R, T, E] the timeline's edge states, or null
  const uint8_t* node_up;  // [R, T, N] the node chain, or null
  const uint8_t* part_up;  // [R, T, N] the participation stream, or null
  float* live;             // [R, N, k]
  void* w;                 // [R, N, k] in Real (the weight pass)
  void* w_self;            // [R, N] in Real (the weight pass)
  float* active;           // [R, N]
  int32_t* deg;            // [R, N] workspace: each row's live slots
  uint32_t* bits;          // [R, N, ceil(k / 32)] workspace: each row's live slots, a bit each
  double* degree_total;    // [R] the run's sums of realized degrees, or null
  int64_t n, k, n_edges, horizon, replicas;
  int32_t passes;          // kLivePass, kWeightPass, or both
};

constexpr int kLivePass = 1;
constexpr int kWeightPass = 2;
constexpr int kSlotSteps = 2;                 // live pass: steps of G slots a lane has in flight
constexpr int kSlotBatch = 8;                 // weight pass: live slots a thread has in flight
constexpr size_t kDefaultShared = 48 * 1024;  // a block's shared memory without opting in
constexpr size_t kMaxShared = 232448;         // 227 KB, the most a block takes on sm_90

// The round's states at the timeline row of t, replica rep's.
struct SlotStates {
  const uint8_t* node_up;
  const uint8_t* part_up;
  const uint8_t* edge_up;
  __device__ __forceinline__ bool up(int64_t j) const {
    return (node_up == nullptr || node_up[j] != 0) & (part_up == nullptr || part_up[j] != 0);
  }
  __device__ __forceinline__ bool edge(int32_t e) const {
    return edge_up == nullptr || edge_up[e] != 0;
  }
};

__device__ __forceinline__ SlotStates slot_states(const SlotArgs& a, int64_t rep) {
  const int64_t tt = a.horizon > 0 ? timeline_row(*a.t, a.horizon) : 0;
  const int64_t at = rep * a.horizon + tt;
  return {a.node_up != nullptr ? a.node_up + at * a.n : nullptr,
          a.part_up != nullptr ? a.part_up + at * a.n : nullptr,
          a.edge_up != nullptr ? a.edge_up + at * a.n_edges : nullptr};
}

// The live pass: a group of G lanes a row (G = 8; 2 where k_max <= 2),
// lane l of the group at slots l, l + G, l + 2G, ..., so a group's reads
// and writes of a row are contiguous. Each lane takes kSlotSteps steps at
// a time: the table reads of the real slots (cnt[i]; every slot with a
// caller's mask), then the gathers of the neighbours' node states and the
// edges' timeline states, all in flight together. Slot s of row i is live
// iff it is real, both ends are up and its edge is up; live is written at
// every slot (with a mask, mask * [live]). A step's live flags are one
// ballot: the group's G bits, the row's bit word and count, no atomics.
// The group's first lane writes d_i, active and the bit words; the block
// adds its count to the replica's total.
template <int G>
__global__ void __launch_bounds__(kThreads) slot_live_kernel(SlotArgs a) {
  launch_counts::add(kSlotSlotRound);
  __shared__ int s_warp[kThreads / 32];
  const int k = static_cast<int>(a.k);
  const int words = (k + 31) / 32;
  const bool masked = a.mask != nullptr;
  const int lane = threadIdx.x & 31, gl = lane % G, shift = lane - gl;
  const int64_t rep = blockIdx.y;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * (kThreads / G) + threadIdx.x / G;
  const bool in = i < a.n;
  const SlotStates st = slot_states(a, rep);
  bool ui = false;
  int c = 0;
  if (in) {
    ui = st.up(i);
    const int cnt = masked ? k : a.cnt[i];
    // A down row has no live slot, and skips its gathers (with a mask it
    // still writes mask * 0 at every slot).
    c = masked ? k : (ui ? cnt : 0);
  }
  const int64_t base = i * a.k;
  float* live = a.live + rep * a.n * a.k + base;
  uint32_t* bits = a.bits + (rep * a.n + i) * words;
  int d = 0;
  uint32_t word = 0u;
  for (int t0 = 0; t0 * G < k; t0 += kSlotSteps) {
    int32_t j[kSlotSteps], e[kSlotSteps];
    float m[kSlotSteps];
    bool real[kSlotSteps], v[kSlotSteps];
#pragma unroll
    for (int u = 0; u < kSlotSteps; ++u) {
      const int s = (t0 + u) * G + gl;
      m[u] = masked && s < c ? a.mask[base + s] : 1.0f;
      real[u] = s < c && ui && (!masked || m[u] != 0.0f);
      j[u] = real[u] ? a.nbr[base + s] : 0;
      e[u] = real[u] && st.edge_up != nullptr ? a.eid[base + s] : 0;
    }
#pragma unroll
    for (int u = 0; u < kSlotSteps; ++u) v[u] = real[u] && (st.up(j[u]) & st.edge(e[u]));
#pragma unroll
    for (int u = 0; u < kSlotSteps; ++u) {
      const int first = (t0 + u) * G;  // the step's first slot
      const int s = first + gl;
      if (in && s < k) live[s] = masked ? __fmul_rn(m[u], v[u] ? 1.0f : 0.0f) : (v[u] ? 1.0f : 0.0f);
      const uint32_t mine = (__ballot_sync(kFull, v[u]) >> shift) & ((1u << G) - 1u);
      d += __popc(mine);
      word |= mine << (first & 31);
      if (first < k && ((first + G) % 32 == 0 || first + G >= k)) {
        if (in && gl == 0) bits[first >> 5] = word;
        word = 0u;
      }
    }
  }
  if (in && gl == 0) {
    a.deg[rep * a.n + i] = d;
    a.active[rep * a.n + i] = ui ? 1.0f : 0.0f;
  }
  if (a.degree_total != nullptr) {
    d = in && gl == 0 ? d : 0;
    for (int o = 16; o > 0; o >>= 1) d += __shfl_xor_sync(kFull, d, o);
    if (lane == 0) s_warp[threadIdx.x >> 5] = d;
    __syncthreads();
    if (threadIdx.x == 0) {
      int block = 0;
      for (int w = 0; w < kThreads / 32; ++w) block += s_warp[w];
      if (block != 0) atomicAdd(a.degree_total + rep, static_cast<double>(block));
    }
  }
}

// The weight pass: a thread a row, kThreads rows a block (fewer where a
// block's [rows, k] tile of weights would pass the default 48 KB). Each
// thread walks its row's live slots off the bit words (no float array read
// back), kSlotBatch at a time in ascending order: their neighbours'
// indices, then those rows' counts, in flight together; w = 1 / (1 +
// max(d_i, d_nbr)) into a zeroed tile in shared memory, and the row's sum
// of them in registers, in slot order (a dead or padded slot's +0 is
// skipped: a sum of weights >= +0 is the same with it); w_self = 1 minus
// the sum. The block copies the tile out coalesced.
template <typename Real>
__global__ void __launch_bounds__(kThreads) slot_weight_kernel(SlotArgs a, int rows) {
  using O = Rn<Real>;
  launch_counts::add(kSlotSlotRound);
  extern __shared__ __align__(16) unsigned char slot_smem[];
  const int k = static_cast<int>(a.k);
  const int words = (k + 31) / 32;
  Real* tile = reinterpret_cast<Real*>(slot_smem);  // [rows, k]
  const int64_t rep = blockIdx.y;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * rows;
  const int nrows = static_cast<int>(rows < a.n - row0 ? rows : a.n - row0);
  const int total = nrows * k;
  for (int q = threadIdx.x; q < total; q += blockDim.x) tile[q] = Real(0);
  const int r = threadIdx.x;
  const int32_t* deg = a.deg + rep * a.n;
  const int64_t i = row0 + r;
  const int64_t base = i * a.k;
  const uint32_t* bits = a.bits + (rep * a.n + i) * words;
  int di = 0;
  uint32_t b = 0u;
  if (r < nrows) {
    di = deg[i];
    b = bits[0];
  }
  __syncthreads();  // the zeros land before the rows' weights
  if (r < nrows) {
    int w = 0;
    Real* row = tile + r * k;
    const Real one = Real(1);
    Real sum = Real(0);
    for (;;) {
      int s[kSlotBatch], j[kSlotBatch], dj[kSlotBatch];
#pragma unroll
      for (int u = 0; u < kSlotBatch; ++u) {
        while (b == 0u && w + 1 < words) b = bits[++w];
        s[u] = b != 0u ? w * 32 + __ffs(b) - 1 : -1;
        b &= b - 1u;
      }
#pragma unroll
      for (int u = 0; u < kSlotBatch; ++u) j[u] = s[u] >= 0 ? a.nbr[base + s[u]] : 0;
#pragma unroll
      for (int u = 0; u < kSlotBatch; ++u) dj[u] = s[u] >= 0 ? deg[j[u]] : 0;
#pragma unroll
      for (int u = 0; u < kSlotBatch; ++u) {
        if (s[u] < 0) break;
        const Real wv = O::div(one, O::add(one, static_cast<Real>(max(di, dj[u]))));
        row[s[u]] = wv;
        sum = O::add(sum, wv);
      }
      if (s[kSlotBatch - 1] < 0) break;
    }
    static_cast<Real*>(a.w_self)[rep * a.n + i] = O::sub(one, sum);
  }
  __syncthreads();
  Real* out = static_cast<Real*>(a.w) + (rep * a.n + row0) * a.k;
  for (int q = threadIdx.x; q < total; q += blockDim.x) out[q] = tile[q];
}

// ---- the timeline -----------------------------------------------------------

// A chain's round s is a map of its states {down = 0, up = 1} to themselves,
// two bits: bit 0 the image of down (u >= stay), bit 1 the image of up (u >=
// enter); at s = 0 both images are u >= init. Maps compose associatively,
// so the chain is a scan over s of maps drawn independently.
constexpr unsigned kIdentity = 2u;  // down -> down, up -> up
constexpr int kSeg = 16;            // rounds a thread walks
constexpr int kSegs = kThreads / 32;
constexpr int kTile = kSeg * kSegs;  // rounds a block takes: a segment a warp

// f, then g.
__device__ __forceinline__ unsigned then(unsigned f, unsigned g) {
  return ((g >> (f & 1u)) & 1u) | (((g >> (f >> 1)) & 1u) << 1);
}

// The state after f from the state st.
__device__ __forceinline__ unsigned apply(unsigned f, unsigned st) { return (f >> st) & 1u; }

// What both timeline passes read and write, filled by fault_timeline below.
struct TimelineArgs {
  uint2 tags[3];         // the fault, node and participation tag keys
  const int32_t* edges;  // [E, 2]: edge e's counter is edges[e][0] * n + edges[e][1]; null: e
  uint8_t* out[3];       // edge_up [T, E], node_up [T, N], part_up [T, N]
  uint8_t* rejoin;       // [T, N]
  uint8_t* carry;        // [tiles, E + N]: each tile's composed map of each chain
  int64_t count[3];      // E, the node chains, the participation streams (0: off)
  int64_t n, horizon;
  float th[7];           // edge (init, enter, stay), node (init, enter, stay), p_out
};

// A block's 32 entities of one stream: the entity groups of the edges, then
// of the node chains, then of the participation streams (grid x).
struct Group {
  int stream;
  int64_t e0;
};

__device__ __forceinline__ int64_t groups_of(int64_t m) { return (m + 31) / 32; }

__device__ __forceinline__ Group group_of(const TimelineArgs& a, int64_t g) {
  const int64_t ge = groups_of(a.count[0]), gn = groups_of(a.count[1]);
  if (g < ge) return {0, 32 * g};
  if (g < ge + gn) return {1, 32 * (g - ge)};
  return {2, 32 * (g - ge - gn)};
}

// Pass 1: every (round, entity) drawn at once. Warp w of the block walks
// segment w of the tile and lane l entity e0 + l, so a round's bytes are
// written coalesced across the warp. The tile's round keys are folded
// first, one a thread, into shared memory: one key a (stream, round) for 32
// entities. A chain writes its round maps into its output, which pass 2
// overwrites with the states, and each tile's composed map into carry;
// participation writes its states.
__global__ void __launch_bounds__(kThreads) timeline_draw_kernel(TimelineArgs a) {
  launch_counts::add(kSlotTimeline);
  __shared__ uint2 keys[kTile];
  __shared__ uint8_t seg[kSegs][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Group gr = group_of(a, blockIdx.x);
  const int64_t m = a.count[gr.stream];
  const int64_t e = gr.e0 + lane;
  const bool live = e < m;
  const bool chain = gr.stream != 2;
  uint64_t c = static_cast<uint64_t>(e);
  if (gr.stream == 0 && live && a.edges != nullptr) {
    c = static_cast<uint64_t>(a.edges[2 * e]) * static_cast<uint64_t>(a.n) +
        static_cast<uint64_t>(a.edges[2 * e + 1]);
  }
  const int th = chain ? 3 * gr.stream : 0;
  const float init = a.th[th], enter = a.th[th + 1], stay = a.th[th + 2], p_out = a.th[6];
  uint8_t* out = a.out[gr.stream];
  const int64_t chains = a.count[0] + a.count[1];
  const int64_t tiles = (a.horizon + kTile - 1) / kTile;
  for (int64_t tile = blockIdx.y; tile < tiles; tile += gridDim.y) {
    const int64_t s0 = tile * kTile;
    if (threadIdx.x < kTile && s0 + threadIdx.x < a.horizon) {
      keys[threadIdx.x] = round_key_at(a.tags[gr.stream], s0 + threadIdx.x);
    }
    __syncthreads();
    const int64_t sb = s0 + warp * kSeg;
    unsigned summary = kIdentity;
    if (live) {
#pragma unroll
      for (int j = 0; j < kSeg; ++j) {
        const int64_t s = sb + j;
        if (s < a.horizon) {
          const float u = uniform32(keys[warp * kSeg + j], c);
          unsigned v;
          if (chain) {
            const unsigned up = u >= (s == 0 ? init : enter);
            const unsigned down = u >= (s == 0 ? init : stay);
            v = down | (up << 1);
            summary = then(summary, v);
          } else {
            v = u >= p_out;
          }
          out[s * m + e] = static_cast<uint8_t>(v);
        }
      }
    }
    if (chain) {
      seg[warp][lane] = static_cast<uint8_t>(summary);
      __syncthreads();
      if (warp == 0 && live) {
        unsigned f = kIdentity;
#pragma unroll
        for (int w = 0; w < kSegs; ++w) f = then(f, seg[w][lane]);
        a.carry[tile * chains + (gr.stream == 0 ? e : a.count[0] + e)] = static_cast<uint8_t>(f);
      }
    }
    __syncthreads();  // keys and seg are the next tile's
  }
}

// Pass 2, the chains' groups only. The state entering tile k is the
// composition of tiles 0 .. k-1 applied to up (warp w composes the w-th
// eighth of them); each warp then composes its segment's maps, enters its
// segment past the segments before it, and applies its maps in order,
// writing the states (and rejoin: up now and down the round before) over
// the maps.
__global__ void __launch_bounds__(kThreads) timeline_scan_kernel(TimelineArgs a) {
  launch_counts::add(kSlotTimeline);
  __shared__ uint8_t part[kSegs][32], seg[kSegs][32];
  if (blockIdx.x >= groups_of(a.count[0]) + groups_of(a.count[1])) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Group gr = group_of(a, blockIdx.x);
  const int64_t m = a.count[gr.stream];
  const int64_t e = gr.e0 + lane;
  const bool live = e < m;
  const int64_t chains = a.count[0] + a.count[1];
  const uint8_t* carry = a.carry + (gr.stream == 0 ? e : a.count[0] + e);
  uint8_t* out = a.out[gr.stream];
  const int64_t tiles = (a.horizon + kTile - 1) / kTile;
  for (int64_t tile = blockIdx.y; tile < tiles; tile += gridDim.y) {
    const int64_t per = (tile + kSegs - 1) / kSegs;
    const int64_t lo = warp * per, hi = min(tile, lo + per);
    unsigned f = kIdentity;
    if (live) {
#pragma unroll 4
      for (int64_t k = lo; k < hi; ++k) f = then(f, carry[k * chains]);
    }
    part[warp][lane] = static_cast<uint8_t>(f);
    const int64_t sb = tile * kTile + warp * kSeg;
    uint8_t maps[kSeg];
    unsigned own = kIdentity;
#pragma unroll
    for (int j = 0; j < kSeg; ++j) {
      maps[j] = live && sb + j < a.horizon ? out[(sb + j) * m + e] : kIdentity;
      own = then(own, maps[j]);
    }
    seg[warp][lane] = static_cast<uint8_t>(own);
    __syncthreads();
    unsigned st = 1u;  // every chain is up before t = 0
#pragma unroll
    for (int w = 0; w < kSegs; ++w) st = apply(part[w][lane], st);
    for (int w = 0; w < warp; ++w) st = apply(seg[w][lane], st);
    if (live) {
#pragma unroll
      for (int j = 0; j < kSeg; ++j) {
        const int64_t s = sb + j;
        if (s < a.horizon) {
          const unsigned now = apply(maps[j], st);
          out[s * m + e] = static_cast<uint8_t>(now);
          if (gr.stream == 1) a.rejoin[s * m + e] = static_cast<uint8_t>(now & (st ^ 1u));
          st = now;
        }
      }
    }
    __syncthreads();  // part and seg are the next tile's
  }
}

// ---- the large-noise payload ------------------------------------------------

template <typename Real>
struct Normal;

template <>
struct Normal<float> {
  static __device__ __forceinline__ float lower() { return nextafterf(-1.0f, 0.0f); }
  static __device__ __forceinline__ float uniform(uint2 key, uint64_t k) {
    const float lo = lower();
    const float f = unit32(threefry_at(key.x, key.y, k));
    return fmaxf(lo, __fadd_rn(__fmul_rn(f, __fsub_rn(1.0f, lo)), lo));
  }
  static __device__ __forceinline__ float erf_inv(float x) {
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
  static __device__ __forceinline__ double uniform(uint2 key, uint64_t k) {
    const double lo = lower();
    const uint2 w = threefry_at(key.x, key.y, k);
    const uint64_t bits = (static_cast<uint64_t>(w.x) << 32) | w.y;
    const double f =
        __dsub_rn(__longlong_as_double(static_cast<long long>((bits >> 12) |
                                                              0x3FF0000000000000ull)),
                  1.0);
    return fmax(lo, __dadd_rn(__dmul_rn(f, __dsub_rn(1.0, lo)), lo));
  }
  static __device__ __forceinline__ double erf_inv(double x) {
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
__device__ __forceinline__ Real noisy(uint2 key, uint64_t k, Real v, Real scale) {
  using N = Normal<Real>;
  const Real z = N::mul(N::sqrt2(), N::erf_inv(N::uniform(key, k)));
  return N::add(v, N::mul(scale, z));
}

// An element a thread: thread k of the launch takes element k = i * d + j
// of the stack (block (bx, by) holds elements from (by * gridDim.x + bx) *
// kThreads). The block's first thread folds the round key while every
// thread loads its element, divides out its row and loads the row's flag;
// honest elements are stored before the one barrier that waits for the key.
// Replica blockIdx.z (the replica axis: keys non-null) takes its own key,
// flags and [n, d] slices.
template <typename Real>
__global__ void __launch_bounds__(kThreads) noise_kernel(
    const int64_t* __restrict__ t, uint2 tag, const int64_t* __restrict__ keys,
    const uint8_t* __restrict__ byzantine, const Real* __restrict__ x, Real scale,
    Real* __restrict__ out, int64_t n, int64_t d) {
  launch_counts::add(kSlotNoise);
  __shared__ uint2 key;
  const int64_t k =
      (static_cast<int64_t>(blockIdx.y) * gridDim.x + blockIdx.x) * kThreads + threadIdx.x;
  if (keys != nullptr) {
    const int64_t rep = blockIdx.z;
    tag = make_uint2(static_cast<uint32_t>(keys[2 * rep]), static_cast<uint32_t>(keys[2 * rep + 1]));
    byzantine += rep * n;
    x += rep * n * d;
    out += rep * n * d;
  }
  if (threadIdx.x == 0) key = round_key_at(tag, *t);
  Real v = Real(0);
  bool byz = false;
  if (k < n * d) {
    v = x[k];
    byz = byzantine[k / d] != 0;
    if (!byz) out[k] = v;
  }
  __syncthreads();
  if (byz) out[k] = noisy(key, static_cast<uint64_t>(k), v, scale);
}

inline int finish() { return static_cast<int>(cudaGetLastError()); }

template <typename Real>
int launch_round(const RoundArgs* args, void* stream) {
  const RoundArgs& a = *args;
  const bool timeline_edges = a.edge_up != nullptr;
  if (a.n <= 0 || a.n > kMaxRows || a.k_in <= 0 || a.in_nbr == nullptr ||
      a.replicas < 1 || a.replicas > 65535 || (a.replicas > 1 && a.rkeys == nullptr) ||
      a.in_cnt == nullptr || a.a == nullptr || a.active == nullptr || a.t == nullptr ||
      (a.directed && (a.out_nbr == nullptr || a.out_cnt == nullptr || a.k_out <= 0)) ||
      (timeline_edges && (a.n_edges <= 0 || a.in_eid == nullptr ||
                          (a.directed && a.out_eid == nullptr))) ||
      ((timeline_edges || a.node_up != nullptr || a.part_up != nullptr) && a.horizon <= 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 blocks(static_cast<unsigned>((a.n + kRoundWarps - 1) / kRoundWarps),
                    static_cast<unsigned>(a.replicas));
  const auto s = static_cast<cudaStream_t>(stream);
  const bool wide = a.n > kNarrowNodes;
  if (a.rkeys != nullptr) {
    if (wide) {
      round_kernel<Real, true, true><<<blocks, kRoundThreads, 0, s>>>(a);
    } else {
      round_kernel<Real, true, false><<<blocks, kRoundThreads, 0, s>>>(a);
    }
  } else if (wide) {
    round_kernel<Real, false, true><<<blocks, kRoundThreads, 0, s>>>(a);
  } else {
    round_kernel<Real, false, false><<<blocks, kRoundThreads, 0, s>>>(a);
  }
  return finish();
}

// The slot round's two launches: the live pass with G lanes a row,
// kThreads / G rows a block; the weight pass a thread a row, as many rows
// a block as a [rows, k] tile of weights in the default 48 KB holds (at
// most kThreads; a multiple of 32 past 32).
template <int G, typename Real>
int launch_slot_passes(const SlotArgs& a, cudaStream_t s) {
  if (a.passes & kLivePass) {
    constexpr int64_t rows = kThreads / G;
    const dim3 blocks(static_cast<unsigned>((a.n + rows - 1) / rows),
                      static_cast<unsigned>(a.replicas));
    slot_live_kernel<G><<<blocks, kThreads, 0, s>>>(a);
    const int err = finish();
    if (err != 0) return err;
  }
  if (a.passes & kWeightPass) {
    int64_t rows = std::min<int64_t>(kThreads,
                                     static_cast<int64_t>(kDefaultShared / sizeof(Real)) / a.k);
    rows = rows > 32 ? rows / 32 * 32 : std::max<int64_t>(rows, 1);
    const size_t bytes = static_cast<size_t>(rows * a.k) * sizeof(Real);
    if (bytes > kMaxShared) return static_cast<int>(cudaErrorInvalidValue);
    if (bytes > kDefaultShared) {
      const cudaError_t err = cudaFuncSetAttribute(
          slot_weight_kernel<Real>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(bytes));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    const dim3 blocks(static_cast<unsigned>((a.n + rows - 1) / rows),
                      static_cast<unsigned>(a.replicas));
    const int threads = static_cast<int>((rows + 31) / 32 * 32);
    slot_weight_kernel<Real><<<blocks, threads, bytes, s>>>(a, static_cast<int>(rows));
    return finish();
  }
  return 0;
}

template <typename Real>
int launch_slot_round(const SlotArgs* args, void* stream) {
  const SlotArgs& a = *args;
  const bool timeline_edges = a.edge_up != nullptr;
  const bool live_pass = (a.passes & kLivePass) != 0, weight_pass = (a.passes & kWeightPass) != 0;
  if (a.n <= 0 || a.n > kMaxRows || a.k <= 0 || a.k > kMaxRows || a.replicas < 1 ||
      a.replicas > 65535 || a.passes < 1 || a.passes > (kLivePass | kWeightPass) ||
      a.nbr == nullptr || a.deg == nullptr || a.bits == nullptr ||
      (live_pass && (a.t == nullptr || (a.cnt == nullptr && a.mask == nullptr) ||
                     a.live == nullptr || a.active == nullptr)) ||
      (weight_pass && (a.w == nullptr || a.w_self == nullptr)) ||
      (timeline_edges && (a.n_edges <= 0 || a.eid == nullptr)) ||
      ((timeline_edges || a.node_up != nullptr || a.part_up != nullptr) && a.horizon <= 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  return a.k <= 2 ? launch_slot_passes<2, Real>(a, s) : launch_slot_passes<8, Real>(a, s);
}

// The payload over x [n, d] (keys null) or over R replicas' [R, n, d]
// (keys [R, 2] words), an element a thread.
template <typename Real>
int launch_noise(const void* t, uint32_t k0, uint32_t k1, const void* keys, int64_t replicas,
                 const void* byzantine, const void* x, double scale, void* out, int64_t n,
                 int64_t d, void* stream) {
  if (n < 0 || d < 0 || replicas < 0 || replicas > 65535 || (replicas > 1 && keys == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0 || d == 0 || replicas == 0) return 0;
  const int64_t blocks = (n * d + kThreads - 1) / kThreads;
  const int64_t bx = std::min<int64_t>(blocks, 0x7FFFFFFF);  // the grid's x limit
  const dim3 grid(static_cast<unsigned>(bx), static_cast<unsigned>((blocks + bx - 1) / bx),
                  static_cast<unsigned>(replicas));
  noise_kernel<Real><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(t), make_uint2(k0, k1), static_cast<const int64_t*>(keys),
      static_cast<const uint8_t*>(byzantine), static_cast<const Real*>(x),
      static_cast<Real>(scale), static_cast<Real*>(out), n, d);
  return finish();
}

}  // namespace

extern "C" {

// One round at the counter *args->t (RoundArgs above), W_t in float32 or
// float64.
int realize_round_f32(const void* args, void* stream) {
  return launch_round<float>(static_cast<const RoundArgs*>(args), stream);
}
int realize_round_f64(const void* args, void* stream) {
  return launch_round<double>(static_cast<const RoundArgs*>(args), stream);
}

// One round of the matrix-free fault form at the counter *args->t
// (SlotArgs above) in two launches on the stream, w and w_self in float32
// or float64.
int realize_slot_round_f32(const void* args, void* stream) {
  return launch_slot_round<float>(static_cast<const SlotArgs*>(args), stream);
}
int realize_slot_round_f64(const void* args, void* stream) {
  return launch_slot_round<double>(static_cast<const SlotArgs*>(args), stream);
}

// The timeline over t = 0 .. horizon - 1 in two launches on the stream:
// the draws, then the chains' scan. keys: fault, node, participation tag
// keys. edges: the [n_edges, 2] list whose pairs give the dense form's
// counters, or null for the per-edge stream (edge e at counter e). thresholds: edge (init, enter, stay), node (init, enter, stay), then
// p_out. A process with a count of 0 is off. carry: the caller's
// workspace of fault_timeline_tile-round tiles times (n_edges + n_nodes)
// bytes.
int fault_timeline(const uint32_t* keys, int64_t n, const void* edges, int64_t n_edges,
                   int64_t n_nodes, int64_t n_part, const float* thresholds, int64_t horizon,
                   void* edge_up, void* node_up, void* rejoin, void* part_up, void* carry,
                   void* stream) {
  if (n <= 0 || horizon <= 0 || n_edges < 0 || n_nodes < 0 || n_part < 0 ||
      (n_edges + n_nodes > 0 && carry == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  TimelineArgs a;
  for (int k = 0; k < 3; ++k) a.tags[k] = make_uint2(keys[2 * k], keys[2 * k + 1]);
  a.edges = static_cast<const int32_t*>(edges);
  a.out[0] = static_cast<uint8_t*>(edge_up);
  a.out[1] = static_cast<uint8_t*>(node_up);
  a.out[2] = static_cast<uint8_t*>(part_up);
  a.rejoin = static_cast<uint8_t*>(rejoin);
  a.carry = static_cast<uint8_t*>(carry);
  a.count[0] = n_edges;
  a.count[1] = n_nodes;
  a.count[2] = n_part;
  a.n = n;
  a.horizon = horizon;
  for (int k = 0; k < 7; ++k) a.th[k] = thresholds[k];
  const int64_t chain_groups = (n_edges + 31) / 32 + (n_nodes + 31) / 32;
  const int64_t groups = chain_groups + (n_part + 31) / 32;
  if (groups == 0) return 0;
  const unsigned gy = static_cast<unsigned>(std::min<int64_t>((horizon + kTile - 1) / kTile, 65535));
  const auto s = static_cast<cudaStream_t>(stream);
  timeline_draw_kernel<<<dim3(static_cast<unsigned>(groups), gy), kThreads, 0, s>>>(a);
  const int err = finish();
  if (err != 0) return err;
  timeline_scan_kernel<<<dim3(static_cast<unsigned>(std::max<int64_t>(chain_groups, 1)), gy),
                         kThreads, 0, s>>>(a);
  return finish();
}

// The rounds of a timeline tile: the carry workspace holds one byte a
// (tile, chain).
int fault_timeline_tile() { return kTile; }

int large_noise_f32(const void* t, uint32_t k0, uint32_t k1, const void* byzantine, const void* x,
                    double scale, void* out, int64_t n, int64_t d, void* stream) {
  return launch_noise<float>(t, k0, k1, nullptr, 1, byzantine, x, scale, out, n, d, stream);
}
int large_noise_f64(const void* t, uint32_t k0, uint32_t k1, const void* byzantine, const void* x,
                    double scale, void* out, int64_t n, int64_t d, void* stream) {
  return launch_noise<double>(t, k0, k1, nullptr, 1, byzantine, x, scale, out, n, d, stream);
}
// The replica axis: keys [R, 2] int64 tag-key words, byzantine [R, n], x
// and out [R, n, d].
int large_noise_batch_f32(const void* t, const void* keys, int64_t replicas, const void* byzantine,
                          const void* x, double scale, void* out, int64_t n, int64_t d,
                          void* stream) {
  return launch_noise<float>(t, 0u, 0u, keys, replicas, byzantine, x, scale, out, n, d, stream);
}
int large_noise_batch_f64(const void* t, const void* keys, int64_t replicas, const void* byzantine,
                          const void* x, double scale, void* out, int64_t n, int64_t d,
                          void* stream) {
  return launch_noise<double>(t, 0u, 0u, keys, replicas, byzantine, x, scale, out, n, d, stream);
}

}  // extern "C"
