// The radix select that the sampling and the compression kernels share.
//
// A selection key packs a score above a reversed index (L - 1 - row, or
// d - 1 - column) in ceil(log2 L) bits, left-aligned in the key word, so
// keys are distinct and the largest comes first in a stable descending
// sort of the scores (ties to the lower index). The k largest keys are found
// over 8-bit digits from the top: each pass builds a 256-bin histogram of
// the candidates' digit in shared memory, and one warp scans it from the
// top for the bin that holds the krem-th largest candidate
// (scan_histogram). The candidates of the next pass are that bin's. The
// passes end once the keys at or above the bin's lower bound (the
// survivors) number at most cap, or at the last digit; with cap equal to
// the k wanted, the survivors are exactly the k largest keys.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

using u128 = unsigned __int128;

constexpr int kBins = 256;

// Bits of L - 1 - row: ceil(log2 L).
__host__ __device__ __forceinline__ int row_bits(int L) {
  int bits = 0;
  while (bits < 31 && (1u << bits) < static_cast<uint32_t>(L)) ++bits;
  return bits;
}

// The selection key: score above L - 1 - row, left-aligned in the word.
template <typename Key, int kScoreBits>
__device__ __forceinline__ Key pack(uint64_t score, uint32_t rev_row, int rbits) {
  constexpr int kWidth = 8 * sizeof(Key);
  return (static_cast<Key>(score) << (kWidth - kScoreBits)) |
         (static_cast<Key>(rev_row) << (kWidth - kScoreBits - rbits));
}

// The leader's selection state, in shared memory.
template <typename Key>
struct State {
  Key prefix;     // the candidates' key bits above the current digit
  Key lower;      // survivors: (key >> p) >= lower
  Key threshold;  // the need-th largest key (the sampler's weights form)
  int p, krem, count, done;
  unsigned hist[kBins];
};

// One warp of the leader: find the histogram's bin B that holds the krem-th
// largest candidate, counting from the top bin; zero the bins; publish the
// survivors' lower bound and whether the passes end.
template <typename Key>
__device__ void scan_histogram(State<Key>* st, int need, int cap) {
  const int lane = threadIdx.x & 31;
  const int top_bin = kBins - 1 - 8 * lane;  // this lane's bins, top_bin down to top_bin - 7
  unsigned c[8];
  unsigned sum = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    c[j] = st->hist[top_bin - j];
    st->hist[top_bin - j] = 0;
    sum += c[j];
  }
  unsigned incl = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned up = __shfl_up_sync(0xFFFFFFFFu, incl, off);
    if (lane >= off) incl += up;
  }
  const int krem = st->krem;
  const unsigned hit = __ballot_sync(0xFFFFFFFFu, incl >= static_cast<unsigned>(krem));
  if (lane != __ffs(hit) - 1) return;
  unsigned above = incl - sum;
  int bin = top_bin;
  unsigned in_bin = c[0];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (above + c[j] >= static_cast<unsigned>(krem)) {
      bin = top_bin - j;
      in_bin = c[j];
      break;
    }
    above += c[j];
  }
  const int survivors = (need - krem) + static_cast<int>(above + in_bin);
  const Key lower = (st->prefix << 8) | static_cast<Key>(bin);
  const bool done = survivors <= cap || st->p == 0;
  st->lower = lower;
  st->prefix = lower;
  st->krem = krem - static_cast<int>(above);
  st->done = done;
  if (!done) st->p -= 8;
}
