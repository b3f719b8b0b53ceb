// The per-phase first-match scan shared by B1 (consumer.cu) and S1
// (consumer2.cu): the device half of the JAX package's _phase_scan_tile
// (antrea_tpu/ops/match.py:1333).
//
// A lane's rule bitmap is a row of 32-bit words; rule r of word j is bit
// (r - 32 * (w0 + j)), w0 being the row's global word offset.  The rules
// fall in three contiguous phases [0, n0), [n0, n0 + nk), [n0 + nk, BIG);
// for each the scan finds the lowest set rule index, or BIG = 1 << 30.
// One block of kThreads threads works on one lane: each thread folds the
// words it strides over into its own three minima per direction
// (scan_word), then block_min6 reduces the six minima over the block (a
// warp-shuffle min, then a min over the warps in shared memory) and writes
// the lane's output row [in0, ink, inb, out0, outk, outb, 0, 0].

#pragma once

#include <stdint.h>

namespace phase_scan {

constexpr int kBig = 1 << 30;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Bits of a word whose global rule index (base + bit) lies in [lo, hi).
__device__ __forceinline__ uint32_t phase_mask(long long base, long long lo,
                                               long long hi) {
  long long klo = lo - base;
  long long khi = hi - base;
  klo = klo < 0 ? 0 : (klo > 32 ? 32 : klo);
  khi = khi < 0 ? 0 : (khi > 32 ? 32 : khi);
  uint32_t mlo = klo >= 32 ? 0u : ~((1u << klo) - 1u);
  uint32_t mhi = khi >= 32 ? 0xFFFFFFFFu : ((1u << khi) - 1u);
  return mlo & mhi;
}

__device__ __forceinline__ void take(uint32_t bits, long long base, int* best) {
  if (bits) {
    int r = static_cast<int>(base) + __ffs(static_cast<int>(bits)) - 1;
    *best = min(*best, r);
  }
}

// Fold one nonzero match word whose bit 0 is global rule `base` into the
// three phase minima best[0..2]; the phases split at b0 and b1.
__device__ __forceinline__ void scan_word(uint32_t m, long long base,
                                          long long b0, long long b1,
                                          int* best) {
  take(m & phase_mask(base, 0, b0), base, &best[0]);
  take(m & phase_mask(base, b0, b1), base, &best[1]);
  take(m & phase_mask(base, b1, kBig), base, &best[2]);
}

// Block-wide min of every thread's six minima; threads 0..7 write the
// lane's output row out[0..7] (the last two words 0).  Call once, from
// every thread of a kThreads-thread block.
__device__ __forceinline__ void block_min6(const int* best,
                                           int32_t* __restrict__ out) {
  __shared__ int part[kWarps][6];
  const int warp = threadIdx.x / 32;
  const int lid = threadIdx.x % 32;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    int v = best[k];
#pragma unroll
    for (int off = 16; off > 0; off /= 2) {
      v = min(v, __shfl_down_sync(0xFFFFFFFFu, v, off));
    }
    if (lid == 0) part[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < 8) {
    int v = 0;
    if (threadIdx.x < 6) {
      v = part[0][threadIdx.x];
      for (int w = 1; w < kWarps; ++w) v = min(v, part[w][threadIdx.x]);
    }
    out[threadIdx.x] = v;
  }
}

}  // namespace phase_scan
