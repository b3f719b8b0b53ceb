// The candidate-superblock scan shared by B2 (pruned_consumer.cu) and B3
// (onepass.cu): the device half of the JAX package's candidate gather and
// _phase_first_from_base (antrea_tpu/ops/match.py:1656-1700 and :725).
//
// One warp scans one direction of one lane.  The lane's aggregate AND has
// one word per 32-word superblock of the incidence rows (bit j of word c is
// set iff incidence word 32 * c + j is nonzero in every dimension's
// aggregate row).  A ballot over the nonzero aggregate words gives the
// candidate count by __popc and the candidates in ascending order by __ffs,
// exactly the values of top_k over the scores (word index, or S when the
// word is zero).  The ke lowest candidates are scanned: thread t reads word
// t of each candidate's 32-word block in the three dimension rows (and the
// toServices row ORed into the service row), 128 coalesced bytes per row,
// ANDs them and folds the nonzero word, whose bit 0 is global rule
// (w0 + 32 * c + t) * 32, into the three phase minima.  Up to kBatch
// candidates are fetched together so their loads are in flight at once; a
// batch short of kBatch repeats its first candidate, which a min ignores.
// B2 fetches four at a time.  B3 fetches one: its kernel also searches,
// resolves and packs, and more in flight cost it registers and warps an SM
// (chip_b3_variants.py).
// Candidates past ke (the fill of top_k, whose words the JAX package zeroes)
// are never read.  The caller reduces the minima over the warp.

#pragma once

#include <stdint.h>

namespace candidate_scan {

constexpr int kBig = 1 << 30;
constexpr int kAgg = 32;  // words per superblock (AGG_BLOCK)

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

__device__ __forceinline__ void take(uint32_t bits, int base, int* best) {
  if (bits) *best = min(*best, base + __ffs(static_cast<int>(bits)) - 1);
}

// One direction of one lane, called by all 32 threads of a warp.  agg(w) is
// the lane's aggregate AND word w < S; ia/ip/is are the lane's three
// incidence rows of S * 32 words, iref the toServices row or nullptr.
// Folds the thread's share of the ke lowest candidates into best[0..2] (the
// phases split at b0 and b1) and returns the number of nonzero aggregate
// words; with kCount false the count stops early, once ke candidates are
// taken (the caller does not need it).  kBatch: candidates in flight.
template <bool kCount, int kBatch, class Agg>
__device__ __forceinline__ int scan(Agg agg, int S, int ke,
                                    const uint32_t* __restrict__ ia,
                                    const uint32_t* __restrict__ ip,
                                    const uint32_t* __restrict__ is,
                                    const uint32_t* __restrict__ iref,
                                    long long w0, long long b0, long long b1,
                                    int* best) {
  const int lid = threadIdx.x & 31;
  int nc = 0;
  int taken = 0;
  for (int c0 = 0; c0 < S; c0 += 32) {
    if (!kCount && taken >= ke) break;
    const int w = c0 + lid;
    const uint32_t g = w < S ? agg(w) : 0u;
    uint32_t bal = __ballot_sync(0xFFFFFFFFu, g != 0u);
    nc += __popc(bal);
    while (bal != 0u && taken < ke) {
      int c[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (u == 0 || (bal != 0u && taken < ke)) {
          c[u] = c0 + __ffs(static_cast<int>(bal)) - 1;
          bal &= bal - 1u;
          ++taken;
        } else {
          c[u] = c[0];
        }
      }
      uint32_t va[kBatch], vp[kBatch], vs[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const long long off = static_cast<long long>(c[u]) * kAgg + lid;
        va[u] = ia[off];
        vp[u] = ip[off];
        vs[u] = is[off];
        if (iref != nullptr) vs[u] |= iref[off];
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const uint32_t m = va[u] & vp[u] & vs[u];
        if (m != 0u) {
          const int base = static_cast<int>(
              (w0 + static_cast<long long>(c[u]) * kAgg + lid) * 32);
          take(m & phase_mask(base, 0, b0), base, &best[0]);
          take(m & phase_mask(base, b0, b1), base, &best[1]);
          take(m & phase_mask(base, b1, kBig), base, &best[2]);
        }
      }
    }
  }
  return nc;
}

}  // namespace candidate_scan
