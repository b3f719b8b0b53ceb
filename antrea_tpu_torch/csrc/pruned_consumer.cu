// B2: the pruned candidate consumer, CUDA C++ for sm_90a.
//
// Replaces the Pallas kernel antrea_tpu/ops/match.py:_pruned_consumer_call
// together with the candidate gather that feeds it (cand_mats,
// match.py:1656-1700: the top_k of the candidate superblocks, the
// candidate-word gathers of the three dimensions, the zeroed fill words and
// the base matrix).  Per lane and direction it takes the lane's aggregate
// AND row g (one word per 32-word superblock), selects the ke lowest
// superblocks whose word is nonzero, ANDs their words in the three
// incidence rows at the lane's interval rows (the egress service row ORed
// with the toServices row when svcref is set), and returns, for each of the
// three contiguous rule phases [0, n0), [n0, n0 + nk), [n0 + nk, 2**30),
// the lowest set global rule index, or BIG = 1 << 30.  Output row per lane:
// [in0, ink, inb, out0, outk, outb, 0, 0] (int32).  A lane with more than
// ke candidates returns the scan of its ke lowest (the caller's full-width
// fallback overwrites it), one with fewer scans only its own.
//
// Inputs: g_in (B, S_in) and g_out (B, S_out) int32; iv (B, 8) int32, the
// lanes' interval rows [in_at, in_peer, in_svc, out_at, out_peer, out_svc,
// svcref_row, 0] (clamped to the tables); the six tables (rows, S * 32)
// int32, ingress at/peer/svc then egress at/peer/svc.
//
// What bounds it: bytes.  A lane reads its two g rows (S_in + S_out words,
// 396 B at the 100k-rule widths) and, per direction, 128 B of each
// dimension row for each candidate it scans (at most 6 * K * 128 B = 3 KB
// at K = 4, a fourth row with svcref); the card's least time counts each
// distinct (table, row, superblock) once.  The candidate matrices this
// replaces were gathered by torch into (B, K * 32) int32 matrices, a base
// matrix a quarter of them, then read back.
//
// Design: one warp per lane and direction, one lane (two warps) to a block,
// so B = 256 gives 256 blocks over the 132 SMs.  The warp runs
// candidate_scan.cuh's scan (shared with B3): a ballot over g's nonzero
// words, the candidates in ascending order by __ffs, up to four candidates'
// 128-byte blocks loaded together, the base derived from the candidate id
// ((w0 + 32 * c + t) * 32), then the AND, the phase masks and __ffs; a
// warp-shuffle min gives the direction's three outputs.  Any B is taken as
// it comes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "candidate_scan.cuh"

namespace {

using candidate_scan::kAgg;
using candidate_scan::kBig;
constexpr int kThreads = 64;  // one lane: warp 0 ingress, warp 1 egress

struct Params {
  const uint32_t* g[2];
  const int32_t* iv;
  const uint32_t* inc[6];
  int32_t* out;
  int rows[6];
  int b, s_in, s_out, ke_in, ke_out, w0_in, w0_out, in_n0, in_nk, out_n0,
      out_nk, svcref;
};

__device__ __forceinline__ const uint32_t* row_ptr(const Params& p, int t,
                                                   int r, long long w) {
  r = r < 0 ? 0 : (r >= p.rows[t] ? p.rows[t] - 1 : r);
  return p.inc[t] + r * w;
}

__global__ void __launch_bounds__(kThreads) pruned_kernel(const Params p) {
  const int d = threadIdx.x / 32;  // 0 ingress, 1 egress
  const int lid = threadIdx.x % 32;
  const long long lane = blockIdx.x;
  const int S = d ? p.s_out : p.s_in;
  const long long W = static_cast<long long>(S) * kAgg;
  const int32_t* iv = p.iv + lane * 8;
  const uint32_t* g = p.g[d] + lane * S;
  const uint32_t* iref =
      (d && p.svcref) ? row_ptr(p, 5, iv[6], W) : nullptr;
  const long long b0 = d ? p.out_n0 : p.in_n0;

  int best[3] = {kBig, kBig, kBig};
  candidate_scan::scan<false, 4>(
      [=](int w) { return g[w]; }, S, d ? p.ke_out : p.ke_in,
      row_ptr(p, 3 * d, iv[3 * d], W), row_ptr(p, 3 * d + 1, iv[3 * d + 1], W),
      row_ptr(p, 3 * d + 2, iv[3 * d + 2], W), iref, d ? p.w0_out : p.w0_in,
      b0, b0 + (d ? p.out_nk : p.in_nk), best);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off /= 2) {
      best[k] = min(best[k], __shfl_xor_sync(0xFFFFFFFFu, best[k], off));
    }
  }
  if (lid < 3) {
    p.out[lane * 8 + 3 * d + lid] = lid == 0 ? best[0] : (lid == 1 ? best[1]
                                                                    : best[2]);
  } else if (d == 0 && lid < 5) {
    p.out[lane * 8 + 3 + lid] = 0;  // columns 6 and 7
  }
}

}  // namespace

// C entry point (loaded with ctypes).  ptrs: g_in, g_out, iv, the six
// tables, out (device pointers).  ints: b, s_in, s_out, ke_in, ke_out,
// w0_in, w0_out, in_n0, in_nk, out_n0, out_nk, svcref, then the six tables'
// row counts.  Launches on `stream`, allocates nothing, and returns
// cudaGetLastError() so a refused launch is reported.
extern "C" int b2_pruned_consumer(void* const* ptrs, const int* ints,
                                  void* stream) {
  Params p;
  p.g[0] = static_cast<const uint32_t*>(ptrs[0]);
  p.g[1] = static_cast<const uint32_t*>(ptrs[1]);
  p.iv = static_cast<const int32_t*>(ptrs[2]);
  for (int i = 0; i < 6; ++i) p.inc[i] = static_cast<const uint32_t*>(ptrs[3 + i]);
  p.out = static_cast<int32_t*>(ptrs[9]);
  int* f[] = {&p.b, &p.s_in, &p.s_out, &p.ke_in, &p.ke_out, &p.w0_in,
              &p.w0_out, &p.in_n0, &p.in_nk, &p.out_n0, &p.out_nk, &p.svcref};
  const int nf = static_cast<int>(sizeof(f) / sizeof(f[0]));
  for (int i = 0; i < nf; ++i) *f[i] = ints[i];
  for (int i = 0; i < 6; ++i) p.rows[i] = ints[nf + i];
  pruned_kernel<<<p.b, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
