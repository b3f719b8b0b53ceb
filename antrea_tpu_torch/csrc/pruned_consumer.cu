// B2: the pruned candidate consumer, CUDA C++ for sm_90a.
//
// Replaces the Pallas kernel antrea_tpu/ops/match.py:_pruned_consumer_call.
// Per lane and direction it ANDs the three candidate-word matrices
// (appliedTo, peer, service words of the lane's K lowest candidate
// superblocks, K * 32 words) and returns, for each of the three contiguous
// rule phases [0, n0), [n0, n0 + nk), [n0 + nk, 2**30), the lowest set
// global rule index, or BIG = 1 << 30 when the phase has no match.  Word j
// of a lane carries its own base: bit t of it is global rule base[j] + t
// (the JAX package's _phase_first_from_base).  Output row per lane:
// [in0, ink, inb, out0, outk, outb, 0, 0] (int32).
//
// What bounds it: bytes.  It reads the eight (B, K * 32) int32 matrices
// once and writes (B, 8): B * 8 * K * 32 * 4 + B * 32 bytes, 1.06 MB at
// K = 4 and B = 256 (0.32 us at the H100's 3.35 TB/s; the launch costs
// more) and 135 MB at B = 32768 (40 us).
//
// Design: one warp per lane and direction, four lanes (eight warps) to a
// block.  Thread j walks words j, j + 32, ... of the direction's rows, so a
// warp reads 128 contiguous bytes of each matrix per step; it masks each
// phase's [lo, hi) window against the word's base, takes __ffs, and a
// warp-shuffle min gives the three outputs.  Any B is taken as it comes.
//
// Later work: the base matrices are a quarter of the traffic and could be
// derived here from the candidate ids; the candidate-word gathers that
// feed the kernel (torch indexing in ops/match._classify_pruned) write the
// matrices once and the kernel reads them again.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBig = 1 << 30;
constexpr int kLanesPerBlock = 4;
constexpr int kThreads = kLanesPerBlock * 64;

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

__global__ void __launch_bounds__(kThreads) pruned_kernel(
    const uint32_t* __restrict__ ia, const uint32_t* __restrict__ ip,
    const uint32_t* __restrict__ is, const int32_t* __restrict__ bi,
    const uint32_t* __restrict__ oa, const uint32_t* __restrict__ op,
    const uint32_t* __restrict__ os, const int32_t* __restrict__ bo,
    int32_t* __restrict__ out, int b, int kw_in, int kw_out, int in_n0,
    int in_nk, int out_n0, int out_nk) {
  const int warp = threadIdx.x / 32;
  const int lid = threadIdx.x % 32;
  const long long lane =
      static_cast<long long>(blockIdx.x) * kLanesPerBlock + warp / 2;
  if (lane >= b) return;  // the whole warp leaves together
  const bool egress = (warp & 1) != 0;
  const int kw = egress ? kw_out : kw_in;
  const long long row = lane * kw;
  const uint32_t* a = (egress ? oa : ia) + row;
  const uint32_t* p = (egress ? op : ip) + row;
  const uint32_t* s = (egress ? os : is) + row;
  const int32_t* base = (egress ? bo : bi) + row;
  const long long b0 = egress ? out_n0 : in_n0;
  const long long b1 = b0 + (egress ? out_nk : in_nk);

  int best[3] = {kBig, kBig, kBig};
  for (int j = lid; j < kw; j += 32) {
    uint32_t m = a[j] & p[j] & s[j];
    if (m == 0u) continue;
    const int bs = base[j];
    take(m & phase_mask(bs, 0, b0), bs, &best[0]);
    take(m & phase_mask(bs, b0, b1), bs, &best[1]);
    take(m & phase_mask(bs, b1, kBig), bs, &best[2]);
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off /= 2) {
      best[k] = min(best[k], __shfl_down_sync(0xFFFFFFFFu, best[k], off));
    }
  }
  if (lid == 0) {
    int32_t* o = out + lane * 8 + (egress ? 3 : 0);
    o[0] = best[0];
    o[1] = best[1];
    o[2] = best[2];
    if (!egress) {
      out[lane * 8 + 6] = 0;
      out[lane * 8 + 7] = 0;
    }
  }
}

}  // namespace

// C entry point (loaded with ctypes).  Launches on `stream`, allocates
// nothing, and returns cudaGetLastError() so a refused launch is reported.
extern "C" int b2_pruned_consumer(const void* ia, const void* ip,
                                  const void* is, const void* bi,
                                  const void* oa, const void* op,
                                  const void* os, const void* bo, void* out,
                                  int b, int kw_in, int kw_out, int in_n0,
                                  int in_nk, int out_n0, int out_nk,
                                  void* stream) {
  const int blocks = (b + kLanesPerBlock - 1) / kLanesPerBlock;
  pruned_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(ia), static_cast<const uint32_t*>(ip),
      static_cast<const uint32_t*>(is), static_cast<const int32_t*>(bi),
      static_cast<const uint32_t*>(oa), static_cast<const uint32_t*>(op),
      static_cast<const uint32_t*>(os), static_cast<const int32_t*>(bo),
      static_cast<int32_t*>(out), b, kw_in, kw_out, in_n0, in_nk, out_n0,
      out_nk);
  return static_cast<int>(cudaGetLastError());
}
