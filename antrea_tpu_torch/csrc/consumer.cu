// B1: the fused incidence consumer, CUDA C++ for sm_90a.
//
// Replaces the Pallas kernel antrea_tpu/ops/match.py:_consumer_call (both
// of its bodies, _phase_scan_tile and the shard-aware _phase_scan_tile_dyn).
// Per lane and direction it ANDs the three gathered incidence rows
// (appliedTo, peer, service) and returns, for each of the three contiguous
// rule phases [0, n0), [n0, n0 + nk), [n0 + nk, 2**30), the lowest set
// global rule index, or BIG = 1 << 30 when the phase has no match.
// Output row per lane: [in0, ink, inb, out0, outk, outb, 0, 0] (int32).
// Rule r of word j is bit (r - 32 * (w0 + j)); w0 is the direction's global
// word offset (0 on one card, the shard's first word under rule sharding).
//
// What bounds it: bytes.  It reads B * (3 * w_in + 3 * w_out) * 4 bytes
// once each and does a few integer operations per word.  At the 100k-rule
// world (w_in 1866, w_out 1260) that is 9.6 MB at B = 256, 2.9 us at the
// H100's 3.35 TB/s, and 1.23 GB at B = 32768, 0.37 ms.
//
// Design: one block of 256 threads per lane; threads stride over the words
// so that a warp reads 128 contiguous bytes of each row per step; each
// thread keeps its own six minima, then a warp-shuffle min and a min over
// the block's warps in shared memory give the lane's six outputs (the scan
// and the reduction live in phase_scan.cuh, shared with S1).  Any B is
// taken as it comes (no tile padding).
//
// Later work: the rows come from torch indexing (the six row gathers of
// classify_batch, left to the framework as the JAX package leaves them to
// XLA), which writes the rows once and this kernel reads them again, so the
// gather triples the traffic above.  Gathering the interval rows inside this
// kernel removes that.

#include <cuda_runtime.h>
#include <stdint.h>

#include "phase_scan.cuh"

namespace {

using phase_scan::kBig;
using phase_scan::kThreads;

// One direction of one lane: the thread's minima of the three phases.
__device__ __forceinline__ void scan_direction(
    const uint32_t* __restrict__ at, const uint32_t* __restrict__ peer,
    const uint32_t* __restrict__ svc, int w, long long w0, long long b0,
    long long b1, int* best) {
  for (int j = threadIdx.x; j < w; j += kThreads) {
    uint32_t m = at[j] & peer[j] & svc[j];
    if (m == 0u) continue;
    phase_scan::scan_word(m, (w0 + j) * 32, b0, b1, best);
  }
}

__global__ void __launch_bounds__(kThreads) consumer_kernel(
    const uint32_t* __restrict__ ia, const uint32_t* __restrict__ ip,
    const uint32_t* __restrict__ is, const uint32_t* __restrict__ oa,
    const uint32_t* __restrict__ op, const uint32_t* __restrict__ os,
    int32_t* __restrict__ out, int w_in, int w_out, int w0_in, int w0_out,
    int in_n0, int in_nk, int out_n0, int out_nk) {
  const long long lane = blockIdx.x;
  int best[6] = {kBig, kBig, kBig, kBig, kBig, kBig};
  const long long ri = lane * w_in;
  const long long ro = lane * w_out;
  scan_direction(ia + ri, ip + ri, is + ri, w_in, w0_in, in_n0,
                 static_cast<long long>(in_n0) + in_nk, best);
  scan_direction(oa + ro, op + ro, os + ro, w_out, w0_out, out_n0,
                 static_cast<long long>(out_n0) + out_nk, best + 3);
  phase_scan::block_min6(best, out + lane * 8);
}

}  // namespace

// C entry point (loaded with ctypes).  Launches on `stream`, allocates
// nothing, and returns cudaGetLastError() so a refused launch is reported.
extern "C" int b1_consumer(const void* ia, const void* ip, const void* is,
                           const void* oa, const void* op, const void* os,
                           void* out, int b, int w_in, int w_out, int w0_in,
                           int w0_out, int in_n0, int in_nk, int out_n0,
                           int out_nk, void* stream) {
  consumer_kernel<<<b, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(ia), static_cast<const uint32_t*>(ip),
      static_cast<const uint32_t*>(is), static_cast<const uint32_t*>(oa),
      static_cast<const uint32_t*>(op), static_cast<const uint32_t*>(os),
      static_cast<int32_t*>(out), w_in, w_out, w0_in, w0_out, in_n0, in_nk,
      out_n0, out_nk);
  return static_cast<int>(cudaGetLastError());
}
