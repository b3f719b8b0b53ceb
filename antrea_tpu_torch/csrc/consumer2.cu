// S1: the two-input phase scan of the cold-path study, CUDA C++ for sm_90a.
//
// Replaces the Pallas kernel `consumer2` of bench_cold_study.py:129 (the
// study's case 4): the framework has already gathered each direction's
// three interval rows and ANDed them, and the kernel scans the two ANDed
// matrices, (B, w_in) and (B, w_out) int32 (u32 bits), for each of the
// three rule phases [0, n0), [n0, n0 + nk), [n0 + nk, ...) the lowest set
// rule index, or BIG = 1 << 30.  Output row per lane: [in0, ink, inb, out0,
// outk, outb, 0, 0] (int32).  It is B1's phase scan (phase_scan.cuh) minus
// the AND; the JAX kernel bounds phase b by w * 32 and this one by BIG,
// which agree because no bit lies past word w.  The JAX grid needs
// B % 128 == 0; this kernel takes any B.
//
// What bounds it: bytes.  It reads B * (w_in + w_out) * 4 bytes once and
// writes B * 32: at the 100k-rule widths (w_in 1866, w_out 1260) and
// B = 32768 that is 410 MB, 0.122 ms at the H100's 3.35 TB/s.
//
// Design: B1's.  One block of 256 threads per lane; threads stride over the
// words so a warp reads 128 contiguous bytes of a row per step; each thread
// keeps its six minima (phase masks from [lo, hi) against 32 * word, __ffs),
// then a warp-shuffle min and a min over the block's warps give the lane's
// row.

#include <cuda_runtime.h>
#include <stdint.h>

#include "phase_scan.cuh"

namespace {

using phase_scan::kBig;
using phase_scan::kThreads;

__device__ __forceinline__ void scan_matrix_row(
    const uint32_t* __restrict__ m, int w, long long b0, long long b1,
    int* best) {
  for (int j = threadIdx.x; j < w; j += kThreads) {
    uint32_t v = m[j];
    if (v == 0u) continue;
    phase_scan::scan_word(v, static_cast<long long>(j) * 32, b0, b1, best);
  }
}

__global__ void __launch_bounds__(kThreads) consumer2_kernel(
    const uint32_t* __restrict__ mi, const uint32_t* __restrict__ mo,
    int32_t* __restrict__ out, int w_in, int w_out, int in_n0, int in_nk,
    int out_n0, int out_nk) {
  const long long lane = blockIdx.x;
  int best[6] = {kBig, kBig, kBig, kBig, kBig, kBig};
  scan_matrix_row(mi + lane * w_in, w_in, in_n0,
                  static_cast<long long>(in_n0) + in_nk, best);
  scan_matrix_row(mo + lane * w_out, w_out, out_n0,
                  static_cast<long long>(out_n0) + out_nk, best + 3);
  phase_scan::block_min6(best, out + lane * 8);
}

}  // namespace

// C entry point (loaded with ctypes).  Launches on `stream`, allocates
// nothing, and returns cudaGetLastError() so a refused launch is reported.
extern "C" int s1_consumer2(const void* mi, const void* mo, void* out, int b,
                            int w_in, int w_out, int in_n0, int in_nk,
                            int out_n0, int out_nk, void* stream) {
  consumer2_kernel<<<b, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(mi), static_cast<const uint32_t*>(mo),
      static_cast<int32_t*>(out), w_in, w_out, in_n0, in_nk, out_n0, out_nk);
  return static_cast<int>(cudaGetLastError());
}
