// B1: the fused incidence consumer, CUDA C++ for sm_90a.
//
// Replaces the Pallas kernel antrea_tpu/ops/match.py:_consumer_call (both
// of its bodies, _phase_scan_tile and the shard-aware _phase_scan_tile_dyn)
// together with the six row gathers that feed it (match.py:1246-1270).
// Per lane and direction it ANDs the three incidence rows (appliedTo, peer,
// service; the egress service row ORed with the toServices row when svcref
// is set), read straight from the tables at the lane's interval rows, and
// returns, for each of the three contiguous rule phases [0, n0),
// [n0, n0 + nk), [n0 + nk, 2**30), the lowest set global rule index, or
// BIG = 1 << 30 when the phase has no match.  Output row per lane:
// [in0, ink, inb, out0, outk, outb, 0, 0] (int32).  Rule r of word j is bit
// (r - 32 * (w0 + j)); w0 is the direction's global word offset (0 on one
// card, the shard's first word under rule sharding).
//
// Inputs: the six tables (rows, w) int32 in the order ingress at/peer/svc,
// egress at/peer/svc; iv (B, 8) int32, the lanes' interval rows
// [in_at, in_peer, in_svc, out_at, out_peer, out_svc, svcref_row, 0].  Row
// indices are clamped to the table, as the framework's gather clamps them.
//
// What bounds it: bytes.  A lane reads 6 rows (7 with svcref) of w words,
// 37.5 KB at the 100k-rule widths (w_in 1866, w_out 1260); the card's least
// time counts each distinct (table, row) once, since rows that many lanes
// share come from L2 after the first read.  The gathered-row contract this
// replaces wrote the B rows out with torch indexing and read them back, at
// least three times these bytes.  At large B every lane still reads its own
// rows, from L2: on an H100 at B = 32768 they stream at about 6 TB/s, so
// L2's rate, not device memory's, bounds it there (PERF.md); reading a row
// once for all the lanes that share it is the next step.
//
// Design: one block of 256 threads per lane.  The lane's words are cut into
// 4-word groups, ingress groups first, and thread t takes groups t,
// t + 256, ... four at a time: for each of the four it issues the loads of
// all three (or four) rows before any AND, so a thread has 12 to 16 loads
// in flight and a lane completes in one memory round trip at these widths
// (782 groups: 3 or 4 a thread).  A block is 8 warps, so B = 256 gives
// 2048 warps over the 132 SMs.  Each thread folds its nonzero words into
// six minima (phase_scan.cuh); a warp-shuffle min and a min over the warps
// in shared memory give the lane's row, deterministically.
//
// Alignment: a row starts at row * w * 4 bytes, which is 16-byte aligned
// only when w % 4 == 0 (w_in 1866 gives 8-byte aligned odd rows).  Each
// group load takes the widest access its row's address allows: one 16-byte
// load, two 8-byte loads, or four 4-byte loads (the choice is the same for
// every thread of the row, so a warp does not diverge on it); the last
// group of a row reads only the words below w.  The tables are not padded:
// they stay the arrays the JAX package builds.

#include <cuda_runtime.h>
#include <stdint.h>

#include "phase_scan.cuh"

namespace {

using phase_scan::kBig;
using phase_scan::kThreads;

constexpr int kGroups = 4;  // 4-word groups a thread loads before its ANDs

struct Params {
  const uint32_t* inc[6];
  const int32_t* iv;
  int32_t* out;
  int rows[6];
  int b, w_in, w_out, w0_in, w0_out, in_n0, in_nk, out_n0, out_nk, svcref;
};

// Words j .. j + 3 of row p (w words, j % 4 == 0); words at or past w read
// as 0.  The load width follows p's alignment (p + j has the same).
__device__ __forceinline__ uint4 load_group(const uint32_t* __restrict__ p,
                                            int j, int w) {
  if (j + 4 <= w) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(p);
    if ((a & 15u) == 0u) return __ldg(reinterpret_cast<const uint4*>(p + j));
    if ((a & 7u) == 0u) {
      const uint2 lo = __ldg(reinterpret_cast<const uint2*>(p + j));
      const uint2 hi = __ldg(reinterpret_cast<const uint2*>(p + j + 2));
      return make_uint4(lo.x, lo.y, hi.x, hi.y);
    }
    return make_uint4(__ldg(p + j), __ldg(p + j + 1), __ldg(p + j + 2),
                      __ldg(p + j + 3));
  }
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (j < w) v.x = __ldg(p + j);
  if (j + 1 < w) v.y = __ldg(p + j + 1);
  if (j + 2 < w) v.z = __ldg(p + j + 2);
  return v;
}

__device__ __forceinline__ const uint32_t* row_ptr(const Params& p, int t,
                                                   int r, int w) {
  r = r < 0 ? 0 : (r >= p.rows[t] ? p.rows[t] - 1 : r);
  return p.inc[t] + static_cast<long long>(r) * w;
}

__device__ __forceinline__ void scan_group(uint4 m, long long word,
                                           long long b0, long long b1,
                                           int* h) {
  if (m.x) phase_scan::scan_word(m.x, word * 32, b0, b1, h);
  if (m.y) phase_scan::scan_word(m.y, (word + 1) * 32, b0, b1, h);
  if (m.z) phase_scan::scan_word(m.z, (word + 2) * 32, b0, b1, h);
  if (m.w) phase_scan::scan_word(m.w, (word + 3) * 32, b0, b1, h);
}

__global__ void __launch_bounds__(kThreads) consumer_kernel(const Params p) {
  const long long lane = blockIdx.x;
  const int32_t* iv = p.iv + lane * 8;
  const uint32_t* ia = row_ptr(p, 0, iv[0], p.w_in);
  const uint32_t* ip = row_ptr(p, 1, iv[1], p.w_in);
  const uint32_t* is = row_ptr(p, 2, iv[2], p.w_in);
  const uint32_t* oa = row_ptr(p, 3, iv[3], p.w_out);
  const uint32_t* op = row_ptr(p, 4, iv[4], p.w_out);
  const uint32_t* os = row_ptr(p, 5, iv[5], p.w_out);
  const uint32_t* oref = p.svcref ? row_ptr(p, 5, iv[6], p.w_out) : nullptr;
  const int gi = (p.w_in + 3) / 4;
  const int ng = gi + (p.w_out + 3) / 4;
  const long long in_b1 = static_cast<long long>(p.in_n0) + p.in_nk;
  const long long out_b1 = static_cast<long long>(p.out_n0) + p.out_nk;

  int best[6] = {kBig, kBig, kBig, kBig, kBig, kBig};
  for (int g0 = 0; g0 < ng; g0 += kThreads * kGroups) {
    uint4 va[kGroups], vp[kGroups], vs[kGroups];
#pragma unroll
    for (int u = 0; u < kGroups; ++u) {
      const int g = g0 + u * kThreads + static_cast<int>(threadIdx.x);
      const bool eg = g >= gi;
      const int j = 4 * (eg ? g - gi : g);
      const int w = g < ng ? (eg ? p.w_out : p.w_in) : 0;
      va[u] = load_group(eg ? oa : ia, j, w);
      vp[u] = load_group(eg ? op : ip, j, w);
      vs[u] = load_group(eg ? os : is, j, w);
      if (eg && oref != nullptr) {
        const uint4 r = load_group(oref, j, w);
        vs[u].x |= r.x;
        vs[u].y |= r.y;
        vs[u].z |= r.z;
        vs[u].w |= r.w;
      }
    }
#pragma unroll
    for (int u = 0; u < kGroups; ++u) {
      const uint4 m = make_uint4(va[u].x & vp[u].x & vs[u].x,
                                 va[u].y & vp[u].y & vs[u].y,
                                 va[u].z & vp[u].z & vs[u].z,
                                 va[u].w & vp[u].w & vs[u].w);
      if ((m.x | m.y | m.z | m.w) == 0u) continue;
      const int g = g0 + u * kThreads + static_cast<int>(threadIdx.x);
      int h[3] = {kBig, kBig, kBig};
      if (g >= gi) {
        scan_group(m, p.w0_out + 4LL * (g - gi), p.out_n0, out_b1, h);
        best[3] = min(best[3], h[0]);
        best[4] = min(best[4], h[1]);
        best[5] = min(best[5], h[2]);
      } else {
        scan_group(m, p.w0_in + 4LL * g, p.in_n0, in_b1, h);
        best[0] = min(best[0], h[0]);
        best[1] = min(best[1], h[1]);
        best[2] = min(best[2], h[2]);
      }
    }
  }
  phase_scan::block_min6(best, p.out + lane * 8);
}

}  // namespace

// C entry point (loaded with ctypes).  ptrs: the six tables, iv, out
// (device pointers).  ints: b, w_in, w_out, w0_in, w0_out, in_n0, in_nk,
// out_n0, out_nk, svcref, then the six tables' row counts.  Launches on
// `stream`, allocates nothing, and returns cudaGetLastError() so a refused
// launch is reported.
extern "C" int b1_consumer(void* const* ptrs, const int* ints, void* stream) {
  Params p;
  for (int i = 0; i < 6; ++i) p.inc[i] = static_cast<const uint32_t*>(ptrs[i]);
  p.iv = static_cast<const int32_t*>(ptrs[6]);
  p.out = static_cast<int32_t*>(ptrs[7]);
  int* f[] = {&p.b, &p.w_in, &p.w_out, &p.w0_in, &p.w0_out, &p.in_n0,
              &p.in_nk, &p.out_n0, &p.out_nk, &p.svcref};
  const int nf = static_cast<int>(sizeof(f) / sizeof(f[0]));
  for (int i = 0; i < nf; ++i) *f[i] = ints[i];
  for (int i = 0; i < 6; ++i) p.rows[i] = ints[nf + i];
  consumer_kernel<<<p.b, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
