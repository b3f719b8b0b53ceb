// B3: the one-pass slow path, CUDA C++ for sm_90a.
//
// Replaces the Pallas kernel antrea_tpu/ops/match.py:_onepass_call in both
// its variants, and the probes the JAX step runs ahead of it
// (antrea_tpu/models/pipeline.py:1684-1711: interval rows, isolation bits,
// aggregate rows).  The resolve variant (one card) does, for every lane of
// the batch, in one pass:
//   - the flow-cache probe decode on the key, meta and ts rows gathered at
//     batch start (key compare, generation, per-state freshness);
//   - for miss lanes, on the post-DNAT tuple: the interval row of each
//     dimension (searchsorted(right=True) on the signed int32 bounds:
//     ingress at with dnat_ip, peer with src_f, svc with (proto << 16) |
//     dnat_port; egress at with src_f, peer with dnat_ip, svc with the same
//     key; with svcref also egress svc with the toServices key of the
//     lane's program), the two isolation bits, and the six aggregate rows
//     read from the tables (the svcref row ORed into egress svc);
//   - the aggregate AND per direction: nc, the count of nonzero words (zero
//     in both directions = skip; more than Ke = min(K, S) in either =
//     fallback), and the Ke lowest nonzero positions as candidate
//     superblocks; per candidate the 32 words of each dimension's
//     incidence row, their AND, and per rule phase the first set bit;
//   - the action fetch at the clipped first-match indices, the verdict with
//     the isolation bits, the ServiceLB / no-endpoint overlay, the merge
//     with the cached image of hit lanes;
//   - the forward and reply commit rows, with the reply slot's FNV-1a hash.
// The hits-only variant (resolve=False: a rule shard of the mesh, whose
// tables are the shard's word slice) stops after the first matches, which
// it emits as global rule indices (hits8), with aux and iv; the caller
// re-walks the fallback lanes, combines across the rule shards and then
// resolves and packs.  It is a compile-time instantiation of the same
// kernel, so the resolve variant's code and registers are unchanged.
// Non-miss lanes take interval row 0 everywhere, as the JAX step's masked
// probes do; every lane writes every output column, hit lanes included
// (their fresh code in meta8 reads isolation row 0).  Outputs (int32):
// main (B, 16) [code, rule_in, rule_out, svc, dnat_ip_f, dnat_port, snat,
// dsr, committed, rev_ins, rev_slot, hit, est, rpl, ins, 0], keys8 (B, 8),
// meta8 (B, 8), aux (B, 4) [skip, fb, cand, 0], iv (B, 8) [in_at,
// in_peer, in_svc, out_at, out_peer, out_svc, svcref_row, iso_in |
// iso_out << 1] (zero on non-miss lanes).  Fallback lanes are re-walked at
// full width by the caller from iv.
//
// What bounds it: bytes.  Every lane streams 29 input words and 44 output
// words: about 38 MB and 11.4 us at the H100's 3.35 TB/s for 2**17 lanes,
// which is all a warm batch (a few dozen misses) needs.  The hits-only
// variant streams 17 input words a lane (pkt, kr, ts, msk; the meta row
// too under per-state timeouts) and 20 output words, and reads the lb row
// of a miss lane only.  A miss lane adds
// its searches (ceil(log32 n) levels of one load a thread per table), its
// six or seven aggregate rows (S = 59 / 40 words at the 100k-rule widths)
// and up to 6 * K * 128 B of candidate blocks; the bounds arrays (346 KB)
// and the rows the lanes share stay in the 50 MB L2.
//
// Design: a thread a lane for the per-lane work, a warp a miss lane for
// the scans.  A block takes 128 lanes, one thread each: the thread loads
// its lane's rows and decodes the probe.  A ballot compacts the block's
// miss lanes into a shared-memory list (with their search keys); the
// block's four warps then take miss lanes from the list.  For each, the
// warp runs the nine searches together, level by level: at a level each
// thread probes one of 32 evenly spaced bounds per table and a ballot's
// popcount narrows the range 32-fold (3 levels for the largest table here,
// 33,431 bounds, against 16 dependent loads of a binary search).  It then
// reads the aggregate rows and scans the candidates with
// candidate_scan.cuh (shared with B2: thread t reads aggregate words t,
// t + 32, ...; a ballot over the nonzero ANDs gives nc and the candidates
// in ascending order; thread j reads word j of each 32-word candidate
// block), reduces the six first matches over the warp and leaves them,
// with the rows and isolation bits, in the lane's shared-memory slot.
// After a barrier each thread resolves, merges and packs its own lane; the
// rows are staged through shared memory so each output array is written
// with coalesced 16-byte stores.  A warm batch thus costs about one
// streaming pass, and blocks without a miss lane skip the scans.  Every
// table row (aggregate rows and candidate blocks alike) is addressed
// through row_at(), the one place a patched-row overlay would go in.  Any
// B is taken as it comes (no tile padding).
//
// An all-miss batch is bound by the miss lanes' chains of dependent loads
// (about 31 lanes a warp at 32 warps an SM at B = 2**17), so it follows
// occupancy: 64 registers, 8 blocks an SM, was the best found on an H100.
// chip_b3_variants.py times this kernel against two or four candidates in
// flight and against caps of 48 and 40 registers (PERF.md has the times).
// Also tried, each above 64 registers and slower on all-miss batches:
// staging the five output rows in one shared buffer with fewer barriers,
// and loading the first aggregate words and the isolation bits ahead of
// the scans.

#include <cuda_runtime.h>
#include <stdint.h>

#include "candidate_scan.cuh"

namespace {

using candidate_scan::kAgg;
using candidate_scan::kBig;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;  // lanes a block, one thread each
constexpr int kActAllow = 0;
constexpr int kActDrop = 1;
constexpr int kActReject = 2;
constexpr int kActPass = 3;
constexpr int kMiss = -1;
constexpr int kProtoTcp = 6;
constexpr int kSvcrefBase = 1 << 24;  // compiler/compile.py SVCREF_BASE
constexpr int kSvcrefNone = 1 << 30;  // SVCREF_NONE
constexpr uint32_t kGenEternal = (1u << 22) - 1u;
constexpr uint32_t kReplyBit = 0x80000000u;
constexpr uint32_t kDsrBit = 1u << 30;
constexpr uint32_t kFnvPrime = 16777619u;
constexpr uint32_t kFnvBasis = 0x811C9DC5u;
constexpr uint32_t kFlowSalt = 0x5CA1AB1Eu;

// The searches of a miss lane: the six dimensions, the svcref probe (egress
// svc again), iso_in, iso_out.
constexpr int kSearch = 9;
// Search keys of a miss lane, in its shared-memory slot.
enum Key { kDnat, kSrc, kSvc, kRef, kKeys };
// A miss lane's slot: its keys, then what its warp found.
constexpr int kBest = kKeys;       // six first matches
constexpr int kNc = kBest + 6;     // nc_in, nc_out
constexpr int kRow = kNc + 2;      // seven interval rows
constexpr int kIso = kRow + 7;     // iso_in, iso_out
constexpr int kSlot = kIso + 2;    // 21, odd: slots spread over banks

struct Params {
  const int32_t* pkt;
  const int32_t* kr;
  const int32_t* ts;
  const int32_t* mrow;
  const int32_t* msk;
  const int32_t* lb;
  const int32_t* bounds[8];  // six dimensions, iso_in, iso_out
  const uint32_t* agg[6];
  const uint32_t* inc[6];
  const int32_t* iso_val[2];
  const int32_t* prog_svc;
  const int32_t* act_in;
  const int32_t* act_out;
  int32_t* main;
  int32_t* keys8;
  int32_t* meta8;
  int32_t* aux;
  int32_t* iv;
  int n_bounds[8];
  int b, s_in, s_out, ke_in, ke_out, n_act_in, n_act_out, n_prog, now, gen_w,
      w0_in, w0_out, in_n0, in_nk, out_n0, out_nk, svcref;
  int t_syn, t_est, t_onew, t_oest, uniform, slot_mask, pref_mask;
};

__device__ __forceinline__ int4 load4(const int32_t* p) {
  return *reinterpret_cast<const int4*>(p);
}

// Row `row` of a table `width` words wide.  Every table row the kernel
// reads, an aggregate row or a candidate block's incidence row, is
// addressed here.
__device__ __forceinline__ const uint32_t* row_at(const uint32_t* tab,
                                                  int row, long long width) {
  return tab + static_cast<long long>(row) * width;
}

__device__ __forceinline__ uint32_t fnv_step(uint32_t h, uint32_t w) {
  h = (h ^ w) * kFnvPrime;
  return h ^ (h >> 15);
}

// ops/hashing.flow_hash on raw (not sign-flipped) addresses.
__device__ __forceinline__ uint32_t flow_hash(uint32_t src, uint32_t dst,
                                              uint32_t proto, uint32_t sport,
                                              uint32_t dport) {
  uint32_t h = fnv_step(kFnvBasis, src);
  h = fnv_step(h, dst);
  h = fnv_step(h, (proto << 16) ^ sport);
  return fnv_step(h, dport ^ kFlowSalt);
}

__device__ __forceinline__ int pack_meta1(int code, int svc, int port) {
  return static_cast<int>(static_cast<uint32_t>(code) |
                          (static_cast<uint32_t>(svc + 1) << 2) |
                          (static_cast<uint32_t>(port) << 16));
}

__device__ __forceinline__ int pack_rules(int rule_in, int rule_out) {
  return static_cast<int>(static_cast<uint32_t>(rule_in + 1) |
                          (static_cast<uint32_t>(rule_out + 1) << 16));
}

// ops/match._resolve_from_actions for one lane and direction.
__device__ __forceinline__ void resolve(int a0, int ab, int h0, int hk,
                                        int hb, int iso, int* code,
                                        int* rule) {
  const bool decided0 = h0 < kBig && a0 != kActPass;
  const bool decidedb = hb < kBig && ab != kActPass;
  const bool hask = hk < kBig;
  if (decided0) {
    *code = a0;
    *rule = h0;
  } else if (iso == 1) {
    *code = hask ? kActAllow : kActDrop;
    *rule = hask ? hk : -1;
  } else {
    *code = decidedb ? ab : kActAllow;
    *rule = decidedb ? hb : -1;
  }
}

// Bounds array of search k (kSearch order) and its length (0 for the
// svcref probe when svcref is off: its row stays 0).
__device__ __forceinline__ const int32_t* search_bounds(const Params& p,
                                                        int k) {
  return p.bounds[k < 6 ? k : (k == 6 ? 5 : k - 1)];
}

__device__ __forceinline__ int search_len(const Params& p, int k) {
  if (k == 6 && !p.svcref) return 0;
  return p.n_bounds[k < 6 ? k : (k == 6 ? 5 : k - 1)];
}

// The nine searches of one miss lane, by its whole warp, all together
// level by level: row[k] = the number of bounds <= key[k] (torch's
// searchsorted(right=True) on ascending bounds).  A level splits the
// remaining `len` bounds after row[k] into 32 chunks of `step`; thread t
// tests the last bound of chunk t, and the ballot's popcount c (the tests
// hold on a prefix) puts the answer in chunk c, whose last bound, when it
// exists, is known to be greater: the range left is min(step - 1,
// len - c * step).  len and row are the same in every thread.
__device__ __forceinline__ void search_rows(const Params& p,
                                            const int (&key)[kSearch],
                                            int (&row)[kSearch]) {
  const int lid = threadIdx.x & 31;
  int len[kSearch];
  bool more = false;
#pragma unroll
  for (int k = 0; k < kSearch; ++k) {
    row[k] = 0;
    len[k] = search_len(p, k);
    more |= len[k] > 0;
  }
  while (more) {
    bool le[kSearch];
#pragma unroll
    for (int k = 0; k < kSearch; ++k) {
      const int step = (len[k] + 31) >> 5;
      const int i = (lid + 1) * step - 1;
      le[k] = len[k] > 0 && i < len[k] &&
              search_bounds(p, k)[row[k] + i] <= key[k];
    }
    more = false;
#pragma unroll
    for (int k = 0; k < kSearch; ++k) {
      if (len[k] > 0) {
        const int step = (len[k] + 31) >> 5;
        const int c = __popc(__ballot_sync(0xFFFFFFFFu, le[k]));
        row[k] += c * step;
        len[k] = min(step - 1, len[k] - c * step);
        more |= len[k] > 0;
      }
    }
  }
}

// One direction of one miss lane, by its whole warp: nc, and the thread's
// minima of the three phases over the ke lowest candidate superblocks
// (candidate_scan.cuh), on the aggregate and incidence rows at the lane's
// interval rows.
__device__ __forceinline__ int scan_direction(const Params& p, int d,
                                              const int (&row)[kSearch],
                                              int* best) {
  const int S = d ? p.s_out : p.s_in;
  const long long W = static_cast<long long>(S) * kAgg;
  const bool ref = d && p.svcref;
  const uint32_t* ga = row_at(p.agg[3 * d], row[3 * d], S);
  const uint32_t* gp = row_at(p.agg[3 * d + 1], row[3 * d + 1], S);
  const uint32_t* gs = row_at(p.agg[3 * d + 2], row[3 * d + 2], S);
  const uint32_t* gr = row_at(p.agg[5], row[6], S);
  const long long b0 = d ? p.out_n0 : p.in_n0;
  return candidate_scan::scan<true, 1>(
      [=](int w) { return ga[w] & gp[w] & (ref ? gs[w] | gr[w] : gs[w]); },
      S, d ? p.ke_out : p.ke_in, row_at(p.inc[3 * d], row[3 * d], W),
      row_at(p.inc[3 * d + 1], row[3 * d + 1], W),
      row_at(p.inc[3 * d + 2], row[3 * d + 2], W),
      ref ? row_at(p.inc[5], row[6], W) : nullptr, d ? p.w0_out : p.w0_in,
      b0, b0 + (d ? p.out_nk : p.in_nk), best);
}

// Write the block's rows of one (B, W) output: each live thread's row v
// goes to shared memory (stride W + 1, conflict-free), then the block
// stores its nl * W contiguous words 16 bytes a thread.
template <int W>
__device__ __forceinline__ void store_rows(int* buf, int32_t* out,
                                           long long lane0, int nl,
                                           bool live, const int (&v)[W]) {
  constexpr int P = W + 1;
  const int t = threadIdx.x;
  __syncthreads();  // the previous output's stores have read buf
  if (live) {
#pragma unroll
    for (int j = 0; j < W; ++j) buf[t * P + j] = v[j];
  }
  __syncthreads();
  int32_t* o = out + lane0 * W;
  for (int g = 4 * t; g < nl * W; g += 4 * kThreads) {
    const int* r = buf + (g / W) * P + g % W;
    *reinterpret_cast<int4*>(o + g) = make_int4(r[0], r[1], r[2], r[3]);
  }
}

// kResolve: the single-card resolve variant (outputs main, keys8, meta8,
// aux, iv).  !kResolve: the rule shard's hits-only variant (p.main is
// hits8 (B, 8) [in0, ink, inb, out0, outk, outb, 0, 0], global rule
// indices through w0_in / w0_out, then aux and iv): it stops after the
// first matches, with no action fetch, resolve, merge or row packing.
template <bool kResolve>
__global__ void __launch_bounds__(kThreads) onepass_kernel(const Params p) {
  __shared__ int s_count[kWarps];
  __shared__ int s_slot[kThreads * kSlot];
  __shared__ int s_buf[kThreads * 17];

  const int t = threadIdx.x;
  const int lid = t & 31;
  const int wid = t >> 5;
  const long long lane0 = static_cast<long long>(blockIdx.x) * kThreads;
  const int nl = static_cast<int>(
      min(static_cast<long long>(kThreads), p.b - lane0));
  const bool live = t < nl;
  const long long lane = lane0 + t;

  // 1. Probe decode (the _cache_lookup discipline), a thread a lane.
  bool hit = false, est = false, rpl = false, miss = false;
  bool no_commit = false, fb_force = false;
  int key[kKeys] = {0, 0, 0, 0};
  if (live) {
    const int4 pk0 = load4(p.pkt + lane * 8);
    const int src_f = pk0.x, dst_f = pk0.y, proto = pk0.z;
    const int pp = load4(p.pkt + lane * 8 + 4).y;
    const int4 kr = load4(p.kr + lane * 4);
    const int4 msk = load4(p.msk + lane * 4);
    const bool valid = msk.x != 0;
    no_commit = msk.y != 0;
    fb_force = msk.z != 0;
    const uint32_t pg_cur =
        static_cast<uint32_t>(proto) | 0x100u |
        (static_cast<uint32_t>(p.gen_w) << 9);
    const uint32_t pg_est =
        static_cast<uint32_t>(proto) | 0x100u | (kGenEternal << 9);
    const uint32_t pg_rpl = pg_est | kReplyBit;
    const uint32_t kpg = static_cast<uint32_t>(kr.w);
    const bool key_hit = kr.x == src_f && kr.y == dst_f && kr.z == pp &&
                         (kpg == pg_cur || kpg == pg_est || kpg == pg_rpl);
    int timeout = p.t_est;
    if (!p.uniform) {
      // The meta row's CONFIRMED bit: read only for per-state timeouts.
      const bool conf = ((p.mrow[lane * 4 + 3] >> 29) & 1) != 0;
      timeout = proto == kProtoTcp ? (conf ? p.t_est : p.t_syn)
                                   : (conf ? p.t_oest : p.t_onew);
    }
    const int age = static_cast<int>(static_cast<uint32_t>(p.now) -
                                     static_cast<uint32_t>(p.ts[lane]));
    hit = key_hit && age <= timeout && valid;
    est = hit && (kpg == pg_est || kpg == pg_rpl);
    rpl = hit && kpg == pg_rpl;
    miss = !hit && valid;
    if (miss) {
      // The probe keys on the post-DNAT tuple.
      const int4 lb0 = load4(p.lb + lane * 8);
      key[kDnat] = lb0.z;
      key[kSrc] = src_f;
      key[kSvc] = static_cast<int>((static_cast<uint32_t>(proto) << 16) |
                                   static_cast<uint32_t>(lb0.w));
      if (p.svcref) {
        const int svc = lb0.x;
        const int ref =
            svc >= 0 ? p.prog_svc[min(svc, p.n_prog - 1)] : kMiss;
        key[kRef] = ref >= 0 ? kSvcrefBase + ref : kSvcrefNone;
      }
    }
  }

  // 2. Compact the block's miss lanes: slot `mine` of `total`.
  const uint32_t bal = __ballot_sync(0xFFFFFFFFu, miss);
  if (lid == 0) s_count[wid] = __popc(bal);
  __syncthreads();
  int mine = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    mine += w < wid ? s_count[w] : 0;
    total += s_count[w];
  }
  mine += __popc(bal & ((1u << lid) - 1u));
  if (miss) {
#pragma unroll
    for (int j = 0; j < kKeys; ++j) s_slot[mine * kSlot + j] = key[j];
  }
  __syncthreads();

  // 3. The scans, a warp a miss lane.
  for (int e = wid; e < total; e += kWarps) {
    int* sl = s_slot + e * kSlot;
    const int k9[kSearch] = {sl[kDnat], sl[kSrc], sl[kSvc], sl[kSrc],
                             sl[kDnat], sl[kSvc], sl[kRef], sl[kDnat],
                             sl[kSrc]};
    int row[kSearch];
    search_rows(p, k9, row);
    int best[6] = {kBig, kBig, kBig, kBig, kBig, kBig};
    const int nc_in = scan_direction(p, 0, row, best);
    const int nc_out = scan_direction(p, 1, row, best + 3);
#pragma unroll
    for (int k = 0; k < 6; ++k) {
#pragma unroll
      for (int off = 16; off > 0; off /= 2) {
        best[k] = min(best[k], __shfl_xor_sync(0xFFFFFFFFu, best[k], off));
      }
    }
    if (lid == 0) {
#pragma unroll
      for (int k = 0; k < 6; ++k) sl[kBest + k] = best[k];
      sl[kNc] = nc_in;
      sl[kNc + 1] = nc_out;
#pragma unroll
      for (int k = 0; k < 7; ++k) sl[kRow + k] = row[k];
      sl[kIso] = p.iso_val[0][row[7]];
      sl[kIso + 1] = p.iso_val[1][row[8]];
    }
  }
  __syncthreads();

  // 4. Resolve, merge and pack, a thread a lane.  Non-miss lanes: no
  // match, isolation row 0.
  int o_main[16], o_keys[8], o_meta[8], o_aux[4], o_iv[8], o_hits[8];
  if (live) {
    int best[6] = {kBig, kBig, kBig, kBig, kBig, kBig};
    int nc_in = 0, nc_out = 0;
    int iso_in, iso_out;
#pragma unroll
    for (int k = 0; k < 8; ++k) o_iv[k] = 0;
    if (miss) {
      const int* sl = s_slot + mine * kSlot;
#pragma unroll
      for (int k = 0; k < 6; ++k) best[k] = sl[kBest + k];
      nc_in = sl[kNc];
      nc_out = sl[kNc + 1];
#pragma unroll
      for (int k = 0; k < 7; ++k) o_iv[k] = sl[kRow + k];
      iso_in = sl[kIso];
      iso_out = sl[kIso + 1];
      o_iv[7] = iso_in | (iso_out << 1);
    } else {
      iso_in = p.iso_val[0][0];
      iso_out = p.iso_val[1][0];
    }
    const bool skip = miss && nc_in == 0 && nc_out == 0;
    const bool fb = miss && (nc_in > p.ke_in || nc_out > p.ke_out || fb_force);
    const int cand = max(nc_in, nc_out);
    if constexpr (!kResolve) {
#pragma unroll
      for (int k = 0; k < 6; ++k) o_hits[k] = best[k];
      o_hits[6] = o_hits[7] = 0;
      o_aux[0] = skip;
      o_aux[1] = fb;
      o_aux[2] = cand;
      o_aux[3] = 0;
    } else {

    // Resolution from the actions at the clipped first-match indices (a
    // lane with no first match reads no action: resolve ignores it).
    auto act = [](const int32_t* a, int h, int n) {
      return h < kBig ? a[h < 0 ? 0 : (h > n - 1 ? n - 1 : h)] : 0;
    };
    int in_code, in_rule, out_code, out_rule;
    resolve(act(p.act_in, best[0], p.n_act_in),
            act(p.act_in, best[2], p.n_act_in), best[0], best[1], best[2],
            iso_in, &in_code, &in_rule);
    resolve(act(p.act_out, best[3], p.n_act_out),
            act(p.act_out, best[5], p.n_act_out), best[3], best[4], best[5],
            iso_out, &out_code, &out_rule);
    const int cls_code = out_code != kActAllow ? out_code : in_code;

    // ServiceLB overlay: the fresh image.
    const int4 pk0 = load4(p.pkt + lane * 8);
    const int4 pk1 = load4(p.pkt + lane * 8 + 4);
    const int src_f = pk0.x, dst_f = pk0.y, proto = pk0.z, sport = pk0.w;
    const int dport = pk1.x, pp = pk1.y;
    const int4 mr = load4(p.mrow + lane * 4);
    const int4 lb0 = load4(p.lb + lane * 8);
    const int4 lb1 = load4(p.lb + lane * 8 + 4);
    const int svc_idx = lb0.x, dnat_ip = lb0.z, dnat_port = lb0.w;
    const int snat_m = lb1.x, dsr_m = lb1.y;
    const bool no_ep = lb0.y != 0;
    const int f_code = no_ep ? kActReject : cls_code;
    const int f_ri = no_ep ? kMiss : in_rule;
    const int f_ro = no_ep ? kMiss : out_rule;

    // Cached image decode and the hit/miss/default merge.
    const int c_code = mr.y & 3;
    const int c_svc = ((mr.y >> 2) & 0x3FFF) - 1;
    const int c_dport = (mr.y >> 16) & 0xFFFF;
    const int c_ri = (mr.z & 0xFFFF) - 1;
    const int c_ro = ((mr.z >> 16) & 0xFFFF) - 1;
    const bool fwd_hit = hit && !rpl;
    o_main[0] = hit ? c_code : (miss ? f_code : kActAllow);
    o_main[1] = hit ? c_ri : (miss ? f_ri : kMiss);
    o_main[2] = hit ? c_ro : (miss ? f_ro : kMiss);
    o_main[3] = hit ? c_svc : (miss ? svc_idx : kMiss);
    o_main[4] = hit ? mr.x : (miss ? dnat_ip : dst_f);
    o_main[5] = hit ? c_dport : (miss ? dnat_port : dport);
    o_main[6] = fwd_hit ? ((mr.w >> 31) & 1) : (miss ? snat_m : 0);
    o_main[7] = fwd_hit ? ((mr.w >> 30) & 1) : (miss ? dsr_m : 0);

    // Commit rows: forward, and the reply-direction entry keyed on the
    // post-DNAT tuple with ports swapped (no reply leg for DSR).
    const bool committed = miss && f_code == kActAllow && !no_commit;
    const bool ins = miss && !no_commit;
    const bool rev_ins = ins && committed && dsr_m == 0;
    const uint32_t pg_est =
        static_cast<uint32_t>(proto) | 0x100u | (kGenEternal << 9);
    const uint32_t egen = committed ? kGenEternal
                                    : static_cast<uint32_t>(p.gen_w);
    const int pg_ins = static_cast<int>(static_cast<uint32_t>(proto) |
                                        0x100u | (egen << 9));
    const int rules_p = pack_rules(f_ri, f_ro);
    const int pref_col = p.now & p.pref_mask;
    const int zcol = static_cast<int>(static_cast<uint32_t>(pref_col) |
                                      (snat_m > 0 ? kReplyBit : 0u) |
                                      (dsr_m > 0 ? kDsrBit : 0u));
    const uint32_t rev_h = flow_hash(
        static_cast<uint32_t>(dnat_ip) ^ kReplyBit,
        static_cast<uint32_t>(src_f) ^ kReplyBit,
        static_cast<uint32_t>(proto), static_cast<uint32_t>(dnat_port),
        static_cast<uint32_t>(sport));
    o_main[8] = committed;
    o_main[9] = rev_ins;
    o_main[10] = static_cast<int>(rev_h &
                                  static_cast<uint32_t>(p.slot_mask));
    o_main[11] = hit;
    o_main[12] = est;
    o_main[13] = rpl;
    o_main[14] = ins;
    o_main[15] = 0;
    o_keys[0] = src_f;
    o_keys[1] = dst_f;
    o_keys[2] = pp;
    o_keys[3] = pg_ins;
    o_keys[4] = dnat_ip;
    o_keys[5] = src_f;
    o_keys[6] = static_cast<int>((static_cast<uint32_t>(dnat_port) << 16) |
                                 static_cast<uint32_t>(sport));
    o_keys[7] = static_cast<int>(pg_est | kReplyBit);
    o_meta[0] = dnat_ip;
    o_meta[1] = pack_meta1(f_code, svc_idx, dnat_port);
    o_meta[2] = rules_p;
    o_meta[3] = zcol;
    o_meta[4] = dst_f;
    o_meta[5] = pack_meta1(f_code, svc_idx, dport);
    o_meta[6] = rules_p;
    o_meta[7] = pref_col;
    o_aux[0] = skip;
    o_aux[1] = fb;
    o_aux[2] = cand;
    o_aux[3] = 0;
    }
  }
  if constexpr (kResolve) {
    store_rows<16>(s_buf, p.main, lane0, nl, live, o_main);
    store_rows<8>(s_buf, p.keys8, lane0, nl, live, o_keys);
    store_rows<8>(s_buf, p.meta8, lane0, nl, live, o_meta);
  } else {
    store_rows<8>(s_buf, p.main, lane0, nl, live, o_hits);
  }
  store_rows<4>(s_buf, p.aux, lane0, nl, live, o_aux);
  store_rows<8>(s_buf, p.iv, lane0, nl, live, o_iv);
}

}  // namespace

// C entry point (loaded with ctypes).  ptrs: pkt, kr, ts, mrow, msk, lb,
// bounds x 6, iso bounds x 2, agg x 6, inc x 6, iso val x 2, prog_svc,
// act_in, act_out, main (hits8 for the hits-only variant), keys8, meta8
// (unread by the hits-only variant), aux, iv (device pointers).  ints: b,
// s_in, s_out, ke_in, ke_out, n_act_in, n_act_out, n_prog, now, gen_w,
// w0_in, w0_out, in_n0, in_nk, out_n0, out_nk, svcref, t_syn, t_est,
// t_onew, t_oest, uniform, slot_mask, pref_mask, then the eight bounds
// lengths (six dimensions, iso_in, iso_out), then resolve (1: the resolve
// variant, 0: hits-only).  Launches on `stream`, allocates nothing, and
// returns cudaGetLastError().
extern "C" int b3_onepass(void* const* ptrs, const int* ints, void* stream) {
  Params p;
  const int32_t* const* in = reinterpret_cast<const int32_t* const*>(ptrs);
  p.pkt = in[0];
  p.kr = in[1];
  p.ts = in[2];
  p.mrow = in[3];
  p.msk = in[4];
  p.lb = in[5];
  for (int i = 0; i < 8; ++i) p.bounds[i] = in[6 + i];
  for (int i = 0; i < 6; ++i) {
    p.agg[i] = static_cast<const uint32_t*>(ptrs[14 + i]);
    p.inc[i] = static_cast<const uint32_t*>(ptrs[20 + i]);
  }
  p.iso_val[0] = in[26];
  p.iso_val[1] = in[27];
  p.prog_svc = in[28];
  p.act_in = in[29];
  p.act_out = in[30];
  p.main = static_cast<int32_t*>(ptrs[31]);
  p.keys8 = static_cast<int32_t*>(ptrs[32]);
  p.meta8 = static_cast<int32_t*>(ptrs[33]);
  p.aux = static_cast<int32_t*>(ptrs[34]);
  p.iv = static_cast<int32_t*>(ptrs[35]);
  int* f[] = {&p.b, &p.s_in, &p.s_out, &p.ke_in, &p.ke_out, &p.n_act_in,
              &p.n_act_out, &p.n_prog, &p.now, &p.gen_w, &p.w0_in,
              &p.w0_out, &p.in_n0, &p.in_nk, &p.out_n0, &p.out_nk,
              &p.svcref, &p.t_syn, &p.t_est, &p.t_onew, &p.t_oest,
              &p.uniform, &p.slot_mask, &p.pref_mask};
  const int nf = static_cast<int>(sizeof(f) / sizeof(f[0]));
  for (int i = 0; i < nf; ++i) *f[i] = ints[i];
  for (int i = 0; i < 8; ++i) p.n_bounds[i] = ints[nf + i];
  const int blocks = (p.b + kThreads - 1) / kThreads;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ints[nf + 8]) {
    onepass_kernel<true><<<blocks, kThreads, 0, s>>>(p);
  } else {
    onepass_kernel<false><<<blocks, kThreads, 0, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}
