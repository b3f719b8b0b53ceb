// B3: the one-pass slow path, CUDA C++ for sm_90a.
//
// Replaces the Pallas kernel antrea_tpu/ops/match.py:_onepass_call in its
// single-card resolve variant.  For every lane of the batch, in one pass:
//   - the flow-cache probe decode on the key, meta and ts rows gathered at
//     batch start (key compare, generation, per-state freshness);
//   - for miss lanes, the AND of the three aggregate rows of each
//     direction: the count of nonzero aggregate words nc (zero in both
//     directions = skip; more than Ke = min(K, S) in either = fallback),
//     and the Ke lowest nonzero positions as candidate superblocks;
//   - per candidate the 32 words of each dimension's incidence row, their
//     AND, and per rule phase the first set bit (base = 32 * global word);
//   - the action fetch at the clipped first-match indices, the verdict with
//     the isolation bits, the ServiceLB / no-endpoint overlay, the merge
//     with the cached image of hit lanes;
//   - the forward and reply commit rows, with the reply slot's FNV-1a hash.
// Every lane writes every output column, hit lanes included, as the TPU
// kernel does.  Outputs (int32): main (B, 16) [code, rule_in, rule_out,
// svc, dnat_ip_f, dnat_port, snat, dsr, committed, rev_ins, rev_slot, hit,
// est, rpl, ins, 0], keys8 (B, 8), meta8 (B, 8), aux (B, 4) [skip, fb,
// cand, 0].  Fallback lanes are re-walked at full width by the caller.
//
// What bounds it: bytes.  Per miss lane about 1.35 KB of lane inputs and
// aggregate rows at the 100k-rule widths (S = 59 / 40), plus up to
// 6 * K * 128 B = 3 KB of candidate rows at K = 4, plus 144 B of outputs:
// about 0.6 GB and 0.18 ms at the H100's 3.35 TB/s for an all-miss batch
// of 2**17 lanes.  A hit lane reads no aggregate or candidate row and
// costs about 0.34 KB.
//
// Design: one warp per lane, four lanes to a block.  The TPU kernel's DMA
// double buffer, 64-lane half-blocks and per-lane copy loops become plain
// loads: thread t reads aggregate words t, t + 32, ...; a ballot over the
// nonzero ANDs gives nc by __popc and the candidates in ascending order by
// __ffs (exactly top_k's values); thread j reads word j of each 32-word
// candidate row (128 coalesced bytes per row), and a warp min gives the
// six first matches; that scan is candidate_scan.cuh, shared with B2.
// Lane 0 then resolves, merges, packs and stores the rows with 16-byte
// stores.  Any B is taken as it comes (no tile padding).
//
// Later work: the six (B, S) aggregate matrices are gathered by torch over
// the whole batch (about 156 MB written and read again at B = 2**17); the
// kernel has the interval rows and could gather them itself.

#include <cuda_runtime.h>
#include <stdint.h>

#include "candidate_scan.cuh"

namespace {

using candidate_scan::kAgg;
using candidate_scan::kBig;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kActAllow = 0;
constexpr int kActDrop = 1;
constexpr int kActReject = 2;
constexpr int kActPass = 3;
constexpr int kMiss = -1;
constexpr int kProtoTcp = 6;
constexpr uint32_t kGenEternal = (1u << 22) - 1u;
constexpr uint32_t kReplyBit = 0x80000000u;
constexpr uint32_t kDsrBit = 1u << 30;
constexpr uint32_t kFnvPrime = 16777619u;
constexpr uint32_t kFnvBasis = 0x811C9DC5u;
constexpr uint32_t kFlowSalt = 0x5CA1AB1Eu;

struct Params {
  const int32_t* pkt;
  const int32_t* kr;
  const int32_t* prb;
  const int32_t* mrow;
  const int32_t* msk;
  const int32_t* lb;
  const uint32_t* agg[6];
  const int32_t* iv;
  const uint32_t* inc[6];
  const int32_t* act_in;
  const int32_t* act_out;
  int32_t* main;
  int32_t* keys8;
  int32_t* meta8;
  int32_t* aux;
  int b, s_in, s_out, ke_in, ke_out, na, nb, now, gen_w, w0_in, w0_out;
  int in_n0, in_nk, out_n0, out_nk, svcref;
  int t_syn, t_est, t_onew, t_oest, uniform, slot_mask, pref_mask;
};

__device__ __forceinline__ int4 load4(const int32_t* p) {
  return *reinterpret_cast<const int4*>(p);
}

__device__ __forceinline__ void store4(int32_t* p, int a, int b, int c,
                                       int d) {
  *reinterpret_cast<int4*>(p) = make_int4(a, b, c, d);
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

// One direction of one miss lane: nc, and the thread's minima of the three
// phases over the ke lowest candidate superblocks (candidate_scan.cuh).
__device__ __forceinline__ int scan_direction(
    const Params& p, long long lane, int d, const int4& iv_lo,
    const int4& iv_hi, int* best) {
  const int S = d ? p.s_out : p.s_in;
  const long long W = static_cast<long long>(S) * kAgg;
  const uint32_t* ga = p.agg[3 * d] + lane * S;
  const uint32_t* gp = p.agg[3 * d + 1] + lane * S;
  const uint32_t* gs = p.agg[3 * d + 2] + lane * S;
  const long long r_at = d ? iv_lo.w : iv_lo.x;
  const long long r_peer = d ? iv_hi.x : iv_lo.y;
  const long long r_svc = d ? iv_hi.y : iv_lo.z;
  const uint32_t* iref =
      (d && p.svcref) ? p.inc[5] + static_cast<long long>(iv_hi.z) * W
                      : nullptr;
  const long long b0 = d ? p.out_n0 : p.in_n0;
  return candidate_scan::scan<true, 1>(
      [=](int w) { return ga[w] & gp[w] & gs[w]; }, S,
      d ? p.ke_out : p.ke_in, p.inc[3 * d] + r_at * W,
      p.inc[3 * d + 1] + r_peer * W, p.inc[3 * d + 2] + r_svc * W, iref,
      d ? p.w0_out : p.w0_in, b0, b0 + (d ? p.out_nk : p.in_nk), best);
}

__global__ void __launch_bounds__(kThreads) onepass_kernel(const Params p) {
  const int lid = threadIdx.x & 31;
  const long long lane =
      static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (lane >= p.b) return;  // the whole warp leaves together

  const int4 pk0 = load4(p.pkt + lane * 8);
  const int4 pk1 = load4(p.pkt + lane * 8 + 4);
  const int src_f = pk0.x, dst_f = pk0.y, proto = pk0.z, sport = pk0.w;
  const int dport = pk1.x, pp = pk1.y;
  const int4 kr = load4(p.kr + lane * 4);
  const int4 prb = load4(p.prb + lane * 4);
  const int4 mr = load4(p.mrow + lane * 4);
  const int4 msk = load4(p.msk + lane * 4);
  const bool valid = msk.x != 0, no_commit = msk.y != 0, fb_force = msk.z != 0;

  // Probe decode (the _cache_lookup discipline).
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
    const bool conf = ((mr.w >> 29) & 1) != 0;
    timeout = proto == kProtoTcp ? (conf ? p.t_est : p.t_syn)
                                 : (conf ? p.t_oest : p.t_onew);
  }
  const int age = static_cast<int>(static_cast<uint32_t>(p.now) -
                                   static_cast<uint32_t>(prb.x));
  const bool hit = key_hit && age <= timeout && valid;
  const bool est = hit && (kpg == pg_est || kpg == pg_rpl);
  const bool rpl = hit && kpg == pg_rpl;
  const bool miss = !hit && valid;

  // Aggregate AND, candidates and first match (miss lanes only; the
  // condition is the same for the whole warp).
  int best[6] = {kBig, kBig, kBig, kBig, kBig, kBig};
  int nc_in = 0, nc_out = 0;
  if (miss) {
    const int4 iv_lo = load4(p.iv + lane * 8);
    const int4 iv_hi = load4(p.iv + lane * 8 + 4);
    nc_in = scan_direction(p, lane, 0, iv_lo, iv_hi, best);
    nc_out = scan_direction(p, lane, 1, iv_lo, iv_hi, best + 3);
#pragma unroll
    for (int k = 0; k < 6; ++k) {
#pragma unroll
      for (int off = 16; off > 0; off /= 2) {
        best[k] = min(best[k], __shfl_xor_sync(0xFFFFFFFFu, best[k], off));
      }
    }
  }
  if (lid != 0) return;

  const bool skip = miss && nc_in == 0 && nc_out == 0;
  const bool fb = miss && (nc_in > p.ke_in || nc_out > p.ke_out || fb_force);
  const int cand = max(nc_in, nc_out);

  // Resolution from the actions at the clipped first-match indices.
  auto clip = [](int h, int n) { return h < 0 ? 0 : (h > n - 1 ? n - 1 : h); };
  int in_code, in_rule, out_code, out_rule;
  resolve(p.act_in[clip(best[0], p.na)], p.act_in[clip(best[2], p.na)],
          best[0], best[1], best[2], prb.y, &in_code, &in_rule);
  resolve(p.act_out[clip(best[3], p.nb)], p.act_out[clip(best[5], p.nb)],
          best[3], best[4], best[5], prb.z, &out_code, &out_rule);
  const int cls_code = out_code != kActAllow ? out_code : in_code;

  // ServiceLB overlay: the fresh image.
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
  const int o_code = hit ? c_code : (miss ? f_code : kActAllow);
  const int o_ri = hit ? c_ri : (miss ? f_ri : kMiss);
  const int o_ro = hit ? c_ro : (miss ? f_ro : kMiss);
  const int o_svc = hit ? c_svc : (miss ? svc_idx : kMiss);
  const int o_dnat = hit ? mr.x : (miss ? dnat_ip : dst_f);
  const int o_dport = hit ? c_dport : (miss ? dnat_port : dport);
  const int o_snat = fwd_hit ? ((mr.w >> 31) & 1) : (miss ? snat_m : 0);
  const int o_dsr = fwd_hit ? ((mr.w >> 30) & 1) : (miss ? dsr_m : 0);

  // Commit rows: forward, and the reply-direction entry keyed on the
  // post-DNAT tuple with ports swapped (no reply leg for DSR).
  const bool committed = miss && f_code == kActAllow && !no_commit;
  const bool ins = miss && !no_commit;
  const bool rev_ins = ins && committed && dsr_m == 0;
  const uint32_t egen = committed ? kGenEternal
                                  : static_cast<uint32_t>(p.gen_w);
  const int pg_ins = static_cast<int>(static_cast<uint32_t>(proto) | 0x100u |
                                      (egen << 9));
  const int rules_p = pack_rules(f_ri, f_ro);
  const int pref_col = p.now & p.pref_mask;
  const int zcol = static_cast<int>(static_cast<uint32_t>(pref_col) |
                                    (snat_m > 0 ? kReplyBit : 0u) |
                                    (dsr_m > 0 ? kDsrBit : 0u));
  const uint32_t rev_h = flow_hash(
      static_cast<uint32_t>(dnat_ip) ^ kReplyBit,
      static_cast<uint32_t>(src_f) ^ kReplyBit, static_cast<uint32_t>(proto),
      static_cast<uint32_t>(dnat_port), static_cast<uint32_t>(sport));
  const int rev_slot = static_cast<int>(rev_h & static_cast<uint32_t>(
      p.slot_mask));
  const int rev_pg = static_cast<int>(pg_est | kReplyBit);
  const int rev_pp = static_cast<int>((static_cast<uint32_t>(dnat_port) << 16) |
                                      static_cast<uint32_t>(sport));

  int32_t* om = p.main + lane * 16;
  store4(om, o_code, o_ri, o_ro, o_svc);
  store4(om + 4, o_dnat, o_dport, o_snat, o_dsr);
  store4(om + 8, committed, rev_ins, rev_slot, hit);
  store4(om + 12, est, rpl, ins, 0);
  store4(p.keys8 + lane * 8, src_f, dst_f, pp, pg_ins);
  store4(p.keys8 + lane * 8 + 4, dnat_ip, src_f, rev_pp, rev_pg);
  store4(p.meta8 + lane * 8, dnat_ip, pack_meta1(f_code, svc_idx, dnat_port),
         rules_p, zcol);
  store4(p.meta8 + lane * 8 + 4, dst_f, pack_meta1(f_code, svc_idx, dport),
         rules_p, pref_col);
  store4(p.aux + lane * 4, skip, fb, cand, 0);
}

}  // namespace

// C entry point (loaded with ctypes).  ptrs: pkt, kr, prb, mrow, msk, lb,
// agg x 6, iv, inc x 6, act_in, act_out, main, keys8, meta8, aux (device
// pointers).  ints: b, s_in, s_out, ke_in, ke_out, na, nb, now, gen_w,
// w0_in, w0_out, in_n0, in_nk, out_n0, out_nk, svcref, t_syn, t_est,
// t_onew, t_oest, uniform, slot_mask, pref_mask.  Launches on `stream`,
// allocates nothing, and returns cudaGetLastError().
extern "C" int b3_onepass(void* const* ptrs, const int* ints, void* stream) {
  Params p;
  p.pkt = static_cast<const int32_t*>(ptrs[0]);
  p.kr = static_cast<const int32_t*>(ptrs[1]);
  p.prb = static_cast<const int32_t*>(ptrs[2]);
  p.mrow = static_cast<const int32_t*>(ptrs[3]);
  p.msk = static_cast<const int32_t*>(ptrs[4]);
  p.lb = static_cast<const int32_t*>(ptrs[5]);
  for (int i = 0; i < 6; ++i) p.agg[i] = static_cast<const uint32_t*>(ptrs[6 + i]);
  p.iv = static_cast<const int32_t*>(ptrs[12]);
  for (int i = 0; i < 6; ++i) p.inc[i] = static_cast<const uint32_t*>(ptrs[13 + i]);
  p.act_in = static_cast<const int32_t*>(ptrs[19]);
  p.act_out = static_cast<const int32_t*>(ptrs[20]);
  p.main = static_cast<int32_t*>(ptrs[21]);
  p.keys8 = static_cast<int32_t*>(ptrs[22]);
  p.meta8 = static_cast<int32_t*>(ptrs[23]);
  p.aux = static_cast<int32_t*>(ptrs[24]);
  int* f[] = {&p.b, &p.s_in, &p.s_out, &p.ke_in, &p.ke_out, &p.na, &p.nb,
              &p.now, &p.gen_w, &p.w0_in, &p.w0_out, &p.in_n0, &p.in_nk,
              &p.out_n0, &p.out_nk, &p.svcref, &p.t_syn, &p.t_est, &p.t_onew,
              &p.t_oest, &p.uniform, &p.slot_mask, &p.pref_mask};
  for (int i = 0; i < static_cast<int>(sizeof(f) / sizeof(f[0])); ++i) {
    *f[i] = ints[i];
  }
  const int blocks = (p.b + kWarps - 1) / kWarps;
  onepass_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
