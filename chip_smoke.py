#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (antrea_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card (Hopper: the kernels are built for sm_90a) and nvcc.
Exits non-zero, printing no result, when CUDA is unavailable, when the
package is missing, or when any phase fails.  Phases, in order:

  1. build every kernel in antrea_tpu_torch/csrc from source (one nvcc per
     source, all started together) and print the build seconds;
  2. build the 100k-rule / 5k-service world on the host (bench.py's headline
     regime: gen_cluster(100_000, n_nodes=64, pods_per_node=32, seed=1),
     gen_services(5_000, seed=2), a 2**17-lane batch over 2**15 flows), and
     two pipelines on the card over it: the staged fused step
     (flow_slots=2**22, miss_chunk=256, fused=True) and the one-pass step
     (the same with prune_budget=4, ct_timeout_s=3600: bench.py's
     measure_fused);
  3. hold each kernel against its plain PyTorch version on the card, bit for
     bit, and time both with CUDA events: B1 and B2 on seeded inputs at the
     world's widths and phases, at B = 256 (the staged step's miss round)
     and B = 32768; B3 on the one-pass step's own inputs for the whole batch
     on an empty cache (all miss);
  4. drive the staged fused step: one cold step, one warm step, 8 steady
     steps, with every launch count set to 0 just before and read just
     after; print ms/step and packets/s;
  5. drive the one-pass step the same way (cold, warm, 8 steady steps) and
     then 4 steps that each expire the whole cache (now = 7200 * (i + 2),
     bench.py's cold_fused regime); print ms/step, packets/s, B3 launches
     and the prune counters; then hold B3 against its plain version once
     more on the warm cache (mostly hits);
  6. the pruned classify, classify_batch(prune_budget=4, fused=True) on
     2**15 lanes (bench.py's measure_cold_pruned), and one cold step of the
     staged pruned pipeline (onepass=False), whose B2 launches must be
     ceil(n_miss / 256);
  7. cross-check: a 4096-lane sub-batch through a fresh state on the card
     and a fresh state on the CPU (plain versions), same tables, cold then
     warm, for the staged and the one-pass step, and the pruned classify of
     those lanes; outputs and state must be bitwise equal;
  8. the async cadence, on the staged fused and the one-pass pipeline: on a
     fresh state with the hot set warmed, one fast step at phases=0 with
     the DROP admission policy over the batch with its last B/8 lanes
     replaced by fresh flows, one coalesced drain step (drain_reclaim=True,
     miss_chunk = the admitted count) over the admitted lanes, and one
     _maintain_scan; B1 (staged) or B3 (one-pass) must launch in the drain
     and nothing in the fast step.  Then the same cadence on 4096 lanes over
     a 2**12-slot cache (so reclaims happen: the fast step runs after every
     entry expired), on the card and on the CPU, bitwise;
  9. S1's path: bench_cold_study_torch.py's case 4 (the six interval rows
     gathered and ANDed in torch, then S1) on its own 100k-rule world at
     B = 2**15, in this process.

S1 is held against its plain version in phase 3, at the same widths.  The
line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

N_RULES = 100_000
N_SERVICES = 5_000
B = 1 << 17
N_FLOWS = 1 << 15
FLOW_SLOTS = 1 << 22
MISS_CHUNK = 256
STEADY_STEPS = 8
EXPIRE_STEPS = 4
CROSS_LANES = 4096
PRUNE_K = 4
B_COLD = 1 << 15
# The async cadence: fresh lanes per fast step, the pool they come from,
# and the cross-check's cache.
N_NEW = B // 8
POOL = 1 << 18
CROSS_SLOTS = 1 << 12
# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM3 bytes/s, and
# the 32-bit non-tensor lane rate used for the kernels' integer operations.
HBM_BYTES_S = 3.35e12
LANE_OPS_S = 67e12


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def build_world():
    """-> (compiled policy set, service tables, the 2**17-lane batch, a
    POOL-lane pool of fresh flows, one lane per flow)."""
    from antrea_tpu_torch.compiler.compile import compile_policy_set
    from antrea_tpu_torch.compiler.services import compile_services
    from antrea_tpu_torch.simulator import (gen_cluster, gen_services,
                                            gen_traffic)

    cluster = gen_cluster(N_RULES, n_nodes=64, pods_per_node=32, seed=1)
    cps = compile_policy_set(cluster.ps)
    services = gen_services(N_SERVICES, cluster.pod_ips, seed=2)
    svc = compile_services(services)
    tr = gen_traffic(cluster.pod_ips, B, n_flows=N_FLOWS, seed=3,
                     services=services, svc_fraction=0.3)
    pool = gen_traffic(cluster.pod_ips, POOL, n_flows=POOL, seed=7,
                       services=services, svc_fraction=0.3,
                       one_per_flow=True)
    return cps, svc, tr, pool


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """The least time the card could take: (seconds, what bounds it)."""
    tb, to = nbytes / HBM_BYTES_S, ops / LANE_OPS_S
    return max(tb, to), "bytes" if tb >= to else "operations"


def random_words(g, shape, dev):
    """Seeded int32 words, each the AND of three random words (bit density
    1/8), so a three-matrix AND has density 1/512 and a phase's first hit
    lies some words deep."""
    import torch

    r = [torch.randint(-(2**31), 2**31, shape, generator=g, dtype=torch.int32,
                       device=dev) for _ in range(3)]
    return r[0] & r[1] & r[2]


def consumer_inputs(b, w_in, w_out, seed, dev):
    """Six (b, w) int32 row matrices, seeded (random_words); every 7th lane
    has an all-zero row (no hit anywhere)."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)

    def row(w):
        m = random_words(g, (b, w), dev)
        m[::7] = 0
        return m.contiguous()

    return ([row(w_in) for _ in range(3)], [row(w_out) for _ in range(3)])


def check_kernel(name, run, plain, b, nbytes, ops, inner):
    """Run the kernel and its plain version on the same inputs, require
    bitwise equality, time both -> record."""
    import torch

    from antrea_tpu_torch.utils.timing import device_time

    got, want = run(), plain()
    torch.cuda.synchronize()
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    err = max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
              for g, w in zip(got, want))
    if err != 0 or not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise SystemExit(f"{name} disagrees with its plain version at B={b}: "
                         f"max abs err {err}")
    # Device time of the kernel (launches queued ahead of the device), and
    # the time per call through the wrapper as the main path pays it.
    k_s = device_time(run, iters=7, inner=inner, host_lead_s=inner * 2e-4)
    call_s = device_time(run, iters=7, inner=inner)
    p_s = device_time(plain, iters=3, inner=1)
    bound_s, by = bound(nbytes, ops)
    log(f"{name} B={b}: bitwise equal to plain; kernel {k_s * 1e6:.2f} us "
        f"({call_s * 1e6:.2f} us per wrapper call), plain {p_s * 1e6:.2f} us, "
        f"bound {bound_s * 1e6:.2f} us ({nbytes / 1e6:.2f} MB, {by}; "
        f"{bound_s / k_s:.2f} of it reached), {nbytes / k_s / 1e9:.1f} GB/s")
    return dict(ms=k_s * 1e3, call_ms=call_s * 1e3, plain_ms=p_s * 1e3,
                bound_ms=bound_s * 1e3, bound_by=by, max_abs_err=err,
                bytes=nbytes)


def check_consumer(meta, dev):
    """Phase 3 for B1 -> per-B records."""
    import torch

    from antrea_tpu_torch.ops import consumer

    recs = {}
    for b, seed, inner in ((256, 1, 50), (32768, 2, 3)):
        rin, rout = consumer_inputs(b, meta.w_in, meta.w_out, seed, dev)
        args = (rin, rout, meta.in_phases, meta.out_phases)
        words = meta.w_in + meta.w_out
        recs[b] = check_kernel(
            f"B1 consumer (w_in={meta.w_in} w_out={meta.w_out})",
            lambda: consumer.fused_hits(*args),
            lambda: consumer.consumer_plain(*args), b,
            b * 3 * words * 4 + b * 8 * 4, b * 2 * words, inner)
        del rin, rout
    torch.cuda.empty_cache()
    return recs


def check_consumer2(meta, dev):
    """Phase 3 for S1: the ANDed rows of consumer_inputs -> per-B
    records."""
    import torch

    from antrea_tpu_torch.ops import consumer2

    recs = {}
    for b, seed, inner in ((256, 5, 50), (32768, 6, 3)):
        rin, rout = consumer_inputs(b, meta.w_in, meta.w_out, seed, dev)
        args = (rin[0] & rin[1] & rin[2], rout[0] & rout[1] & rout[2],
                meta.in_phases, meta.out_phases)
        del rin, rout
        words = meta.w_in + meta.w_out
        recs[b] = check_kernel(
            f"S1 consumer2 (w_in={meta.w_in} w_out={meta.w_out})",
            lambda: consumer2.and_hits(*args),
            lambda: consumer2.and_hits_plain(*args), b,
            b * words * 4 + b * 8 * 4, b * 2 * words, inner)
        del args
    torch.cuda.empty_cache()
    return recs


def pruned_inputs(b, ke, s, g, dev):
    """One direction's B2 inputs: ke candidate superblocks per lane among s
    (ascending; every 5th lane has only fill candidates, zeroed), their
    words (random_words) and the base matrix."""
    import torch

    from antrea_tpu_torch.ops import match

    cand = torch.sort(torch.randint(0, s, (b, ke), generator=g, device=dev),
                      dim=1).values
    m = [random_words(g, (b, ke * 32), dev) for _ in range(3)]
    m[0][::5] = 0
    return m + [match.candidate_base(cand)]


def check_pruned(meta, s_in, s_out, dev):
    """Phase 3 for B2 at K = PRUNE_K -> per-B records."""
    import torch

    from antrea_tpu_torch.ops import pruned_consumer as pc

    ke_in, ke_out = min(PRUNE_K, s_in), min(PRUNE_K, s_out)
    recs = {}
    for b, seed, inner in ((256, 3, 50), (32768, 4, 5)):
        g = torch.Generator(device=dev).manual_seed(seed)
        args = (pruned_inputs(b, ke_in, s_in, g, dev),
                pruned_inputs(b, ke_out, s_out, g, dev), meta.in_phases,
                meta.out_phases)
        words = 32 * (ke_in + ke_out)
        recs[b] = check_kernel(
            f"B2 pruned consumer (K={PRUNE_K})",
            lambda: pc.pruned_hits(*args), lambda: pc.pruned_plain(*args), b,
            b * 4 * words * 4 + b * 8 * 4, b * 2 * words, inner)
        del args
    torch.cuda.empty_cache()
    return recs


def onepass_inputs(step, state, drs, dsvc, lanes, now):
    """The one-pass step's B3 inputs for `lanes` against `state` (the
    step's own preparation) -> (x, tabs, st)."""
    import torch

    from antrea_tpu_torch.models import pipeline as pl
    from antrea_tpu_torch.ops import hashing
    from antrea_tpu_torch.ops import onepass as op

    meta = step.meta
    src_f, dst_f, proto, sport, dport = lanes
    pp = pl._pair16(sport, dport)
    h = hashing.flow_hash(pl._raw_bits(src_f), pl._raw_bits(dst_f), proto,
                          sport, dport)
    slot = h & (meta.flow_slots - 1)
    pg = proto | 0x100
    hit, _, _, mr, kr0, ts0 = pl._cache_lookup(
        state.flow, slot, torch.stack([src_f, dst_f], 1), pp, pg,
        pg | (pl.GEN_ETERNAL << 9), now, proto, meta)
    x, _ = pl._onepass_inputs(state.aff, drs, dsvc, src_f, dst_f, proto,
                              sport, dport, pp, h, ~hit, kr0, mr, ts0, now,
                              meta)
    ing, eg = drs.ingress, drs.egress
    tabs = op.OnepassTables(
        inc=tuple(t.inc for t in (ing.at, ing.peer, ing.svc, eg.at, eg.peer,
                                  eg.svc)),
        act_in=ing.action, act_out=eg.action)
    mm = meta.match
    st = op.OnepassStatic(k=mm.prune_budget, in_phases=mm.in_phases,
                          out_phases=mm.out_phases, svcref=mm.svcref,
                          timeouts=meta.timeouts, n_slots=meta.flow_slots,
                          pref_mask=pl.PREF_MASK)
    return x, tabs, st


def check_onepass(step, state, drs, dsvc, lanes, now, what):
    """Phase 3 / 5 for B3 on the step's own inputs -> record.  The byte
    bound counts what these inputs need: every lane's input row (40 words),
    its four action words and its 36 output words; a miss lane's six
    aggregate rows and, per direction, min(nc, K) candidate rows of 128 B
    per dimension (a fourth for the egress svcref row)."""
    import torch

    from antrea_tpu_torch.ops import onepass as op

    x, tabs, st = onepass_inputs(step, state, drs, dsvc, lanes, now)
    b = x.pkt.shape[0]
    got = op.onepass(x, tabs, now, 0, st)
    hit = got[0][:, 11] != 0
    miss = int((~hit).sum())
    s_in, s_out = x.agg[0].shape[1], x.agg[3].shape[1]
    cand_rows = 0
    for d, dims in ((0, 3), (1, 4 if st.svcref else 3)):
        g = x.agg[3 * d] & x.agg[3 * d + 1] & x.agg[3 * d + 2]
        nc = ((g != 0).sum(dim=1) * ~hit).clamp(max=min(st.k, g.shape[1]))
        cand_rows += int(nc.sum()) * dims
    agg_words = miss * 3 * (s_in + s_out)
    nbytes = b * (40 + 4 + 36) * 4 + agg_words * 4 + cand_rows * 128
    ops = 2 * agg_words + 2 * 32 * cand_rows
    del got
    rec = check_kernel(
        f"B3 one-pass ({what}, K={st.k}, {miss} miss lanes)",
        lambda: op.onepass(x, tabs, now, 0, st),
        lambda: op.onepass_plain(x, tabs, now, 0, st), b, nbytes, ops, 3)
    rec.update(miss_lanes=miss, candidate_rows=cand_rows)
    del x
    torch.cuda.empty_cache()
    return rec


def to_lanes(tr, dev, n=None):
    import numpy as np
    import torch

    from antrea_tpu_torch.utils import ip as iputil

    cols = (iputil.flip_u32(tr.src_ip), iputil.flip_u32(tr.dst_ip),
            tr.proto, tr.src_port, tr.dst_port)
    return tuple(torch.from_numpy(np.ascontiguousarray(c[:n], dtype=np.int32))
                 .to(dev) for c in cols)


def check_out(out, b, slow=True):
    """Shapes, types and verdict codes of a step's outputs; with the slow
    path run (slow), the candidate histogram counts every miss."""
    import torch

    for k, v in out.items():
        if k == "prune_cand_hist":
            if slow and int(v[:-1].sum()) != int(out["n_miss"]):
                raise SystemExit("prune_cand_hist does not count every miss")
            continue
        if v.dim() and v.shape != (b,):
            raise SystemExit(f"out[{k}] has shape {tuple(v.shape)}, not ({b},)")
        if v.dtype != torch.int32:
            raise SystemExit(f"out[{k}] is {v.dtype}, not int32")
    code = out["code"]
    if not bool(((code >= 0) & (code <= 2)).all()):
        raise SystemExit("verdict codes outside {allow, drop, reject}")


def reset_counts():
    from antrea_tpu_torch.ops import (consumer, consumer2, onepass,
                                      pruned_consumer)

    consumer.launches = pruned_consumer.launches = onepass.launches = 0
    consumer2.launches = 0


def counts() -> tuple[int, int, int]:
    """(B1, B2, B3) launches since reset_counts()."""
    from antrea_tpu_torch.ops import consumer, onepass, pruned_consumer

    return consumer.launches, pruned_consumer.launches, onepass.launches


def timed_step(step, state, drs, dsvc, lanes, now):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, out = step(state, drs, dsvc, *lanes, now, 0)
    torch.cuda.synchronize()
    return state, out, time.perf_counter() - t0


def drive_staged(step, state, drs, dsvc, lanes):
    """Phase 4: the staged fused step (bench.py's headline path)."""
    reset_counts()
    state, out, cold_s = timed_step(step, state, drs, dsvc, lanes, 100)
    check_out(out, B)
    n_miss = int(out["n_miss"])
    b1 = counts()[0]
    want = -(-n_miss // MISS_CHUNK)
    if b1 != want or b1 == 0:
        raise SystemExit(f"cold step launched B1 {b1} times, expected "
                         f"ceil({n_miss}/{MISS_CHUNK}) = {want}")
    log(f"staged cold step: {cold_s * 1e3:.1f} ms, n_miss {n_miss}, "
        f"B1 launches {b1}, committed {int(out['committed'].sum())}, "
        f"n_evict {int(out['n_evict'])}")
    state, out, warm_s = timed_step(step, state, drs, dsvc, lanes, 101)
    check_out(out, B)
    log(f"staged warm step: {warm_s * 1e3:.2f} ms, n_miss "
        f"{int(out['n_miss'])}, est {int(out['est'].sum())}")
    times, misses, before = [], [], counts()[0]
    for i in range(STEADY_STEPS):
        state, out, s = timed_step(step, state, drs, dsvc, lanes, 102 + i)
        times.append(s)
        misses.append(int(out["n_miss"]))
    check_out(out, B)
    launches = counts()
    if launches[1:] != (0, 0):
        raise SystemExit(f"the staged step launched B2/B3: {launches}")
    med = sorted(times)[len(times) // 2]
    log(f"staged steady: {STEADY_STEPS} steps, median {med * 1e3:.3f} "
        f"ms/step (min {min(times) * 1e3:.3f}, max {max(times) * 1e3:.3f}), "
        f"{B / med / 1e6:.2f} M packets/s; n_miss per step {misses}; "
        f"B1 launches in steady steps {launches[0] - before}")
    return dict(cold_ms=cold_s * 1e3, warm_ms=warm_s * 1e3,
                steady_ms=med * 1e3, steady_pps=B / med), launches[0]


def drive_onepass(step, state, drs, dsvc, lanes):
    """Phase 5: the one-pass step, cold, warm, steady and expire-all."""
    reset_counts()
    state, out, cold_s = timed_step(step, state, drs, dsvc, lanes, 100)
    check_out(out, B)
    n_miss, n_fb = int(out["n_miss"]), int(out["n_prune_fb"])
    b1, b2, b3 = counts()
    if b3 != 1 or b2 != 0 or b1 != (1 if n_fb else 0):
        raise SystemExit(f"cold one-pass step launched (B1, B2, B3) = "
                         f"{(b1, b2, b3)}, expected ({int(n_fb > 0)}, 0, 1)")
    log(f"one-pass cold step: {cold_s * 1e3:.1f} ms, n_miss {n_miss}, "
        f"skips {int(out['n_prune_skips'])}, fallbacks {n_fb}, "
        f"(B1, B2, B3) launches {(b1, b2, b3)}, committed "
        f"{int(out['committed'].sum())}, n_evict {int(out['n_evict'])}")
    state, out, warm_s = timed_step(step, state, drs, dsvc, lanes, 101)
    check_out(out, B)
    log(f"one-pass warm step: {warm_s * 1e3:.2f} ms, n_miss "
        f"{int(out['n_miss'])}, est {int(out['est'].sum())}, launches so far "
        f"{counts()}")
    times, misses, b3s = [], [], []
    for i in range(STEADY_STEPS):
        before = counts()[2]
        state, out, s = timed_step(step, state, drs, dsvc, lanes, 102 + i)
        times.append(s)
        misses.append(int(out["n_miss"]))
        b3s.append(counts()[2] - before)
        if b3s[-1] != (1 if misses[-1] else 0):
            raise SystemExit(f"steady step {i}: {b3s[-1]} B3 launches with "
                             f"{misses[-1]} misses")
    check_out(out, B)
    med = sorted(times)[len(times) // 2]
    log(f"one-pass steady: {STEADY_STEPS} steps, median {med * 1e3:.3f} "
        f"ms/step (min {min(times) * 1e3:.3f}, max {max(times) * 1e3:.3f}), "
        f"{B / med / 1e6:.2f} M packets/s; n_miss per step {misses}; "
        f"B3 launches per step {b3s}")
    e_times, skips, fbs = [], [], []
    for i in range(EXPIRE_STEPS):
        state, out, s = timed_step(step, state, drs, dsvc, lanes,
                                   7200 * (i + 2))
        check_out(out, B)
        if int(out["n_miss"]) != B:
            raise SystemExit(f"expire-all step {i}: n_miss {out['n_miss']}")
        e_times.append(s)
        skips.append(int(out["n_prune_skips"]))
        fbs.append(int(out["n_prune_fb"]))
    e_med = sorted(e_times)[len(e_times) // 2]
    launches = counts()
    log(f"one-pass expire-all: {EXPIRE_STEPS} steps of {B} misses, median "
        f"{e_med * 1e3:.2f} ms/step (min {min(e_times) * 1e3:.2f}, max "
        f"{max(e_times) * 1e3:.2f}), {B / e_med / 1e6:.3f} M packets/s; "
        f"skips {skips}, fallbacks {fbs} (skip share {skips[0] / B:.4f}, "
        f"fallback share {fbs[0] / B:.4f}); launches over the path "
        f"(B1, B2, B3) {launches}")
    if launches[1] != 0:
        raise SystemExit("the one-pass step launched B2")
    rec = dict(cold_ms=cold_s * 1e3, warm_ms=warm_s * 1e3,
               steady_ms=med * 1e3, steady_pps=B / med,
               expire_ms=e_med * 1e3, expire_pps=B / e_med,
               skip_share=skips[0] / B, fallback_share=fbs[0] / B)
    return rec, launches, state


def drive_pruned_classify(step, drs, lanes, dev):
    """Phase 6a: classify_batch(prune_budget=4, fused=True) on B_COLD
    lanes, timed on the host clock around synchronized calls."""
    import torch

    from antrea_tpu_torch.ops.match import classify_batch

    src, dst, proto, _, dport = (t[:B_COLD] for t in lanes)
    meta = step.meta.match

    def run():
        return classify_batch(drs, src, dst, proto, dport, meta=meta,
                              fused=True)

    run()
    times = []
    reset_counts()
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cls = run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = counts()
    if launches[1] != 5:
        raise SystemExit(f"5 pruned classifies launched B2 {launches[1]} "
                         f"times")
    med = sorted(times)[len(times) // 2]
    skip = float(cls["prune_skip"].float().mean())
    fb = float(cls["prune_fb"].float().mean())
    log(f"pruned classify B={B_COLD}: median {med * 1e3:.3f} ms "
        f"(min {min(times) * 1e3:.3f}, max {max(times) * 1e3:.3f}), "
        f"{B_COLD / med / 1e6:.2f} M packets/s; skip rate {skip:.4f}, "
        f"fallback rate {fb:.4f}; (B1, B2, B3) launches over 5 calls "
        f"{launches}")
    return dict(ms=med * 1e3, pps=B_COLD / med, skip_rate=skip,
                fallback_rate=fb)


def drive_staged_pruned(step, drs, dsvc, lanes, dev):
    """Phase 6b: one cold step of the staged pruned pipeline (onepass=False)
    on a fresh state; B2 launches once per miss round."""
    from antrea_tpu_torch.models import pipeline as pl

    meta = step.meta._replace(onepass=False)
    state = pl.init_state(FLOW_SLOTS, meta.aff_slots, device=dev)

    def staged(*a, **k):
        return pl.pipeline_step(*a, meta=meta, **k)

    reset_counts()
    state, out, s = timed_step(staged, state, drs, dsvc, lanes, 100)
    check_out(out, B)
    n_miss = int(out["n_miss"])
    launches = counts()
    want = -(-n_miss // MISS_CHUNK)
    if launches[1] != want or launches[2] != 0:
        raise SystemExit(f"staged pruned cold step launched (B1, B2, B3) = "
                         f"{launches}, expected B2 = ceil({n_miss}/"
                         f"{MISS_CHUNK}) = {want} and no B3")
    log(f"staged pruned cold step: {s * 1e3:.1f} ms, n_miss {n_miss}, "
        f"skips {int(out['n_prune_skips'])}, fallbacks "
        f"{int(out['n_prune_fb'])}, (B1, B2, B3) launches {launches}")
    return dict(cold_ms=s * 1e3), launches


def cross_check(step, drs, dsvc, tr, dev, what, pruned_meta=None):
    """Phase 7: a fresh state on the card and on the CPU, same tables, cold
    then warm; outputs and state bitwise equal."""
    import torch

    from antrea_tpu_torch.models import pipeline as pl
    from antrea_tpu_torch.ops.match import classify_batch, tree_map

    sub_cuda = to_lanes(tr, dev, CROSS_LANES)
    sub_cpu = tuple(t.cpu() for t in sub_cuda)
    drs_cpu = tree_map(lambda t: t.cpu(), drs)
    dsvc_cpu = tree_map(lambda t: t.cpu(), dsvc)
    st_gpu = pl.init_state(FLOW_SLOTS, step.meta.aff_slots, device=dev)
    st_cpu = pl.init_state(FLOW_SLOTS, step.meta.aff_slots, device="cpu")
    for now in (100, 101):
        st_gpu, og = step(st_gpu, drs, dsvc, *sub_cuda, now, 0)
        st_cpu, oc = step(st_cpu, drs_cpu, dsvc_cpu, *sub_cpu, now, 0)
        for k in oc:
            if not torch.equal(og[k].cpu(), oc[k]):
                raise SystemExit(f"cross-check {what} now={now}: out[{k}] "
                                 f"differs")
        for part in ("flow", "aff"):
            for f, tg, tc in zip(getattr(st_cpu, part)._fields,
                                 getattr(st_gpu, part), getattr(st_cpu, part)):
                if not torch.equal(tg[:-1].cpu(), tc[:-1]):
                    raise SystemExit(f"cross-check {what} now={now}: "
                                     f"{part}.{f} differs")
        log(f"cross-check {what} now={now}: {CROSS_LANES} lanes, n_miss "
            f"{int(oc['n_miss'])}, outputs and state bitwise equal "
            f"(card vs CPU)")
    if pruned_meta is not None:
        s, d, p, _, dp = sub_cuda
        cg = classify_batch(drs, s, d, p, dp, meta=pruned_meta, fused=True)
        cc = classify_batch(drs_cpu, *(t.cpu() for t in (s, d, p, dp)),
                            meta=pruned_meta, fused=True)
        for k in cc:
            if not torch.equal(cg[k].cpu(), cc[k]):
                raise SystemExit(f"cross-check pruned classify: {k} differs")
        log(f"cross-check pruned classify: {CROSS_LANES} lanes, fallback "
            f"{int(cc['prune_fb'].sum())}, skip {int(cc['prune_skip'].sum())}"
            f", every output bitwise equal (card vs CPU)")
    del drs_cpu, dsvc_cpu, st_cpu, st_gpu
    torch.cuda.empty_cache()


def async_cadence(step, state, drs, dsvc, hot, fresh, now, gen=0,
                  timed=True):
    """The async engine's device half on `state`: the fast step (phases=0,
    DROP admission) over `hot` with its last len(fresh[0]) lanes replaced
    by `fresh`, the coalesced drain (one round, drain_reclaim=True) of the
    admitted lanes, and one _maintain_scan at gen.  -> (fast out, drain
    out, (n_aged, n_revalidated), seconds of each of the three)."""
    import torch

    from antrea_tpu_torch.compiler.compile import ACT_DROP
    from antrea_tpu_torch.models import pipeline as pl

    n = fresh[0].shape[0]
    batch = tuple(torch.cat([h[:h.shape[0] - n], f])
                  for h, f in zip(hot, fresh))
    fast_meta = step.meta._replace(phases=0, miss_code=ACT_DROP)
    secs = []

    def run(fn):
        if timed:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        if timed:
            torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        return r

    _, fo = run(lambda: pl.pipeline_step(state, drs, dsvc, *batch, now, gen,
                                         meta=fast_meta))
    adm = fo["miss"] != 0
    window = tuple(c[adm] for c in batch)
    n_adm = window[0].shape[0]
    drain_meta = step.meta._replace(drain_reclaim=True,
                                    miss_chunk=max(1, n_adm))
    _, do = run(lambda: pl.pipeline_step(state, drs, dsvc, *window, now, gen,
                                         meta=drain_meta))
    _, n_aged, n_stale = run(lambda: pl._maintain_scan(
        state, now, gen, timeouts=step.meta.timeouts))
    return fo, do, (n_aged, n_stale), secs


def drive_async(step, drs, dsvc, lanes, pool, dev, what):
    """Phase 8: the async cadence on a fresh 2**22-slot state whose hot set
    is warmed by two synchronous steps."""
    from antrea_tpu_torch.compiler.compile import ACT_DROP
    from antrea_tpu_torch.models import pipeline as pl

    state = pl.init_state(FLOW_SLOTS, step.meta.aff_slots, device=dev)
    for now in (100, 101):
        step(state, drs, dsvc, *lanes, now, 0)
    reset_counts()
    fo, do, (aged, stale), secs = async_cadence(
        step, state, drs, dsvc, lanes, tuple(c[:N_NEW] for c in pool), 102)
    launches = counts()
    check_out(fo, B, slow=False)
    n_adm = int(fo["n_miss"])
    check_out(do, n_adm)
    miss = fo["miss"] != 0
    if (not bool((fo["code"][miss] == ACT_DROP).all())
            or int(fo["committed"].sum()) != 0):
        raise SystemExit(f"async {what}: the fast step classified or "
                         f"committed a miss lane")
    if int(do["n_miss"]) != n_adm or n_adm == 0:
        raise SystemExit(f"async {what}: drain n_miss {int(do['n_miss'])}, "
                         f"admitted {n_adm}, fresh {N_NEW}")
    want = (0, 0, 1) if step.meta.onepass else (1, 0, 0)
    if launches[1] != 0 or launches[2] != want[2] or (
            launches[0] != want[0] and not step.meta.onepass):
        raise SystemExit(f"async {what}: (B1, B2, B3) launches {launches}, "
                         f"expected {want} (B1 <= 1 on the one-pass drain)")
    log(f"async cadence, {what}: fast step {secs[0] * 1e3:.2f} ms "
        f"({n_adm} lanes admitted of {B}), drain {secs[1] * 1e3:.2f} ms "
        f"(n_miss {int(do['n_miss'])}, committed "
        f"{int(do['committed'].sum())}, n_evict {int(do['n_evict'])}, "
        f"n_reclaim {int(do['n_reclaim'])}), maintain_scan "
        f"{secs[2] * 1e3:.2f} ms (aged {int(aged)}, revalidated "
        f"{int(stale)}); (B1, B2, B3) launches {launches}")
    del state
    return dict(fast_ms=secs[0] * 1e3, drain_ms=secs[1] * 1e3,
                maintain_ms=secs[2] * 1e3, admitted=n_adm,
                n_reclaim=int(do["n_reclaim"]),
                n_evict=int(do["n_evict"])), launches


def cross_check_async(step, drs, dsvc, tr, pool, dev, what):
    """Phase 8b: the async cadence on CROSS_LANES lanes over a
    CROSS_SLOTS-slot cache, on the card and on the CPU (plain versions),
    same tables: a cold synchronous step at now=100, then the cadence at
    now=7400 (every entry expired: the drain reclaims) and gen=1 (the scan
    revalidates the gen-0 denials).  Outputs, counts and state bitwise."""
    import torch

    from antrea_tpu_torch.models import pipeline as pl
    from antrea_tpu_torch.ops.match import tree_map

    meta = step.meta._replace(flow_slots=CROSS_SLOTS)

    def sub_step(*a):
        return pl.pipeline_step(*a, meta=meta)

    sub_step.meta = meta
    lanes = to_lanes(tr, dev, CROSS_LANES)
    fresh = to_lanes(pool, dev, CROSS_LANES // 8)
    runs = {}
    for d in ("cuda", "cpu"):
        cpu = d == "cpu"
        drs_d = tree_map(lambda t: t.cpu(), drs) if cpu else drs
        dsvc_d = tree_map(lambda t: t.cpu(), dsvc) if cpu else dsvc
        ln, fr = ((tuple(t.cpu() for t in lanes), tuple(t.cpu() for t in fresh))
                  if cpu else (lanes, fresh))
        st = pl.init_state(CROSS_SLOTS, meta.aff_slots, device=d)
        _, cold = sub_step(st, drs_d, dsvc_d, *ln, 100, 0)
        fo, do, scan, _ = async_cadence(sub_step, st, drs_d, dsvc_d, ln, fr,
                                        7400, gen=1, timed=not cpu)
        runs[d] = (cold, fo, do, scan, st)
        del drs_d, dsvc_d
    g, c = runs["cuda"], runs["cpu"]
    for part, og, oc in zip(("cold", "fast", "drain"), g[:3], c[:3]):
        for k in oc:
            if not torch.equal(og[k].cpu(), oc[k]):
                raise SystemExit(f"async cross-check {what}: {part} out[{k}] "
                                 f"differs")
    if [int(x) for x in g[3]] != [int(x) for x in c[3]]:
        raise SystemExit(f"async cross-check {what}: scan counts differ")
    for part in ("flow", "aff"):
        for f, tg, tc in zip(getattr(c[4], part)._fields,
                             getattr(g[4], part), getattr(c[4], part)):
            if not torch.equal(tg[:-1].cpu(), tc[:-1]):
                raise SystemExit(f"async cross-check {what}: {part}.{f} "
                                 f"differs")
    do = c[2]
    if int(do["n_reclaim"]) == 0:
        raise SystemExit(f"async cross-check {what}: no reclaim")
    log(f"async cross-check {what}: {CROSS_LANES} lanes over {CROSS_SLOTS} "
        f"slots, admitted {int(c[1]['n_miss'])}, drain n_reclaim "
        f"{int(do['n_reclaim'])} n_evict {int(do['n_evict'])}, scan (aged, "
        f"revalidated) {tuple(int(x) for x in c[3])}; outputs, counts and "
        f"state bitwise equal (card vs CPU)")
    del runs
    torch.cuda.empty_cache()


def drive_study():
    """Phase 9: S1's path, bench_cold_study_torch.py's case 4 on the card,
    in this process.  -> (S1 launches, seconds per batch)."""
    import bench_cold_study_torch as study
    from antrea_tpu_torch.ops import consumer2

    reset_counts()
    res = study.main(["--cases", "4", "--device", "cuda"])
    n = consumer2.launches
    b1, b2, b3 = counts()
    if n == 0 or (b1, b2, b3) != (0, 0, 0):
        raise SystemExit(f"the study's case 4 launched S1 {n} times and "
                         f"(B1, B2, B3) {(b1, b2, b3)}")
    (sec,) = res["times_s"].values()
    log(f"study case 4 (AND in torch + S1) at B={B_COLD}: {sec * 1e3:.3f} "
        f"ms/batch, S1 launches {n}")
    return n, sec


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    from antrea_tpu_torch import _build
    from antrea_tpu_torch.models import pipeline as pl

    dev = torch.device("cuda")
    card = card_line()
    log(f"card: {card}")
    log("torch", torch.__version__, "cuda", torch.version.cuda,
        "python", sys.version.split()[0])

    # 1. Build.
    t0 = time.perf_counter()
    report = _build.build()
    log(f"kernels built in {time.perf_counter() - t0:.2f} s: "
        + ", ".join(f"{k} {v['seconds']:.2f} s" for k, v in report.items()))
    for k, v in report.items():
        for line in v["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {k}: {line.strip()}")

    # 2. World and the two pipelines.
    t0 = time.perf_counter()
    cps, svc, tr, pool_tr = build_world()
    log(f"world built on the host in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    step, state, (drs, dsvc) = pl.make_pipeline(
        cps, svc, flow_slots=FLOW_SLOTS, miss_chunk=MISS_CHUNK, fused=True,
        device=dev)
    meta = step.meta.match
    ostep, ostate, (pdrs, pdsvc) = pl.make_pipeline(
        cps, svc, flow_slots=FLOW_SLOTS, miss_chunk=MISS_CHUNK, fused=True,
        prune_budget=PRUNE_K, ct_timeout_s=3600, device=dev)
    torch.cuda.synchronize()
    pmeta = ostep.meta.match
    if not ostep.meta.onepass:
        raise SystemExit("fused + prune_budget did not select the one-pass "
                         "step")
    s_in, s_out = pdrs.ingress.at.agg.shape[1], pdrs.egress.at.agg.shape[1]
    log(f"pipeline tables on the card in {time.perf_counter() - t0:.1f} s: "
        f"w_in={meta.w_in} w_out={meta.w_out} in_phases={meta.in_phases} "
        f"out_phases={meta.out_phases}; pruned w_in={pmeta.w_in} "
        f"w_out={pmeta.w_out}, superblocks S_in={s_in} S_out={s_out}, "
        f"svcref={pmeta.svcref}; device memory "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    lanes = to_lanes(tr, dev)

    # 3. Kernels against their plain versions.
    b1 = check_consumer(meta, dev)
    s1 = check_consumer2(meta, dev)
    b2 = check_pruned(pmeta, s_in, s_out, dev)
    b3 = {"cold": check_onepass(ostep, ostate, pdrs, pdsvc, lanes, 100,
                                "empty cache")}

    # 4. The staged fused step.
    staged, b1_launches = drive_staged(step, state, drs, dsvc, lanes)
    del state
    torch.cuda.empty_cache()

    # 5. The one-pass step; then B3 once more on its warm cache.
    one, op_launches, ostate = drive_onepass(ostep, ostate, pdrs, pdsvc,
                                             lanes)
    b3["warm"] = check_onepass(ostep, ostate, pdrs, pdsvc, lanes,
                               7200 * (EXPIRE_STEPS + 1) + 1, "warm cache")
    del ostate
    torch.cuda.empty_cache()

    # 6. The pruned classify and the staged pruned step.
    pcls = drive_pruned_classify(ostep, pdrs, lanes, dev)
    spruned, sp_launches = drive_staged_pruned(ostep, pdrs, pdsvc, lanes, dev)
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f}"
        f" GiB")

    # 7. Cross-checks against the CPU (plain versions), same tables.
    cross_check(step, drs, dsvc, tr, dev, "staged fused")
    cross_check(ostep, pdrs, pdsvc, tr, dev, "one-pass", pruned_meta=pmeta)

    # 8. The async cadence, then its cross-checks against the CPU.
    pool = to_lanes(pool_tr, dev)
    a_staged, a_st_launches = drive_async(step, drs, dsvc, lanes, pool, dev,
                                          "staged fused")
    a_one, a_op_launches = drive_async(ostep, pdrs, pdsvc, lanes, pool, dev,
                                       "one-pass")
    cross_check_async(step, drs, dsvc, tr, pool_tr, dev, "staged fused")
    cross_check_async(ostep, pdrs, pdsvc, tr, pool_tr, dev, "one-pass")
    del pool, lanes
    torch.cuda.empty_cache()

    # 9. S1's path: the cold-path study's case 4.
    s1_launches, study_s = drive_study()
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f}"
        f" GiB")

    def rec(name, src, replaces, launches, r, **extra):
        keys = ("ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err")
        return {"name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": launches,
                **{k: r[k] for k in keys}, "library_ms": None,
                "call_ms": r["call_ms"], **extra}

    def at(r):
        return {k: r[k] for k in ("ms", "call_ms", "plain_ms", "bound_ms")}

    kernels = [
        rec("B1 consumer", "antrea_tpu_torch/csrc/consumer.cu",
            "antrea_tpu/ops/match.py:1422", b1_launches, b1[256],
            at_B32768=at(b1[32768]),
            launches_onepass_path=op_launches[0],
            launches_async_staged_path=a_st_launches[0],
            launches_async_onepass_path=a_op_launches[0]),
        rec("B2 pruned consumer", "antrea_tpu_torch/csrc/pruned_consumer.cu",
            "antrea_tpu/ops/match.py:1517", sp_launches[1], b2[256],
            at_B32768=at(b2[32768])),
        rec("B3 one-pass", "antrea_tpu_torch/csrc/onepass.cu",
            "antrea_tpu/ops/match.py:1854", op_launches[2], b3["cold"],
            batch=B, warm_cache={**at(b3["warm"]),
                                 "miss_lanes": b3["warm"]["miss_lanes"]},
            launches_async_onepass_path=a_op_launches[2]),
        rec("S1 consumer2", "antrea_tpu_torch/csrc/consumer2.cu",
            "bench_cold_study.py:129", s1_launches, s1[32768],
            at_B256=at(s1[256]), study_case4_ms=study_s * 1e3),
    ]
    log(json.dumps({"card": card, "staged": staged, "onepass": one,
                    "pruned_classify": pcls, "staged_pruned": spruned,
                    "async_staged": a_staged, "async_onepass": a_one}))
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
