#!/usr/bin/env python3
"""Cold-path study of the PyTorch/CUDA port: the counterpart of
bench_cold_study.py, with the same cases, flags and world.

Measures, at the 100k-rule world and B = 2**15 (on the card unless
--device cpu):
  1. the unpruned classify end to end (the six row gathers feeding B1);
  2. the interval lookups (searchsorted) alone;
  3. the lookups and the six row gathers, reduced (the gather bound);
  4. the six rows gathered and ANDed in torch, then the two-input phase
     scan S1 (ops/consumer2, csrc/consumer2.cu);
  5. the overlap decomposition of the churn step (empty service tables,
     flow_slots 2**20, N_NEW = B // 8 fresh lanes a step from a 2**18
     one-per-flow pool): the fast step alone (phases=0), the coalesced
     drain alone (one round, drain_reclaim=True), the two serialized over
     one window, and the two with the drain one window behind;
  6. the pruning decomposition: the summary-only classify, the pruned
     classify end to end at each K of PRUNE_LADDER with its fallback and
     skip rates, and a match-density sweep (a share of lanes with
     addresses outside every pod range), written as one JSON document.

    python3 bench_cold_study_torch.py [--cases 1,...,6] [--smoke]
                                      [--json PATH] [--device cuda|cpu]

Times come from utils/timing.device_loop_time (k_big - k_small iterations,
best of the repeats), which on the card counts the host's share of each
iteration.  --smoke shrinks the world (3000 rules, B = 2**10) and the loops
so the methodology runs on the CPU; its times are noise, its rates exact.
Without a card the default --device cuda exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cases", default="1,2,3,4,5,6",
                    help="comma-separated case numbers to run")
    ap.add_argument("--smoke", action="store_true",
                    help="toy world + tiny loops: a CPU-green methodology "
                         "proof, not a measurement")
    ap.add_argument("--json", default="COLD_STUDY_torch_prune.json",
                    help="case-6 decomposition JSON output path")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the study runs (cpu only when asked)")
    return ap.parse_args(argv)


def card_line() -> str:
    """nvidia-smi's name and power limit of the first card."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def main(argv=None) -> dict:
    """Run the study -> {"card", "device", "times_s": {case name: s},
    "prune": the case-6 document or None}.  Raises SystemExit(2) when the
    card was asked for and there is none."""
    args = parse(argv)
    cases = {int(c) for c in args.cases.split(",") if c.strip()}

    import numpy as np
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("bench_cold_study_torch: torch.cuda.is_available() is false "
              "(pass --device cpu to run on the CPU)", file=sys.stderr)
        raise SystemExit(2)

    from antrea_tpu_torch.compiler.compile import compile_policy_set
    from antrea_tpu_torch.models import pipeline as pmod
    from antrea_tpu_torch.models.profile import device_name
    from antrea_tpu_torch.ops import consumer2
    from antrea_tpu_torch.ops import match as m
    from antrea_tpu_torch.simulator import gen_cluster, gen_traffic
    from antrea_tpu_torch.utils import ip as iputil
    from antrea_tpu_torch.utils.timing import device_loop_time

    dev = torch.device(args.device)
    card = card_line() if dev.type == "cuda" else "cpu"
    print(f"card: {card}", flush=True)
    smoke = args.smoke
    B = 1 << (10 if smoke else 15)
    n_rules = 3_000 if smoke else 100_000
    k_small, k_big, repeats = (2, 4, 1) if smoke else (8, 64, 3)
    i32 = torch.int32

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(
            dev)

    cluster = gen_cluster(n_rules, n_nodes=64, pods_per_node=32, seed=1)
    cps = compile_policy_set(cluster.ps)
    drs, meta = m.to_device(cps, dev)
    tr = gen_traffic(cluster.pod_ips, B, n_flows=B, seed=3)
    src = t(iputil.flip_u32(tr.src_ip))
    dst = t(iputil.flip_u32(tr.dst_ip))
    proto = t(tr.proto)
    dport = t(tr.dst_port)
    name = device_name(src)
    print("w_in", meta.w_in, "w_out", meta.w_out,
          "NB at", tuple(drs.ingress.at.bounds.shape),
          "peer", tuple(drs.ingress.peer.bounds.shape),
          "svc", tuple(drs.ingress.svc.bounds.shape), "smoke", smoke,
          "device", name, flush=True)
    times: dict[str, float] = {}

    def timeit(label, body, carry):
        sec = device_loop_time(body, carry, k_small=k_small, k_big=k_big,
                               repeats=repeats)
        times[label] = sec
        print(f"{label}: {sec * 1e3:.3f} ms/batch -> {B / sec / 1e6:.2f}M "
              f"pps", flush=True)
        return sec

    def perturb(dp_, acc):
        """A data dependence of each iteration on the last (as the JAX
        study's carry): flip the port's low bit when acc is odd."""
        return dp_ ^ (acc & 1)

    carry = (torch.zeros((), dtype=i32, device=dev), drs, src, dst, proto,
             dport)

    def searchsorted_rows(drs_, s_, d_, svc_key):
        ing, eg = drs_.ingress, drs_.egress
        return ((ing.at, d_), (ing.peer, s_), (ing.svc, svc_key),
                (eg.at, s_), (eg.peer, d_), (eg.svc, svc_key))

    # 1) end to end, unpruned (B1 on the card, its plain version on a CPU)
    def body_full(i, c):
        acc, drs_, s_, d_, p_, dp_ = c
        cls = m.classify_batch(drs_, s_, d_, p_, perturb(dp_, acc),
                               meta=meta, fused=True)
        return (acc + cls["code"].sum(dtype=i32), drs_, s_, d_, p_, dp_)

    t_full = (timeit("end-to-end (unpruned)", body_full, carry)
              if 1 in cases else None)

    # 2) the interval lookups alone
    def body_ss(i, c):
        acc, drs_, s_, d_, p_, dp_ = c
        svc_key = (p_ << 16) | perturb(dp_, acc)
        tot = sum(m._dim_index(tab, x).sum(dtype=i32)
                  for tab, x in searchsorted_rows(drs_, s_, d_, svc_key))
        return (acc + tot, drs_, s_, d_, p_, dp_)

    if 2 in cases:
        timeit("searchsorted only", body_ss, carry)

    # 3) lookups + six row gathers, reduced (no consumer)
    def body_g(i, c):
        acc, drs_, s_, d_, p_, dp_ = c
        svc_key = (p_ << 16) | perturb(dp_, acc)
        tot = sum(tab.inc[m._dim_index(tab, x)].sum(dtype=i32)
                  for tab, x in searchsorted_rows(drs_, s_, d_, svc_key))
        return (acc + tot, drs_, s_, d_, p_, dp_)

    if 3 in cases:
        timeit("searchsorted+gathers+reduce (no consumer)", body_g, carry)

    # 4) the AND in torch + the two-input consumer S1
    def body_and(i, c):
        acc, drs_, s_, d_, p_, dp_ = c
        svc_key = (p_ << 16) | perturb(dp_, acc)
        ing, eg = drs_.ingress, drs_.egress

        def row(tab, x):
            return tab.inc[m._dim_index(tab, x)]

        mi = row(ing.at, d_) & row(ing.peer, s_) & row(ing.svc, svc_key)
        mo = row(eg.at, s_) & row(eg.peer, d_) & row(eg.svc, svc_key)
        hits = consumer2.and_hits(mi, mo, meta.in_phases, meta.out_phases)
        return (acc + hits[:, 0].sum(dtype=i32), drs_, s_, d_, p_, dp_)

    if 4 in cases:
        timeit("AND-in-torch + 2-input consumer (S1)", body_and, carry)

    # 5) the overlap decomposition of the churn step
    if 5 in cases:
        from antrea_tpu_torch.compiler.services import compile_services

        n_new = B // 8
        pool_n = 1 << (12 if smoke else 18)
        ptr = gen_traffic(cluster.pod_ips, pool_n, n_flows=pool_n, seed=7,
                          one_per_flow=True)
        pool = (t(iputil.flip_u32(ptr.src_ip)), t(iputil.flip_u32(ptr.dst_ip)),
                t(ptr.proto), t(ptr.src_port), t(ptr.dst_port))
        hot = (src, dst, proto, t(tr.src_port), dport)
        step5, state5, (drs5, dsvc5) = pmod.make_pipeline(
            cps, compile_services([]), flow_slots=1 << (14 if smoke else 20),
            miss_chunk=n_new, fused=True, device=dev)
        meta_fast = step5.meta._replace(phases=0)
        meta_drain = step5.meta._replace(drain_reclaim=True)
        for w in (100, 101):  # warm the hot set
            step5(state5, drs5, dsvc5, *hot, w, 0)
        base = pmod.clone_state(state5)

        def window(k):
            off = (max(k, 0) * n_new) % (pool_n - n_new)
            return tuple(c[off:off + n_new] for c in pool)

        def overlap_body(fast, drain, deferred):
            """One churn iteration: the fast step over the mixed batch,
            the drain of the current (deferred=False) or previous window;
            every timed run starts from the warm state."""

            def body(i, c):
                if i == 0:
                    pmod.copy_state_(state5, base)
                fresh = window(i)
                if fast:
                    cols = tuple(torch.cat([h[:B - n_new], f])
                                 for h, f in zip(hot, fresh))
                    pmod.pipeline_step(state5, drs5, dsvc5, *cols, 102 + i,
                                       0, meta=meta_fast)
                if drain:
                    pmod.pipeline_step(state5, drs5, dsvc5,
                                       *(window(i - 1) if deferred else fresh),
                                       102 + i, 0, meta=meta_drain)
                return c

            return body

        t_fast = timeit("churn fast step alone (phases=0)",
                        overlap_body(True, False, False), state5)
        t_drain = timeit("coalesced drain alone (drain_reclaim)",
                         overlap_body(False, True, False), state5)
        t_serial = timeit("fast + drain SERIALIZED (same window)",
                          overlap_body(True, True, False), state5)
        t_ovl = timeit("fast + drain OVERLAPPED (window i-1 deferred)",
                       overlap_body(True, True, True), state5)
        print(f"overlap decomposition: fast {t_fast * 1e3:.2f} + drain "
              f"{t_drain * 1e3:.2f} = {1e3 * (t_fast + t_drain):.2f} ms "
              f"predicted; serialized {t_serial * 1e3:.2f} ms, overlapped "
              f"{t_ovl * 1e3:.2f} ms -> recovered "
              f"{1e3 * (t_serial - t_ovl):.2f} ms/step "
              f"({B / t_ovl / 1e6:.2f}M pps overlapped)", flush=True)
        del state5, base, drs5, dsvc5

    # 6) the pruning decomposition
    doc = None
    if 6 in cases:
        drs_p, meta_p1 = m.to_device(cps, dev, prune_budget=m.PRUNE_LADDER[0])
        s_in = int(drs_p.ingress.at.agg.shape[1])
        print(f"prune tables: w_in {meta_p1.w_in} (agg-padded), S {s_in} "
              f"superblocks", flush=True)

        def body_prune(meta_k, summary):
            def body(i, c):
                acc, drs_, s_, d_, p_, dp_ = c
                cls = m.classify_batch(drs_, s_, d_, p_, perturb(dp_, acc),
                                       meta=meta_k, fused=not summary,
                                       summary_only=summary)
                return (acc + cls["code"].sum(dtype=i32), drs_, s_, d_, p_,
                        dp_)
            return body

        def rates(cls):
            return (float(cls["prune_fb"].float().mean()),
                    float(cls["prune_skip"].float().mean()))

        carry6 = (carry[0], drs_p, src, dst, proto, dport)
        if t_full is None:
            t_full = timeit("end-to-end (unpruned reference)", body_full,
                            carry)
        t_sum = timeit("summary-only (phase 1: agg gather + AND)",
                       body_prune(meta_p1, True), carry6)
        k_sweep = {}
        for k in m.PRUNE_LADDER:
            meta_k = meta_p1._replace(prune_budget=k)
            t_k = timeit(f"pruned end-to-end K={k}",
                         body_prune(meta_k, False), carry6)
            fb, skip = rates(m.classify_batch(drs_p, src, dst, proto, dport,
                                              meta=meta_k))
            k_sweep[str(k)] = {"pruned_s_per_batch": t_k,
                               "pruned_pps": B / t_k, "fallback_rate": fb,
                               "skip_rate": skip}
            print(f"  K={k}: fb_rate {fb:.4f} skip_rate {skip:.4f}",
                  flush=True)

        # Match density: a share of lanes get addresses outside every pod
        # range (0.x.y.z), so the aggregate AND proves no match.
        rng = np.random.default_rng(11)
        ext = rng.integers(1, 1 << 24, size=B).astype(np.uint32)
        meta_k4 = meta_p1._replace(prune_budget=4)
        density_sweep = {}
        for frac in (0.0, 0.5, 1.0):
            n_ext = int(B * frac)
            d_mix = np.asarray(tr.dst_ip).copy()
            s_mix = np.asarray(tr.src_ip).copy()
            d_mix[:n_ext] = ext[:n_ext]
            s_mix[:n_ext] = ext[::-1][:n_ext]
            cm = (carry[0], drs_p, t(iputil.flip_u32(s_mix)),
                  t(iputil.flip_u32(d_mix)), proto, dport)
            t_d = timeit(f"pruned K=4, external-lane frac {frac}",
                         body_prune(meta_k4, False), cm)
            fb, skip = rates(m.classify_batch(drs_p, cm[2], cm[3], proto,
                                              dport, meta=meta_k4))
            density_sweep[str(frac)] = {"pruned_pps": B / t_d,
                                        "skip_rate": skip,
                                        "fallback_rate": fb}

        doc = {
            "metric": "cold_prune_decomposition",
            "smoke": smoke,
            "batch": B,
            "n_rules": n_rules,
            "superblocks": s_in,
            "fused": dev.type == "cuda",
            "unpruned_s_per_batch": t_full,
            "unpruned_pps": B / t_full,
            "summary_only_s_per_batch": t_sum,
            "summary_only_pps": B / t_sum,
            "k_sweep": k_sweep,
            "density_sweep": density_sweep,
            "device": name,
            "card": card,
        }
        line = json.dumps(doc)
        print(line, flush=True)
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as f:
            f.write(line + "\n")
        print(f"# wrote {args.json}", flush=True)
    return {"card": card, "device": name, "times_s": times, "prune": doc}


if __name__ == "__main__":
    main()
