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
     bit, and time both with CUDA events, on the world's own tables and the
     batch's own interval rows (the one-pass step's inputs on an empty
     cache: every lane a miss): B1 (staged tables), S1 (their ANDed rows)
     and B2 (pruned tables, the lanes' own aggregate AND rows, K = 4) on the
     first 256 lanes (the staged step's miss round) and the first 32768; B3
     on the whole batch, from the lane columns and the tables (it runs the
     probes itself).  For B1 and B2 also the time of the torch gathers that
     their old call sites ran on the same lanes, for B3 the torch prologue
     its old call site ran (prologue_ms), and two bounds: each distinct
     (table, row) read once, and every lane's rows read;
  4. drive the staged fused step: one cold step, one warm step, 8 steady
     steps, with every launch count set to 0 just before and read just
     after; print ms/step and packets/s;
  5. drive the one-pass step the same way (cold, warm, 8 steady steps) and
     then 4 steps that each expire the whole cache (now = 7200 * (i + 2),
     bench.py's cold_fused regime); print ms/step, packets/s, B3 launches
     and the prune counters; then hold B3 against its plain version once
     more on the warm cache (mostly hits), and B1 on every fallback lane of
     one more expire-all batch (the one-pass fallback re-walk's inputs);
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
     B = 2**15, in this process;
 10. the full per-packet walk (models/forwarding.pipeline_step_full) at the
     headline width, with node-0's topology (its 32 pods at ofports from 3,
     the other 63 nodes remote at their pod CIDRs) and in_port (1/16 of
     the lanes spoofed), flags and arp_op columns: the one-pass and the
     staged fused step, one cold, one warm and 8 steady steps each, ms/step
     and packets/s; then a 4096-lane card-vs-CPU cross-check of each;
 11. the (1, 1) mesh (parallel/mesh.make_sharded_pipeline_full) on NCCL,
     world size 1, in this process, one-pass (B3h and the fallback's B1)
     and staged, over the same world, batch and steps: every output and
     the flow and affinity tables bitwise equal to phase 10's, ms/step
     beside phase 10's (the seam's overhead);
 12. the (1, 2) mesh, one-pass: two gloo processes sharing the card, each
     building its own rule shard on the host; every output of every step
     and both ranks' final state bitwise equal (sha256) to phase 10's; each
     shard's incidence and aggregate bytes on the card.

 13. the engine (datapath/tpuflow.TpuflowDatapath), built from the
     headline PolicySet with node-0's topology (flow_slots=2**22,
     miss_chunk=256, canary_probes=8, delta_slots=128), one-pass
     (fused=True, prune_budget=4) and then staged (fused=True), one engine
     at a time: cold, warm and 8 steady steps of the headline traffic
     through step(), pod churn on 4 address groups (a fresh pod in, a
     member out, each canary-certified and kept in the delta slots), and a
     step of 2**17 fresh flows each with a churned address on one side;
     its verdicts and rule ids bitwise equal to an engine built from the
     post-delta PolicySet (the full recompile), 4096 more such flows
     bitwise equal to the port's engine on the CPU, and B1, B3 and
     (through the pruned canary) B2 launched in the phase.
 14. the async engine and the step knobs, one engine at a time:
     (a) bench.py's attack-floor engine (bench.py:1236-1246: flow_slots
     2**18, async, admission="drop", miss_source_rate=4.0 and burst 16,
     second_chance, canary_probes=8), one-pass and then staged (fused):
     4 rounds of a 4096-lane SYN flood (gen_syn_flood over 256 pod
     targets), each a step and a drain_slowpath, the last also a
     maintenance tick, bitwise equal to the same engine on the CPU
     (results, the tick, drains, the queue and admission counters, the
     tables); then 1 warm and 3 timed rounds of 2**17 lanes, each a step,
     a tick and a drain (bench.py runs 2 and 64: cut for time, a tick
     costing seconds), packets/s, ms per step, tick and drain, and
     slowpath_stats(); B1 (staged) or B3 (one-pass) launches in the
     drains, nothing in the fast steps.  The tick has no drain task, so
     bench.py's cadence never drains; each round adds the drain an agent
     runs beside its ticks.  (b) the churn cadence through the engine
     (admission="forward", drain_batch=2**14, the headline traffic with
     its last B/8 lanes fresh each round), 8 rounds each of
     overlap_commits off, on, and autotune_drain (one-pass; staged: the
     overlapped variant alone, cut for time): ms per fast step, drain and
     round; then the last round's lanes re-stepped: every settled lane at
     the same endpoint has the verdict and rule ids of a synchronous
     engine stepped on the same batches.
     (c) a one-pass engine with telemetry, the FlowExporter gate and
     second chance, 4096 fresh flows (lengths near 2**31) cold, warm,
     warm and past the idle timeout, on the card and on the CPU: every
     result, telemetry counter and table (counters included) bitwise
     equal, and the forward entries' packets and bytes those stepped.
     (d) B3 at second chance's stamp mask against its plain version on
     the headline batch, all-miss and warm, beside phase 3 and 5's
     times; then the one-pass steady step at 2**22 slots with each knob
     on against all off.  (e) profile() in sync and async mode on (c)'s
     engine: the chain's phases, summing to the total, cache_stats()
     unchanged.

 15. dual-stack at the headline width, on the headline world's twin (each
     pod also at fd00:10:0:<node>::<pod + 2>, each Service also at
     fd00:96::<i> with its endpoints' twins; the lanes of every flow with an
     odd source port carry its v6 twin, about half the batch), one pipeline
     or engine at a time: (a) B1 and B2 (K = 4) against their plain versions
     on the dual-stack tables at the batch's post-DNAT interval rows, v6
     sub-space rows included (first 256 and 32768 lanes, timed with both
     bounds as in phase 3); (b) the full walk on the staged fused
     dual-stack pipeline with node-0's dual-stack topology: cold, warm, 8
     steady steps, two coverage steps (spoofed v6 lanes, ND requests,
     FIN/RST), and its 4096-lane card-vs-CPU check; (c) the pruned classify
     with v6 lanes on 2**15 lanes; (d) the dual-stack engine (fused,
     canary_probes=8, delta_slots=128): cold, warm, 8 steady steps (the host
     views of the wide columns timed), v6 pod churn on 4 address groups and
     a step of 2**17 fresh v6 flows to the churned addresses, whose
     verdicts and rule ids equal an engine built from the post-delta
     PolicySet; (e) 4096 lanes, half v6, cold then warm through fresh
     engines on the card and on the CPU: every StepResult field, the
     tables, dump_flows() and a 16-lane trace() bitwise equal.

 16. tenant worlds, the serving batcher, restart and the scalar twin:
     (a) a staged fused engine on the headline world (flow_slots=2**22,
     canary_probes=8, serving_batcher=True, canonical_sizes=(2048, 8192))
     with 12 tenant worlds, 4 each of gen_cluster(n, n_nodes=8,
     pods_per_node=32) for n = 2,000, 8,000 and 25,000 (five rungs: each
     phase capacity pads to its own power of two, which splits the
     2,000-rule worlds over three), each at quota=2**18 and
     aff_quota=2**16: tenant_create seconds per rule count, device bytes
     per world; (b)'s first 4096 lanes cold then warm through this
     engine's step_tenants and a CPU engine's with the same worlds: every
     StepResult field, every world's tables, dump_flows(),
     tenant_dump_flows() and tenant_stats() bitwise equal (the card's
     worlds fresh again after); (b) step_tenants on 2**17 mixed lanes
     (half the headline traffic on the default world, half split evenly
     over the tenants, gen_traffic over each tenant's own pods): cold, warm
     and 8 steady steps, with every launch count set to 0 just before and
     read just after, and each dispatch's launches read around it with its
     world (B1 launched inside tenant worlds); packets/s, dispatches a
     step, the padded share, and the distinct (rung signature, lane count)
     pairs reaching models/forwarding.pipeline_step_full, at most (rungs +
     1) x 2; beside it the same engine's plain step on 2**17 default-world
     lanes; B1 against its plain version on a 25,000-rule world's
     rung-padded tables at 2048 lanes and at MISS_CHUNK (256), the round
     the staged step launches it on; (e) the
     same two installs (the headline bundle, one tenant's) on that engine
     and on an engine with a persist dir (in a temporary directory, one
     tenant per rule count), which is dropped and rebuilt from the dir: boot
     seconds, the generation, the tenants' tids, specs and generations, the
     native round journal, and from the second step on the codes and rule
     ids of the headline batch and of each tenant equal to the engine that
     never restarted; (f) 16 fresh headline lanes through
     make_datapath("oracle") and through the restarted engine (its cache
     empty): every StepResult field equal; (c) a one-pass engine
     (fused=True, prune_budget=4) with one tenant per rule count on the
     card and on the CPU: 4096 mixed lanes (half default) cold then warm
     through step_tenants, every StepResult field, every world's tables,
     dump_flows() and tenant_dump_flows() bitwise equal, and lane for lane
     equal to unbatched step/tenant_step from the same states on the card;
     the launch counts set to 0 just before each card step_tenants and read
     just after (B3 launched inside the tenant worlds, read around each of
     its dispatches, not the replays'); B2 and B3 against their plain
     versions on the 25,000-rule world's rung-padded pruned tables; (d) a
     tenant install through the pruned canary (B2), then a forced canary
     veto (a FaultPlan) on another tenant: only that world rolls back; (f)
     the twin on the 8,000-rule tenant's PolicySet against the engine on
     the card, 512 lanes cold then warm: every field and dump_flows()
     equal.  Each sub-phase's seconds are printed.

 17. the mesh engine (parallel/meshpath.MeshDatapath, the whole mesh in
     this process on the card) on the headline world with node-0's
     topology, one engine at a time: (1, 1) and (1, 2) one-pass
     (flow_slots=2**22 a replica) and (2, 1) staged fused (2**21 a replica,
     the same global capacity); cold, warm and 8 steady steps of the
     headline traffic each, ms/step and packets/s beside phase 13's
     engine, with every launch count set to 0 just before the first step
     and read just after the last (B3h on every rule shard of a one-pass
     step, never B3; B1 in the staged rounds and the fallback re-walks),
     and the peak device memory.  (1, 1) is held to phase 13's one-pass
     engine on the same steps: every StepResult field, dump_flows() and
     cache_stats() bitwise equal; (1, 2) to (1, 1): every field, and both
     rule shards' state copies equal to (1, 1)'s state (dump rows
     excluded); (2, 1)'s verdicts, DNAT and rule ids to (1, 1)'s, with its
     spilled and retried lanes reported.  The kernel calls of each cold
     step are recorded and held against their plain versions on those
     inputs (B3h and B1 on each rule shard, w0 > 0 on (1, 2)'s second),
     B2 on (1, 2)'s replica-resolved canary; then corrupt_replica(1) on
     (2, 1) must make canary_scan report replica 1 and degrade the engine.

 18. live resize and replica-loss failover on the mesh engine
     (parallel/reshard.py, parallel/failover.py) on the headline world with
     node-0's topology, reshard_budget=2**20 rows a tick, each step held
     to a (1, 1) reference engine (2**22 slots) on the same batch: every
     lane's service, DNAT on every lane of a service without session
     affinity, code and rule ids on every lane whose DNAT is equal (each
     replica keeps its own affinity table, as in the JAX engine, so a
     fresh flow of a sticky client may pick another endpoint: on such a
     lane each engine's endpoint must be one of the service's and its code
     and rule ids the scalar Oracle's at that endpoint, and at most 32 such
     lanes, MAX_STICKY_LANES, in the phase); (a) a staged fused (2, 1)
     engine (2**21 slots a replica) grows to 4 replicas and shrinks back
     to 2, each tick stepping the headline batch and a 4,096-lane churn
     batch of fresh flows before its maintenance tick (2 canary probes,
     RESIZE_PROBES); ms per migration tick and rows migrated per second,
     the cutover's ms, steady ms/step before, during and after, the
     established lanes served from the migrated cache after
     each flip, reshard_stats() (2 cutovers, 0 aborts), the reshard-*
     journal, peak device memory at 4 replicas; (b) a grow with
     corrupt_target(1): the cutover aborts (begin -> replica-canary-veto ->
     abort), the generation kept, the old topology serving the reference's
     verdicts; (c) a one-pass (2, 1) engine with failover=True: a FaultPlan
     kills replica 1, the probes quarantine and mask it, the evacuation
     shrinks to 1 replica, and once the site is quiet the readmission grows
     back to 2; ticks and seconds from the kill to each flip,
     failover_stats().  Each part reads the launches of the engine under
     test (every count set to 0 just before each of its calls and read just
     after) and holds the kernels it recorded against their plain versions:
     B1 from a mid-migration step and from the grow's and the vetoed
     grow's target canaries, B3h from a mid-evacuation step, B2 from a
     probe round and the evacuation's target canary (a part fails if one
     of these was not recorded).

 19. the agent that drives the engine (agent/controller.py, the
     dissemination wire, the surfaces), on the headline world: (a) every
     controlplane object of the PolicySet as an ADDED watch event spanning
     node-0, each through the wire format, into a RamStore watched by an
     AgentPolicyController that drives an engine on the card with phase
     13's one-pass knobs; the sync, phase 13's headline steps (every
     StepResult field, dump_flows() and cache_stats() bitwise equal to
     phase 13's engine), phase 13's 4 churned groups as UPDATED events
     with added / removed (each must reach apply_group_delta, never a
     bundle) and its delta step (bitwise equal to phase 13's); the event
     count and bytes, the publish and sync seconds, the ms from the delta
     events' stamps to their realization (the agent's dissemination_hist)
     and ms/step beside phase 13's; then the agent disconnects, the policy
     phase 13's last step attributed most lanes to is deleted from the
     store, and the re-list's window (the store's snapshot) retracts it;
     (b) a DisseminationServer over the same store and a NetAgent in this
     process with its own engine on the card, over mutual TLS (the TLS
     route, cryptography or openssl, is printed; with neither, (b) is
     reported as not run): the PKI, the handshake, the stream of the whole
     world (the server's re-list, WIRE_CHUNK events a pump round), the
     sync; its engine, fresh on the smaller set, and (a)'s after the
     retraction step 2**17 fresh headline lanes, held to each other (lanes
     of affinity services whose sticky endpoint differs counted, the
     first STICKY_SAMPLE held to the scalar Oracle at each endpoint);
     (d) the agent's API server over (a)'s engine, tapped by a
     TraceflowController: /metrics, /commitplane, /audit, /agentinfo, 8
     headline 5-tuples traced through /traceflow (held to trace() and to
     the scalar Oracle) and as live traceflows completed by a step, antctl
     get and traceflow --server, antctl check --device cuda, a support
     bundle; (c) SubprocessAgent(datapath_type="tpuflow") whose child
     agent_proc builds its engine on the card by default, on
     gen_cluster(10_000) and 4,096-lane batches, against an in-process
     agent's engine on the card fed the same store: cold, warm and a
     membership delta, every reply field bitwise equal, no error reply and
     nothing on the child's stderr.  After every sync each agent's
     sync_failures_total must be 0, last_sync_error and permanent_failure
     empty, and the generation the expected one.  The launch counts are
     read (never written) around each part, and the first call of B1, B2
     and B3 in (a) and of B2 and B3 in (b) is recorded and held to its
     plain version (a part fails if one was not recorded).
 20. the controller's fan-out and status plane (simulator/fleet.py,
     controller/status.py, controller/apiserver.py), at the reference
     controller's scale test, xLargeScale (25,000 namespaces,
     100,000 pods on 64 nodes, 75,000 NetworkPolicies, placed as
     bench_controller.py's populate places them): (a) the port's
     NetworkPolicyController feeding a RamStore, watched by 63 inproc fake
     agents (node-1 .. node-63) and by node-0's AgentPolicyController,
     whose engine is on the card with phase 13's one-pass knobs, all
     reporting to one StatusAggregator: every fake agent holds its node's
     span (fleet_converged), node-0's agent its span's policies and
     groups, all 75,000 policies Realized on their whole span; node-0's
     engine steps 2**17 seeded lanes toward its pods (cold, warm, 8
     steady), code, est and DNAT bitwise equal to a second engine built
     from the controller's span for node-0 (rule ids too while the two
     hold the policies in the same order), 32 lanes held to the scalar
     Oracle; (b) bench_controller.py's fleet_storm over mutual TLS on its
     --small world (2,500 namespaces) plus one app=web pod a node: one
     DisseminationServer (cap 64, resync chunk 256, 4 resyncs in flight,
     drain 256, send budget 100,000 bytes) with a StatusAggregator, 63
     NetFakeAgents (node-1's sockets reset by a FaultPlan) and node-0's
     NetAgent with its own engine on the card, pumped and synced every
     cycle; 3 rounds of run_churn_storm (churn 128, cap 64), each to
     convergence with the queue bounds held, then 20 live rewrites (the
     realization histograms' tail); node-0's engine on 4,096 lanes from
     the storm's CIDRs bitwise equal to an engine built from the span;
     antctl get policystatus against the port's ControllerApiServer lists
     every storm policy Realized on all 64 nodes.  The launch counts are
     read around each call of node-0's engines, the first call of each
     kernel recorded and held to its plain version; B3 must have launched
     in each part.
 21. the static-analysis plane and the card's sync census, after phases
     16-20 have joined: (a) antrea_tpu_torch.analysis.run() over this
     checkout, clean with an empty BASELINE.analysis_torch.json, its
     seconds and pass inventory printed; (b) phase 13's one-pass engine
     and the bare staged fused step (flow_slots=2**22, miss_chunk=256),
     each warmed with a cold and a warm step of the headline batch, then
     CENSUS_STEPS (4) steady steps from one cloned state twice: under
     torch.cuda.set_sync_debug_mode("warn") (utils/sync_census.py: each
     sync attributed to the innermost frame inside antrea_tpu_torch/) and
     without it.  Every StepResult field (the engine) or output (the bare
     step) and the final state bitwise equal; the syncs a step printed by
     site and line; every sync in models/ or ops/ at a function its
     module's HOST_SYNCS declares; B3 launched on the engine's steps and
     B1 on the staged step's (the counts read around each run, equal in
     both), the first call of each recorded and held to its plain version.

In phase 3 also B3h (B3's hits-only variant, resolve=False) against its
plain version on B3's inputs: on the whole tables (w0 = 0) and on each half
of a 2-way word split (shard 1 at w0 = W / 2); in phase 5 on the warm
cache with valid = 0, no_commit = 1 and fb_force = 1 lanes.

Phases 16, 18 and 20 run in child processes of the script
(chip_smoke.py --phase N OUT), started together after phase 15 beside
phases 17 and 19, which run in this process (so their lines interleave
and their times are taken with the others running); each child hands its
record, kernel records and launch counts back as JSON.

The line before the last is the kernels' JSON record; the last line is
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
# Node-0's local pods in the full walk's topology.
N_LOCAL = 32
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
    POOL-lane pool of fresh flows, one lane per flow, the pod IPs, the
    PolicySet and the service list)."""
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
    return cps, svc, tr, pool, cluster.pod_ips, cluster.ps, services


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """The least time the card could take: (seconds, what bounds it)."""
    tb, to = nbytes / HBM_BYTES_S, ops / LANE_OPS_S
    return max(tb, to), "bytes" if tb >= to else "operations"


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


def with_gathers(rec, name, gather, per_lane_bytes, inner):
    """Add to a B1/B2 record the time of the torch gathers that the old call
    sites ran on the same lanes (gather_ms: the device's own time for them,
    queued ahead like the kernel's ms; gather_call_ms: per call as the path
    paid it, the host's issue time included) and the per-lane bound (every
    lane's rows read from device memory: the old contract's bound) beside
    rec's rows-once bound; print both shares."""
    from antrea_tpu_torch.utils.timing import device_time

    gather_s = device_time(gather, iters=7, inner=inner,
                           host_lead_s=inner * 2e-3)
    gather_call_s = device_time(gather, iters=7, inner=inner)
    lane_s, _ = bound(per_lane_bytes, 0)
    rec.update(gather_ms=gather_s * 1e3, gather_call_ms=gather_call_s * 1e3,
               bound_per_lane_ms=lane_s * 1e3, bytes_per_lane=per_lane_bytes,
               share_rows_once=rec["bound_ms"] / rec["ms"],
               share_per_lane=lane_s * 1e3 / rec["ms"])
    log(f"  {name}: torch gathers of the old call site {gather_s * 1e6:.2f} "
        f"us ({gather_call_s * 1e6:.2f} us per call); bounds: rows once "
        f"{rec['bound_ms'] * 1e3:.2f} us ({rec['share_rows_once']:.3f} "
        f"reached), per lane {lane_s * 1e6:.2f} us "
        f"({per_lane_bytes / 1e6:.2f} MB, {rec['share_per_lane']:.3f} "
        f"reached)")
    return rec


def distinct(iv, cols) -> int:
    """Distinct values over the given columns of iv (one table's rows)."""
    import torch

    return int(torch.unique(iv[:, list(cols)]).numel())


def check_consumer(tabs, iv, svcref, in_phases, out_phases, what, inner,
                   w0=(0, 0)):
    """Phase 3 for B1 on the world's tables at the batch's interval rows
    -> record.  The rows-once bound counts each distinct (table, row) once,
    plus iv and the output; the per-lane bound every lane's 6 (7 with
    svcref) rows.  w0: a rule shard's first words (phase 17)."""
    from antrea_tpu_torch.ops import consumer

    b = iv.shape[0]
    w = [t.shape[1] for t in tabs]
    cols = [(0,), (1,), (2,), (3,), (4,), (5, 6) if svcref else (5,)]
    io = b * 8 * 4 * 2
    once = sum(distinct(iv, c) * wt * 4 for c, wt in zip(cols, w)) + io
    per_lane = b * 4 * (sum(w) + (w[5] if svcref else 0)) + io
    args = (tabs, iv, svcref, in_phases, out_phases, *w0)
    rec = check_kernel(
        f"B1 consumer ({what}, w_in={w[0]} w_out={w[3]}, w0={tuple(w0)})",
        lambda: consumer.fused_hits(*args),
        lambda: consumer.fused_hits_plain(*args), b, once,
        b * 2 * (w[0] + w[3]), inner)
    idx = [iv[:, k].long() for k in range(7)]

    def gather():
        rows = [t[i] for t, i in zip(tabs, idx)]
        if svcref:
            rows[5] = rows[5] | tabs[5][idx[6]]
        return rows

    rec["lanes"] = b
    return with_gathers(rec, "B1", gather, per_lane, inner)


def check_consumer2(tabs, iv, in_phases, out_phases, inner):
    """Phase 3 for S1 on the ANDed rows of the lanes iv -> record."""
    import torch

    from antrea_tpu_torch.ops import consumer, consumer2

    rows_in, rows_out = consumer.gather_rows(tabs, iv, False)
    args = (rows_in[0] & rows_in[1] & rows_in[2],
            rows_out[0] & rows_out[1] & rows_out[2], in_phases, out_phases)
    del rows_in, rows_out
    b, words = iv.shape[0], tabs[0].shape[1] + tabs[3].shape[1]
    rec = check_kernel(
        f"S1 consumer2 (w_in={tabs[0].shape[1]} w_out={tabs[3].shape[1]})",
        lambda: consumer2.and_hits(*args),
        lambda: consumer2.and_hits_plain(*args), b,
        b * words * 4 + b * 8 * 4, b * 2 * words, inner)
    del args
    torch.cuda.empty_cache()
    return rec


def check_pruned(g_in, g_out, iv, tabs, k, svcref, in_phases, out_phases,
                 inner, w0=(0, 0)):
    """Phase 3 for B2 at K = k on the world's tables with the lanes' own
    aggregate AND rows and interval rows -> record.  The bounds count this
    run's data: the two g rows, iv and the output of every lane, and per
    direction 128 B of each dimension row (a fourth with svcref) for each
    of the min(nc, ke) candidates it scans; rows once counts each distinct
    (table, row, superblock) once, per lane every lane's."""
    import torch

    from antrea_tpu_torch.ops import pruned_consumer as pc

    b = iv.shape[0]
    ke = [min(k, g.shape[1]) for g in (g_in, g_out)]
    io = (g_in.numel() + g_out.numel()) * 4 + b * 8 * 4 * 2
    once = lane = 0
    for d, g in ((0, g_in), (1, g_out)):
        cand, valid = pc.candidate_ids(g, ke[d])
        cols = [3 * d, 3 * d + 1, 3 * d + 2] + ([6] if d and svcref else [])
        lane += int(valid.sum()) * len(cols) * 128
        for col in cols:
            keys = iv[:, col].long()[:, None] * g.shape[1] + cand
            if d and col >= 5 and svcref:
                continue  # the svc table's rows: counted once below
            once += int(torch.unique(keys[valid]).numel()) * 128
        if d and svcref:
            keys = torch.cat([iv[:, c].long()[:, None] * g.shape[1] + cand
                              for c in (5, 6)], dim=1)
            once += int(torch.unique(
                keys[torch.cat([valid, valid], dim=1)]).numel()) * 128
    args = (g_in, g_out, iv, tabs, ke[0], ke[1], svcref, in_phases,
            out_phases, *w0)
    rec = check_kernel(
        f"B2 pruned consumer (K={k}, w0={tuple(w0)})",
        lambda: pc.pruned_hits(*args),
        lambda: pc.pruned_hits_plain(*args), b, once + io, lane // 2, inner)

    def gather():
        return [pc.candidate_mats(tabs[3 * d:3 * d + 3], g,
                                  [iv[:, 3 * d + j] for j in range(3)],
                                  iv[:, 6] if d and svcref else None, ke[d])
                for d, g in ((0, g_in), (1, g_out))]

    return with_gathers(rec, "B2", gather, lane + io, inner)


def onepass_inputs(step, state, drs, dsvc, lanes, now):
    """The one-pass step's B3 inputs for `lanes` against `state` (the
    step's own preparation) -> (x, tabs, st, the probe's hit mask)."""
    import torch

    from antrea_tpu_torch.models import pipeline as pl
    from antrea_tpu_torch.ops import hashing

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
    x, tabs, st, _ = pl._onepass_inputs(state.aff, drs, dsvc, src_f, dst_f,
                                        proto, sport, dport, pp, h, kr0, mr,
                                        ts0, now, meta)
    return x, tabs, st, hit


def lane_probes(x, tabs, st, hit):
    """The lanes' interval rows (column 7, B3's isolation bits, zeroed: the
    staged layout) and the two aggregate-AND matrices, from B3's plain
    probes on the card -> (iv (B, 8), g_in (B, S_in), g_out (B, S_out))."""
    from antrea_tpu_torch.ops import onepass as op

    iv, aggs, _, _ = op.probes_plain(x, tabs, st.svcref, ~hit)
    iv[:, 7] = 0
    g = [(aggs[3 * d] & aggs[3 * d + 1] & aggs[3 * d + 2]).contiguous()
         for d in (0, 1)]
    return iv, g[0], g[1]


def check_onepass(step, state, drs, dsvc, lanes, now, what):
    """Phase 3 / 5 for B3 on the step's own lane inputs and tables ->
    record, with both bounds of b3_work on this run's data.  Beside the
    kernel, the torch prologue that the old call site ran on the same
    lanes (_onepass_probes and the stacks of the old interval-row and
    probe inputs), timed queued ahead (prologue_ms) and per call."""
    import torch

    from antrea_tpu_torch.ops import onepass as op

    x, tabs, st, hit = onepass_inputs(step, state, drs, dsvc, lanes, now)
    b = x.pkt.shape[0]
    got = op.onepass(x, tabs, now, 0, st)
    miss = got[0][:, 11] == 0  # every lane is valid
    n_miss = int(miss.sum())
    once, per_lane, ops, blocks = b3_work(tabs, st, got[4][miss], b)
    del got
    rec = check_kernel(
        f"B3 one-pass ({what}, K={st.k}, {n_miss} miss lanes)",
        lambda: op.onepass(x, tabs, now, 0, st),
        lambda: op.onepass_plain(x, tabs, now, 0, st), b, once, ops, 3)
    rec.update(miss_lanes=n_miss, candidate_blocks=blocks)
    with_lane_bound(rec, "B3", per_lane)
    prologue_time(rec, x, hit, drs, dsvc, step.meta)
    del x
    torch.cuda.empty_cache()
    return rec


def b3_work(tabs, st, iv_miss, b, resolve=True):
    """The work of a B3 call on this run's data, for its bounds: iv_miss the
    miss lanes' interval rows (B3's iv output).  The lane words: the
    resolve variant needs every lane's 29 input words (pkt, kr, ts, mrow,
    msk, lb) and writes 44; the hits-only variant (resolve=False) needs
    every lane's pkt, kr, ts and msk (17 words), its meta row only under
    per-state timeouts (the CONFIRMED bit picks the timeout), the lb row
    of a miss lane only (the post-DNAT probe keys), and writes 20.  "Rows
    once" counts the lane words, each bounds array once, and each distinct
    aggregate row and candidate block (table, row, superblock) that the
    miss lanes read, once; "per lane" counts the lane words and, for every
    miss lane, its six (seven with svcref) aggregate rows, its min(nc, K)
    candidate blocks of 128 B per dimension (a fourth for the svcref row)
    and ceil(log2 n) words of each search.  -> (rows-once bytes, per-lane
    bytes, operations, distinct candidate blocks)."""
    import math

    import torch

    from antrea_tpu_torch.ops import pruned_consumer as pc

    iv = iv_miss.long()
    n_miss = iv.shape[0]
    s = [tabs.agg[0].shape[1], tabs.agg[3].shape[1]]
    dims = [(0, 0), (1, 1), (2, 2), (3, 3), (4, 4), (5, 5)]
    if st.svcref:
        dims.append((5, 6))  # (table, iv column): the svcref row
    if resolve:
        lane_io = b * (29 + 44) * 4
    else:
        uniform = len(set(st.timeouts)) == 1
        lane_io = (b * (17 + (0 if uniform else 4) + 20) + n_miss * 8) * 4
    once = lane_io + sum(t.shape[0] * 4 for t in (*tabs.bounds,
                                                  *tabs.iso_bounds))
    agg_words = n_miss * (3 * s[0] + (len(dims) - 3) * s[1])
    per_lane = lane_io + agg_words * 4
    blocks = cand_rows = 0
    for d in (0, 1):
        cols = [(t, c) for t, c in dims if t // 3 == d]
        r = [tabs.agg[t][iv[:, c]] for t, c in cols]
        g = r[0] & r[1] & (r[2] | r[3] if len(r) == 4 else r[2])
        cand, valid = pc.candidate_ids(g, min(st.k, s[d]))
        for t, c in cols:
            key = iv[:, c, None] * s[d] + cand
            blocks += int(torch.unique(key[valid]).numel())
        cand_rows += int(valid.sum()) * len(cols)
    per_lane += cand_rows * 128
    for t in range(6):
        cs = [c for tt, c in dims if tt == t]
        once += int(torch.unique(iv[:, cs]).numel()) * s[t // 3] * 4
    once += blocks * 128
    searches = [t.shape[0] for t in (*tabs.bounds, *tabs.iso_bounds)]
    if st.svcref:
        searches.append(tabs.bounds[5].shape[0])
    per_lane += n_miss * 4 * sum(math.ceil(math.log2(n)) for n in searches
                                 if n > 1)
    ops = 2 * agg_words + 2 * 32 * cand_rows
    return once, per_lane, ops, blocks


def with_lane_bound(rec, name, per_lane):
    """Add the per-lane bound of per_lane bytes to a record beside its
    rows-once bound, and print both shares."""
    lane_s, _ = bound(per_lane, 0)
    rec.update(bound_per_lane_ms=lane_s * 1e3, bytes_per_lane=per_lane,
               share_rows_once=rec["bound_ms"] / rec["ms"],
               share_per_lane=lane_s * 1e3 / rec["ms"])
    log(f"  {name}: bounds: rows once {rec['bound_ms'] * 1e3:.2f} us "
        f"({rec['share_rows_once']:.3f} reached), per lane "
        f"{lane_s * 1e6:.2f} us ({per_lane / 1e6:.2f} MB, "
        f"{rec['share_per_lane']:.3f} reached)")
    return rec


def prologue_time(rec, x, hit, drs, dsvc, meta):
    """The torch prologue of B3's old call site on the same lanes, timed
    queued ahead (prologue_ms) and per call, added to rec."""
    import torch

    from antrea_tpu_torch.models import pipeline as pl
    from antrea_tpu_torch.utils.timing import device_time

    src_f, proto = x.pkt[:, 0].contiguous(), x.pkt[:, 2].contiguous()
    svc_idx, dnat_ip, dnat_port = (x.lb[:, c].contiguous() for c in (0, 2, 3))
    z = torch.zeros_like(src_f)

    def prologue():
        iv6, iv_ref, aggs, iso_in, iso_out = pl._onepass_probes(
            drs, dsvc, src_f, proto, svc_idx, dnat_ip, dnat_port, ~hit, meta)
        return (torch.stack([x.ts, iso_in, iso_out, z], dim=1),
                torch.stack([*iv6, iv_ref, z], dim=1), aggs)

    pro_s = device_time(prologue, iters=7, inner=3, host_lead_s=3 * 2e-3)
    pro_call_s = device_time(prologue, iters=7, inner=3)
    rec.update(prologue_ms=pro_s * 1e3, prologue_call_ms=pro_call_s * 1e3)
    log(f"  B3: removed torch prologue {pro_s * 1e3:.4f} ms "
        f"({pro_call_s * 1e3:.4f} ms per call)")


def check_hits_only(x, tabs, st, now, w0, what, gen_w=0):
    """B3h (onepass(resolve=False)) against its plain version on the same
    inputs, bit for bit, timed with CUDA events -> record, with both bounds
    of b3_work's hits-only accounting."""
    import torch

    from antrea_tpu_torch.ops import onepass as op

    b = x.pkt.shape[0]
    # Which lanes miss: the resolve variant's hit column (held to its plain
    # version above) and the valid bit.
    hit = op.onepass(x, tabs, now, gen_w, st, *w0)[0][:, 11] != 0
    miss = ~hit & (x.msk[:, 0] != 0)
    iv = op.onepass(x, tabs, now, gen_w, st, *w0, resolve=False)[2]
    n_miss = int(miss.sum())
    once, per_lane, ops, blocks = b3_work(tabs, st, iv[miss], b,
                                        resolve=False)
    del iv
    rec = check_kernel(
        f"B3h hits-only ({what}, K={st.k}, w0={w0}, {n_miss} miss lanes)",
        lambda: op.onepass(x, tabs, now, gen_w, st, *w0, resolve=False),
        lambda: op.onepass_plain(x, tabs, now, gen_w, st, *w0,
                                 resolve=False),
        b, once, ops, 3)
    rec.update(miss_lanes=n_miss, candidate_blocks=blocks, w0=list(w0))
    with_lane_bound(rec, "B3h", per_lane)
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
        # The dual-stack walk's wide views are (b, 4).
        want = (b, 4) if k in ("dnat_w_f", "peer_w") else (b,)
        if v.dim() and v.shape != want:
            raise SystemExit(f"out[{k}] has shape {tuple(v.shape)}, not "
                             f"{want}")
        if v.dtype != torch.int32:
            raise SystemExit(f"out[{k}] is {v.dtype}, not int32")
    code = out["code"]
    if not bool(((code >= 0) & (code <= 2)).all()):
        raise SystemExit("verdict codes outside {allow, drop, reject}")


def reset_counts():
    from antrea_tpu_torch.ops import (consumer, consumer2, onepass,
                                      pruned_consumer)

    consumer.launches = pruned_consumer.launches = onepass.launches = 0
    consumer2.launches = onepass.launches_hits = 0


def counts() -> tuple[int, int, int]:
    """(B1, B2, B3) launches since reset_counts()."""
    from antrea_tpu_torch.ops import consumer, onepass, pruned_consumer

    return consumer.launches, pruned_consumer.launches, onepass.launches


def counts5() -> tuple[int, int, int, int, int]:
    """(B1, B2, B3, B3h, S1) launches since reset_counts()."""
    from antrea_tpu_torch.ops import consumer2, onepass

    return counts() + (onepass.launches_hits, consumer2.launches)


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


def drive_pruned_classify(meta, drs, lanes, dev, v6=None, what=""):
    """Phase 6a (15c with v6 lanes): classify_batch(prune_budget=4,
    fused=True) on B_COLD lanes, timed on the host clock around
    synchronized calls.  -> (record, launches)."""
    import torch

    from antrea_tpu_torch.ops.match import classify_batch

    src, dst, proto, _, dport = (t[:B_COLD] for t in lanes)

    def run():
        return classify_batch(drs, src, dst, proto, dport, meta=meta,
                              fused=True, v6=v6)

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
    log(f"{what}pruned classify B={B_COLD}: median {med * 1e3:.3f} ms "
        f"(min {min(times) * 1e3:.3f}, max {max(times) * 1e3:.3f}), "
        f"{B_COLD / med / 1e6:.2f} M packets/s; skip rate {skip:.4f}, "
        f"fallback rate {fb:.4f}; (B1, B2, B3) launches over 5 calls "
        f"{launches}")
    return dict(ms=med * 1e3, pps=B_COLD / med, skip_rate=skip,
                fallback_rate=fb), launches


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


def node0_spec(pod_ips):
    """Node-0's forwarding world in the headline cluster (pods at
    10.0.<node>.x, 32 a node): its 32 pods at ofports from 3, the other 63
    nodes remote at their pod CIDRs.  -> Topology."""
    from antrea_tpu_torch.compiler.topology import NodeRoute, Topology
    from antrea_tpu_torch.utils import ip as iputil

    return Topology(
        node_name="node-0", gateway_ip="10.0.0.1", pod_cidr="10.0.0.0/24",
        local_pods=[(iputil.u32_to_ip(int(u)), 3 + i)
                    for i, u in enumerate(pod_ips[:N_LOCAL])],
        remote_nodes=[NodeRoute(name=f"node-{k}", node_ip=f"192.168.0.{k}",
                                pod_cidr=f"10.0.{k}.0/24")
                      for k in range(1, 64)])


def node0_topology(pod_ips):
    """node0_spec compiled -> ForwardingTables."""
    from antrea_tpu_torch.compiler.topology import compile_topology

    return compile_topology(node0_spec(pod_ips))


def honest_ports(src_ip, pod_ips):
    """Each source's ingress port as node-0 sees it: a node-0 pod's own
    ofport, every other source (another node's pod) the tunnel."""
    import numpy as np

    from antrea_tpu_torch.compiler.topology import OFPORT_TUNNEL

    port_of = np.zeros(1 << 16, np.int32)  # by the low 16 address bits
    local = np.asarray(pod_ips[:N_LOCAL], np.uint32)
    port_of[local & 0xFFFF] = 3 + np.arange(N_LOCAL)
    src = np.asarray(src_ip, np.uint32)
    return np.where(np.isin(src, local), port_of[src & 0xFFFF],
                    OFPORT_TUNNEL).astype(np.int32)


def full_lanes(tr, pod_ips, dev):
    """The batch's columns for the full walk -> {"headline": ...,
    "coverage": ...}, each 8 int32 columns on dev (the five tuple columns,
    in_port, flags, arp_op).  headline: the bench's own tuples as node-0
    sees them, in_port honest (a node-0 pod's own ofport; every other
    source is another node's pod and comes in on the tunnel), flags and
    arp_op zero; it is what the timed steps run.  coverage: the same
    tuples with 1/16 of the lanes spoofed (another local pod's port), FIN
    or RST on 1/128 and an ARP request on 1/512, from a seed.  These rates
    come from no workload: they only put SpoofGuard, the teardown and the
    ARP lanes through the bitwise checks, and their steps are not reported
    as performance."""
    import numpy as np
    import torch

    rng = np.random.default_rng(21)
    b = tr.src_ip.shape[0]
    in_port = honest_ports(tr.src_ip, pod_ips)
    spoof = rng.random(b) < 1 / 16
    cover_port = np.where(spoof, 3 + (in_port + 1) % N_LOCAL, in_port)
    flags = np.where(rng.random(b) < 1 / 128,
                     rng.choice(np.array([1, 4], np.int32), b), 0)
    arp_op = np.where(rng.random(b) < 1 / 512, 1, 0)
    zero = np.zeros(b, np.int32)
    tup = to_lanes(tr, dev)

    def on(*cols):
        return tup + tuple(torch.from_numpy(np.ascontiguousarray(
            c, dtype=np.int32)).to(dev) for c in cols)

    return {"headline": on(in_port, zero, zero),
            "coverage": on(cover_port, flags, arp_op)}


def full_step(meta, state, drs, dsvc, dft, cols, now, v6=None):
    from antrea_tpu_torch.models import forwarding as fw

    return fw.pipeline_step_full(state, drs, dsvc, dft, *cols[:6], now, 0,
                                 cols[6], cols[7], meta=meta, v6=v6)


NOWS = (100, 101) + tuple(102 + i for i in range(STEADY_STEPS))
# The full walk's steps, (columns, now): cold, warm and STEADY_STEPS steady
# steps on the headline columns (timed), then two coverage steps (checked
# bitwise, not reported as performance).
FULL_STEPS = (tuple(("headline", now) for now in NOWS)
              + (("coverage", NOWS[-1] + 1), ("coverage", NOWS[-1] + 2)))
N_TIMED = len(NOWS)


def step_stats(times) -> dict:
    """Cold, warm and steady median of the timed (headline) steps."""
    steady = sorted(times[2:N_TIMED])
    med = steady[len(steady) // 2]
    return dict(cold_ms=times[0] * 1e3, warm_ms=times[1] * 1e3,
                steady_ms=med * 1e3, steady_min_ms=steady[0] * 1e3,
                steady_max_ms=steady[-1] * 1e3, steady_pps=B / med)


def drive_full(meta, drs, dsvc, dft, cols, dev, what, v6=None):
    """Phase 10 (15b with the v6 lanes v6): pipeline_step_full on the card
    on a fresh state over FULL_STEPS, with every launch count set to 0 just
    before and read just after.  -> (record, each step's outputs (CPU), the
    final state (CPU), launches)."""
    import torch

    from antrea_tpu_torch.models import pipeline as pl

    state = pl.init_state(FLOW_SLOTS, meta.aff_slots, device=dev,
                          key_words=meta.key_words)
    reset_counts()
    outs, times = [], []
    for key, now in FULL_STEPS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, out = full_step(meta, state, drs, dsvc, dft, cols[key], now,
                               v6)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        check_out(out, B)
        outs.append({k: v.cpu() for k, v in out.items()})
    launches = counts()
    want = (0, 0, 1) if meta.onepass else (1, 0, 0)
    if any(w and not n for w, n in zip(want, launches)) or launches[1]:
        raise SystemExit(f"full walk {what}: (B1, B2, B3) launches "
                         f"{launches}")
    rec = step_stats(times)
    cold, cover = outs[0], outs[N_TIMED:]
    kinds = torch.bincount(cold["fwd_kind"], minlength=10).tolist()
    log(f"full walk {what}, headline traffic: cold {rec['cold_ms']:.1f} ms "
        f"(n_miss {int(cold['n_miss'])}, spoofed "
        f"{int(cold['spoofed'].sum())}, committed "
        f"{int(cold['committed'].sum())}, fwd_kind counts {kinds}), warm "
        f"{rec['warm_ms']:.2f} ms, steady median {rec['steady_ms']:.3f} "
        f"ms/step (min {rec['steady_min_ms']:.3f}, max "
        f"{rec['steady_max_ms']:.3f}), {rec['steady_pps'] / 1e6:.2f} M "
        f"packets/s; n_miss per step "
        f"{[int(o['n_miss']) for o in outs[:N_TIMED]]}")
    log(f"full walk {what}, coverage steps (not performance): n_miss "
        f"{[int(o['n_miss']) for o in cover]}, spoofed "
        f"{[int(o['spoofed'].sum()) for o in cover]}, fwd_kind counts "
        f"{[torch.bincount(o['fwd_kind'], minlength=10).tolist() for o in cover]}"
        f"; (B1, B2, B3) launches over all {len(FULL_STEPS)} steps "
        f"{launches}")
    if not all(int(o["spoofed"].sum()) for o in cover):
        raise SystemExit(f"full walk {what}: no spoofed lane in a coverage "
                         f"step")
    st_cpu = pl.PipelineState(*(type(p)(*(t.cpu() for t in p))
                                for p in state))
    del state
    torch.cuda.empty_cache()
    return rec, outs, st_cpu, launches


def cross_check_full(meta, drs, dsvc, dft, cols, dev, what, v6=None):
    """Phase 10b (15b with the v6 lanes v6): CROSS_LANES lanes of the full
    walk on a fresh state on the card and on the CPU (plain versions), same
    tables: cold on the headline columns, then warm on the coverage
    columns; outputs and state bitwise equal."""
    import torch

    from antrea_tpu_torch.models import pipeline as pl
    from antrea_tpu_torch.ops.match import tree_map

    cpu = [tree_map(lambda t: t.cpu(), x) for x in (drs, dsvc, dft)]
    st_g = pl.init_state(FLOW_SLOTS, meta.aff_slots, device=dev,
                         key_words=meta.key_words)
    st_c = pl.init_state(FLOW_SLOTS, meta.aff_slots, device="cpu",
                         key_words=meta.key_words)
    sub6 = None if v6 is None else tuple(c[:CROSS_LANES] for c in v6)
    for key, now in (("headline", 100), ("coverage", 101)):
        sub = tuple(c[:CROSS_LANES] for c in cols[key])
        st_g, og = full_step(meta, st_g, drs, dsvc, dft, sub, now, sub6)
        st_c, oc = full_step(meta, st_c, *cpu, tuple(c.cpu() for c in sub),
                             now, None if sub6 is None
                             else tuple(c.cpu() for c in sub6))
        for k in oc:
            if not torch.equal(og[k].cpu(), oc[k]):
                raise SystemExit(f"full-walk cross-check {what} now={now}: "
                                 f"out[{k}] differs")
        for part in ("flow", "aff"):
            for f, tg, tc in zip(getattr(st_c, part)._fields,
                                 getattr(st_g, part), getattr(st_c, part)):
                if not torch.equal(tg[:-1].cpu(), tc[:-1]):
                    raise SystemExit(f"full-walk cross-check {what} "
                                     f"now={now}: {part}.{f} differs")
        log(f"full-walk cross-check {what} {key} now={now}: {CROSS_LANES} "
            f"lanes, "
            f"n_miss {int(oc['n_miss'])}, spoofed {int(oc['spoofed'].sum())}"
            f", outputs and state bitwise equal (card vs CPU)")
    del st_g, st_c, cpu
    torch.cuda.empty_cache()


def same_as(outs, state, ref_outs, ref_state, what):
    """Every output of every step and the final flow and affinity tables
    (dump row excluded) bitwise equal to the single-card walk's; the mesh's
    per-data-shard counters have a leading axis of 1."""
    import torch

    for t, (o, r) in enumerate(zip(outs, ref_outs)):
        if set(o) != set(r):
            raise SystemExit(f"{what} step {t}: output keys differ")
        for k, v in r.items():
            if not torch.equal(o[k].cpu().reshape(v.shape), v):
                raise SystemExit(f"{what} step {t}: out[{k}] differs from "
                                 f"the single-card walk")
    for p, rp in zip(state, ref_state):
        for f, a, b in zip(type(rp)._fields, p, rp):
            if not torch.equal(a[:-1].cpu(), b[:-1]):
                raise SystemExit(f"{what}: {f} differs from the single-card "
                                 f"walk")


def drive_mesh11(cps, svc, ft, cols, dev, ref, what, **kw):
    """Phase 11: make_sharded_pipeline_full on a (1, 1) mesh, NCCL, world
    size 1, in this process, over the same world, batch and steps as phase
    10 (kw: the builder's knobs, onepass=True for B3h); every output and
    the final flow and affinity tables bitwise equal to phase 10's.
    -> (record, launches)."""
    import tempfile

    import torch
    import torch.distributed as dist

    from antrea_tpu_torch.ops import onepass
    from antrea_tpu_torch.parallel import mesh as pm

    ref_rec, ref_outs, ref_state = ref
    with tempfile.TemporaryDirectory() as tmp:
        # NCCL: a one-process world on the card.
        dist.init_process_group(pm.default_backend(dev, 1),
                                init_method=f"file://{tmp}/store",
                                world_size=1, rank=0)
        try:
            mesh = pm.make_mesh(1, 1, dev)
            step, state, tabs = pm.make_sharded_pipeline_full(
                cps, svc, ft, mesh, flow_slots=FLOW_SLOTS,
                miss_chunk=MISS_CHUNK, fused=True, **kw)
            reset_counts()
            outs, times = [], []
            for key, now in FULL_STEPS:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, out = step(state, *tabs, *cols[key], now, 0)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                outs.append({k: v.cpu() for k, v in out.items()})
            launches = counts() + (onepass.launches_hits,)
        finally:
            dist.destroy_process_group()
    same_as(outs, state, ref_outs, ref_state, f"(1, 1) mesh {what}")
    want_h = 1 if step.meta.onepass else 0
    if (launches[2] != 0 or (launches[3] == 0) == bool(want_h)
            or (not want_h and launches[0] == 0)):
        raise SystemExit(f"(1, 1) mesh {what}: (B1, B2, B3, B3h) launches "
                         f"{launches}")
    rec = step_stats(times)
    log(f"(1, 1) mesh {what} (NCCL), headline traffic: cold "
        f"{rec['cold_ms']:.1f} ms, warm {rec['warm_ms']:.2f} ms, steady "
        f"median {rec['steady_ms']:.3f} ms/step (min "
        f"{rec['steady_min_ms']:.3f}, max {rec['steady_max_ms']:.3f}) "
        f"against the single-card walk's {ref_rec['steady_ms']:.3f} (cold "
        f"{ref_rec['cold_ms']:.1f}); every output of all "
        f"{len(FULL_STEPS)} steps (coverage steps included) and the flow "
        f"and affinity tables bitwise equal to it; (B1, B2, B3, B3h) "
        f"launches {launches}")
    del state, tabs
    torch.cuda.empty_cache()
    return dict(rec, single_card_steady_ms=ref_rec["steady_ms"]), launches


def _digest(t) -> str:
    import hashlib

    return hashlib.sha256(t.cpu().contiguous().numpy().tobytes()).hexdigest()


# The prune observables that count per rule shard: a lane's candidate
# superblocks are the most on any one shard, and it falls back when any
# shard has more than K (match.py:1800-1815), so under a rule split they
# differ from one card's by design; every other output is the same.
RULE_LOCAL = ("n_prune_fb", "prune_cand_hist")


def digests(outs, state):
    """sha256 of every output of every step (RULE_LOCAL's kept as values)
    and of every flow and affinity column (dump row excluded): how the
    (1, 2) ranks' results are held to this process's bitwise."""
    return ([{k: v.cpu().reshape(-1).tolist() if k in RULE_LOCAL
              else _digest(v) for k, v in o.items()} for o in outs],
            [_digest(t[:-1]) for p in state for t in p])


def table_bytes(drs) -> tuple[int, int]:
    """(incidence bytes, aggregate bytes) of a rule set's tables."""
    dims = [getattr(getattr(drs, d), k) for d in ("ingress", "egress")
            for k in ("at", "peer", "svc")]
    return (sum(t.inc.numel() * 4 for t in dims),
            sum(t.agg.numel() * 4 for t in dims if t.agg is not None))


def mesh_rank(mesh, cps, svc, ft, cols, kw):
    """A (1, 2) rank: its shard of the full walk over phase 10's steps ->
    dict(digests, step seconds, (B1, B3h) launches, the shard's incidence
    and aggregate bytes on the card)."""
    import torch

    from antrea_tpu_torch.ops import consumer, onepass
    from antrea_tpu_torch.parallel import mesh as pm

    step, state, tabs = pm.make_sharded_pipeline_full(
        cps, svc, ft, mesh, flow_slots=FLOW_SLOTS, miss_chunk=MISS_CHUNK,
        fused=True, **kw)
    drs = tabs[0]
    inc_b, agg_b = table_bytes(drs)
    cols = {k: [torch.from_numpy(c).to(mesh.device) for c in v]
            for k, v in cols.items()}
    consumer.launches = onepass.launches_hits = 0
    outs, times = [], []
    for key, now in FULL_STEPS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, out = step(state, *tabs, *cols[key], now, 0)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        outs.append(out)
    return dict(digests=digests(outs, state), times=times,
                launches=(consumer.launches, onepass.launches_hits),
                inc_bytes=inc_b, agg_bytes=agg_b,
                w0=[int(drs.ingress.word_idx[0]), int(drs.egress.word_idx[0])])


def drive_mesh12(cps, svc, ft, cols, dev, ref, one_card, **kw):
    """Phase 12: the (1, 2) mesh, two gloo processes sharing the card, over
    the same world, batch and steps; every output of every step and the
    final state of both ranks bitwise equal (sha256) to phase 10's one-pass
    walk.  one_card: the single card's table_bytes.  -> record."""
    from antrea_tpu_torch.parallel import mesh as pm

    ref_rec, ref_outs, ref_state = ref
    want = digests(ref_outs, ref_state)
    t0 = time.perf_counter()
    ranks = pm.spawn(mesh_rank, 1, 2, device=dev, args=(
        cps, svc, ft, {k: [c.cpu().numpy() for c in v]
                       for k, v in cols.items()}, kw))
    wall = time.perf_counter() - t0
    for r, res in enumerate(ranks):
        got_outs, got_state = res["digests"]
        for t, (g, w) in enumerate(zip(got_outs, want[0])):
            bad = [k for k in w if k not in RULE_LOCAL and g.get(k) != w[k]]
            if bad or set(g) != set(w):
                raise SystemExit(f"(1, 2) mesh rank {r} step {t}: {bad} "
                                 f"differ from the single-card walk")
        if got_state != want[1]:
            raise SystemExit(f"(1, 2) mesh rank {r}: the flow or affinity "
                             f"tables differ from the single-card walk")
        if res["digests"][0] != ranks[0]["digests"][0]:
            raise SystemExit("(1, 2) mesh: the two rule shards' outputs "
                             "differ")
        if res["launches"][1] == 0:
            raise SystemExit(f"(1, 2) mesh rank {r}: B3h never launched")
    stats = [step_stats(res["times"]) for res in ranks]
    for r, res in enumerate(ranks):
        log(f"(1, 2) mesh rank {r} (gloo, w0 {res['w0']}): incidence "
            f"{res['inc_bytes'] / 2**20:.1f} MiB, aggregate "
            f"{res['agg_bytes'] / 2**20:.2f} MiB on the card; headline "
            f"traffic: cold {stats[r]['cold_ms']:.1f} ms, warm "
            f"{stats[r]['warm_ms']:.2f} ms, steady median "
            f"{stats[r]['steady_ms']:.3f} ms/step (min "
            f"{stats[r]['steady_min_ms']:.3f}, max "
            f"{stats[r]['steady_max_ms']:.3f}); (B1, B3h) launches "
            f"{res['launches']}")
    log(f"one card's tables: incidence {one_card[0] / 2**20:.1f} MiB, "
        f"aggregate {one_card[1] / 2**20:.2f} MiB")
    log(f"(1, 2) mesh: {len(FULL_STEPS)} steps (coverage steps included), "
        f"every output but {RULE_LOCAL} "
        f"and both ranks' state bitwise equal to the single-card walk, the "
        f"two ranks' outputs equal; cold step's (n_prune_fb, "
        f"prune_cand_hist): mesh {[ranks[0]['digests'][0][0][k] for k in RULE_LOCAL]}"
        f", one card {[want[0][0][k] for k in RULE_LOCAL]}; {wall:.1f} s "
        f"for the group, the host build of each rank's tables included")
    return dict(steady_ms=max(st["steady_ms"] for st in stats),
                cold_ms=max(st["cold_ms"] for st in stats),
                warm_ms=max(st["warm_ms"] for st in stats),
                launches_b3h=[r["launches"][1] for r in ranks],
                launches_b1=[r["launches"][0] for r in ranks],
                inc_bytes=[r["inc_bytes"] for r in ranks],
                agg_bytes=[r["agg_bytes"] for r in ranks],
                one_card_inc_bytes=one_card[0],
                one_card_agg_bytes=one_card[1],
                single_card_steady_ms=ref_rec["steady_ms"], group_s=wall)


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


# ---- phase 13: the engine (datapath/tpuflow.TpuflowDatapath) --------------
# Address groups churned (a fresh pod in, a member out, each), the canary's
# probes per commit (the scalar Oracle walks each probe at 100k rules), and
# the delta step's extra cross-check lanes.
CHURN_GROUPS = 4
ENGINE_PROBES = 8


def world_copy(ps):
    """A PolicySet an engine may own: a delta rewrites the member lists of
    the groups it touches, so each engine gets its own group objects (the
    policies are shared; nothing writes them)."""
    import copy
    import dataclasses

    return dataclasses.replace(
        ps, address_groups={k: copy.copy(g)
                            for k, g in ps.address_groups.items()},
        applied_to_groups={k: copy.copy(g)
                           for k, g in ps.applied_to_groups.items()})


def engine_batch(src, dst, proto, sport, dport, pod_ips):
    from antrea_tpu_torch.packet import PacketBatch

    return PacketBatch(src_ip=src, dst_ip=dst, proto=proto, src_port=sport,
                       dst_port=dport, in_port=honest_ports(src, pod_ips))


def churn_plan(eng, ps):
    """Pod churn for CHURN_GROUPS address groups: per group a fresh pod IP
    inside node k's pod CIDR (10.0.k.200 + k) joins and one member leaves,
    a member whose address no other group of the same rule dimensions
    overlaps (so each delta takes slots instead of folding into a
    recompile).  -> [(group, added, removed)]."""
    from antrea_tpu_torch.datapath.tpuflow import _overlaps
    from antrea_tpu_torch.utils import ip as iputil

    plan = []
    for name in sorted(ps.address_groups):
        g = ps.address_groups[name]
        gids = eng._name_gids.get(name)
        if not g.members or g.ip_blocks or not gids:
            continue
        ips = [m.ip for m in g.members]
        for ip in ips:
            r = iputil.cidr_to_range(ip)
            others = [iputil.merge_ranges(list(eng._gid_ident[gid][2]))
                      for gid in gids]
            others += [eng._ranges_of(n) for gid in gids
                       for n in eng._gid_ident[gid][1] if n != name]
            if ips.count(ip) == 1 and not any(_overlaps(o, r)
                                              for o in others):
                k = len(plan) + 1
                plan.append((name, [f"10.0.{k}.{200 + k}"], [ip]))
                break
        if len(plan) == CHURN_GROUPS:
            return plan
    raise SystemExit(f"engine: found {len(plan)} churnable groups, not "
                     f"{CHURN_GROUPS}")


def delta_batch(plan, pod_ips, n, seed):
    """n fresh flows, each with one of the churned addresses on one side
    (source and destination in turn) and a seeded pod on the other; TCP
    with source ports below 1024, which the headline traffic never uses,
    so no lane is in the cache."""
    import numpy as np

    from antrea_tpu_torch.utils import ip as iputil

    addrs = np.array([iputil.ip_to_u32(ip) for _, a, r in plan
                      for ip in a + r], np.uint32)
    rng = np.random.default_rng(seed)
    i = np.arange(n)
    a = addrs[i % len(addrs)]
    other = np.asarray(pod_ips, np.uint32)[rng.integers(0, len(pod_ips), n)]
    swap = (i // len(addrs)) % 2 == 1
    src, dst = np.where(swap, other, a), np.where(swap, a, other)
    return (src, dst, np.full(n, 6, np.int32),
            (1 + i % 1023).astype(np.int32),
            rng.choice(np.array([80, 443, 5432, 8080], np.int32), n))


RESULT_FIELDS = ("code", "est", "reply", "reject_kind", "snat", "dsr",
                 "svc_idx", "dnat_ip", "dnat_port", "committed", "spoofed",
                 "fwd_kind", "out_port", "peer_ip", "tc_act", "tc_port")


def same_result(a, b, what, fields=RESULT_FIELDS):
    import numpy as np

    for f in fields:
        if not np.array_equal(getattr(a, f), getattr(b, f)):
            raise SystemExit(f"engine {what}: {f} differs")
    if a.ingress_rule != b.ingress_rule or a.egress_rule != b.egress_rule:
        raise SystemExit(f"engine {what}: rule attribution differs")


def overlay_rows(eng, src, dst):
    """The DeltaOverlay of lanes (src, dst) under eng's pending deltas (the
    delta lanes need no DNAT) -> (lanes, rows per address dimension,
    bytes)."""
    import torch

    from antrea_tpu_torch.ops import match as tm

    drs = eng._drs
    s = eng._flipped(src)
    d = eng._flipped(dst)
    iv = tm.interval_rows(drs, s, d, torch.zeros_like(s))
    ov = tm.delta_overlay(drs, iv, s, d, eng._n_deltas)
    rows = [ov.tabs[c].shape[0] for c in (0, 1, 3, 4)]
    nbytes = sum(ov.tabs[c].numel() * 4 for c in (0, 1, 3, 4))
    return ov.lanes.numel(), rows, nbytes


def drive_engine(ps, services, pod_ips, tr, dev, what, ref=None, keep=None,
                 **knobs):
    """Phase 13 for one mode: the port's TpuflowDatapath on the card over
    the headline world with node-0's topology (built from the PolicySet:
    compile, tables, the commit plane), stepped on the headline traffic
    (cold, warm, STEADY_STEPS steady), then CHURN_GROUPS canary-certified
    group deltas that stay in the slots, then one step of B fresh flows
    each touching a churned address, with every launch count set to 0 just
    before the first step and read just after the delta step.  Checks: the
    delta step's verdicts and rule ids bitwise equal to a second engine
    built from the post-delta PolicySet (`ref`, built here when None), and
    CROSS_LANES more such flows bitwise equal to the port's engine on the
    CPU after the same deltas.  With keep (a dict) the headline steps'
    results, and dump_flows() and cache_stats() after them, are kept there
    (phase 17's reference), and the churn plan, the slots it took and the
    delta step's result (phase 19's).  -> (record, launches, ref)."""
    import gc

    import numpy as np
    import torch

    from antrea_tpu_torch.datapath import TpuflowDatapath

    kw = dict(flow_slots=FLOW_SLOTS, miss_chunk=MISS_CHUNK,
              canary_probes=ENGINE_PROBES, topology=node0_spec(pod_ips),
              **knobs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = TpuflowDatapath(world_copy(ps), services, device=dev, **kw)
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    hb = engine_batch(tr.src_ip, tr.dst_ip, tr.proto, tr.src_port,
                      tr.dst_port, pod_ips)
    reset_counts()
    times, misses = [], []
    for now in NOWS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = eng.step(hb, now)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        misses.append(r.n_miss)
        if r.code.shape != (B,) or not np.isin(r.code, (0, 1, 2)).all():
            raise SystemExit(f"engine {what}: bad verdict column")
        if keep is not None:
            keep.setdefault("results", []).append(r)
    rec = step_stats(times)
    if keep is not None:
        keep.update(dump=eng.dump_flows(NOWS[-1]), cache=eng.cache_stats(),
                    rec=rec)
    plan = churn_plan(eng, ps)
    inc0 = eng._drs.ingress.at.inc
    lat = []
    for name, added, removed in plan:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.apply_group_delta(name, added, removed)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
    n_deltas = eng._n_deltas
    if n_deltas < 1 or eng._drs.ingress.at.inc is not inc0:
        raise SystemExit(f"engine {what}: the deltas folded into a "
                         f"recompile ({n_deltas} slots)")
    st = eng.commit_stats()
    if st["canary_probes_total"] < len(plan) or st["degraded"]:
        raise SystemExit(f"engine {what}: canary did not certify: {st}")
    cols = delta_batch(plan, pod_ips, B + CROSS_LANES, 31)
    main = engine_batch(*(c[:B] for c in cols), pod_ips)
    cross = engine_batch(*(c[B:] for c in cols), pod_ips)
    fb0 = (eng.prune_stats() or {}).get("fallbacks_total", 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = eng.step(main, NOWS[-1] + 1)
    torch.cuda.synchronize()
    delta_s = time.perf_counter() - t0
    launches = counts()
    if keep is not None:
        keep.update(plan=plan, delta=r, n_deltas=n_deltas)
    if r.n_miss != B:
        raise SystemExit(f"engine {what}: delta step missed {r.n_miss} of "
                         f"{B} fresh lanes")
    if knobs.get("prune_budget"):
        fb = eng.prune_stats()["fallbacks_total"] - fb0
        if fb != B:
            raise SystemExit(f"engine {what}: {fb} of {B} delta lanes took "
                             f"the forced fallback")
    ov_lanes, ov_rows, ov_bytes = overlay_rows(eng, main.src_ip,
                                               main.dst_ip)
    rec.update(compile_s=compile_s, delta_ms=[x * 1e3 for x in lat],
               delta_step_ms=delta_s * 1e3, n_deltas=n_deltas,
               overlay_lanes=ov_lanes, overlay_rows=ov_rows,
               overlay_bytes=ov_bytes, launches=list(launches),
               canary_probes=st["canary_probes_total"])
    log(f"engine {what}: built from the PolicySet in {compile_s:.1f} s; "
        f"headline traffic: cold {rec['cold_ms']:.1f} ms, warm "
        f"{rec['warm_ms']:.2f} ms, steady median {rec['steady_ms']:.3f} "
        f"ms/step (min {rec['steady_min_ms']:.3f}, max "
        f"{rec['steady_max_ms']:.3f}), {rec['steady_pps'] / 1e6:.2f} M "
        f"packets/s; n_miss per step {misses}")
    log(f"engine {what}: {len(plan)} group deltas in {n_deltas} slots, "
        f"apply_group_delta {', '.join(f'{x * 1e3:.1f}' for x in lat)} ms "
        f"(canary of {ENGINE_PROBES} probes each, {st['canary_probes_total']}"
        f" probes); delta step of {B} fresh lanes {delta_s * 1e3:.1f} ms "
        f"({B / delta_s / 1e6:.2f} M packets/s), overlay {ov_lanes} lanes, "
        f"{ov_rows} rows per address dimension, {ov_bytes / 1e6:.2f} MB; "
        f"(B1, B2, B3) launches over the phase {launches}")
    rc_card = eng.step(cross, NOWS[-1] + 2)
    post_ps = world_copy(eng._ps)
    outs = r
    del eng, r
    gc.collect()
    torch.cuda.empty_cache()

    # The port's engine on the CPU after the same deltas, on the
    # CROSS_LANES more fresh flows (cold there, uncached on the card).
    ec = TpuflowDatapath(world_copy(ps), services, device="cpu",
                         **{**kw, "flow_slots": CROSS_SLOTS,
                            "canary_probes": 0})
    for name, added, removed in plan:
        ec.apply_group_delta(name, added, removed)
    if ec._n_deltas != n_deltas:
        raise SystemExit(f"engine {what}: CPU twin took {ec._n_deltas} "
                         f"slots, the card {n_deltas}")
    same_result(rc_card, ec.step(cross, NOWS[-1] + 2),
                f"{what} card vs CPU")
    del ec
    gc.collect()
    log(f"engine {what}: {CROSS_LANES} fresh delta lanes bitwise equal "
        f"(card vs CPU engine)")

    # The full recompile: an engine built from the post-delta PolicySet.
    if ref is None:
        eref = TpuflowDatapath(post_ps, services, device=dev,
                               **{**kw, "canary_probes": 0})
        ref = eref.step(main, NOWS[-1] + 1)
        del eref
        gc.collect()
        torch.cuda.empty_cache()
    same_result(outs, ref, f"{what} deltas vs full recompile",
                fields=("code",))
    log(f"engine {what}: delta step verdicts and rule ids bitwise equal to "
        f"the engine built from the post-delta PolicySet")
    return rec, launches, ref


# ---- phase 14: the async engine and the step knobs --------------------------
# bench.py's attack-floor engine (bench.py:1236-1246), built fused; its flood
# over FLOOD_TARGETS pod targets, warmed FLOOD_WARM rounds and timed
# FLOOD_ROUNDS (bench.py runs 2 and 64: cut for the script's time, each
# round's tick costing seconds); the flood's CROSS_LANES-lane rounds held
# against the CPU engine; the churn cadence's drain batch and rounds; a
# time past every idle timeout; and the stamp second chance narrows, past
# 2**27 so that the narrowed stamp differs.
FLOOD_KW = dict(flow_slots=1 << 18, aff_slots=1 << 8, async_slowpath=True,
                miss_queue_slots=1 << 14, drain_batch=256, admission="drop",
                miss_source_rate=4.0, miss_source_burst=16,
                second_chance=True, canary_probes=8, flightrec_slots=256,
                realization_slots=0)
FLOOD_TARGETS = 256
FLOOD_WARM = 1
FLOOD_ROUNDS = 3
FLOOD_CROSS_ROUNDS = 4
CHURN_DRAIN = 1 << 14
CHURN_ROUNDS = 8
# The churn variants of each mode (the staged walk runs the overlapped one
# alone: the variants' host logic is the mode's, and each costs an engine
# build of 5-8 s).
CHURN_VARIANTS = {"one-pass": ("overlap off", "overlap on", "autotune"),
                  "staged fused": ("overlap on",)}
IDLE_NOW = 102 + 3600 + 1
CHANCE_NOW = (1 << 28) + 100
MODES14 = (("one-pass", dict(fused=True, prune_budget=PRUNE_K)),
           ("staged fused", dict(fused=True)))
FLOOD_FIELDS = ("code", "est", "pending", "reject_kind", "svc_idx",
                "dnat_ip", "dnat_port", "committed", "fwd_kind", "out_port")


def same_engines(a, b, what):
    """Engine a (the card) against engine b (the CPU): slowpath_stats(),
    cache_stats(), the rule counters, telemetry_stats()' counters and the
    flow-cache and affinity tables (the dump row excluded), bitwise."""
    import torch

    sa, sb = a.slowpath_stats(), b.slowpath_stats()
    if sa is not None:
        ha, hb = sa.pop("drain_hist"), sb.pop("drain_hist")
        if sa != sb or ha._counts != hb._counts:
            raise SystemExit(f"{what}: slowpath_stats differ: {sa} / {sb}")
    for name in ("cache_stats", "stats"):
        if getattr(a, name)() != getattr(b, name)():
            raise SystemExit(f"{what}: {name}() differs")
    ta, tb = a.telemetry_stats(), b.telemetry_stats()
    if (ta is None) != (tb is None) or (
            ta is not None and ta["counters"] != tb["counters"]):
        raise SystemExit(f"{what}: telemetry counters differ")
    for part in ("flow", "aff"):
        for f, x, y in zip(getattr(a._state, part)._fields,
                           getattr(a._state, part), getattr(b._state, part)):
            if not torch.equal(x[:-1].cpu(), y[:-1]):
                raise SystemExit(f"{what}: {part}.{f} differs")


def timed(fn):
    """fn() between two synchronizes -> (its result, seconds, the (B1, B2,
    B3) launches it made)."""
    import torch

    c0 = counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = fn()
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    return r, s, tuple(x - y for x, y in zip(counts(), c0))


def flood_round(eng, targets, n, seq, now, tick=True):
    """The attack-floor cadence, one round: the fast step over n SYN-flood
    lanes, a maintenance tick (unless not `tick`), and one drain_slowpath
    (the tick has no drain task: maintenance.py registers the cache scan,
    not a drain, so bench.py's cadence never drains; an agent drains beside
    its ticks).  -> (step result, tick, drain stats, seconds and launches
    of each)."""
    from antrea_tpu_torch.simulator.traffic import gen_syn_flood

    b = gen_syn_flood(targets, n, start_seq=seq, seed=5)
    r, s0, l0 = timed(lambda: eng.step(b, now))
    tick, s1, l1 = timed(lambda: eng.maintenance_tick(now=now) if tick
                         else None)
    drain, s2, l2 = timed(lambda: eng.drain_slowpath(now))
    return r, tick, drain, (s0, s1, s2), (l0, l1, l2)


def drive_flood(ps, services, pod_ips, dev, what, knobs):
    """Phase 14a for one mode: bench.py's attack-floor engine, first
    FLOOD_CROSS_ROUNDS rounds of CROSS_LANES flood lanes beside the same
    engine on the CPU (every result and drain, the last round's tick, then
    every counter and the tables, bitwise), then FLOOD_WARM + FLOOD_ROUNDS
    rounds of B lanes, timed, with the launch counts set to 0 just before
    the B-lane rounds and read just after.  -> record."""
    import gc

    import torch

    from antrea_tpu_torch.datapath import TpuflowDatapath

    kw = dict(FLOOD_KW, **knobs)
    t0 = time.perf_counter()
    eng = TpuflowDatapath(world_copy(ps), services, device=dev, **kw)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = TpuflowDatapath(world_copy(ps), services, device="cpu", **kw)
    cpu_build_s = time.perf_counter() - t0
    targets = list(pod_ips[:FLOOD_TARGETS])
    seq, now = 0, 100
    for r in range(FLOOD_CROSS_ROUNDS):
        # The last round's tick alone: a tick costs seconds (the canary).
        tick = r == FLOOD_CROSS_ROUNDS - 1
        a = flood_round(eng, targets, CROSS_LANES, seq, now, tick)
        c = flood_round(cpu, targets, CROSS_LANES, seq, now, tick)
        same_result(a[0], c[0], f"flood {what} round {r}", FLOOD_FIELDS)
        if (tick and a[1]["ran"] != c[1]["ran"]) or a[2] != c[2]:
            raise SystemExit(f"flood {what} round {r}: tick or drain "
                             f"differs: {a[1:3]} / {c[1:3]}")
        seq, now = seq + CROSS_LANES, now + 1
    same_engines(eng, cpu, f"flood {what}, {CROSS_LANES} lanes")
    st0 = eng.slowpath_stats()
    log(f"flood {what}: {FLOOD_CROSS_ROUNDS} rounds of {CROSS_LANES} lanes "
        f"bitwise equal to the CPU engine (built in {cpu_build_s:.1f} s; "
        f"results, the tick, drains, queue and admission counters, the "
        f"{kw['flow_slots']}-slot tables): "
        f"admitted {st0['admitted_total']}, source-limited "
        f"{st0['source_limited_total']}, drained {st0['drained_total']}")
    del cpu
    gc.collect()
    reset_counts()
    secs, parts = [], []
    for r in range(FLOOD_WARM + FLOOD_ROUNDS):
        res, _, _, s, lc = flood_round(eng, targets, B, seq, now)
        if res.n_miss != B or int(res.pending.sum()) != B:
            raise SystemExit(f"flood {what}: {res.n_miss} misses, "
                             f"{int(res.pending.sum())} pending of {B}")
        if r >= FLOOD_WARM:
            secs.append(s)
        parts.append(lc)
        seq, now = seq + B, now + 1
    launches = counts()
    fast = tuple(sum(p[0][k] for p in parts) for k in range(3))
    tick = tuple(sum(p[1][k] for p in parts) for k in range(3))
    drain = tuple(sum(p[2][k] for p in parts) for k in range(3))
    onepass = bool(knobs.get("prune_budget"))
    if fast != (0, 0, 0) or drain[2 if onepass else 0] == 0 or (
            onepass and drain[1]) or (not onepass and drain[1:] != (0, 0)):
        raise SystemExit(f"flood {what}: (B1, B2, B3) launches in the fast "
                         f"steps {fast}, ticks {tick}, drains {drain}")
    st = eng.slowpath_stats()
    total = sum(sum(s) for s in secs)

    def med(k):
        return sorted(s[k] for s in secs)[len(secs) // 2] * 1e3

    rec = dict(build_s=build_s, pps=FLOOD_ROUNDS * B / total,
               pps_step_tick=FLOOD_ROUNDS * B / sum(s[0] + s[1]
                                                     for s in secs),
               step_ms=med(0), tick_ms=med(1), drain_ms=med(2),
               launches=list(launches), launches_fast=list(fast),
               launches_tick=list(tick), launches_drain=list(drain),
               **{k: st[k] for k in ("admitted_total", "early_drops_total",
                                     "source_limited_total",
                                     "overflows_total", "drained_total",
                                     "depth")})
    log(f"flood {what}: engine built in {build_s:.1f} s; "
        f"{FLOOD_ROUNDS} rounds of {B} SYN-flood lanes after {FLOOD_WARM} "
        f"warm: {rec['pps'] / 1e6:.3f} M packets/s over step + tick + "
        f"drain ({rec['pps_step_tick'] / 1e6:.3f} M over step + tick, "
        f"bench.py's cadence); median ms: fast step {rec['step_ms']:.2f}, "
        f"tick {rec['tick_ms']:.2f}, drain {rec['drain_ms']:.2f}; "
        f"slowpath_stats: admitted {st['admitted_total']}, early drops "
        f"{st['early_drops_total']}, source-limited "
        f"{st['source_limited_total']}, overflows {st['overflows_total']}, "
        f"drained {st['drained_total']}, depth {st['depth']}; (B1, B2, B3) "
        f"launches: fast steps {fast}, ticks {tick}, drains {drain}")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def churn_batch(tr, pool_tr, pod_ips, r):
    """The headline traffic with its last B/8 lanes replaced by window r of
    the fresh-flow pool (phase 8's shape, as a PacketBatch)."""
    import numpy as np

    k = B - N_NEW
    sl = slice(r * N_NEW, (r + 1) * N_NEW)
    cols = [np.concatenate([getattr(tr, f)[:k], getattr(pool_tr, f)[sl]])
            for f in ("src_ip", "dst_ip", "proto", "src_port", "dst_port")]
    return engine_batch(*cols, pod_ips)


def churn_reference(ps, services, pod_ips, tr, pool_tr, dev):
    """Phase 14b's synchronous engine (one-pass; the staged walk's verdicts
    are the same), stepped on the CHURN_ROUNDS churn batches, then on the
    last one again -> that step's result."""
    import gc

    import torch

    from antrea_tpu_torch.datapath import TpuflowDatapath

    sync = TpuflowDatapath(world_copy(ps), services, device=dev,
                           **churn_kw(pod_ips, MODES14[0][1]))
    for r in range(CHURN_ROUNDS):
        sync.step(churn_batch(tr, pool_tr, pod_ips, r), 100 + r)
    want = sync.step(churn_batch(tr, pool_tr, pod_ips, CHURN_ROUNDS - 1),
                     100 + CHURN_ROUNDS)
    del sync
    gc.collect()
    torch.cuda.empty_cache()
    return want


def churn_kw(pod_ips, knobs):
    return dict(flow_slots=FLOW_SLOTS, miss_chunk=MISS_CHUNK, canary_probes=0,
                topology=node0_spec(pod_ips), **knobs)


def drive_churn(ps, services, pod_ips, tr, pool_tr, dev, what, knobs, want,
                variants):
    """Phase 14b for one mode: the churn cadence through the engine
    (admission="forward", drain_batch=CHURN_DRAIN), for each of `variants`
    (of overlap_commits off, on, and autotune_drain) CHURN_ROUNDS rounds of
    a step and a drain_slowpath; then a re-step of the last round's lanes
    against `want`, the synchronous engine's result on them: every lane
    the async engine does not hold pending and that reached the same
    endpoint has the synchronous verdict and rule ids.  (Session affinity
    learns a client's endpoint from its first classified flow, and the
    drains classify in queue order, not lane order, so an affinity
    service's client may reach another endpoint.)  -> record."""
    import gc

    import numpy as np
    import torch

    from antrea_tpu_torch.datapath import TpuflowDatapath

    last = churn_batch(tr, pool_tr, pod_ips, CHURN_ROUNDS - 1)
    rec = {}
    for name in variants:
        extra = {"overlap off": {}, "overlap on": {"overlap_commits": True},
                 "autotune": {"autotune_drain": True}}[name]
        eng = TpuflowDatapath(world_copy(ps), services, device=dev,
                              async_slowpath=True, admission="forward",
                              drain_batch=CHURN_DRAIN,
                              **churn_kw(pod_ips, knobs), **extra)
        reset_counts()
        steps, drains, rounds = [], [], []
        for r in range(CHURN_ROUNDS):
            b = churn_batch(tr, pool_tr, pod_ips, r)
            t0 = time.perf_counter()
            res, s0, l0 = timed(lambda: eng.step(b, 100 + r))
            dr, s1, l1 = timed(lambda: eng.drain_slowpath(100 + r))
            rounds.append(time.perf_counter() - t0)
            steps.append(s0)
            drains.append(s1)
            if l0 != (0, 0, 0) or not dr["drained"]:
                raise SystemExit(f"churn {what} {name} round {r}: fast "
                                 f"step launches {l0}, drained {dr}")
        eng.flush_slowpath()
        launches = counts()
        got = eng.step(last, 100 + CHURN_ROUNDS)
        done = got.pending == 0
        same_ep = (done & (got.dnat_ip == want.dnat_ip)
                   & (got.dnat_port == want.dnat_port))
        bad = [i for i in np.nonzero(same_ep)[0]
               if got.code[i] != want.code[i]
               or got.ingress_rule[i] != want.ingress_rule[i]
               or got.egress_rule[i] != want.egress_rule[i]]
        if bad or int(same_ep.sum()) < B * 9 // 10:
            raise SystemExit(f"churn {what} {name}: did not converge to the "
                             f"synchronous verdicts: {int(done.sum())} of "
                             f"{B} lanes settled, {int(same_ep.sum())} at "
                             f"the same endpoint, {len(bad)} differ")
        st = eng.slowpath_stats()
        med = [sorted(x)[len(x) // 2] * 1e3 for x in (steps, drains, rounds)]
        rec[name] = dict(step_ms=med[0], drain_ms=med[1], round_ms=med[2],
                         launches=list(launches),
                         drained=st["drained_total"],
                         drain_batch=st["drain_batch"],
                         autotune_up=st["autotune_decisions_up"],
                         autotune_down=st["autotune_decisions_down"],
                         settled=int(done.sum()),
                         other_endpoint=int((done & ~same_ep).sum()))
        log(f"churn {what}, {name}: median ms: fast step {med[0]:.2f}, "
            f"drain {med[1]:.2f}, round {med[2]:.2f}; drained "
            f"{st['drained_total']} in {st['drains_total']} drains, chunk "
            f"{st['drain_batch']} (autotune up {st['autotune_decisions_up']}"
            f", down {st['autotune_decisions_down']}); (B1, B2, B3) "
            f"launches {launches}; re-step: {int(done.sum())} of {B} lanes "
            f"settled, {int(same_ep.sum())} at the synchronous engine's "
            f"endpoint with its verdicts and rule ids, "
            f"{int((done & ~same_ep).sum())} at another (affinity)")
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    return rec


def drive_knobs(ps, services, pod_ips, tr, pool_tr, dev):
    """Phase 14c: a one-pass engine with telemetry, the FlowExporter gate
    and second chance, on the card and on the CPU, stepped on CROSS_LANES
    fresh flows (one lane each, lengths near 2**31) cold, warm, warm again
    and past the idle timeout: results, tel_* counters, telemetry_stats()
    and the tables with their counter columns bitwise equal; after the
    third step every live forward entry of the batch holds its three
    packets and their bytes (past 2**32).  Then 14e on the card engine:
    profile() in sync and async mode, the phases the chain's and summing
    to the total, cache_stats() unchanged.  -> (record, the card engine's
    profiles)."""
    import gc

    import numpy as np
    import torch

    from antrea_tpu_torch.datapath import TpuflowDatapath
    from antrea_tpu_torch.features import FeatureGates
    from antrea_tpu_torch.models import profile as prof
    from antrea_tpu_torch.utils import ip as iputil

    kw = dict(flow_slots=FLOW_SLOTS, miss_chunk=MISS_CHUNK, canary_probes=0,
              topology=node0_spec(pod_ips), fused=True, prune_budget=PRUNE_K,
              telemetry=True, second_chance=True,
              feature_gates=FeatureGates({"FlowExporter": True}))
    eng = TpuflowDatapath(world_copy(ps), services, device=dev, **kw)
    cpu = TpuflowDatapath(world_copy(ps), services, device="cpu", **kw)
    n = CROSS_LANES
    b = engine_batch(pool_tr.src_ip[:n], pool_tr.dst_ip[:n],
                     pool_tr.proto[:n], pool_tr.src_port[:n],
                     pool_tr.dst_port[:n], pod_ips)
    b.pkt_len = (2**31 - 1 - np.arange(n) % 97).astype(np.int32)
    tel = []
    for now in (100, 101, 102, IDLE_NOW):
        r = eng.step(b, now)
        same_result(r, cpu.step(b, now), f"knobs now={now}")
        same_engines(eng, cpu, f"knobs now={now}")
        tel.append(dict(eng.telemetry_stats()["counters"]))
        if now == 102:
            flows = {(f["src"], f["dst"], f["sport"], f["dport"]): f
                     for f in eng.dump_flows(now) if not f["reply"]}
            lanes = {(iputil.u32_to_ip(int(b.src_ip[i])),
                      iputil.u32_to_ip(int(b.dst_ip[i])),
                      int(b.src_port[i]), int(b.dst_port[i])): i
                     for i in range(n)}
            # Each live forward entry holds its packets at its lane's
            # length (a slot collision can restart an entry), and most
            # hold all three steps'.
            live = [(f, lanes[k]) for k, f in flows.items() if k in lanes]
            full = sum(f["packets"] == 3 for f, _ in live)
            if full < n * 9 // 10 or any(
                    not 1 <= f["packets"] <= 3
                    or f["bytes"] != f["packets"] * int(b.pkt_len[i])
                    for f, i in live):
                raise SystemExit("knobs: the flow counters do not hold the "
                                 "steps' packets and bytes")
    if not (tel[0]["probe_hit"] == 0 and tel[0]["probe_miss"] > 0
            and tel[0]["dma_hb"] > 0 and tel[1]["probe_hit"] > 0
            and tel[-1]["probe_stale"] > tel[-2]["probe_stale"]):
        raise SystemExit(f"knobs: telemetry counters {tel}")
    del cpu
    gc.collect()
    log(f"knobs: one-pass engine with telemetry, the FlowExporter gate and "
        f"second chance, {n} lanes cold, warm, warm, past the idle timeout: "
        f"card bitwise equal to the CPU engine (results, telemetry, tables "
        f"and counters); {full} of {len(live)} live forward entries hold 3 "
        f"packets and their bytes (up to {3 * (2**31 - 1)}); telemetry "
        f"{tel[-1]}")
    hot = engine_batch(tr.src_ip, tr.dst_ip, tr.proto, tr.src_port,
                       tr.dst_port, pod_ips)
    fresh = engine_batch(pool_tr.src_ip, pool_tr.dst_ip, pool_tr.proto,
                         pool_tr.src_port, pool_tr.dst_port, pod_ips)
    profiles = {}
    for mode, chain in (("sync", prof.PHASE_CHAIN),
                        ("async", prof.ASYNC_PHASE_CHAIN)):
        before = eng.cache_stats()
        out, s, _ = timed(lambda: eng.profile(hot, fresh, mode=mode, now=200,
                                              k_small=1, k_big=3, repeats=1))
        total = sum(out["phases_s"].values())
        if (list(out["phases_s"]) != [c[0] for c in chain]
                or abs(total - out["total_s"]) > 1e-9 * out["total_s"]
                or eng.cache_stats() != before):
            raise SystemExit(f"profile {mode}: phases {out['phases_s']}, "
                             f"total {out['total_s']}, cache "
                             f"{eng.cache_stats()} / {before}")
        profiles[mode] = dict(total_ms=out["total_s"] * 1e3, pps=out["pps"],
                              run_s=s, phases_ms={
                                  k: v * 1e3
                                  for k, v in out["phases_s"].items()})
        log(f"profile {mode} (one-pass engine, {B} lanes, "
            f"{out['fresh_per_step']} fresh a step): total "
            f"{out['total_s'] * 1e3:.2f} ms/step, phases (ms) "
            + ", ".join(f"{k} {v * 1e3:.3f}"
                        for k, v in out["phases_s"].items())
            + f"; sums to the total, cache_stats unchanged; {s:.1f} s")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return dict(live_forward_entries=len(live), full_entries=full,
                telemetry=tel[-1]), profiles


def drive_chance(cps, svc, tr, dev, b3_ref):
    """Phase 14d: B3 at second chance's stamp mask against its plain
    version on the headline batch, all-miss and warm, at CHANCE_NOW (past
    2**27, so the narrowed stamp differs), beside the PREF_MASK records
    (b3_ref); then the one-pass steady step with each knob on against all
    off, on the same warm 2**22-slot state (the knobs' winner-mask passes
    and counter scatters).  -> (records, knob step times)."""
    import gc

    import torch

    from antrea_tpu_torch.models import pipeline as pl

    step, state, (drs, dsvc) = pl.make_pipeline(
        cps, svc, flow_slots=FLOW_SLOTS, miss_chunk=MISS_CHUNK, fused=True,
        prune_budget=PRUNE_K, ct_timeout_s=3600, second_chance=True,
        device=dev)
    if step.meta.pref_mask != pl.PREF_MASK_CHANCE:
        raise SystemExit("second_chance did not narrow the stamp mask")
    lanes = to_lanes(tr, dev)
    rec = {"cold": check_onepass(step, state, drs, dsvc, lanes, CHANCE_NOW,
                                 "second-chance mask, empty cache")}
    for now in (CHANCE_NOW, CHANCE_NOW + 1):
        state, _ = step(state, drs, dsvc, *lanes, now, 0)
    rec["warm"] = check_onepass(step, state, drs, dsvc, lanes,
                                CHANCE_NOW + 2, "second-chance mask, warm")
    for k in ("cold", "warm"):
        log(f"B3 {k}: {rec[k]['ms'] * 1e3:.2f} us at PREF_MASK_CHANCE "
            f"against {b3_ref[k]['ms'] * 1e3:.2f} us at PREF_MASK")
    lens = torch.full((B,), 1500, dtype=torch.int32, device=dev)
    base = step.meta._replace(second_chance=False)
    metas = {"off": base, "second_chance": step.meta,
             "count_flow_stats": base._replace(count_flow_stats=True),
             "telemetry": base._replace(telemetry=True),
             "all": step.meta._replace(count_flow_stats=True,
                                       telemetry=True)}
    times = {name: [] for name in metas}
    now = CHANCE_NOW + 3
    # The knobs in turns, a step each a round (the first round untimed), so
    # that drift of the host's speed spreads over all of them.
    for i in range(STEADY_STEPS + 1):
        for name, meta in metas.items():
            _, s, _ = timed(lambda: pl.pipeline_step(
                state, drs, dsvc, *lanes, now, 0, meta=meta, lens=lens))
            now += 1
            if i:
                times[name].append(s)
    knob_ms = {k: sorted(v)[len(v) // 2] * 1e3 for k, v in times.items()}
    log(f"one-pass steady step at {FLOW_SLOTS} slots, median ms of "
        f"{STEADY_STEPS} with each knob (in turns): "
        + ", ".join(f"{k} {v:.3f}" for k, v in knob_ms.items()))
    del state, drs, dsvc
    gc.collect()
    torch.cuda.empty_cache()
    return rec, knob_ms


# ---- phase 15: dual-stack ---------------------------------------------------
# The headline world's dual-stack twin: each pod also at fd00:10:0:<n>::<p+2>
# (node n's v6 podCIDR fd00:10:0:<n>::/64), each Service also at
# fd00:96::<i> with its endpoints' twins, every other address at
# 2001:db8::<a>; the lanes of every flow with an odd source port carry the
# flow's v6 twin.  Test data derived here (the simulator has no dual-stack
# generator).
PODS_PER_NODE = 32
V6_POD_W0, V6_SVC_W0, V6_OTHER_W0 = 0xFD000010, 0xFD000096, 0x20010DB8


def pod_twin(i: int) -> str:
    """The v6 twin of pod i of gen_cluster (node i // 32, pod i % 32)."""
    n, p = divmod(i, PODS_PER_NODE)
    return f"fd00:10:0:{n:x}::{p + 2:x}"


def twin_words(addr, pod_ips, services):
    """(B,) u32 v4 addresses -> (B, 4) u32 words of their v6 twins."""
    import numpy as np

    from antrea_tpu_torch.utils import ip as iputil

    addr = np.asarray(addr, np.uint32)

    def index_of(table):
        order = np.argsort(table, kind="stable")
        srt = table[order]
        pos = np.searchsorted(srt, addr).clip(0, len(srt) - 1)
        return srt[pos] == addr, order[pos]

    is_pod, pod = index_of(np.asarray(pod_ips, np.uint32))
    is_svc, svc = index_of(np.array([iputil.ip_to_u32(s.cluster_ip)
                                     for s in services], np.uint32))
    is_svc &= ~is_pod
    w = np.zeros((addr.shape[0], 4), np.uint32)
    w[:, 0] = np.where(is_pod, V6_POD_W0,
                       np.where(is_svc, V6_SVC_W0, V6_OTHER_W0))
    w[:, 1] = np.where(is_pod, pod // PODS_PER_NODE, 0)
    w[:, 3] = np.where(is_pod, pod % PODS_PER_NODE + 2,
                       np.where(is_svc, svc, addr))
    return w


def dual_world(ps, services, pod_ips):
    """The headline PolicySet and Services with their v6 twins -> (ps6,
    services6).  Each group member that is a pod gains its twin as a
    second member; ipBlocks stay v4.  Each Service gains a v6 twin entry
    (the metaProxier's split of a RequireDualStack Service)."""
    import dataclasses

    from antrea_tpu_torch.utils import ip as iputil

    twin = {iputil.u32_to_ip(int(u)): pod_twin(i)
            for i, u in enumerate(pod_ips)}

    def dual(g):
        extra = [dataclasses.replace(m, ip=twin[m.ip]) for m in g.members
                 if m.ip in twin]
        return dataclasses.replace(g, members=list(g.members) + extra)

    ps6 = dataclasses.replace(
        ps, address_groups={k: dual(g) for k, g in ps.address_groups.items()},
        applied_to_groups={k: dual(g)
                           for k, g in ps.applied_to_groups.items()})
    svc6 = [dataclasses.replace(
        s, cluster_ip=f"fd00:96::{i:x}",
        endpoints=[dataclasses.replace(e, ip=twin[e.ip])
                   for e in s.endpoints])
        for i, s in enumerate(services)]
    return ps6, list(services) + svc6


def dual_spec(pod_ips):
    """Node-0's topology with its v6 half: the v6 gateway and podCIDR, each
    local pod's twin at the same ofport, every remote node's v6 podCIDR
    over its v4 underlay address."""
    import dataclasses

    from antrea_tpu_torch.compiler.topology import NodeRoute

    t = node0_spec(pod_ips)
    return dataclasses.replace(
        t, gateway_ip6="fd00:10::1", pod_cidr6="fd00:10:0:0::/64",
        local_pods=t.local_pods + [(pod_twin(i), port) for i, (_, port)
                                   in enumerate(t.local_pods)],
        remote_nodes=t.remote_nodes + [
            NodeRoute(name=f"node-{k}", node_ip=f"192.168.0.{k}",
                      pod_cidr=f"fd00:10:0:{k:x}::/64") for k in range(1, 64)])


DUAL_NODE_IPS = ["fd00:10::1"]


def dual_batch(tr, pod_ips, services, n=None, shadow=None):
    """The batch with the v6 lanes of every flow whose source port is odd
    (their v4 columns zero, as PacketBatch.from_packets leaves them); in_port
    honest as node-0 sees the v4 flow (a twin enters where its pod does).
    -> PacketBatch."""
    import numpy as np

    from antrea_tpu_torch.packet import PacketBatch

    sl = slice(None, n)
    src, dst = tr.src_ip[sl], tr.dst_ip[sl]
    is6 = (tr.src_port[sl] & 1).astype(np.int32)
    return PacketBatch(
        src_ip=np.where(is6 == 1, 0, src).astype(np.uint32),
        dst_ip=np.where(is6 == 1, 0, dst).astype(np.uint32),
        proto=tr.proto[sl], src_port=tr.src_port[sl],
        dst_port=tr.dst_port[sl],
        in_port=honest_ports(src if shadow is None else shadow[sl], pod_ips),
        src_ip6=np.where(is6[:, None] == 1,
                         twin_words(src, pod_ips, services), 0).astype(
                             np.uint32),
        dst_ip6=np.where(is6[:, None] == 1,
                         twin_words(dst, pod_ips, services), 0).astype(
                             np.uint32),
        is6=is6)


def v6_lanes(b, dev, n=None):
    """A batch's (src6w_f, dst6w_f, is6) on dev."""
    import numpy as np
    import torch

    from antrea_tpu_torch.utils import ip as iputil

    return tuple(torch.from_numpy(np.ascontiguousarray(c[:n], np.int32))
                 .to(dev) for c in (iputil.flip_u32(b.src_ip6),
                                    iputil.flip_u32(b.dst_ip6), b.is6))


def dual_rows(step, state, drs, dsvc, lanes, v6):
    """The lanes' post-DNAT interval rows on the dual-stack tables, as the
    staged classify builds them (wide ServiceLB, then the v6 lanes' rows in
    the v6 sub-spaces) -> (B, 8) int32."""
    from antrea_tpu_torch.models import pipeline as pl
    from antrea_tpu_torch.ops import match as tm

    src, dst, proto, sport, dport = lanes
    wide = pl._wide_lanes(src, dst, v6)
    h = pl._wide_hash(*wide[:2], proto, sport, dport)
    svc_idx, _, dnat_ip, dnat_port, _, _, dnat_w, _ = pl._service_lb(
        state.aff, dsvc, h, src, dst, proto, dport, 100, step.meta.aff_slots,
        wide=wide)
    key = (proto << 16) | dnat_port
    ref = (tm._svcref_key(key, pl._svc_ref_of(svc_idx, dsvc))
           if step.meta.match.svcref else None)
    return tm.interval_rows(drs, src, dnat_ip, key, ref,
                            v6=(wide[0], dnat_w, wide[2]))


def v6_row_count(drs, iv) -> int:
    """How many of the lanes' ip-dimension rows lie in a v6 sub-space."""
    ing, eg = drs.ingress, drs.egress
    return sum(int((iv[:, c] > t.bounds.shape[0]).sum())
               for c, t in ((0, ing.at), (1, ing.peer), (3, eg.at),
                            (4, eg.peer)))


def agg_and(drs, iv, svcref):
    """The lanes' aggregate-AND rows per direction (svcref's row ORed into
    egress svc) -> (g_in, g_out)."""
    g = []
    for d, dd in enumerate((drs.ingress, drs.egress)):
        rows = [t.agg[iv[:, 3 * d + k].long()]
                for k, t in enumerate((dd.at, dd.peer, dd.svc))]
        if d and svcref:
            rows[2] = rows[2] | dd.svc.agg[iv[:, 6].long()]
        g.append((rows[0] & rows[1] & rows[2]).contiguous())
    return g


def churn_plan6(eng, ps):
    """v6 pod churn for CHURN_GROUPS address groups: per group a fresh v6 pod
    (fd00:10:0:<k>::<200 + k>, in node k's v6 podCIDR) joins and one v6
    member leaves, one whose address no other group of the same rule
    dimensions covers (so each delta takes slots).  -> [(group, added,
    removed)]."""
    from antrea_tpu_torch.datapath.tpuflow import _overlaps
    from antrea_tpu_torch.utils import ip as iputil

    plan = []
    for name in sorted(ps.address_groups):
        g = ps.address_groups[name]
        gids = eng._name_gids.get(name)
        if not g.members or g.ip_blocks or not gids:
            continue
        ips = [m.ip for m in g.members]
        for ip in ips:
            if not iputil.is_v6(ip) or ips.count(ip) != 1:
                continue
            r = iputil.cidr_to_range(ip)
            others = [iputil.merge_ranges(list(eng._gid_ident[gid][2]))
                      for gid in gids]
            others += [eng._ranges_of(n) for gid in gids
                       for n in eng._gid_ident[gid][1] if n != name]
            if not any(_overlaps(o, r) for o in others):
                k = len(plan) + 1
                plan.append((name, [f"fd00:10:0:{k:x}::{200 + k:x}"], [ip]))
                break
        if len(plan) == CHURN_GROUPS:
            return plan
    raise SystemExit(f"dual-stack engine: found {len(plan)} churnable "
                     f"groups, not {CHURN_GROUPS}")


def delta_batch6(plan, pod_ips, n, seed):
    """n fresh v6 flows, each with one of the churned v6 addresses on one
    side (source and destination in turn) and a seeded pod's twin on the
    other; TCP from source ports below 1024 (never in the headline
    traffic).  in_port: a node-0 pod's port where the source is its twin,
    else the tunnel.  -> PacketBatch."""
    import numpy as np

    from antrea_tpu_torch.packet import PacketBatch
    from antrea_tpu_torch.utils import ip as iputil

    twin_ip = {pod_twin(i): int(u) for i, u in enumerate(pod_ips)}
    churned = [ip for _, a, r in plan for ip in a + r]
    cw = np.array([iputil.key_to_words(iputil.ip_to_key(ip))
                   for ip in churned], np.uint32)
    cshadow = np.array([twin_ip.get(ip, 0) for ip in churned], np.uint32)
    rng = np.random.default_rng(seed)
    i = np.arange(n)
    a = i % len(churned)
    pod = rng.integers(0, len(pod_ips), n)
    pw = np.zeros((n, 4), np.uint32)
    pw[:, 0], pw[:, 1] = V6_POD_W0, pod // PODS_PER_NODE
    pw[:, 3] = pod % PODS_PER_NODE + 2
    swap = ((i // len(churned)) % 2 == 1)[:, None]
    src6, dst6 = np.where(swap, pw, cw[a]), np.where(swap, cw[a], pw)
    shadow = np.where(swap[:, 0], np.asarray(pod_ips, np.uint32)[pod],
                      cshadow[a])
    z = np.zeros(n, np.uint32)
    return PacketBatch(
        src_ip=z, dst_ip=z, proto=np.full(n, 6, np.int32),
        src_port=(1 + i % 1023).astype(np.int32),
        dst_port=rng.choice(np.array([80, 443, 5432, 8080], np.int32), n),
        in_port=honest_ports(shadow, pod_ips), src_ip6=src6, dst_ip6=dst6,
        is6=np.ones(n, np.int32))


DUAL_FIELDS = RESULT_FIELDS + ("pending", "n_miss", "punt", "mcast_idx",
                               "l7_redirect", "dec_ttl", "dnat_key",
                               "peer_key")


def same_engine_state(a, b, now, what):
    """Two engines' flow and affinity tables (dump row excluded) and
    dump_flows() bitwise equal."""
    import torch

    for part in ("flow", "aff"):
        for f, ta, tb in zip(getattr(a._state, part)._fields,
                             getattr(a._state, part), getattr(b._state, part)):
            if not torch.equal(ta[:-1].cpu(), tb[:-1].cpu()):
                raise SystemExit(f"{what}: {part}.{f} differs")
    if a.dump_flows(now) != b.dump_flows(now):
        raise SystemExit(f"{what}: dump_flows() differs")


def sub_batch(b, idx):
    """The lanes idx of a PacketBatch."""
    import dataclasses

    return dataclasses.replace(b, **{
        f.name: getattr(b, f.name)[idx] for f in dataclasses.fields(b)
        if getattr(b, f.name) is not None})


def timed_wide_keys(cls):
    """Wrap cls._wide_keys (the engine's host views of the wide columns)
    to add each call's seconds to the returned list; -> (list, restore)."""
    orig = cls.__dict__["_wide_keys"]
    spent = []

    def timed(col):
        t0 = time.perf_counter()
        out = orig.__func__(col)
        spent.append(time.perf_counter() - t0)
        return out

    cls._wide_keys = staticmethod(timed)

    def restore():
        cls._wide_keys = orig

    return spent, restore


def drive_dual(ps, services, pod_ips, tr, dev):
    """Phase 15: the dual-stack path at the headline width, one pipeline or
    engine at a time.  Cuts for time (no width is cut): (e)'s fresh
    engines are built from the post-delta PolicySet, and its card engine
    then serves as (d)'s recompile reference, so (d) and (e) build three
    engines, not four; those two engines classify in rounds of
    CROSS_LANES lanes, not MISS_CHUNK (the reference's 2**17-lane delta
    step in 32 rounds, not 512; chunking moves no verdict or rule id).
    Still over the 60 s aim (about 90 s on an NVIDIA H100 80GB HBM3 at
    700 W): four 100k-rule host compiles of the twin world (~36 s) and the
    four deltas' canaries (~11 s) are most of it.  -> (record, B1 records, B2
    records, B2's launches in (c))."""
    import gc

    import numpy as np
    import torch

    from antrea_tpu_torch.compiler.compile import compile_policy_set
    from antrea_tpu_torch.compiler.services import compile_services
    from antrea_tpu_torch.compiler.topology import (FWD_ARP_REPLY,
                                                    compile_topology)
    from antrea_tpu_torch.datapath import TpuflowDatapath
    from antrea_tpu_torch.models import forwarding as fw
    from antrea_tpu_torch.models import pipeline as pl
    from antrea_tpu_torch.ops import match as tm

    t15 = time.perf_counter()
    ps6, services6 = dual_world(ps, services, pod_ips)
    t0 = time.perf_counter()
    cps6 = compile_policy_set(ps6)
    svc6 = compile_services(services6, node_ips=DUAL_NODE_IPS)
    step, state, (drs, dsvc) = pl.make_pipeline(
        cps6, svc6, flow_slots=FLOW_SLOTS, miss_chunk=MISS_CHUNK, fused=True,
        dual_stack=True, device=dev)
    meta = step.meta.match
    torch.cuda.synchronize()
    hb = dual_batch(tr, pod_ips, services)
    n6 = int(hb.is6.sum())
    log(f"dual-stack world: {sum(len(g.members) for g in ps6.address_groups.values())}"
        f" address-group members, {len(services6)} services "
        f"({svc6.uip6_w.shape[0]} v6 frontends), compiled and on the card "
        f"in {time.perf_counter() - t0:.1f} s; v6 bounds per ip dimension "
        f"{[t.bounds6.shape[0] for t in (drs.ingress.at, drs.ingress.peer, drs.egress.at, drs.egress.peer)]}"
        f"; batch {B} lanes, {n6} v6; device memory "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    lanes = to_lanes(hb, dev)
    v6 = v6_lanes(hb, dev)

    # (a) B1 and B2 on the dual-stack tables at the batch's interval rows.
    iv = dual_rows(step, state, drs, dsvc, lanes, v6)
    n_rows6 = v6_row_count(drs, iv)
    log(f"dual-stack interval rows: {n_rows6} of {4 * B} ip-dimension rows "
        f"in a v6 sub-space")
    stabs = tm.tables(drs)
    b1 = {b: check_consumer(stabs, iv[:b], meta.svcref, meta.in_phases,
                            meta.out_phases, f"dual-stack, first {b} lanes, "
                            f"{v6_row_count(drs, iv[:b])} v6 rows", inner)
          for b, inner in ((256, 50), (32768, 3))}
    pdrs, pmeta = tm.to_device(cps6, dev, prune_budget=PRUNE_K)
    g_in, g_out = agg_and(pdrs, iv, pmeta.svcref)
    b2 = {b: check_pruned(g_in[:b], g_out[:b], iv[:b], tm.tables(pdrs),
                          PRUNE_K, pmeta.svcref, pmeta.in_phases,
                          pmeta.out_phases, inner)
          for b, inner in ((256, 50), (32768, 5))}
    del iv, g_in, g_out, stabs
    torch.cuda.empty_cache()

    # (b) The walk on the staged fused dual-stack pipeline.
    spec = dual_spec(pod_ips)
    dft = fw.fwd_to_device(compile_topology(spec), dev)
    # The full walk's columns with the v6 lanes' v4 addresses zero (flipped),
    # as the batch carries them.
    six = v6[2] != 0
    zf = torch.tensor(-(2**31), dtype=torch.int32, device=dev)
    cols = {k: (torch.where(six, zf, c[0]), torch.where(six, zf, c[1]))
            + c[2:] for k, c in full_lanes(tr, pod_ips, dev).items()}
    walk, outs, _, walk_launches = drive_full(step.meta, drs, dsvc, dft,
                                              cols, dev, "dual-stack staged "
                                              "fused", v6=v6)
    nd = [int(((o["fwd_kind"] == FWD_ARP_REPLY) & six.cpu()).sum())
          for o in outs[N_TIMED:]]
    log(f"dual-stack walk: v6 ND replies in the coverage steps {nd}")
    del outs
    cross_check_full(step.meta, drs, dsvc, dft, cols, dev,
                     "dual-stack staged fused", v6=v6)
    del state, drs, dsvc, dft, cols
    gc.collect()
    torch.cuda.empty_cache()

    # (c) The pruned classify with v6 lanes.
    pcls, pc_launches = drive_pruned_classify(
        pmeta, pdrs, lanes, dev, v6=tuple(t[:B_COLD] for t in v6),
        what="dual-stack ")
    del pdrs, lanes
    torch.cuda.empty_cache()

    # (d) The dual-stack engine: steps, v6 churn, the delta step.
    kw = dict(flow_slots=FLOW_SLOTS, miss_chunk=MISS_CHUNK, fused=True,
              dual_stack=True, canary_probes=ENGINE_PROBES, delta_slots=128,
              topology=spec, node_ips=DUAL_NODE_IPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = TpuflowDatapath(world_copy(ps6), services6, device=dev, **kw)
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    spent, restore = timed_wide_keys(TpuflowDatapath)
    reset_counts()
    times, misses = [], []
    for now in NOWS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = eng.step(hb, now)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        misses.append(r.n_miss)
        if r.code.shape != (B,) or not np.isin(r.code, (0, 1, 2)).all():
            raise SystemExit("dual-stack engine: bad verdict column")
    restore()
    # Per step the two views (dnat_key, peer_key); the steady steps' median.
    views = sorted(a + b for a, b in zip(spent[4::2], spent[5::2]))
    rec = step_stats(times)
    rec["host_views_ms"] = views[len(views) // 2] * 1e3
    plan = churn_plan6(eng, ps6)
    inc0 = eng._drs.ingress.at.inc
    lat = []
    for name, added, removed in plan:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.apply_group_delta(name, added, removed)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
    if eng._n_deltas < 1 or eng._drs.ingress.at.inc is not inc0:
        raise SystemExit(f"dual-stack engine: the v6 deltas folded into a "
                         f"recompile ({eng._n_deltas} slots)")
    st = eng.commit_stats()
    if st["canary_probes_total"] < len(plan) or st["degraded"]:
        raise SystemExit(f"dual-stack engine: canary did not certify: {st}")
    main = delta_batch6(plan, pod_ips, B, 31)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = eng.step(main, NOWS[-1] + 1)
    torch.cuda.synchronize()
    delta_s = time.perf_counter() - t0
    eng_launches = counts()
    if r.n_miss != B or not eng_launches[0] or eng_launches[2]:
        raise SystemExit(f"dual-stack engine: delta step n_miss {r.n_miss}, "
                         f"(B1, B2, B3) launches {eng_launches}")
    rec.update(compile_s=compile_s, delta_ms=[x * 1e3 for x in lat],
               delta_step_ms=delta_s * 1e3, n_deltas=eng._n_deltas,
               launches=list(eng_launches),
               canary_probes=st["canary_probes_total"])
    log(f"dual-stack engine: built in {compile_s:.1f} s; headline traffic "
        f"({n6} v6 lanes): cold {rec['cold_ms']:.1f} ms, warm "
        f"{rec['warm_ms']:.2f} ms, steady median {rec['steady_ms']:.3f} "
        f"ms/step (min {rec['steady_min_ms']:.3f}, max "
        f"{rec['steady_max_ms']:.3f}), {rec['steady_pps'] / 1e6:.2f} M "
        f"packets/s, of which the host views of the wide columns "
        f"(dnat_key, peer_key) {rec['host_views_ms']:.1f} ms a step; n_miss "
        f"per step {misses}")
    log(f"dual-stack engine: {len(plan)} v6 group deltas in "
        f"{eng._n_deltas} slots, apply_group_delta "
        f"{', '.join(f'{x * 1e3:.1f}' for x in lat)} ms; delta step of {B} "
        f"fresh v6 lanes {delta_s * 1e3:.1f} ms; (B1, B2, B3) launches over "
        f"(d) {eng_launches}")
    post_ps = world_copy(eng._ps)
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    # (e) Card against CPU on fresh engines (the post-delta PolicySet's, at
    # CROSS_SLOTS so that their tables compare): 4096 of the batch's lanes,
    # half v6, cold then warm; then the card engine is (d)'s recompile
    # reference (the delta lanes' tuples are not in its cache: their
    # source ports are below 1024).
    half = CROSS_LANES // 2
    idx = np.concatenate([np.nonzero(hb.is6 == 0)[0][:half],
                          np.nonzero(hb.is6 == 1)[0][:half]])
    cb = sub_batch(hb, np.sort(idx))
    ekw = {**kw, "canary_probes": 0, "flow_slots": CROSS_SLOTS,
           "miss_chunk": CROSS_LANES}
    eg = TpuflowDatapath(world_copy(post_ps), services6, device=dev, **ekw)
    ec = TpuflowDatapath(world_copy(post_ps), services6, device="cpu", **ekw)
    for now in (NOWS[-1] + 1, NOWS[-1] + 2):
        what = f"dual-stack card vs CPU now={now}"
        same_result(eg.step(cb, now), ec.step(cb, now), what, DUAL_FIELDS)
        same_engine_state(eg, ec, now, what)
    lanes16 = sub_batch(cb, np.arange(16))
    if eg.trace(lanes16, NOWS[-1] + 3) != ec.trace(lanes16, NOWS[-1] + 3):
        raise SystemExit("dual-stack card vs CPU: trace() differs")
    log(f"dual-stack engines card vs CPU: {CROSS_LANES} lanes ({half} v6), "
        f"cold then warm: every StepResult field, the tables, dump_flows() "
        f"and a 16-lane trace() bitwise equal")
    del ec
    gc.collect()
    same_result(r, eg.step(main, NOWS[-1] + 1),
                "dual-stack deltas vs full recompile", fields=("code",))
    log("dual-stack engine: delta step verdicts and rule ids bitwise equal "
        "to the engine built from the post-delta PolicySet")
    del eg, r
    gc.collect()
    torch.cuda.empty_cache()
    rec15 = dict(walk=walk, walk_launches=list(walk_launches),
                 pruned_classify=pcls, engine=rec, v6_rows=n_rows6,
                 seconds=time.perf_counter() - t15)
    log(f"phase 15 took {rec15['seconds']:.1f} s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    return rec15, b1, b2, pc_launches


# ---- phase 16: tenant worlds, the serving batcher, restart, the twin -------
# (a)'s tenant worlds (TENANTS_PER_RUNG of each rule count, each
# gen_cluster(n, n_nodes=8, pods_per_node=32), at the per-tenant flow and
# affinity quotas), the batcher's ladder, the flows of each tenant's share of
# (b)'s batch, (c)'s mixed lanes, the one-pass engines' default-world cache
# in (c) and (d) (card and CPU alike), and (f)'s lanes.
TENANT_RULES = (2_000, 8_000, 25_000)
TENANTS_PER_RUNG = 4
TENANT_QUOTA = 1 << 18
TENANT_AFF_QUOTA = 1 << 16
LADDER = (2048, 8192)
TENANT_FLOWS = 2048
ONEPASS_SLOTS = 1 << 16
TWIN_LANES = 512
# (f)'s headline lanes: the twin walks each through the scalar Oracle at
# 100k rules, about a quarter second a lane (16 keep the phase's depth
# for the agent's phase 19).
TWIN_HEADLINE_LANES = 16


def tenant_worlds():
    """-> [(rule count, cluster)]: TENANTS_PER_RUNG worlds of each of
    TENANT_RULES, rule count r's i-th at seed 100 + 10 * r + i."""
    from antrea_tpu_torch.simulator import gen_cluster

    return [(n, gen_cluster(n, n_nodes=8, pods_per_node=32,
                            seed=100 + 10 * r + i))
            for r, n in enumerate(TENANT_RULES)
            for i in range(TENANTS_PER_RUNG)]


def tenant_traffic(cluster, n, seed, n_flows=None):
    """n lanes of gen_traffic over the tenant's own pods."""
    from antrea_tpu_torch.simulator import gen_traffic

    return gen_traffic(cluster.pod_ips, n, seed=seed,
                       n_flows=n_flows or max(8, n // 2))


def mixed(parts, tids, seed):
    """PacketBatches `parts`, one per world id of `tids`, concatenated and
    shuffled by a seeded permutation -> (batch, each lane's world id)."""
    import dataclasses

    import numpy as np

    cols = {f.name: np.concatenate([getattr(p, f.name) for p in parts])
            for f in dataclasses.fields(parts[0])
            if getattr(parts[0], f.name) is not None}
    b = type(parts[0])(**cols)
    lane = np.concatenate([np.full(p.size, t, np.int64)
                           for p, t in zip(parts, tids)])
    perm = np.random.default_rng(seed).permutation(b.size)
    return sub_batch(b, perm), lane[perm]


def world_bytes(drs, state) -> int:
    """Device bytes of one world's rule and state tensors."""
    from antrea_tpu_torch.models.pipeline import tree_leaves

    return sum(x.numel() * x.element_size()
               for x in tree_leaves(drs) + tree_leaves(state))


def world_states(eng, tids) -> list:
    return [eng._state] + [eng._tenants.world(t).fields["_state"]
                           for t in tids]


def set_world_states(eng, tids, states) -> None:
    eng._state = states[0]
    for t, s in zip(tids, states[1:]):
        eng._tenants.world(t).fields["_state"] = s


def recording_signatures(eng):
    """Wrap models/forwarding.pipeline_step_full to record each dispatch's
    (rung signature, lane count), the signature being what the tenancy
    plane keys a world's rung by: its step meta and the shapes of its rule
    and state tensors; and, per dispatch, the world of `eng` it ran in and
    the (B1, B2, B3) launches it made.  -> (signatures, [(world id,
    launches)], restore)."""
    from antrea_tpu_torch.models import forwarding as fw
    from antrea_tpu_torch.models.pipeline import tree_leaves

    real = fw.pipeline_step_full
    sigs, per_world = [], []

    def recording(state, drs, *args, meta, **kw):
        sigs.append(((meta, tuple(tuple(x.shape) for x in tree_leaves(drs)),
                      tuple(tuple(x.shape) for x in tree_leaves(state))),
                     int(args[2].shape[0])))
        c0 = counts()
        out = real(state, drs, *args, meta=meta, **kw)
        per_world.append((eng._tenant_id(),
                          tuple(x - y for x, y in zip(counts(), c0))))
        return out

    fw.pipeline_step_full = recording

    def restore():
        fw.pipeline_step_full = real

    return sigs, per_world, restore


def tenant_launches(per_world) -> tuple[int, int, int]:
    """(B1, B2, B3) launches of the dispatches that ran in a tenant world
    (not the default world, id 0)."""
    return tuple(sum(ln[k] for tid, ln in per_world if tid)
                 for k in range(3))


def add_counts(a, b) -> tuple:
    return tuple(x + y for x, y in zip(a, b))


def step_fields():
    """Every StepResult field but the rule ids (compared as lists)."""
    import dataclasses

    from antrea_tpu_torch.datapath.interface import StepResult

    return tuple(f.name for f in dataclasses.fields(StepResult)
                 if f.name not in ("ingress_rule", "egress_rule"))


def same_worlds(a, b, tids, now, what):
    """Two engines' worlds (the default and each tenant): the flow and
    affinity tables (dump row excluded), dump_flows() of each, bitwise."""
    import torch

    for k, (sa, sb) in enumerate(zip(world_states(a, tids),
                                     world_states(b, tids))):
        for part in ("flow", "aff"):
            for f, x, y in zip(getattr(sa, part)._fields,
                               getattr(sa, part), getattr(sb, part)):
                if not torch.equal(x[:-1].cpu(), y[:-1].cpu()):
                    raise SystemExit(f"{what}: world {k} {part}.{f} "
                                     f"differs")
    if a.dump_flows(now) != b.dump_flows(now):
        raise SystemExit(f"{what}: dump_flows() differs")
    for t in tids:
        if a.tenant_dump_flows(t, now) != b.tenant_dump_flows(t, now):
            raise SystemExit(f"{what}: tenant_dump_flows({t}) differs")


def same_tenant_stats(a, b, tids, what):
    """Two engines' tenant_stats() on the fields a step does not meter."""
    ta, tb = a.tenant_stats(), b.tenant_stats()
    if any(ta[t][k] != tb[t][k] for t in tids
           for k in ("generation", "degraded", "occupied", "rule_words",
                     "word_off", "quota_slots")):
        raise SystemExit(f"{what}: tenant_stats() differs")


def drive_tenants(ps, services, pod_ips, tr, pool_tr, dev):
    """Phase 16: tenant worlds and the serving batcher at the headline
    width, restart from a persist dir, and the scalar twin.  Cuts for time
    (no width is cut): (e)'s engine holds one tenant per rule count (each
    commit rewrites the whole snapshot, ~50 MB of JSON with the headline
    PolicySet), and (c) runs on (d)'s one-pass engines, one tenant per rule
    count.
    -> (record, {kernel: record}, {window: (B1, B2, B3, B3h, S1)
    launches})."""
    import gc
    import os
    import shutil
    import tempfile
    import types

    import numpy as np
    import torch

    from antrea_tpu_torch.datapath import TpuflowDatapath, make_datapath
    from antrea_tpu_torch.datapath.commit import CanaryMismatchError
    from antrea_tpu_torch.datapath.tenancy import _sub_batch
    from antrea_tpu_torch.dissemination.faults import FaultPlan
    from antrea_tpu_torch.models import pipeline as pl
    from antrea_tpu_torch.ops.match import interval_rows, tables

    t16 = time.perf_counter()
    peak_before = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fields = step_fields()
    kw = dict(flow_slots=FLOW_SLOTS, miss_chunk=MISS_CHUNK, fused=True,
              canary_probes=ENGINE_PROBES, serving_batcher=True,
              canonical_sizes=LADDER)
    tq = dict(quota=TENANT_QUOTA, aff_quota=TENANT_AFF_QUOTA)
    rec, kern, launches = {}, {}, {}

    # (a) The tenant engine: the headline world and 12 tenant worlds.
    t0 = time.perf_counter()
    worlds = tenant_worlds()
    gen_s = time.perf_counter() - t0
    eng, build_s, _ = timed(lambda: TpuflowDatapath(
        world_copy(ps), services, device=dev, **kw))
    mem_default = torch.cuda.memory_allocated()
    tids, create_s = [], {n: [] for n in TENANT_RULES}
    for i, (n, c) in enumerate(worlds):
        tid, s, _ = timed(lambda: eng.tenant_create(
            f"t{n}-{i % TENANTS_PER_RUNG}", world_copy(c.ps), **tq))
        tids.append(tid)
        create_s[n].append(s)
    # Worlds of one rule count may still take several rungs: the padding
    # rounds each phase's capacity up to a power of two on its own.
    rungs = eng.tenant_rungs()
    if not len(TENANT_RULES) <= len(rungs) <= len(tids):
        raise SystemExit(f"tenants: {len(rungs)} rung signatures over "
                         f"{len(tids)} worlds")
    wbytes = {n: [] for n in TENANT_RULES}
    for (n, _), tid in zip(worlds, tids):
        f = eng._tenants.world(tid).fields
        wbytes[n].append(world_bytes(f["_drs"], f["_state"]))
    rec["a"] = dict(
        gen_s=gen_s, build_s=build_s, create_s=create_s,
        world_bytes=wbytes,
        default_world_bytes=world_bytes(eng._drs, eng._state),
        device_bytes_after=torch.cuda.memory_allocated(),
        device_bytes_default=mem_default, rungs=len(rungs))
    log(f"tenants (a): headline engine built in {build_s:.1f} s; "
        f"{len(tids)} tenant worlds generated in {gen_s:.1f} s; "
        + "; ".join(f"{n} rules: tenant_create "
                    f"{', '.join(f'{s:.2f}' for s in create_s[n])} s, "
                    f"{wbytes[n][0] / 2**20:.1f} MiB on the card a world"
                    for n in TENANT_RULES)
        + f"; {len(rungs)} rungs; device memory "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB (the default "
        f"world {mem_default / 2**30:.3f})")

    # (b) step_tenants on mixed B-lane batches: half the headline traffic
    # on the default world, half split evenly over the tenants.
    half = B // 2
    per = [half // len(tids) + (1 if i < half % len(tids) else 0)
           for i in range(len(tids))]
    parts = [sub_batch(tr, np.arange(half))] + [
        tenant_traffic(c, k, 200 + i, TENANT_FLOWS)
        for i, ((_, c), k) in enumerate(zip(worlds, per))]
    mb, lane_tids = mixed(parts, [0] + tids, 16)

    # The staged step_tenants card against CPU, before (b) and from fresh
    # worlds: (b)'s first CROSS_LANES lanes, cold then warm, through this
    # engine and a CPU engine given the same worlds; every StepResult
    # field, every world's tables, dump_flows(), tenant_dump_flows() and
    # tenant_stats() bitwise equal.  The card's worlds are fresh again
    # after.
    t0 = time.perf_counter()
    p = TpuflowDatapath(world_copy(ps), services, device="cpu", **kw)
    if [p.tenant_create(f"t{n}-{i % TENANTS_PER_RUNG}", world_copy(c.ps),
                        **tq) for i, (n, c) in enumerate(worlds)] != tids:
        raise SystemExit("staged tenants: tids differ card vs CPU")
    fresh = [pl.clone_state(s) for s in world_states(eng, tids)]
    xb = sub_batch(mb, np.arange(CROSS_LANES))
    xtids = lane_tids[:CROSS_LANES]
    xmiss = []
    for now in (NOWS[0] - 2, NOWS[0] - 1):
        rd = eng.step_tenants(xtids, xb, now)
        rp = p.step_tenants(xtids, xb, now)
        xmiss.append(rd.n_miss)
        what = f"staged step_tenants card vs CPU @{now}"
        same_result(rd, rp, what, fields)
        same_worlds(eng, p, tids, now, what)
        same_tenant_stats(eng, p, tids, what)
    set_world_states(eng, tids, fresh)
    del p, fresh
    gc.collect()
    rec["a_cross"] = dict(lanes=CROSS_LANES, n_miss=xmiss,
                          seconds=time.perf_counter() - t0)
    log(f"tenants (a): staged step_tenants on (b)'s first {CROSS_LANES} "
        f"mixed lanes, cold then warm (n_miss {xmiss}), card vs CPU engine "
        f"with the same {len(tids)} tenant worlds: every StepResult field, "
        f"every world's tables, dump_flows(), tenant_dump_flows() and "
        f"tenant_stats() bitwise equal ({rec['a_cross']['seconds']:.1f} s "
        f"with the CPU engine's build)")

    sigs, per_world, restore = recording_signatures(eng)
    st0 = eng.serving_stats()
    times, misses = [], []
    reset_counts()
    try:
        for now in NOWS:
            r, s, _ = timed(lambda: eng.step_tenants(lane_tids, mb, now))
            times.append(s)
            misses.append(r.n_miss)
            if r.code.shape != (B,) or not np.isin(r.code, (0, 1, 2)).all():
                raise SystemExit("step_tenants: bad verdict column")
    finally:
        restore()
    launches["b"] = counts5()
    in_tenants_b = tenant_launches(per_world)
    st1 = eng.serving_stats()
    n_disp = st1["dispatches"] - st0["dispatches"]
    n_pad = st1["padded_lanes"] - st0["padded_lanes"]
    n_flush = st1["flushed_lanes"] - st0["flushed_lanes"]
    distinct = set(sigs)
    bound = (len(rungs) + 1) * len(LADDER)
    if not 0 < len(distinct) <= bound:
        raise SystemExit(f"step_tenants: {len(distinct)} dispatch "
                         f"signatures, over rungs x ladder = {bound}")
    if in_tenants_b[0] == 0 or n_flush != B * len(NOWS):
        raise SystemExit(f"step_tenants: B1 launches {launches['b']}, "
                         f"{in_tenants_b[0]} in tenant worlds, {n_flush} "
                         f"lanes flushed")
    rb = step_stats(times)
    rb.update(dispatches_per_step=n_disp / len(NOWS),
              padded_share=n_pad / (n_flush + n_pad),
              signatures=len(distinct), signature_bound=bound,
              signature_lanes=sorted({n for _, n in distinct}),
              n_miss=misses, launches=list(launches["b"]),
              launches_in_tenant_worlds=list(in_tenants_b))
    ptimes = []
    for now in NOWS:
        r, s, _ = timed(lambda: eng.step(tr, now + len(NOWS)))
        ptimes.append(s)
    rb["plain_step"] = step_stats(ptimes)
    rec["b"] = rb
    log(f"tenants (b): step_tenants on {B} mixed lanes (half the headline "
        f"traffic, half over {len(tids)} tenants): cold "
        f"{rb['cold_ms']:.1f} ms, warm {rb['warm_ms']:.1f} ms, steady "
        f"median {rb['steady_ms']:.2f} ms (min {rb['steady_min_ms']:.2f}, "
        f"max {rb['steady_max_ms']:.2f}), {rb['steady_pps'] / 1e6:.2f} M "
        f"packets/s; {rb['dispatches_per_step']:.1f} dispatches a step, "
        f"padded share {rb['padded_share']:.3f}, {len(distinct)} dispatch "
        f"signatures (bound {bound}: {len(rungs)} tenant rungs and the "
        f"default world's, x {len(LADDER)} sizes), lane counts "
        f"{rb['signature_lanes']}; n_miss "
        f"{misses}; (B1, B2, B3, B3h, S1) launches {launches['b']}, "
        f"(B1, B2, B3) in tenant worlds {in_tenants_b}.  The same "
        f"engine's plain step on {B} default-world lanes: first "
        f"{rb['plain_step']['cold_ms']:.1f} ms, steady "
        f"{rb['plain_step']['steady_ms']:.2f} ms, "
        f"{rb['plain_step']['steady_pps'] / 1e6:.2f} M packets/s")

    # B1 against its plain version on a 25,000-rule tenant's rung-padded
    # staged tables, at that tenant's own fresh lanes' interval rows: 2048
    # lanes, and MISS_CHUNK, the round the staged step launches it on.
    big = TENANT_RULES.index(max(TENANT_RULES)) * TENANTS_PER_RUNG
    wf = eng._tenants.world(tids[big]).fields
    src, dst, proto, sport, dport = to_lanes(
        tenant_traffic(worlds[big][1], 2048, 250, 2048), dev)
    iv = interval_rows(wf["_drs"], src, dst, (proto << 16) | dport)
    mm = wf["_meta"].match
    for key, rows in (("b1", iv), ("b1_chunk", iv[:MISS_CHUNK])):
        kern[key] = check_consumer(
            tables(wf["_drs"]), rows, mm.svcref, mm.in_phases,
            mm.out_phases, f"tenant world of {worlds[big][0]} rules, "
            f"rung-padded, {rows.shape[0]} lanes", 5)
    del iv, wf

    # (e) Restart.  The never-restarted twin is the engine above, given the
    # same two installs; the restarted one writes its persist dir first.
    # Every commit rewrites the whole snapshot (the headline PolicySet is
    # ~50 MB of JSON), so the tenants and the tenant's install come before
    # the headline bundle: one large snapshot, not three.
    eng.tenant_install_bundle(tids[0], world_copy(worlds[0][1].ps))
    eng.install_bundle(ps=world_copy(ps))
    picks = [r * TENANTS_PER_RUNG for r in range(len(TENANT_RULES))]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_persist_")
    try:
        e = TpuflowDatapath(None, services, device=dev, persist_dir=tmp,
                            **kw)
        etids = [e.tenant_create(f"t{worlds[k][0]}", world_copy(
            worlds[k][1].ps), **tq) for k in picks]
        tg, tinstall_s, _ = timed(lambda: e.tenant_install_bundle(
            etids[0], world_copy(worlds[0][1].ps)))
        g, install_s, _ = timed(lambda: e.install_bundle(ps=world_copy(ps)))
        keys = ("name", "generation", "quota_slots", "queue_quota",
                "rule_words")
        specs = {t: {k: v[k] for k in keys}
                 for t, v in e.tenant_stats().items()}
        del e
        gc.collect()
        torch.cuda.empty_cache()
        rs, boot_s, _ = timed(lambda: TpuflowDatapath(
            persist_dir=tmp, device=dev, **kw))
        if rs.generation != g or g < 1 or tg != 1:
            raise SystemExit(f"restart: generation {rs.generation}, before "
                             f"the drop {g} (tenant {tg})")
        if rs._conf_store.backend != "native":
            raise SystemExit("restart: the round journal is not the native "
                             "store")
        got = {t: {k: v[k] for k in keys}
               for t, v in rs.tenant_stats().items()}
        if got != specs:
            raise SystemExit(f"restart: tenant worlds {got}, not {specs}")
        # (f), the headline world's part: TWIN_HEADLINE_LANES fresh flows
        # through the scalar twin and through the restarted engine, whose
        # cache the restart emptied.
        fresh = sub_batch(pool_tr, np.arange(TWIN_HEADLINE_LANES))
        twin, twin_build_s, _ = timed(lambda: make_datapath(
            "oracle", world_copy(ps), services, flow_slots=FLOW_SLOTS,
            canary_probes=0))
        rt, twin_step_s, _ = timed(lambda: twin.step(fresh, 90))
        rr, eng_step_s, _ = timed(lambda: rs.step(fresh, 90))
        same_result(rr, rt, "twin, headline lanes", fields=fields)
        del twin
        now = NOWS[-1] + 2 * len(NOWS) + 1
        for k in range(2):
            r_rs = rs.step(tr, now + k)
            r_tw = eng.step(tr, now + k)
        same_result(r_rs, r_tw, "restart vs never restarted",
                    fields=("code",))
        for k, et in zip(picks, etids):
            b = parts[1 + k]
            for j in range(2):
                r_rs = rs.tenant_step(et, b, now + j)
                r_tw = eng.tenant_step(tids[k], b, now + j)
            same_result(r_rs, r_tw, f"restart, tenant {et}",
                        fields=("code",))
        rec["e"] = dict(boot_s=boot_s, install_s=install_s,
                        tenant_install_s=tinstall_s, generation=g,
                        snapshot_bytes=os.path.getsize(os.path.join(
                            tmp, "datapath_snapshot.json")))
        rec["f_headline"] = dict(lanes=TWIN_HEADLINE_LANES,
                                 twin_build_s=twin_build_s,
                                 twin_ms=twin_step_s * 1e3,
                                 engine_ms=eng_step_s * 1e3)
        log(f"restart (e): headline bundle installed with its snapshot in "
            f"{install_s:.1f} s ({rec['e']['snapshot_bytes'] / 1e6:.1f} MB "
            f"of JSON), the tenant's in {tinstall_s:.1f} s; rebuilt from "
            f"the dir in {boot_s:.1f} s: generation {rs.generation}, "
            f"{len(got)} tenant worlds with their tids, specs and "
            f"generations, native round journal; from the second step on, "
            f"the headline batch's and each tenant's codes and rule ids "
            f"equal the never-restarted engine's")
        log(f"twin (f): {TWIN_HEADLINE_LANES} fresh headline lanes, every "
            f"StepResult field equal to the restarted engine's; twin built "
            f"in {twin_build_s:.1f} s, its step {twin_step_s * 1e3:.0f} ms, "
            f"the engine's {eng_step_s * 1e3:.1f} ms")
        del rs
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del eng, parts, mb
    gc.collect()
    torch.cuda.empty_cache()

    # (c), (d): one-pass engines on the card and on the CPU, the headline
    # world and one tenant per rule count.
    okw = dict(kw, flow_slots=ONEPASS_SLOTS, prune_budget=PRUNE_K,
               ct_timeout_s=3600)
    sel = [worlds[k] for k in picks]
    d, build_d, _ = timed(lambda: TpuflowDatapath(
        world_copy(ps), services, device=dev, **okw))
    p = TpuflowDatapath(world_copy(ps), services, device="cpu", **okw)
    dt = [d.tenant_create(f"t{n}", world_copy(c.ps), **tq) for n, c in sel]
    if [p.tenant_create(f"t{n}", world_copy(c.ps), **tq)
            for n, c in sel] != dt:
        raise SystemExit("one-pass tenants: tids differ card vs CPU")
    half = CROSS_LANES // 2
    per = [half // len(dt) + (1 if i < half % len(dt) else 0)
           for i in range(len(dt))]
    cparts = [sub_batch(tr, np.arange(half))] + [
        tenant_traffic(c, k, 300 + i) for i, ((_, c), k) in
        enumerate(zip(sel, per))]
    cb, clanes = mixed(cparts, [0] + dt, 17)
    # The launch counts are those of the card's step_tenants alone: set to
    # 0 just before each and read just after, before the CPU engine's step
    # and the unbatched replays.
    launches["c"] = (0,) * 5
    in_tenants_c = (0, 0, 0)
    for now in (500, 501):
        pre = [pl.clone_state(s) for s in world_states(d, dt)]
        _, per_world, restore = recording_signatures(d)
        reset_counts()
        try:
            rd = d.step_tenants(clanes, cb, now)
        finally:
            restore()
        launches["c"] = add_counts(launches["c"], counts5())
        in_tenants_c = add_counts(in_tenants_c, tenant_launches(per_world))
        rp = p.step_tenants(clanes, cb, now)
        same_result(rd, rp, f"step_tenants card vs CPU @{now}", fields)
        same_worlds(d, p, dt, now, f"step_tenants card vs CPU @{now}")
        # (The replay below steps the card's worlds once more, so the
        # meters that count steps differ from the second round on.)
        same_tenant_stats(d, p, dt, "step_tenants card vs CPU")
        # Lane for lane against unbatched dispatch from the same states.
        post = world_states(d, dt)
        set_world_states(d, dt, pre)
        n_miss = 0
        for tid in [0] + dt:
            idx = np.nonzero(clanes == tid)[0]
            sub = _sub_batch(cb, idx)
            u = (d.step(sub, now) if tid == 0
                 else d.tenant_step(tid, sub, now))
            n_miss += u.n_miss
            same_result(u, types.SimpleNamespace(**{
                f: (None if getattr(rd, f) is None or f == "n_miss"
                    else np.asarray(getattr(rd, f))[idx]) for f in fields},
                ingress_rule=[rd.ingress_rule[i] for i in idx],
                egress_rule=[rd.egress_rule[i] for i in idx]),
                f"step_tenants vs unbatched, world {tid} @{now}",
                tuple(f for f in fields if f != "n_miss"))
        if n_miss != rd.n_miss:
            raise SystemExit(f"step_tenants n_miss {rd.n_miss}, unbatched "
                             f"{n_miss}")
        set_world_states(d, dt, post)
    b3_tenants = in_tenants_c[2]
    if launches["c"][2] == 0 or b3_tenants == 0:
        raise SystemExit(f"one-pass tenants: B3 launches {launches['c']}, "
                         f"{b3_tenants} inside tenant worlds")
    padded_c = d.serving_stats()["padded_lanes"]
    log(f"tenants (c): {CROSS_LANES} mixed lanes ({half} default, "
        f"{per} over {len(dt)} tenants, one per rule count) cold then warm "
        f"through step_tenants on the one-pass engine, card vs CPU: every "
        f"StepResult field, every world's tables, dump_flows(), "
        f"tenant_dump_flows() and tenant_stats() bitwise equal, and lane "
        f"for lane equal to unbatched step/tenant_step from the same "
        f"states; padded lanes {padded_c}; the card's step_tenants "
        f"launched (B1, B2, B3, B3h, S1) {launches['c']}, (B1, B2, B3) "
        f"{in_tenants_c} of them inside tenant worlds")
    del p
    gc.collect()

    # B2 and B3 against their plain versions on the 25,000-rule tenant's
    # rung-padded pruned tables (its aggregate rows and its own lanes).
    wf = d._tenants.world(dt[-1]).fields
    step_t = types.SimpleNamespace(meta=wf["_meta"])
    tl = to_lanes(tenant_traffic(sel[-1][1], 2048, 350, 2048), dev)
    x, otabs, ost, hit = onepass_inputs(step_t, wf["_state"], wf["_drs"],
                                        d._dsvc, tl, 510)
    iv, g_in, g_out = lane_probes(x, otabs, ost, hit)
    mm = wf["_meta"].match
    kern["b2"] = check_pruned(g_in, g_out, iv, otabs.inc, PRUNE_K,
                              mm.svcref, mm.in_phases, mm.out_phases, 5)
    del x, iv, g_in, g_out
    kern["b3"] = check_onepass(step_t, wf["_state"], wf["_drs"], d._dsvc,
                               tl, 510, f"tenant world of {sel[-1][0]} "
                               f"rules, rung-padded")
    del wf, tl

    # (d) A tenant install through the canary (B2 on the pruned tables),
    # then a forced canary veto on another tenant: only that world rolls
    # back.
    reset_counts()
    if d.tenant_install_bundle(dt[0], world_copy(sel[0][1].ps)) != 1:
        raise SystemExit("one-pass tenants: install did not commit")
    launches["d_canary"] = counts5()
    if launches["d_canary"][1] == 0:
        raise SystemExit("one-pass tenants: the install's canary launched "
                         "no B2")
    victim = d._tenants.world(dt[1]).fields
    kept = (victim["_state"], victim["_drs"])
    plan = FaultPlan(seed=1)
    plan.after("dp.canary", 0, "fail", times=1)
    d.arm_commit_faults(plan, "dp")
    try:
        d.tenant_install_bundle(dt[1], world_copy(sel[1][1].ps))
        raise SystemExit("one-pass tenants: the forced veto did not fire")
    except CanaryMismatchError:
        pass
    st = d.tenant_stats()
    victim = d._tenants.world(dt[1]).fields
    if (st[dt[1]]["degraded"] != 1 or st[dt[1]]["generation"] != 0
            or st[dt[0]]["generation"] != 1 or st[dt[0]]["degraded"]
            or st[dt[2]]["degraded"] or d.degraded or d.generation != 0
            or victim["_state"] is not kept[0]
            or victim["_drs"] is not kept[1]):
        raise SystemExit(f"one-pass tenants: the veto reached beyond its "
                         f"world: {st}")
    r = d.tenant_step(dt[1], cparts[2], 520)
    if not np.isin(r.code, (0, 1, 2)).all():
        raise SystemExit("one-pass tenants: the vetoed world does not serve")
    rec["cd"] = dict(build_s=build_d, launches=list(launches["c"]),
                     launches_in_tenant_worlds=list(in_tenants_c),
                     canary_launches=list(launches["d_canary"]),
                     padded_lanes=padded_c)
    log(f"tenants (d): one-pass engine built in {build_d:.1f} s; a tenant "
        f"install's canary launched (B1, B2, B3, B3h, S1) "
        f"{launches['d_canary']}; a "
        f"forced canary veto on tenant {dt[1]} rolled back and degraded "
        f"that world alone (its tables kept by reference), which serves on")
    del d, victim, kept
    gc.collect()
    torch.cuda.empty_cache()

    # (f) The twin on the 8,000-rule tenant's PolicySet against the port's
    # engine on the card, cold then warm.
    n8, c8 = worlds[TENANTS_PER_RUNG]
    e8 = TpuflowDatapath(world_copy(c8.ps), device=dev, miss_chunk=MISS_CHUNK,
                         fused=True, canary_probes=0,
                         flow_slots=TENANT_QUOTA, aff_slots=TENANT_AFF_QUOTA)
    tw8 = make_datapath("oracle", world_copy(c8.ps), canary_probes=0,
                        flow_slots=TENANT_QUOTA, aff_slots=TENANT_AFF_QUOTA)
    b8 = tenant_traffic(c8, TWIN_LANES, 400, TWIN_LANES // 2)
    f8 = {}
    for now, what in ((600, "cold"), (601, "warm")):
        rt, ts, _ = timed(lambda: tw8.step(b8, now))
        re_, es, _ = timed(lambda: e8.step(b8, now))
        same_result(re_, rt, f"twin, {n8}-rule world, {what}", fields)
        f8[what] = dict(twin_ms=ts * 1e3, engine_ms=es * 1e3)
    if sorted(map(str, e8.dump_flows(602))) != sorted(
            map(str, tw8.dump_flows(602))):
        raise SystemExit("twin: dump_flows() differs")
    rec["f"] = f8
    log(f"twin (f): make_datapath('oracle') on the {n8}-rule tenant's "
        f"PolicySet against the engine on the card, {TWIN_LANES} lanes: "
        f"every StepResult field and dump_flows() equal; cold twin "
        f"{f8['cold']['twin_ms']:.0f} ms, engine "
        f"{f8['cold']['engine_ms']:.1f} ms; warm twin "
        f"{f8['warm']['twin_ms']:.0f} ms, engine "
        f"{f8['warm']['engine_ms']:.1f} ms")
    del e8, tw8
    gc.collect()
    torch.cuda.empty_cache()
    rec["peak_bytes"] = torch.cuda.max_memory_allocated()
    rec["script_peak_bytes"] = max(peak_before, rec["peak_bytes"])
    rec["seconds"] = time.perf_counter() - t16
    log(f"phase 16 took {rec['seconds']:.1f} s; peak device memory in the "
        f"phase {rec['peak_bytes'] / 2**30:.3f} GiB, in the script "
        f"{rec['script_peak_bytes'] / 2**30:.3f} GiB")
    return rec, kern, launches


# ---- phase 17: the mesh engine (parallel/meshpath.MeshDatapath) ----------
# The shapes: (n_data, n_rule), the mode, its knobs and the flow slots per
# replica (the same global capacity, 2**22).
MESH_SHAPES = (((1, 1), "one-pass", dict(fused=True, prune_budget=PRUNE_K),
                FLOW_SLOTS),
               ((1, 2), "one-pass", dict(fused=True, prune_budget=PRUNE_K),
                FLOW_SLOTS),
               ((2, 1), "staged fused", dict(fused=True), FLOW_SLOTS // 2))
VERDICT_FIELDS = ("code", "svc_idx", "dnat_ip", "dnat_port")


class KernelInputs:
    """While active, records the arguments of the first call of each kernel
    wrapper (B1 consumer.fused_hits, B2 pruned_consumer.pruned_hits, B3 and
    B3h onepass.onepass) per rule shard, keyed (kernel, w0); the wrappers
    run and count as usual.  The callers look the wrappers up on their
    modules at each call, so the recording sees the step's own calls."""

    SITES = (("consumer", "fused_hits", "B1"),
             ("pruned_consumer", "pruned_hits", "B2"),
             ("onepass", "onepass", "B3"))

    def __init__(self):
        self.seen = {}
        self._saved = []

    def __enter__(self):
        import importlib
        import inspect

        for mod_name, fn_name, tag in self.SITES:
            mod = importlib.import_module(f"antrea_tpu_torch.ops.{mod_name}")
            real = getattr(mod, fn_name)
            self._saved.append((mod, fn_name, real))
            setattr(mod, fn_name, self._wrap(tag, real,
                                             inspect.signature(real)))
        return self

    def _wrap(self, tag, real, sig):
        def call(*a, **k):
            got = sig.bind(*a, **k)
            got.apply_defaults()
            arg = got.arguments
            if arg.get("resolve") is False:
                tag_ = "B3h"
            else:
                tag_ = tag
            self.seen.setdefault((tag_, (int(arg["w0_in"]),
                                         int(arg["w0_out"]))), arg)
            return real(*a, **k)

        return call

    def __exit__(self, *exc):
        for mod, fn_name, real in self._saved:
            setattr(mod, fn_name, real)
        self._saved = []


def rows_digest(state) -> int:
    """The digest of a state's tables without their dump rows (the scratch
    row masked lanes write, which any of them may win)."""
    from antrea_tpu_torch.models import pipeline as pl

    return pl.tensor_digest(t[:-1] for t in pl.tree_leaves(state))


def check_recorded(seen, shape, inner):
    """Each kernel call recorded in a mesh step (KernelInputs) held bitwise
    against its plain version on the same inputs -> {name: record}."""
    out = {}
    for (tag, w0), a in sorted(seen.items()):
        what = f"mesh {shape[0]}x{shape[1]}, rule shard at w0={w0}"
        if tag == "B3h":
            out[f"B3h w0={w0}"] = check_hits_only(
                a["x"], a["tabs"], a["st"], a["now"], w0, what,
                gen_w=a["gen_w"])
        elif tag == "B1":
            out[f"B1 w0={w0}"] = check_consumer(
                a["tabs"], a["iv"], a["svcref"], a["in_phases"],
                a["out_phases"], f"{what}, {a['iv'].shape[0]} lanes",
                inner, w0=w0)
        elif tag == "B2":
            out[f"B2 w0={w0}"] = check_pruned(
                a["g_in"], a["g_out"], a["iv"], a["tabs"],
                max(a["ke_in"], a["ke_out"]), a["svcref"], a["in_phases"],
                a["out_phases"], inner, w0=w0)
        else:
            raise SystemExit(f"mesh {shape}: B3's resolve variant ran in a "
                             f"mesh step")
    return out


def drive_mesh_engine(ps, services, pod_ips, tr, dev, kept13):
    """Phase 17: the mesh engine on the card at (1, 1) and (1, 2) one-pass
    and (2, 1) staged fused, one engine at a time, each stepped on the
    headline traffic (cold, warm, STEADY_STEPS steady) with every launch
    count set to 0 just before the first step and read just after the last.
    (1, 1) is held to phase 13's one-pass engine on the same steps (every
    StepResult field, dump_flows(), cache_stats()), (1, 2) to (1, 1) (every
    field, the state digest, its two rule shards' state copies), (2, 1)'s
    verdicts to (1, 1)'s.  The kernels each cold step called are held
    against their plain versions on the recorded inputs; B2 on the
    replica-resolved canary of (1, 2); corrupt_replica(1) on (2, 1) must
    make canary_scan report replica 1 and degrade the engine.
    -> (records by shape, kernel records)."""
    import gc

    import torch

    from antrea_tpu_torch.parallel import MeshDatapath

    t17 = time.perf_counter()
    hb = engine_batch(tr.src_ip, tr.dst_ip, tr.proto, tr.src_port,
                      tr.dst_port, pod_ips)
    recs, kernels = {}, {}
    first = None
    for shape, what, knobs, slots in MESH_SHAPES:
        name = f"{shape[0]}x{shape[1]}"
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        eng = MeshDatapath(world_copy(ps), services, device=dev,
                           n_data=shape[0], n_rule=shape[1],
                           flow_slots=slots, miss_chunk=MISS_CHUNK,
                           canary_probes=ENGINE_PROBES,
                           topology=node0_spec(pod_ips), **knobs)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        results, times = [], []
        recorder = KernelInputs()
        reset_counts()
        for i, now in enumerate(NOWS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if i == 0:
                with recorder:
                    r = eng.step(hb, now)
            else:
                r = eng.step(hb, now)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            results.append(r)
        launches = counts5()
        rec = step_stats(times)
        peak = torch.cuda.max_memory_allocated() / 2**30
        ms = eng.mesh_stats()
        cache = eng.cache_stats()
        rec.update(shape=list(shape), mode=what, flow_slots=slots,
                   build_s=build_s, launches=list(launches),
                   peak_gib=peak, n_miss=[x.n_miss for x in results],
                   spill_lanes_total=ms["spill_lanes_total"],
                   spill_retried_total=ms["spill_retried_total"],
                   cache_slots=cache["slots"])
        if launches[2] != 0:
            raise SystemExit(f"mesh {name}: B3 (resolve) launched "
                             f"{launches[2]} times in the mesh steps")
        if what == "one-pass" and not launches[3]:
            raise SystemExit(f"mesh {name}: B3h never launched")
        if what != "one-pass" and not launches[0]:
            raise SystemExit(f"mesh {name}: B1 never launched")
        if cache["slots"] != FLOW_SLOTS:
            raise SystemExit(f"mesh {name}: {cache['slots']} slots")
        if shape == (1, 1):
            for k, (a, b) in enumerate(zip(results, kept13["results"])):
                same_result(a, b, f"mesh 1x1 vs phase 13, step {k}",
                            fields=RESULT_FIELDS + ("punt", "mcast_idx",
                                                    "l7_redirect",
                                                    "dec_ttl"))
                if a.n_miss != b.n_miss:
                    raise SystemExit(f"mesh 1x1 vs phase 13: n_miss {k}")
            dump = eng.dump_flows(NOWS[-1])
            if dump != kept13["dump"] or cache != kept13["cache"]:
                raise SystemExit("mesh 1x1 vs phase 13: dump_flows or "
                                 "cache_stats differ")
            first = dict(results=results, dump=dump, cache=cache,
                         digest=rows_digest(eng._state[0][0]))
            log(f"mesh engine 1x1: every StepResult field of the "
                f"{len(NOWS)} steps, dump_flows ({len(dump)} entries) and "
                f"cache_stats bitwise equal to phase 13's engine")
        elif shape == (1, 2):
            for k, (a, b) in enumerate(zip(results, first["results"])):
                same_result(a, b, f"mesh 1x2 vs 1x1, step {k}",
                            fields=RESULT_FIELDS + ("punt", "mcast_idx",
                                                    "l7_redirect",
                                                    "dec_ttl"))
            copies = {rows_digest(c) for c in eng._state[0]}
            if (copies != {first["digest"]}
                    or eng.dump_flows(NOWS[-1]) != first["dump"]):
                raise SystemExit("mesh 1x2: state differs from 1x1's, or "
                                 "its rule shards' copies differ")
            rec["w0"] = [list(w) for w in eng._drs.w0]
            log(f"mesh engine 1x2: every StepResult field and the state "
                f"bitwise equal to 1x1; rule shards at w0 {rec['w0']}, "
                f"their state copies equal")
        else:
            for k, (a, b) in enumerate(zip(results, first["results"])):
                same_result(a, b, f"mesh 2x1 vs 1x1, step {k}",
                            fields=VERDICT_FIELDS)
            est = sum(int((a.est != b.est).sum())
                      for a, b in zip(results, first["results"]))
            rec["est_lanes_differing_from_1x1"] = est
            log(f"mesh engine 2x1: verdicts, DNAT and rule ids bitwise "
                f"equal to 1x1 ({est} lane-steps differ in est: the "
                f"replicas' private tables collide differently)")
        log(f"mesh engine {name} ({what}): built in {build_s:.1f} s; cold "
            f"{rec['cold_ms']:.1f} ms, warm {rec['warm_ms']:.2f} ms, "
            f"steady median {rec['steady_ms']:.3f} ms/step (min "
            f"{rec['steady_min_ms']:.3f}, max {rec['steady_max_ms']:.3f}), "
            f"{rec['steady_pps'] / 1e6:.2f} M packets/s; (B1, B2, B3, B3h, "
            f"S1) launches {launches}; spilled {ms['spill_lanes_total']} "
            f"lanes, retried {ms['spill_retried_total']}; peak device "
            f"memory {peak:.3f} GiB")
        del results
        kernels[name] = check_recorded(recorder.seen, shape, 2)
        if shape == (1, 2):
            # B2: the replica-resolved canary on the pruned rule shards.
            recorder = KernelInputs()
            reset_counts()
            with recorder:
                scan = eng.canary_scan(now=NOWS[-1], recover=False)
            rec["canary_launches"] = list(counts5())
            if scan["mismatches"] or scan["degraded"] or not counts()[1]:
                raise SystemExit(f"mesh 1x2 canary: {scan}, launches "
                                 f"{rec['canary_launches']}")
            kernels["1x2 canary"] = check_recorded(
                {k: v for k, v in recorder.seen.items() if k[0] == "B2"},
                shape, 20)
        if shape == (2, 1):
            desc = eng.corrupt_replica(1)
            scan = eng.canary_scan(now=NOWS[-1], recover=False)
            mism = eng.commit_stats()["replica_mismatches"]
            if not (scan["mismatches"] and scan["degraded"]
                    and set(mism) == {1}):
                raise SystemExit(f"mesh 2x1: corrupt_replica(1) not caught: "
                                 f"{scan}, {mism}")
            rec["replica_veto"] = {"scan": scan, "replica_mismatches": mism}
            log(f"mesh engine 2x1: {desc}; canary_scan {scan}, replica "
                f"mismatches {mism}")
        recs[name] = rec
        del eng
    gc.collect()
    torch.cuda.empty_cache()
    p13 = kept13["rec"]
    log(f"phase 13's one-pass engine beside it: cold {p13['cold_ms']:.1f} "
        f"ms, warm {p13['warm_ms']:.2f} ms, steady "
        f"{p13['steady_ms']:.3f} ms/step; phase 17 took "
        f"{time.perf_counter() - t17:.1f} s")
    return recs, kernels



# ---- phase 18: live resize and replica-loss failover on the mesh engine ----
# A replica's flow slots (the (2, 1) engine's global capacity is 2**22, as
# phase 17's), and the rows a maintenance tick migrates: the grow from
# (2, 1) walks its 2**22 global slots in 4 ticks, the shrink from (4, 1)
# its 2**23 in 8.
RESIZE_SLOTS = FLOW_SLOTS // 2
RESHARD_BUDGET = 1 << 20
# The failover plane's knobs: quarantine on 2 failed probe rounds, readmit
# after 2 quiet ones, retry a vetoed evacuation after 2 ticks.  Its
# deadlines are far above any step or probe round of this script (a cold
# staged step takes ~3 s), so only the FaultPlan kills the replica.
FAILOVER_KNOBS = dict(probe_fails=2, readmit_passes=2, retry_ticks=2,
                      probe_deadline_s=60.0, dispatch_deadline_s=120.0)
# Steady steps timed before and after a resize.
RESIZE_STEADY = 3
# Fresh-flow lanes of the churn batch stepped before each tick of (a).
RESIZE_CHURN = 4096
# Canary probes of phase 18's engines: every maintenance tick's watchdog
# canary walks its probes through the scalar Oracle at 100k rules, a tick's
# main cost (phase 14: 1.7-3.3 s with 8), and a resize takes 5-12 ticks.
# A corrupted target replica flips every probe's verdict (phase 17 found 8
# of 8), so 2 still veto it.
RESIZE_PROBES = 2
# A resize or a failover arc that takes more maintenance ticks fails.
MAX_TICKS = 40
# Lanes of session-affinity services that may reach another endpoint than
# the (1, 1) reference's in all of phase 18 (each held to the scalar Oracle
# at its endpoint, StickyWitness); more fail the phase.
MAX_STICKY_LANES = 32


class PhaseLaunches:
    """Launch counts of the engine under test, summed over its calls: each
    call runs with every count set to 0 just before and read just after,
    so the reference engine's steps and the plain-version checks between
    them never count.  `witness` holds the lanes whose endpoint differs
    from the reference's (StickyWitness)."""

    def __init__(self, witness):
        self.total = [0, 0, 0, 0, 0]
        self.steps = 0  # steps held to the reference (pair_step)
        self.sticky = 0  # their affinity lanes whose DNAT differed
        self.witness = witness

    def run(self, fn, *a, **k):
        reset_counts()
        out = fn(*a, **k)
        self.total = [x + y for x, y in zip(self.total, counts5())]
        return out


class AdvanceLog:
    """Times each run of the engine's reshard-migrate task (the plane's
    advance: a migration window, or the certified cutover) with the card
    synchronized around it: phase before, seconds, rows migrated (every
    world's), target width and outcome; a cutover's stages (catch-up,
    target canary and audit, flip) timed apart."""

    STAGES = ("_catchup", "_certify", "_audit_target", "_flip")

    def __init__(self, eng):
        import torch

        self.calls = []
        real = eng._maint_reshard

        def staged(plane, stages):
            for name in self.STAGES:
                fn = getattr(plane, name)

                def timed(*a, _fn=fn, _name=name, **k):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    try:
                        return _fn(*a, **k)
                    finally:
                        torch.cuda.synchronize()
                        stages[_name] = (stages.get(_name, 0.0)
                                         + time.perf_counter() - t0)

                setattr(plane, name, timed)

        def run(now, budget):
            plane = eng._reshard
            if plane is None:
                return real(now, budget)
            phase = plane.status()["phase"]
            before = plane.migrated_rows + plane.tenant_rows()
            stages = {}
            if phase == "ready":
                staged(plane, stages)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            spent = real(now, budget)
            torch.cuda.synchronize()
            self.calls.append(dict(
                phase=phase, s=time.perf_counter() - t0, now=int(now),
                rows=plane.migrated_rows + plane.tenant_rows() - before,
                n_to=plane.dst_n, done=plane.done, aborted=plane.aborted,
                stages_ms={k: v * 1e3 for k, v in stages.items()}))
            return spent

        # The task is registered with the bound attribute at each
        # reshard_begin (and at the failover plane's own resizes).
        eng._maint_reshard = run

    def summary(self, since=0) -> dict:
        calls = self.calls[since:]
        mig = [c for c in calls if c["phase"] == "migrate"]
        cut = [c for c in calls if c["phase"] == "ready"]
        rows, secs = sum(c["rows"] for c in mig), sum(c["s"] for c in mig)
        return dict(migrate_ticks=len(mig),
                    migrate_ms=[c["s"] * 1e3 for c in mig],
                    migrate_rows=rows,
                    rows_per_s=rows / secs if secs else 0.0,
                    cutover_ms=[c["s"] * 1e3 for c in cut],
                    cutover_stages_ms=[c["stages_ms"] for c in cut],
                    cutover_outcome=["flipped" if c["done"] else "aborted"
                                     for c in cut])


class TargetCanaryInputs:
    """Records the kernel inputs of the first replica-resolved canary that
    runs on a resize's TARGET placement (the plane sets the engine's
    _reshard_canary redirect around it) -> KernelInputs.seen."""

    def __init__(self, eng):
        self.rec = KernelInputs()
        self.done = False
        real = eng._canary_classify

        def call(batch, now):
            if eng._reshard_canary is None or self.done:
                return real(batch, now)
            self.done = True
            with self.rec:
                return real(batch, now)

        eng._canary_classify = call


def resize_batches(tr, pool_tr, pod_ips):
    """(the headline batch, churn(k): the k-th RESIZE_CHURN-lane slice of
    the fresh-flow pool, wrapping)."""
    hb = engine_batch(tr.src_ip, tr.dst_ip, tr.proto, tr.src_port,
                      tr.dst_port, pod_ips)

    def churn(k):
        k %= POOL // RESIZE_CHURN
        sl = slice(k * RESIZE_CHURN, (k + 1) * RESIZE_CHURN)
        return engine_batch(pool_tr.src_ip[sl], pool_tr.dst_ip[sl],
                            pool_tr.proto[sl], pool_tr.src_port[sl],
                            pool_tr.dst_port[sl], pod_ips)

    return hb, churn


class StickyWitness:
    """The second witness for a lane where the engine under test and the
    (1, 1) reference reach different endpoints of a session-affinity
    service.  Each data replica keeps its own affinity table, so a client's
    sticky endpoint is found only on the replica its earlier flow homed on
    (or lost to a collision another table shape does not have): a fresh
    flow homed elsewhere picks its endpoint anew, and its verdict and rules
    follow that endpoint.  The JAX package's MeshDatapath differs from its
    (1, 1) engine the same way (tests/test_torch_mesh_affinity.py).  On
    such a lane each engine's endpoint must be one of the service's, and
    its code and rule ids those the scalar Oracle gives the packet at that
    endpoint; at most `cap` such lanes in all."""

    def __init__(self, ps, services, cap=MAX_STICKY_LANES):
        self.ps, self.services, self.cap = ps, services, cap
        self.lanes = 0
        self._po = None

    def check(self, batch, i, res, what):
        from antrea_tpu_torch.oracle.pipeline import PipelineOracle
        from antrea_tpu_torch.packet import Packet
        from antrea_tpu_torch.utils import ip as iputil

        if self._po is None:
            self._po = PipelineOracle(self.ps, self.services)
        prog = self._po.programs[int(res.svc_idx[i])]
        ep = (int(res.dnat_ip[i]), int(res.dnat_port[i]))
        if ep not in {(iputil.ip_to_key(e.ip), e.port)
                      for e in prog.endpoints}:
            raise SystemExit(f"{what}: lane {i} reached {ep}, not an "
                             f"endpoint of its service")
        p = batch.packet(int(i))
        v = self._po.oracle.classify(
            Packet(src_ip=p.src_ip, dst_ip=ep[0], proto=p.proto,
                   src_port=p.src_port, dst_port=ep[1]), svc_ref=prog.ref)
        got = (int(res.code[i]), res.ingress_rule[i], res.egress_rule[i])
        want = (int(v.code), v.ingress.rule, v.egress.rule)
        if got != want:
            raise SystemExit(f"{what}: lane {i} at its endpoint {ep}: "
                             f"(code, ingress rule, egress rule) {got}, the "
                             f"Oracle's {want}")


def same_verdicts(a, b, what, batch, witness, aff) -> int:
    """Every lane's service equal; DNAT equal on every lane whose service
    keeps no session affinity (`aff`: each service's affinity timeout);
    code and rule ids equal on every lane whose DNAT is equal; on each lane
    whose DNAT differs, both engines held to the witness (StickyWitness)
    -> the number of such lanes."""
    import numpy as np

    if not np.array_equal(a.svc_idx, b.svc_idx):
        raise SystemExit(f"engine {what}: svc_idx differs")
    svc = np.asarray(a.svc_idx)
    sticky = (svc >= 0) & (aff[np.clip(svc, 0, None)] > 0)
    moved = ((np.asarray(a.dnat_ip) != np.asarray(b.dnat_ip))
             | (np.asarray(a.dnat_port) != np.asarray(b.dnat_port)))
    if (moved & ~sticky).any():
        raise SystemExit(f"engine {what}: DNAT differs on "
                         f"{int((moved & ~sticky).sum())} lanes of services "
                         f"without session affinity")
    keep = ~moved
    if not np.array_equal(np.asarray(a.code)[keep], np.asarray(b.code)[keep]):
        raise SystemExit(f"engine {what}: code differs")
    for f in ("ingress_rule", "egress_rule"):
        x, y = getattr(a, f), getattr(b, f)
        if [r for r, k in zip(x, keep) if k] != [r for r, k in zip(y, keep)
                                                  if k]:
            raise SystemExit(f"engine {what}: rule attribution differs")
    for i in np.nonzero(moved)[0]:
        witness.check(batch, i, a, f"engine {what}")
        witness.check(batch, i, b, f"reference {what}")
    witness.lanes += int(moved.sum())
    if witness.lanes > witness.cap:
        raise SystemExit(f"engine {what}: {witness.lanes} lanes of affinity "
                         f"services reached another endpoint than the "
                         f"reference's, more than {witness.cap}")
    return int(moved.sum())


def pair_step(eng, ref, batch, now, what, acc, recorder=None):
    """One step of the engine under test (its launches counted, the card
    synchronized around it) and of the (1, 1) reference on the same batch,
    their verdicts held equal (same_verdicts; acc counts the steps and the
    affinity lanes whose DNAT differs, held to acc.witness) -> (result,
    seconds)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if recorder is not None:
        with recorder:
            r = acc.run(eng.step, batch, now)
    else:
        r = acc.run(eng.step, batch, now)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    acc.sticky += same_verdicts(r, ref.step(batch, now), what, batch,
                                acc.witness,
                                eng._dsvc.aff_timeout.cpu().numpy())
    acc.steps += 1
    return r, dt


def copies_equal(eng) -> bool:
    """Every rule shard's copy of each replica's state equal (dump rows
    excluded)."""
    return all(len({rows_digest(c) for c in row}) == 1 for row in eng._state)


def need_kernels(got, tags, what):
    """Raise unless check_recorded held each kernel of `tags` against its
    plain version in `what` (got: its {name: record})."""
    have = {name.split()[0] for name in got}
    missing = [t for t in tags if t not in have]
    if missing:
        raise SystemExit(f"phase 18 {what}: {missing} not recorded and "
                         f"held to the plain version (held: {sorted(got)})")
    return got


def drive_resize(ps, services, pod_ips, tr, pool_tr, dev):
    """Phase 18: (a) a staged fused (2, 1) engine grows to 4 replicas and
    shrinks back to 2 under the headline batch and a churn batch a tick;
    (b) a grow vetoed by corrupt_target(1); (c) a one-pass (2, 1) engine
    with failover=True: replica 1 killed (FaultPlan), quarantined, masked,
    evacuated to 1 replica, readmitted to 2 once its site goes quiet.  Every
    step's verdicts, DNAT and rule ids equal to a (1, 1) reference engine
    on the same batches, or on a lane of a session-affinity service whose
    endpoint differs, to the scalar Oracle at its endpoint (StickyWitness).
    -> (record, kernel records, launches by part)."""
    import gc

    import torch

    from antrea_tpu_torch.dissemination.faults import FaultPlan
    from antrea_tpu_torch.parallel import MeshDatapath

    t18 = time.perf_counter()
    hb, churn = resize_batches(tr, pool_tr, pod_ips)
    kw = dict(n_rule=1, miss_chunk=MISS_CHUNK, canary_probes=RESIZE_PROBES,
              topology=node0_spec(pod_ips), reshard_budget=RESHARD_BUDGET)
    rec, kern, launches = {}, {}, {}
    witness = StickyWitness(ps, services)

    def build(n_data, slots, **knobs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e = MeshDatapath(world_copy(ps), services, device=dev, n_data=n_data,
                         flow_slots=slots, **kw, **knobs)
        torch.cuda.synchronize()
        return e, time.perf_counter() - t0

    def steady(eng, ref, t, what, acc):
        """RESIZE_STEADY timed steps -> (next instant, {ms, spilled lanes a
        step, replicas})."""
        times = []
        spill0 = eng.mesh_stats()["spill_lanes_total"]
        for _ in range(RESIZE_STEADY):
            _r, dt = pair_step(eng, ref, hb, t, what, acc)
            times.append(dt * 1e3)
            t += 1
        spilled = eng.mesh_stats()["spill_lanes_total"] - spill0
        return t, dict(ms=times, spilled_a_step=spilled / RESIZE_STEADY,
                       replicas=eng._n_data, topology_generation=eng._topo_gen)

    # (a) grow 2 -> 4 and shrink 4 -> 2 under traffic.
    gc.collect()
    torch.cuda.empty_cache()
    eng, build_s = build(2, RESIZE_SLOTS, fused=True)
    ref, ref_s = build(1, FLOW_SLOTS, fused=True)
    adv = AdvanceLog(eng)
    tcan = TargetCanaryInputs(eng)
    acc = PhaseLaunches(witness)
    a = dict(build_s=build_s, ref_build_s=ref_s)
    t = 100
    for _ in range(2):  # cold, warm
        pair_step(eng, ref, hb, t, "resize (a) warm-up", acc)
        t += 1
    t, a["before"] = steady(eng, ref, t, "resize (a) before", acc)
    a["est_before"] = int(pair_step(eng, ref, hb, t, "resize (a)",
                                    acc)[0].est.sum())
    t += 1
    step_rec = KernelInputs()
    k = 0
    for n in (4, 2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        since = len(adv.calls)
        t_begin = time.perf_counter()
        acc.run(eng.reshard_begin, n)
        ticks, during, tick_ms = 0, [], []
        while eng.reshard_status() is not None:
            st = eng.reshard_status()
            rc = (step_rec if n == 4 and st["phase"] == "migrate"
                  and st["progress_ratio"] > 0 and not step_rec.seen
                  else None)
            _r, dt = pair_step(eng, ref, hb, t, f"resize (a) to {n}", acc,
                               recorder=rc)
            during.append(dt * 1e3)
            pair_step(eng, ref, churn(k), t, f"resize (a) to {n}, churn",
                      acc)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            acc.run(eng.maintenance_tick, now=t)
            torch.cuda.synchronize()
            tick_ms.append((time.perf_counter() - t0) * 1e3)
            t += 1
            k += 1
            ticks += 1
            if ticks > MAX_TICKS:
                raise SystemExit(f"resize (a) to {n}: no cutover in "
                                 f"{MAX_TICKS} ticks: {eng.reshard_status()}")
        if (eng._n_data, eng._topo_gen) != (n, 1 if n == 4 else 2):
            raise SystemExit(f"resize (a) to {n}: ended at {eng._n_data} "
                             f"replicas, generation {eng._topo_gen}")
        r, dt = pair_step(eng, ref, hb, t, f"resize (a) after {n}", acc)
        t += 1
        torch.cuda.synchronize()
        part = dict(ticks=ticks, seconds=time.perf_counter() - t_begin,
                    tick_ms=tick_ms, during_ms=during,
                    est_after_flip=int(r.est.sum()),
                    **adv.summary(since))
        if n == 4:
            part["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        a[f"to{n}"] = part
        log(f"resize (a) to {n}: {ticks} ticks, {part['seconds']:.1f} s; "
            f"migration ticks {[round(x, 1) for x in part['migrate_ms']]} ms "
            f"({part['migrate_rows']} rows, {part['rows_per_s']:.0f} rows/s),"
            f" cutover {[round(x, 1) for x in part['cutover_ms']]} ms "
            f"(stages {part['cutover_stages_ms']}); whole "
            f"ticks {[round(x, 1) for x in tick_ms]} ms; steps during "
            f"{[round(x, 1) for x in during]} ms; est lanes after the flip "
            f"{part['est_after_flip']} (before the resize "
            f"{a['est_before']})" + (f"; peak device memory at 4 replicas "
                                    f"{part['peak_gib']:.3f} GiB"
                                    if n == 4 else ""))
    t, a["after"] = steady(eng, ref, t, "resize (a) after", acc)
    rs = eng.reshard_stats()
    kinds = [e["kind"] for e in eng.flightrecorder_events()
             if e["kind"].startswith("reshard")]
    if (rs["cutovers_total"], rs["aborts_total"]) != (2, 0) or kinds != [
            "reshard-begin", "reshard-migrated", "reshard-cutover"] * 2:
        raise SystemExit(f"resize (a): {rs}, {kinds}")
    if not copies_equal(eng):
        raise SystemExit("resize (a): rule-shard state copies differ")
    a.update(reshard_stats={k2: v for k2, v in rs.items()
                            if k2 != "last_span"},
             last_span=rs["last_span"], reshard_kinds=kinds,
             copies_equal=True, launches=list(acc.total),
             compared_steps=acc.steps, sticky_dnat_lanes=acc.sticky)
    launches["a"] = list(acc.total)
    if not acc.total[0] or acc.total[2]:
        raise SystemExit(f"resize (a): (B1, B2, B3, B3h, S1) launches "
                         f"{acc.total}")
    log(f"resize (a): steady before {a['before']}, after "
        f"{a['after']}; reshard_stats {a['reshard_stats']}; kinds "
        f"{kinds}; rule-shard copies equal; (B1, B2, B3, B3h, S1) launches "
        f"{acc.total}; {acc.steps} steps held to the reference, "
        f"{acc.sticky} affinity lanes with another endpoint")
    kern["a step"] = need_kernels(check_recorded(step_rec.seen, (2, 1), 20),
                                  ["B1"], "(a) mid-migration step")
    kern["a target canary"] = need_kernels(
        check_recorded(tcan.rec.seen, (4, 1), 20), ["B1"],
        "(a) target canary")
    rec["a"] = a

    # (b) a grow vetoed by a corrupted target replica.
    acc = PhaseLaunches(witness)
    tcan = TargetCanaryInputs(eng)
    since = len(adv.calls)
    gen0 = (eng._n_data, eng._topo_gen)
    acc.run(eng.reshard_begin, 4)
    desc = eng._reshard.corrupt_target(1)
    ticks = 0
    while eng.reshard_status() is not None:
        pair_step(eng, ref, hb, t, "resize (b)", acc)
        acc.run(eng.maintenance_tick, now=t)
        t += 1
        ticks += 1
        if ticks > MAX_TICKS:
            raise SystemExit("resize (b): never ended")
    rs = eng.reshard_stats()
    chain = [e["kind"] for e in eng.flightrecorder_events()
             if e["kind"] in ("reshard-begin", "replica-canary-veto",
                              "reshard-abort")][-3:]
    if ((eng._n_data, eng._topo_gen) != gen0 or rs["aborts_total"] != 1
            or chain != ["reshard-begin", "replica-canary-veto",
                         "reshard-abort"] or eng.degraded):
        raise SystemExit(f"resize (b): {gen0} -> {eng._n_data, eng._topo_gen}"
                         f", {rs}, {chain}, degraded {eng.degraded}")
    t, after = steady(eng, ref, t, "resize (b) after the abort", acc)
    b = dict(ticks=ticks, corrupt=desc, chain=chain, after=after,
             launches=list(acc.total), compared_steps=acc.steps,
             sticky_dnat_lanes=acc.sticky, **adv.summary(since))
    launches["b"] = list(acc.total)
    log(f"resize (b): {desc}; {ticks} ticks to {chain}; generation "
        f"{gen0} kept, the old topology serving the reference's verdicts "
        f"({after}); (B1, B2, B3, B3h, S1) launches {acc.total}")
    kern["b target canary"] = need_kernels(
        check_recorded(tcan.rec.seen, (4, 1), 20), ["B1"],
        "(b) target canary")
    rec["b"] = b
    del eng, ref
    gc.collect()
    torch.cuda.empty_cache()

    # (c) replica 1 killed: quarantine, evacuation, readmission.
    one = dict(fused=True, prune_budget=PRUNE_K)
    eng, build_s = build(2, RESIZE_SLOTS, failover=True,
                         failover_knobs=FAILOVER_KNOBS, **one)
    ref, ref_s = build(1, FLOW_SLOTS, **one)
    adv = AdvanceLog(eng)
    tcan = TargetCanaryInputs(eng)
    probe_rec = KernelInputs()
    fo = eng._failover
    real_round = fo._probe_round

    def probe_round(now):
        if probe_rec.seen:
            return real_round(now)
        with probe_rec:
            return real_round(now)

    fo._probe_round = probe_round
    acc = PhaseLaunches(witness)
    c = dict(build_s=build_s, ref_build_s=ref_s)
    t = 100
    for _ in range(2):
        pair_step(eng, ref, hb, t, "failover (c) warm-up", acc)
        t += 1
    t, c["before"] = steady(eng, ref, t, "failover (c) before", acc)
    plan = FaultPlan(seed=5)
    plan.every("n0.replica_dead", 1, "r1", times=-1)
    eng.arm_failover_faults(plan, "n0")
    step_rec = KernelInputs()
    torch.cuda.synchronize()
    t_kill = time.perf_counter()
    ticks, phases, during = 0, [], []
    for goal in ("evacuated", "healthy"):
        while eng.failover_stats()["phase"] != goal:
            st = eng.reshard_status()
            rc = (step_rec if st is not None and st["progress_ratio"] > 0
                  and not step_rec.seen else None)
            _r, dt = pair_step(eng, ref, hb, t, f"failover (c) to {goal}",
                               acc, recorder=rc)
            during.append(dt * 1e3)
            acc.run(eng.maintenance_tick, now=t)
            phases.append(eng.failover_stats()["phase"])
            t += 1
            ticks += 1
            if ticks > MAX_TICKS:
                raise SystemExit(f"failover (c): stuck before {goal}: "
                                 f"{eng.failover_stats()}")
        torch.cuda.synchronize()
        c[f"to_{goal}"] = dict(ticks=ticks,
                               seconds=time.perf_counter() - t_kill,
                               n_data=eng._n_data)
        if goal == "evacuated":
            if eng._n_data != 1:
                raise SystemExit(f"failover (c): evacuated to "
                                 f"{eng._n_data} replicas")
            plan.quiesce()
    t, c["after"] = steady(eng, ref, t, "failover (c) after", acc)
    fs = eng.failover_stats()
    if (fs["quarantines_total"], fs["evacuations_total"],
            fs["readmissions_total"], eng._n_data) != (1, 1, 1, 2):
        raise SystemExit(f"failover (c): {fs}, {eng._n_data} replicas")
    c.update(failover_stats={k2: fs[k2] for k2 in (
        "quarantines_total", "evacuations_total", "readmissions_total",
        "remiss_total", "requeued_total", "probes_total",
        "probe_failures_total", "slow_dispatches_total")},
        phases=phases, during_ms=during, launches=list(acc.total),
        compared_steps=acc.steps, sticky_dnat_lanes=acc.sticky,
        kinds=[e["kind"] for e in eng.flightrecorder_events()
               if e["kind"].startswith(("replica-", "reshard-"))],
        **adv.summary())
    launches["c"] = list(acc.total)
    if not (acc.total[1] and acc.total[3]) or acc.total[2]:
        raise SystemExit(f"failover (c): (B1, B2, B3, B3h, S1) launches "
                         f"{acc.total}")
    log(f"failover (c): kill -> evacuation flip {c['to_evacuated']['ticks']}"
        f" ticks, {c['to_evacuated']['seconds']:.1f} s; -> readmission "
        f"{c['to_healthy']['ticks']} ticks, {c['to_healthy']['seconds']:.1f} "
        f"s; phases {phases}; failover_stats {c['failover_stats']}; "
        f"migration ticks {[round(x, 1) for x in c['migrate_ms']]} ms, "
        f"cutovers {[round(x, 1) for x in c['cutover_ms']]} ms "
        f"{c['cutover_outcome']} (stages {c['cutover_stages_ms']}); steady "
        f"before {c['before']}, after "
        f"{c['after']}; (B1, B2, B3, B3h, S1) launches {acc.total}; "
        f"{acc.steps} steps held to the reference, {acc.sticky} affinity "
        f"lanes with another endpoint")
    kern["c step"] = need_kernels(check_recorded(step_rec.seen, (2, 1), 20),
                                  ["B3h"], "(c) mid-evacuation step")
    kern["c probes"] = need_kernels(
        check_recorded(probe_rec.seen, (2, 1), 20), ["B2"],
        "(c) probe round")
    kern["c target canary"] = need_kernels(
        check_recorded(tcan.rec.seen, (1, 1), 20), ["B2"],
        "(c) evacuation target canary")
    rec["c"] = c
    del eng, ref
    gc.collect()
    torch.cuda.empty_cache()
    rec["seconds"] = time.perf_counter() - t18
    log(f"phase 18 took {rec['seconds']:.1f} s")
    return rec, kern, launches


# ---- phase 19: the agent on the card ----------------------------------------
# The agent's node (node-0's topology is the engines'); (b)'s server ships a
# re-list in chunks of WIRE_CHUNK events a pump round (DisseminationServer's
# resync_chunk), so that neither end's socket buffer fills while the one
# thread that runs both ends handles the frames; (c)'s world, lanes and
# slots (a JSON list a field over the pipe); (d)'s live traceflows.
AGENT_NODE = "node-0"
WIRE_CHUNK = 512
PIPE_RULES = 10_000
PIPE_B = 4096
PIPE_SLOTS = 1 << 16
TRACE_LANES = 8
# Lanes of affinity services whose sticky endpoint differs between the
# agent's engine and a fresh one, held to the scalar Oracle at each
# endpoint (a quarter second a lane at 100k rules); the rest are counted.
STICKY_SAMPLE = 32


class SampledWitness:
    """StickyWitness on the first `sample` lanes it is asked about, with no
    cap on the lanes counted."""

    def __init__(self, ps, services, sample):
        self._w = StickyWitness(ps, services, cap=sample)
        self.sample, self.asked, self.lanes, self.cap = sample, 0, 0, 1 << 62

    def check(self, batch, i, res, what):
        self.asked += 1
        if self.asked <= 2 * self.sample:  # both engines of a lane
            self._w.check(batch, i, res, what)


def world_events(ps, node):
    """The PolicySet's controlplane objects as ADDED watch events spanning
    `node`, each through the wire format (one serde JSON line an event), in
    the PolicySet's own order (address groups, appliedTo groups, policies):
    -> (events, the lines' bytes, seconds)."""
    from antrea_tpu_torch.controller.networkpolicy import WatchEvent
    from antrea_tpu_torch.dissemination import serde

    t0 = time.perf_counter()
    out, nbytes = [], 0
    for obj_type, items in (("AddressGroup", ps.address_groups.items()),
                            ("AppliedToGroup", ps.applied_to_groups.items()),
                            ("NetworkPolicy",
                             ((p.uid, p) for p in ps.policies))):
        for name, obj in items:
            line = serde.event_to_wire(WatchEvent(
                kind="ADDED", obj_type=obj_type, name=name, obj=obj,
                span={node}))
            nbytes += len(line)
            out.append(serde.event_from_wire(line))
    return out, nbytes, time.perf_counter() - t0


def delta_events(ps, plan, node):
    """Phase 13's churn plan as UPDATED address-group events (the group's
    new member list, with added / removed), through the wire format."""
    import dataclasses

    from antrea_tpu_torch.apis import controlplane as cp
    from antrea_tpu_torch.controller.networkpolicy import WatchEvent
    from antrea_tpu_torch.dissemination import serde

    out = []
    for name, added, removed in plan:
        g = ps.address_groups[name]
        gone = [m for m in g.members if m.ip in removed]
        new = [cp.GroupMember(ip=ip) for ip in added]
        obj = dataclasses.replace(
            g, members=[m for m in g.members if m.ip not in removed] + new)
        out.append(serde.event_from_wire(serde.event_to_wire(WatchEvent(
            kind="UPDATED", obj_type="AddressGroup", name=name, obj=obj,
            span={node}, added=new, removed=gone))))
    return out


class EngineCalls:
    """Counts an engine's install_bundle and apply_group_delta calls (the
    agent's two ways of reaching it)."""

    def __init__(self, eng):
        self.n = {"install_bundle": 0, "apply_group_delta": 0}
        for name in self.n:
            real = getattr(eng, name)

            def call(*a, _real=real, _name=name, **k):
                self.n[_name] += 1
                return _real(*a, **k)

            setattr(eng, name, call)


def clean_sync(agent, what, generation=None):
    """An agent swallows its engine's failures by design (it counts them
    and retries): after every sync its failure counters must be zero and
    its engine's generation the expected one."""
    import torch

    torch.cuda.synchronize()
    if (agent.sync_failures_total or agent.last_sync_error
            or agent.permanent_failure):
        raise SystemExit(
            f"agent {what}: sync failed ({agent.sync_failures_total} "
            f"failures): {agent.last_sync_error!r} "
            f"{agent.permanent_failure!r}")
    if generation is not None and agent.datapath.generation != generation:
        raise SystemExit(f"agent {what}: generation "
                         f"{agent.datapath.generation}, not {generation}")


def timed_sync(agent, what, generation):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    agent.sync()
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    clean_sync(agent, what, generation)
    return s


def launched(before):
    """(B1, B2, B3, B3h, S1) launches since `before` (counts5() then): the
    counts are read, never written, in phase 19."""
    return [b - a for a, b in zip(before, counts5())]


def check_b3_recorded(a, what):
    """B3 (the resolve variant) against its plain version on the inputs a
    step passed it (KernelInputs) -> record, with b3_work's bounds."""
    from antrea_tpu_torch.ops import onepass as op

    x, tabs, st, now, gen_w = a["x"], a["tabs"], a["st"], a["now"], a["gen_w"]
    b = x.pkt.shape[0]
    got = op.onepass(x, tabs, now, gen_w, st)
    miss = (got[0][:, 11] == 0) & (x.msk[:, 0] != 0)
    n_miss = int(miss.sum())
    once, per_lane, ops, blocks = b3_work(tabs, st, got[4][miss], b)
    del got
    rec = check_kernel(
        f"B3 one-pass ({what}, K={st.k}, {n_miss} miss lanes)",
        lambda: op.onepass(x, tabs, now, gen_w, st),
        lambda: op.onepass_plain(x, tabs, now, gen_w, st), b, once, ops, 3)
    rec.update(miss_lanes=n_miss, candidate_blocks=blocks)
    return with_lane_bound(rec, "B3", per_lane)


def check_phase19(seen, what, tags, phase=19):
    """Each kernel call recorded in a part of phase 19 (or 20) held bitwise
    to its plain version (B3 here, B1 and B2 through check_recorded);
    raises unless each kernel of `tags` was recorded."""
    b3 = {k: v for k, v in seen.items() if k[0] == "B3"}
    out = check_recorded({k: v for k, v in seen.items() if k[0] != "B3"},
                         (1, 1), 2)
    for (_, w0), a in b3.items():
        out[f"B3 w0={w0}"] = check_b3_recorded(a, what)
    have = {name.split()[0] for name in out}
    missing = [t for t in tags if t not in have]
    if missing:
        raise SystemExit(f"phase {phase} {what}: {missing} not recorded "
                         f"and held to the plain version (held: "
                         f"{sorted(out)})")
    return out


def tls_backend() -> str:
    """Which of the two routes netwire's PKI takes here: the cryptography
    package, or the openssl binary it falls back to ("" for neither)."""
    import shutil

    try:
        import cryptography  # noqa: F401

        return "cryptography"
    except ImportError:
        return "openssl" if shutil.which("openssl") else ""


def drive_wire(store, services, kw, fresh, now, dev):
    """Phase 19 (b): a DisseminationServer over (a)'s store (the world
    after the deltas and the deletion) and a NetAgent in this process with
    its own engine on the card, over mutual TLS: the PKI, the handshake,
    the stream of the whole world (the server's re-list, WIRE_CHUNK events
    a round), the sync, and the fresh batch's step -> (record, launches,
    recorded kernel checks, the step's result)."""
    import gc
    import tempfile

    import torch

    from antrea_tpu_torch.datapath import TpuflowDatapath
    from antrea_tpu_torch.dissemination import netwire

    backend = tls_backend()
    log(f"phase 19 (b): TLS through {backend or 'NOTHING'} "
        f"(netwire.make_ca / issue_cert)")
    if not backend:
        log("phase 19 (b) NOT RUN: neither the cryptography package nor the "
            "openssl binary is on this machine")
        return ({"run": False, "reason": "no cryptography, no openssl"},
                [0] * 5, {}, None)
    rec = {"run": True, "tls": backend}
    with tempfile.TemporaryDirectory() as certdir:
        t0 = time.perf_counter()
        netwire.make_ca(certdir)
        srv = netwire.DisseminationServer(store, certdir,
                                          resync_chunk=WIRE_CHUNK)
        rec["pki_s"] = time.perf_counter() - t0
        try:
            eng = TpuflowDatapath(None, services, device=dev, **kw)
            calls = EngineCalls(eng)
            before = counts5()
            with KernelInputs() as ki:
                t0 = time.perf_counter()
                na = netwire.NetAgent(AGENT_NODE, srv.address, certdir, eng)
                srv.wait_connected(1, timeout=30.0)
                rec["handshake_s"] = time.perf_counter() - t0
                t0 = time.perf_counter()
                shipped = rounds = 0
                while na.resyncs_total < 1:
                    shipped += srv.pump()
                    na.pump(wait=0.5)
                    rounds += 1
                    if rounds > 100_000 or not na.connected:
                        raise SystemExit(f"phase 19 (b): the stream stalled "
                                         f"after {shipped} events")
                rec.update(stream_s=time.perf_counter() - t0, events=shipped,
                           rounds=rounds)
                rec["sync_s"] = timed_sync(na.agent, "(b) install", 1)
                if calls.n != {"install_bundle": 1, "apply_group_delta": 0}:
                    raise SystemExit(f"phase 19 (b): engine calls {calls.n}")
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                r = eng.step(fresh, now)
                torch.cuda.synchronize()
                rec["step_ms"] = (time.perf_counter() - t0) * 1e3
            launches = launched(before)
            if r.n_miss != fresh.size:
                raise SystemExit(f"phase 19 (b): {r.n_miss} of "
                                 f"{fresh.size} fresh lanes missed")
            rec.update(resyncs_total=srv.dissemination_stats()[
                "resyncs_total"], launches=launches)
            na.sync_and_report()
            na.close()
        finally:
            srv.close()
    log(f"phase 19 (b): PKI {rec['pki_s']:.2f} s, handshake "
        f"{rec['handshake_s']:.3f} s, the world's {rec['events']} events in "
        f"{rec['rounds']} rounds, {rec['stream_s']:.1f} s; sync "
        f"{rec['sync_s']:.1f} s; its cold step of the fresh batch "
        f"{rec['step_ms']:.1f} ms; (B1, B2, B3, B3h, S1) launches "
        f"{launches}")
    del eng, na
    gc.collect()
    torch.cuda.empty_cache()
    checks = check_phase19(ki.seen, "(b) the wire's engine", ("B2", "B3"))
    return rec, launches, checks, r


def pipe_world():
    """(c)'s world: gen_cluster(PIPE_RULES) with the headline's node and pod
    layout, PIPE_B lanes of its traffic, and one churnable address group's
    delta."""
    from antrea_tpu_torch.packet import PacketBatch
    from antrea_tpu_torch.simulator import gen_cluster, gen_traffic

    cluster = gen_cluster(PIPE_RULES, n_nodes=64, pods_per_node=32, seed=11)
    tr = gen_traffic(cluster.pod_ips, PIPE_B, n_flows=PIPE_B // 2, seed=12)
    batch = PacketBatch(src_ip=tr.src_ip, dst_ip=tr.dst_ip, proto=tr.proto,
                        src_port=tr.src_port, dst_port=tr.dst_port)
    return cluster, batch


PIPE_FIELDS = ("code", "est", "reply", "reject_kind", "snat", "svc_idx",
               "dnat_ip", "dnat_port")


def same_reply(got, want, what):
    """A child agent's step reply against a StepResult, field by field."""
    for f in PIPE_FIELDS:
        if got[f] != [int(x) for x in getattr(want, f)]:
            raise SystemExit(f"phase 19 (c) {what}: {f} differs")
    if (got["ingress_rule"] != want.ingress_rule
            or got["egress_rule"] != want.egress_rule):
        raise SystemExit(f"phase 19 (c) {what}: rule attribution differs")


def drive_pipe(dev):
    """Phase 19 (c): SubprocessAgent(datapath_type="tpuflow") with its child
    agent_proc on the card (the default device: no device is passed on
    the card, dev on the CPU) and an in-process agent
    driving the same engine on the card, both watching one store: the
    world's events pumped over the pipe, sync, the batch cold and warm, a
    membership delta and the batch again; every reply field equal, no
    error reply, nothing on the child's stderr -> record."""
    import torch

    from antrea_tpu_torch.agent import AgentPolicyController
    from antrea_tpu_torch.datapath import TpuflowDatapath
    from antrea_tpu_torch.dissemination import RamStore
    from antrea_tpu_torch.dissemination.transport import SubprocessAgent

    cluster, batch = pipe_world()
    events, nbytes, _ = world_events(cluster.ps, AGENT_NODE)
    store = RamStore()
    rec = {"rules": PIPE_RULES, "lanes": PIPE_B, "events": len(events),
           "event_bytes": nbytes}
    local_dp = TpuflowDatapath(device=dev, miss_chunk=32,
                               flow_slots=PIPE_SLOTS, aff_slots=1 << 8)
    local = AgentPolicyController(AGENT_NODE, local_dp, store)
    t0 = time.perf_counter()
    sub = SubprocessAgent(AGENT_NODE, store, datapath_type="tpuflow",
                          flow_slots=PIPE_SLOTS, aff_slots=1 << 8,
                          device=None if dev.type == "cuda" else dev.type)
    try:
        argv = sub._proc.args
        if argv[argv.index("--device") + 1] != dev.type or argv[2] != (
                "antrea_tpu_torch.dissemination.agent_proc"):
            raise SystemExit(f"phase 19 (c): the child is {argv}")
        for ev in events:
            store.apply(ev)
        t1 = time.perf_counter()
        rec["pumped"] = sub.pump()
        rec["pump_s"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        reply = sub.sync()  # the child's first reply: it is up
        rec["sync_s"] = time.perf_counter() - t1
        rec["child_up_s"] = time.perf_counter() - t0
        local.sync()
        clean_sync(local, "(c) in-process install", 1)
        if reply["generation"] != 1 or reply["realized"] != (
                local.realized_generations()):
            raise SystemExit(f"phase 19 (c): the child synced to "
                             f"generation {reply['generation']}")
        step_ms = []
        for k, now in enumerate((10, 11, 12)):
            if k == 2:
                # A membership delta: a pod leaves the first group that
                # has two members.
                name = next(n for n, g in sorted(
                    cluster.ps.address_groups.items()) if len(g.members) > 1)
                (ev,) = delta_events(cluster.ps, [
                    (name, [], [cluster.ps.address_groups[name]
                                .members[0].ip])], AGENT_NODE)
                store.apply(ev)
                if not local._deltas:
                    raise SystemExit("phase 19 (c): the delta was not a "
                                     "membership delta")
                sub.pump()
                if sub.sync()["generation"] != 2:
                    raise SystemExit("phase 19 (c): the child's delta did "
                                     "not commit")
                local.sync()
                clean_sync(local, "(c) in-process delta", 2)
            t1 = time.perf_counter()
            got = sub.step(batch, now)
            step_ms.append((time.perf_counter() - t1) * 1e3)
            same_reply(got, local_dp.step(batch, now), f"step at now={now}")
        torch.cuda.synchronize()
        tail = sub._stderr_tail()
        if tail:
            raise SystemExit(f"phase 19 (c): the child wrote to stderr: "
                             f"{tail[-400:]}")
        rec.update(step_ms=step_ms, n_deltas=local_dp._n_deltas)
    finally:
        sub.stop()
    log(f"phase 19 (c): child agent_proc on {dev.type} up in "
        f"{rec['child_up_s']:.1f} s; {rec['pumped']} events "
        f"({nbytes / 1e6:.2f} MB) pumped in {rec['pump_s']:.2f} s, sync "
        f"{rec['sync_s']:.2f} s; {PIPE_B}-lane steps over the pipe "
        f"{', '.join(f'{x:.1f}' for x in step_ms)} ms, every reply field "
        f"bitwise equal to the in-process agent's engine (a delta before "
        f"the last)")
    return rec


def drive_surfaces(eng, agent, tr, svc_idx, dev):
    """Phase 19 (d): the agent's API server over (a)'s engine, tapped by a
    TraceflowController: /metrics, /commitplane, /audit, /agentinfo, the
    probe traceflow of TRACE_LANES headline 5-tuples (each held to the
    engine's trace() and to the scalar Oracle), the same 5-tuples as live
    traceflows completed by a step of the tapped engine, antctl get and
    traceflow --server, antctl check --device cuda, and a support bundle
    -> record.  svc_idx: phase 13's Service column of the headline batch
    (the traced flows reach no Service, so the Oracle classifies the
    packet as sent)."""
    import contextlib
    import io
    import tarfile
    import tempfile
    from urllib.request import urlopen

    import numpy as np

    from antrea_tpu_torch import antctl
    from antrea_tpu_torch.agent.apiserver import AgentApiServer
    from antrea_tpu_torch.controller.traceflow import (TraceflowController,
                                                       TraceflowSpec)
    from antrea_tpu_torch.observability.supportbundle import collect_bundle
    from antrea_tpu_torch.oracle import Oracle
    from antrea_tpu_torch.packet import Packet, PacketBatch
    from antrea_tpu_torch.utils import ip as iputil

    rec = {}
    tfc = TraceflowController()
    tapped = tfc.tap(AGENT_NODE, eng)
    srv = AgentApiServer(tapped, node=AGENT_NODE, agent=agent,
                         tf_controller=tfc).start()
    url = srv.address

    def get(path):
        with urlopen(url + path, timeout=120) as r:
            return r.read().decode()

    def cli(argv):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = antctl.main(argv)
        return rc, out.getvalue()

    try:
        t0 = time.perf_counter()
        metrics = get("/metrics")
        for fam in ("antrea_tpu_flow_cache_entries",
                    "antrea_tpu_default_verdict_packets_total"):
            if fam not in metrics:
                raise SystemExit(f"phase 19 (d): /metrics lacks {fam}")
        commit = json.loads(get("/commitplane"))
        if commit.get("degraded") or commit.get("generation") != (
                eng.generation):
            raise SystemExit(f"phase 19 (d): /commitplane {commit}")
        audit = json.loads(get("/audit"))
        info = json.loads(get("/agentinfo?now=1"))
        if info["networkPolicies"] != len(agent.policy_set.policies):
            raise SystemExit(f"phase 19 (d): /agentinfo {info}")
        rec["routes_s"] = time.perf_counter() - t0
        # TRACE_LANES headline TCP flows that reach no Service, at fresh
        # source ports.
        pick = np.nonzero((np.asarray(svc_idx) < 0)
                          & (np.asarray(tr.proto) == 6))[0][:TRACE_LANES]
        rows = [(iputil.u32_to_ip(int(tr.src_ip[i])),
                 iputil.u32_to_ip(int(tr.dst_ip[i])), int(tr.proto[i]),
                 50000 + k, int(tr.dst_port[i])) for k, i in enumerate(pick)]
        oracle = Oracle(agent.policy_set)
        batch = PacketBatch(
            src_ip=np.array([iputil.ip_to_u32(r[0]) for r in rows],
                            np.uint32),
            dst_ip=np.array([iputil.ip_to_u32(r[1]) for r in rows],
                            np.uint32),
            proto=np.array([r[2] for r in rows], np.int32),
            src_port=np.array([r[3] for r in rows], np.int32),
            dst_port=np.array([r[4] for r in rows], np.int32))
        now = NOWS[-1] + 10
        trace = eng.trace(batch, now=now)
        t0 = time.perf_counter()
        for k, (src, dst, proto, sport, dport) in enumerate(rows):
            obs = json.loads(get(f"/traceflow?src={src}&dst={dst}"
                                 f"&proto={proto}&sport={sport}"
                                 f"&dport={dport}&now={now}"))
            want = int(oracle.classify(Packet(
                src_ip=iputil.ip_to_u32(src), dst_ip=iputil.ip_to_u32(dst),
                proto=proto, src_port=sport, dst_port=dport)).code)
            if obs["code"] != trace[k]["code"] or obs["code"] != want:
                raise SystemExit(f"phase 19 (d): traceflow {rows[k]}: "
                                 f"{obs['code']}, trace() "
                                 f"{trace[k]['code']}, Oracle {want}")
        rec["traceflow_ms"] = (time.perf_counter() - t0) * 1e3 / len(rows)
        # The same 5-tuples as live traceflows, completed by one step of
        # the tapped engine.
        for k, (src, dst, proto, sport, dport) in enumerate(rows):
            tfc.start_live(TraceflowSpec(
                name=f"live-{k}", src_ip=src, dst_ip=dst, proto=proto,
                src_port=sport, dst_port=dport, live_traffic=True),
                AGENT_NODE)
        r = tapped.step(batch, now)
        for k in range(len(rows)):
            st = tfc.results[f"live-{k}"]
            verdict = {0: "Allow", 1: "Drop", 2: "Reject"}[int(r.code[k])]
            if st.phase != "Succeeded" or st.verdict != verdict or int(
                    r.code[k]) != trace[k]["code"]:
                raise SystemExit(f"phase 19 (d): live traceflow {rows[k]}: "
                                 f"{st.phase} {st.verdict}, step {verdict}")
        rec["traceflows"] = len(rows)
        rec["verdicts"] = [int(x) for x in r.code]
        for argv in (["get", "agentinfo"], ["get", "cache"],
                     ["traceflow", "--src", rows[0][0], "--dst", rows[0][1],
                      "--dport", str(rows[0][4])]):
            rc, out = cli(argv + ["--server", url])
            if rc != 0 or not out.strip():
                raise SystemExit(f"phase 19 (d): antctl {argv}: rc {rc}")
        t0 = time.perf_counter()
        rc, out = cli(["check", "--device", dev.type])
        rec["check_s"] = time.perf_counter() - t0
        if rc != 0:
            raise SystemExit(f"phase 19 (d): antctl check:\n{out}")
        rec["check"] = out.split()
        with tempfile.TemporaryDirectory() as d:
            t0 = time.perf_counter()
            path = f"{d}/bundle.tar.gz"
            members = collect_bundle(eng, path, node=AGENT_NODE, now=now)
            rec["bundle_s"] = time.perf_counter() - t0
            with tarfile.open(path) as tar:
                names = tar.getnames()
        need = {"meta.json", "stats.json", "cache_stats.json", "flows.json",
                "maintenance.json", "flightrecorder.json",
                "realization.json", "metrics.prom"}
        if not need <= set(members) or names != members:
            raise SystemExit(f"phase 19 (d): bundle members {members}")
        rec.update(bundle_members=members, audit_keys=sorted(audit))
    finally:
        srv.close()
    log(f"phase 19 (d): /metrics, /commitplane, /audit, /agentinfo in "
        f"{rec['routes_s']:.2f} s; {rec['traceflows']} traceflows "
        f"({rec['traceflow_ms']:.1f} ms each) equal to trace() and the "
        f"scalar Oracle, live traceflows completed by the step; antctl get "
        f"/ traceflow --server; antctl check --device {dev.type} in "
        f"{rec['check_s']:.1f} s ({' '.join(rec['check'])}); bundle of "
        f"{len(members)} members in {rec['bundle_s']:.1f} s")
    return rec


def drive_agent(ps, services, pod_ips, tr, dev, kept13):
    """Phase 19: (a) the world's controlplane objects, through the wire
    format, into a RamStore that an AgentPolicyController watches, driving
    an engine on the card with phase 13's one-pass knobs: the sync, phase
    13's headline steps, its 4 churned groups as UPDATED events (each must
    reach apply_group_delta) and its delta step, every step bitwise equal
    to phase 13's engine; then the agent disconnects, the policy phase
    13's last step attributed most lanes to is deleted from the store, and
    the re-list's window retracts it; (b) the mTLS wire (drive_wire) on the
    same store builds a fresh engine on the smaller set, which the
    retraction's fresh lanes are held to; (d) the surfaces
    (drive_surfaces); (c) the pipe transport (drive_pipe).  The kernels each part launched (counts read,
    never written) and the calls recorded in (a) and (b), each held to its
    plain version -> (record, {part: launches}, {name: kernel record})."""
    import gc

    import numpy as np
    import torch

    from antrea_tpu_torch.agent import AgentPolicyController
    from antrea_tpu_torch.controller.networkpolicy import WatchEvent
    from antrea_tpu_torch.datapath import TpuflowDatapath
    from antrea_tpu_torch.dissemination import RamStore, serde

    t19 = time.perf_counter()
    rec, parts = {}, {}
    kw = dict(flow_slots=FLOW_SLOTS, miss_chunk=MISS_CHUNK,
              canary_probes=ENGINE_PROBES, topology=node0_spec(pod_ips),
              fused=True, prune_budget=PRUNE_K)
    events, nbytes, wire_s = world_events(ps, AGENT_NODE)
    store = RamStore()
    eng = TpuflowDatapath(None, services, device=dev, **kw)
    calls = EngineCalls(eng)
    # The agent's watch, as its constructor takes it given the store (its
    # handle lets the agent disconnect below).
    agent = AgentPolicyController(AGENT_NODE, eng)
    watch = store.watch(AGENT_NODE, agent.handle_event)
    hb = engine_batch(tr.src_ip, tr.dst_ip, tr.proto, tr.src_port,
                      tr.dst_port, pod_ips)
    before = counts5()
    with KernelInputs() as ki:
        t0 = time.perf_counter()
        for ev in events:
            store.apply(ev)
        publish_s = time.perf_counter() - t0
        sync_s = timed_sync(agent, "(a) install", 1)
        if calls.n != {"install_bundle": 1, "apply_group_delta": 0}:
            raise SystemExit(f"phase 19 (a): engine calls {calls.n}")
        times = []
        for i, now in enumerate(NOWS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = eng.step(hb, now)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            same_result(r, kept13["results"][i],
                        f"phase 19 (a) vs phase 13, step {i}")
        if eng.dump_flows(NOWS[-1]) != kept13["dump"]:
            raise SystemExit("phase 19 (a): dump_flows() differs from phase "
                             "13's")
        if eng.cache_stats() != kept13["cache"]:
            raise SystemExit("phase 19 (a): cache_stats() differs from "
                             "phase 13's")
        steps = step_stats(times)
        # Phase 13's pod churn as watch events: each a membership delta.
        plan = kept13["plan"]
        inc0 = eng._drs.ingress.at.inc
        hist = agent.dissemination_hist
        c0, s0 = hist.count, hist.sum
        t0 = time.perf_counter()
        for ev in delta_events(ps, plan, AGENT_NODE):
            store.apply(ev)
        if len(agent._deltas) != len(plan) or agent._rules_dirty:
            raise SystemExit(f"phase 19 (a): the churn queued "
                             f"{len(agent._deltas)} deltas, dirty "
                             f"{agent._rules_dirty}")
        agent.sync()
        delta_sync_s = time.perf_counter() - t0
        clean_sync(agent, "(a) deltas", 1 + len(plan))
        if (calls.n != {"install_bundle": 1, "apply_group_delta": len(plan)}
                or eng._drs.ingress.at.inc is not inc0
                or eng._n_deltas != kept13["n_deltas"]):
            raise SystemExit(f"phase 19 (a): the deltas took {calls.n}, "
                             f"{eng._n_deltas} slots (phase 13: "
                             f"{kept13['n_deltas']})")
        realized_ms = (hist.sum - s0) / (hist.count - c0) * 1e3
        cols = delta_batch(plan, pod_ips, B + CROSS_LANES, 31)
        main = engine_batch(*(c[:B] for c in cols), pod_ips)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = eng.step(main, NOWS[-1] + 1)
        torch.cuda.synchronize()
        delta_step_ms = (time.perf_counter() - t0) * 1e3
        same_result(r, kept13["delta"], "phase 19 (a) vs phase 13, the "
                    "delta step")
    parts["a"] = launched(before)
    if dev.type == "cuda" and not all(parts["a"][:3]):
        raise SystemExit(f"phase 19 (a): (B1, B2, B3, B3h, S1) launches "
                         f"{parts['a']}: a kernel of the path never ran")
    rec["a"] = dict(events=len(events), event_bytes=nbytes,
                    wire_s=wire_s, publish_s=publish_s, sync_s=sync_s,
                    **steps, phase13_steady_ms=kept13["rec"]["steady_ms"],
                    deltas=len(plan), delta_sync_s=delta_sync_s,
                    delta_realized_ms=realized_ms,
                    delta_step_ms=delta_step_ms,
                    sync_hist_count=agent.sync_hist.count,
                    launches=parts["a"])
    log(f"phase 19 (a): {len(events)} events ({nbytes / 1e6:.1f} MB on the "
        f"wire, encoded and decoded in {wire_s:.1f} s) published to the "
        f"agent in {publish_s:.1f} s; sync {sync_s:.1f} s; headline steps "
        f"cold {steps['cold_ms']:.1f} ms, warm {steps['warm_ms']:.2f} ms, "
        f"steady {steps['steady_ms']:.3f} ms (phase 13's engine "
        f"{kept13['rec']['steady_ms']:.3f} ms), bitwise equal to phase 13 "
        f"with dump_flows() and cache_stats(); {len(plan)} UPDATED events "
        f"to {eng._n_deltas} delta slots (no bundle) in "
        f"{delta_sync_s * 1e3:.1f} ms, realized {realized_ms:.1f} ms after "
        f"their stamps (dissemination_hist); delta step "
        f"{delta_step_ms:.1f} ms bitwise equal to phase 13's; (B1, B2, B3, "
        f"B3h, S1) launches {parts['a']}")
    checks = check_phase19(ki.seen, "(a) the agent's engine",
                           ("B1", "B2", "B3"))
    checks = {f"(a) {k}": v for k, v in checks.items()}
    del ki, main, r

    # The agent disconnects; the policy phase 13's last step attributed
    # most lanes to is deleted meanwhile; the re-list's window (the
    # store's snapshot, without it) retracts it at its end.
    hits = {}
    for rid in (*kept13["results"][-1].ingress_rule,
                *kept13["results"][-1].egress_rule):
        if rid is not None:
            uid = rid.split("/", 1)[0]
            hits[uid] = hits.get(uid, 0) + 1
    drop = max(sorted(hits), key=hits.get)
    watch.stop()
    store.apply(serde.event_from_wire(serde.event_to_wire(WatchEvent(
        kind="DELETED", obj_type="NetworkPolicy", name=drop))))
    relist = store.watch_queue(AGENT_NODE, replay=False)
    snap = store.resync(relist).take()
    before = counts5()
    t0 = time.perf_counter()
    agent.begin_resync()
    for ev in snap:
        agent.handle_event(ev)
    agent.end_resync()
    relist_s = time.perf_counter() - t0
    gen = eng.generation
    resync_sync_s = timed_sync(agent, "(a) re-list", gen + 1)
    if drop in {p.uid for p in agent.policy_set.policies}:
        raise SystemExit(f"phase 19: the re-list kept {drop}")
    fresh = engine_batch(tr.src_ip, tr.dst_ip, tr.proto,
                         (1 + np.arange(B) % 1023).astype(np.int32),
                         tr.dst_port, pod_ips)
    now = NOWS[-1] + 5
    got = eng.step(fresh, now)
    parts["relist"] = launched(before)
    moved = sum(1 for a, b in zip(got.ingress_rule + got.egress_rule,
                                  kept13["results"][-1].ingress_rule
                                  + kept13["results"][-1].egress_rule)
                if b is not None and b.startswith(drop + "/") and a != b)
    if moved == 0:
        raise SystemExit(f"phase 19: dropping {drop} moved no lane's rule")
    rec["relist"] = dict(dropped=drop, events=len(snap), relist_s=relist_s,
                         sync_s=resync_sync_s, lanes_moved=moved,
                         launches=parts["relist"])
    log(f"phase 19: {drop} deleted while the agent was away; the re-list "
        f"of {len(snap)} events handled in {relist_s:.1f} s, the "
        f"retraction's sync {resync_sync_s:.1f} s; {moved} lanes no longer "
        f"attributed to it")

    # (b) The mTLS wire over the same store (the world after the deltas
    # and the deletion): a fresh engine built on the smaller set, which the
    # retraction is held to.  The agent's engine keeps its affinity table
    # across the bundle, so a client's earlier flows pin its endpoint where
    # the fresh engine picks anew: on such a lane both are held to the
    # scalar Oracle at their endpoints (StickyWitness, a sample of them),
    # on every other lane to each other.
    rec["b"], parts["b"], kb, rb = drive_wire(store, services, kw, fresh,
                                              now, dev)
    checks.update({f"(b) {k}": v for k, v in kb.items()})
    if rb is not None:
        witness = SampledWitness(agent.policy_set, services,
                                 STICKY_SAMPLE)
        sticky = same_verdicts(got, rb, "phase 19: the retraction vs the "
                               "wire's engine, built on the smaller set",
                               fresh, witness,
                               eng._dsvc.aff_timeout.cpu().numpy())
        rec["relist"].update(sticky_lanes=sticky, sticky_checked=min(
            sticky, STICKY_SAMPLE))
        log(f"phase 19: the retraction's {B} fresh lanes bitwise equal to "
            f"the wire's engine ({sticky} lanes of affinity services at "
            f"other sticky endpoints, {min(sticky, STICKY_SAMPLE)} of them "
            f"held to the scalar Oracle)")
    relist.stop()
    del rb, got, fresh

    # (d) The surfaces on (a)'s engine.
    before = counts5()
    rec["d"] = drive_surfaces(eng, agent, tr, kept13["results"][-1].svc_idx,
                              dev)
    parts["d"] = launched(before)
    del eng, agent, store, events, snap
    gc.collect()
    torch.cuda.empty_cache()

    # (c) The pipe transport on its own world.
    before = counts5()
    rec["c"] = drive_pipe(dev)
    parts["c"] = launched(before)
    rec["seconds"] = time.perf_counter() - t19
    log(f"phase 19 took {rec['seconds']:.1f} s; launches by part "
        f"(B1, B2, B3, B3h, S1) {parts}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    return rec, parts, checks


# ---- phase 20: the controller's fan-out and status plane -------------------
# The reference controller's own scale test, "xLargeScale"
# (networkpolicy_controller_perf_test.go:46-52: 25,000 namespaces, 100,000
# pods, 75,000 NetworkPolicies), its pods placed on FLEET_NODES nodes as
# bench_controller.py's populate places them.  node-0 runs the port's agent,
# whose engine is on the card; every other node runs a watch-only fake agent
# (simulator/fleet.py, the antrea-agent-simulator model).  (b)'s storm takes
# bench_controller.py's fleet_storm knobs, on its --small world.
FLEET_NODES = 64
FLEET_NS = 25_000
FLEET_PODS_PER_NS = 4
FLEET_NPS_PER_NS = 3
FLEET_B = B
FLEET_SLOTS = FLOW_SLOTS
STORM_NS = 2_500
STORM_ROUNDS = 3
STORM_CHURN = 128
STORM_CAP = 64
STORM_LANES = 4096
STORM_MAX_CYCLES = 2000
STORM_TAIL = 20
FLEET_FIELDS = ("code", "est", "reply", "svc_idx", "dnat_ip", "dnat_port",
                "committed")


def fleet_populate(ctl, n_ns, pods_per_ns, nps_per_ns) -> int:
    """bench_controller.py's populate on the port's apis.crd: n_ns
    namespaces, each of pods_per_ns pods (app-0 / app-1, on node
    (i * pods_per_ns + j) % FLEET_NODES) and nps_per_ns K8s NetworkPolicies
    (app-(k % 2) isolated, open to app-((k + 1) % 2) on TCP 80) -> the
    events the controller emitted."""
    from antrea_tpu_torch.apis.crd import (K8sNetworkPolicy, K8sNPRule,
                                           K8sPeer, LabelSelector, Namespace,
                                           Pod, PortSpec)

    n_events = 0

    def count(_ev):
        nonlocal n_events
        n_events += 1

    ctl.subscribe(count)
    for i in range(n_ns):
        ns = f"ns-{i}"
        ctl.upsert_namespace(Namespace(name=ns, labels={"team": f"t{i % 50}"}))
        for j in range(pods_per_ns):
            ctl.upsert_pod(Pod(
                name=f"pod-{j}", namespace=ns,
                labels={"app": f"app-{j % 2}"},
                ip=f"10.{(i >> 8) & 255}.{i & 255}.{j + 1}",
                node=f"node-{(i * pods_per_ns + j) % FLEET_NODES}",
            ))
        for k in range(nps_per_ns):
            ctl.upsert_k8s_policy(K8sNetworkPolicy(
                uid=f"np-{i}-{k}", name=f"np-{k}", namespace=ns,
                pod_selector=LabelSelector.make({"app": f"app-{k % 2}"}),
                ingress=[K8sNPRule(
                    peers=[K8sPeer(pod_selector=LabelSelector.make(
                        {"app": f"app-{(k + 1) % 2}"}))],
                    ports=[PortSpec(protocol=6, port=80)],
                )],
            ))
    return n_events


def storm_pods(ctl, nodes):
    """One app=web pod a node (bench_controller.py's storm world), in a
    namespace of their own, at 10.200.0.<n + 1>: addresses populate never
    gives (its 10.<i >> 8>.<i & 255>.1 would be pod-0 of namespace i)."""
    from antrea_tpu_torch.apis.crd import Namespace, Pod

    ctl.upsert_namespace(Namespace(name="storm", labels={"team": "storm"}))
    for n, node in enumerate(nodes):
        ctl.upsert_pod(Pod(name=f"web-{n}", namespace="storm",
                           labels={"app": "web"}, ip=f"10.200.0.{n + 1}",
                           node=node))


def pod_u32(i, j):
    """populate's address of pod j of namespace i, as a u32."""
    return ((10 << 24) | (((i >> 8) & 255) << 16) | ((i & 255) << 8)
            | (j + 1))


def fleet_lanes(n_ns, pods_per_ns, n, seed):
    """n seeded lanes toward node-0's pods: half from a pod of the other
    app in the destination's namespace (the one peer its policies open, on
    TCP 80 only), half from any pod of the world; destination port 80 on
    half of them, any port on the rest; one lane in ten UDP."""
    import numpy as np

    from antrea_tpu_torch.packet import PacketBatch

    rng = np.random.default_rng(seed)
    i = np.repeat(np.arange(n_ns), pods_per_ns)
    j = np.tile(np.arange(pods_per_ns), n_ns)
    mine = (i * pods_per_ns + j) % FLEET_NODES == 0
    pick = rng.integers(0, int(mine.sum()), n)
    di, dj = i[mine][pick], j[mine][pick]
    near = rng.random(n) < 0.5
    # The other app's pods in the same namespace: j' = j + 1 + 2m (mod).
    nj = (dj + 1 + 2 * rng.integers(0, max(1, pods_per_ns // 2), n)) \
        % pods_per_ns
    si = np.where(near, di, rng.integers(0, n_ns, n))
    sj = np.where(near, nj, rng.integers(0, pods_per_ns, n))
    dport = np.where(rng.random(n) < 0.5, 80,
                     rng.integers(1, 65536, n)).astype(np.int32)
    proto = np.where(rng.random(n) < 0.1, 17, 6).astype(np.int32)
    return PacketBatch(
        src_ip=pod_u32(si, sj).astype(np.uint32),
        dst_ip=pod_u32(di, dj).astype(np.uint32), proto=proto,
        src_port=rng.integers(1024, 65536, n).astype(np.int32),
        dst_port=dport)


def storm_lanes(n, web_ip, seed):
    """n seeded TCP lanes toward node-0's web pod from the storm's CIDRs:
    every round's 198.<r>.<k>.0/24 and storm-0's rewrites' 203.<0 or
    1>.<j>.0/24 (the storm's, then the live tail's), so that the last
    round's drops and the lifted ones both occur."""
    import numpy as np

    from antrea_tpu_torch.packet import PacketBatch
    from antrea_tpu_torch.utils import ip as iputil

    rng = np.random.default_rng(seed)
    r = rng.integers(1, STORM_ROUNDS + 1, n)
    k = rng.integers(0, STORM_CHURN, n)
    rewrite = rng.random(n) < 0.25
    a = np.where(rewrite, 203, 198)
    b = np.where(rewrite, rng.integers(0, 2, n), r)
    c = np.where(rewrite, rng.integers(0, STORM_TAIL, n), k)
    src = (a << 24) | (b << 16) | (c << 8) | rng.integers(1, 255, n)
    return PacketBatch(
        src_ip=src.astype(np.uint32),
        dst_ip=np.full(n, iputil.ip_to_u32(web_ip), np.uint32),
        proto=np.full(n, 6, np.int32),
        src_port=rng.integers(1024, 65536, n).astype(np.int32),
        dst_port=np.full(n, 80, np.int32))


class LaunchReader:
    """Sums the (B1, B2, B3, B3h, S1) launches of the calls it runs, each
    read before and after (the counts are read, never written), and records
    the kernels' inputs while they run (KernelInputs)."""

    def __init__(self):
        self.total = [0, 0, 0, 0, 0]
        self.ki = KernelInputs()

    def run(self, fn, *a, **k):
        before = counts5()
        with self.ki:
            out = fn(*a, **k)
        self.total = [x + y for x, y in zip(self.total, launched(before))]
        return out

    def held(self, what, dev):
        """The first recorded call of each kernel held bitwise to its plain
        version.  B3 carries every step's misses, so it must have launched;
        B1 (the one-pass fallback: a lane with more than PRUNE_K candidate
        superblocks) and B2 (the canary's pruned classify, when a probe's
        aggregate AND is not zero) run where the data needs them, and each
        that launched must have been recorded."""
        need = ["B3"] + [t for t, n in zip(("B1", "B2"), self.total) if n]
        if dev.type == "cuda" and not self.total[2]:
            raise SystemExit(f"phase 20 {what}: (B1, B2, B3, B3h, S1) "
                             f"launches {self.total}: B3 never ran")
        return check_phase19(self.ki.seen, what, need, phase=20)


def same_policy_sets(got, want, what):
    """The agent's PolicySet against the controller's span for its node:
    policy uids with their generations, and the group names."""
    g = {p.uid: p.generation for p in got.policies}
    w = {p.uid: p.generation for p in want.policies}
    if g != w:
        raise SystemExit(f"{what}: {len(g)} policies, the span holds "
                         f"{len(w)} ({len(g.keys() ^ w.keys())} uids differ)")
    for part in ("address_groups", "applied_to_groups"):
        if set(getattr(got, part)) != set(getattr(want, part)):
            raise SystemExit(f"{what}: {part} differ from the span's")


def same_lanes(a, b, what, rules):
    """FLEET_FIELDS bitwise equal; the rule ids too when `rules`."""
    import numpy as np

    for f in FLEET_FIELDS:
        if not np.array_equal(getattr(a, f), getattr(b, f)):
            raise SystemExit(f"{what}: {f} differs")
    if a.n_miss != b.n_miss:
        raise SystemExit(f"{what}: {a.n_miss} misses, {b.n_miss}")
    if rules and (a.ingress_rule != b.ingress_rule
                  or a.egress_rule != b.egress_rule):
        raise SystemExit(f"{what}: rule attribution differs")


def oracle_sample(ps, batch, res, what, n=STICKY_SAMPLE):
    """The first n/2 allowed and n/2 dropped lanes of a step held to the
    scalar Oracle on the same PolicySet: code and rule ids."""
    import numpy as np

    from antrea_tpu_torch.oracle import Oracle

    code = np.asarray(res.code)
    lanes = (list(np.flatnonzero(code == 0)[:n // 2])
             + list(np.flatnonzero(code != 0)[:n // 2]))
    if len(lanes) < n:
        raise SystemExit(f"{what}: {int((code == 0).sum())} allowed and "
                         f"{int((code != 0).sum())} dropped lanes; the "
                         f"sample needs {n // 2} of each")
    o = Oracle(ps)
    for i in lanes:
        v = o.classify(batch.packet(int(i)))
        got = (int(code[i]), res.ingress_rule[i], res.egress_rule[i])
        want = (int(v.code), v.ingress.rule, v.egress.rule)
        if got != want:
            raise SystemExit(f"{what}: lane {i} (code, ingress rule, egress "
                             f"rule) {got}, the Oracle's {want}")
    return len(lanes)


def fleet_engine(ps, dev):
    """node-0's engine: phase 13's one-pass knobs, no Services (the scale
    test's world has none), no topology."""
    from antrea_tpu_torch.datapath import TpuflowDatapath

    return TpuflowDatapath(ps, [], device=dev, flow_slots=FLEET_SLOTS,
                           miss_chunk=MISS_CHUNK, canary_probes=ENGINE_PROBES,
                           fused=True, prune_budget=PRUNE_K)


def drive_fan_out(dev):
    """Phase 20 (a): the port's NetworkPolicyController at xLargeScale
    feeding a RamStore, watched by FLEET_NODES - 1 inproc fake agents and by
    node-0's AgentPolicyController (a queued watch, drained into the agent
    each pump), all reporting to one StatusAggregator; then node-0's
    engine against a reference engine built from the controller's span for
    node-0 -> (record, launches, recorded kernel checks)."""
    import gc
    import resource

    import numpy as np
    import torch

    from antrea_tpu_torch.agent import AgentPolicyController
    from antrea_tpu_torch.controller import NetworkPolicyController
    from antrea_tpu_torch.controller.status import (PHASE_REALIZED,
                                                     StatusAggregator)
    from antrea_tpu_torch.dissemination import RamStore
    from antrea_tpu_torch.simulator.fleet import (FakeAgentFleet,
                                                  fleet_converged)

    rec = {}
    nodes = [f"node-{i}" for i in range(FLEET_NODES)]
    ctl = NetworkPolicyController()
    store = RamStore()
    ctl.subscribe(store.apply)
    agg = StatusAggregator(ctl)
    report = agg.make_agent_reporter()
    fleet = FakeAgentFleet(store, nodes[1:], status_reporter=report)
    eng = fleet_engine(None, dev)
    agent = AgentPolicyController(AGENT_NODE, eng, status_reporter=report)
    watch0 = store.watch_queue(AGENT_NODE)
    lr = LaunchReader()

    t0 = time.perf_counter()
    emitted = fleet_populate(ctl, FLEET_NS, FLEET_PODS_PER_NS,
                             FLEET_NPS_PER_NS)
    rec["controller_s"] = time.perf_counter() - t0
    counts_ = ctl.object_counts()
    t0 = time.perf_counter()
    fleet.pump()
    seen0 = 0
    for ev in watch0.drain():
        agent.handle_event(ev)
        seen0 += 1
    rec["pump_s"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lr.run(agent.sync)
    torch.cuda.synchronize()
    rec["sync_s"] = time.perf_counter() - t0
    clean_sync(agent, "phase 20 (a) node-0", 1)

    t0 = time.perf_counter()
    if not fleet_converged(ctl, fleet, nodes[1:]):
        raise SystemExit("phase 20 (a): the fake agents do not hold their "
                         "nodes' spans")
    want0 = ctl.policy_set_for_node(AGENT_NODE)
    same_policy_sets(agent.policy_set, want0, "phase 20 (a) node-0's agent")
    rec["converged_check_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    statuses = agg.all_statuses()
    rec["status_s"] = time.perf_counter() - t0
    bad = [s for s in statuses if s.phase != PHASE_REALIZED
           or s.current_nodes != s.desired_nodes]
    if len(statuses) != counts_["networkPolicies"] or bad:
        raise SystemExit(f"phase 20 (a): {len(statuses)} statuses for "
                         f"{counts_['networkPolicies']} policies, "
                         f"{len(bad)} not Realized on their whole span "
                         f"(first: {bad[:1]})")
    per_node = sorted([a.events_seen for a in fleet.agents.values()]
                      + [seen0])
    rec.update(namespaces=FLEET_NS, nodes=FLEET_NODES,
               controller_events=emitted, **counts_,
               events_delivered=sum(per_node),
               events_per_node_min=per_node[0],
               events_per_node_median=per_node[len(per_node) // 2],
               events_per_node_max=per_node[-1], node0_events=seen0,
               node0_policies=len(want0.policies),
               node0_rules=sum(len(p.rules) for p in want0.policies),
               node0_address_groups=len(want0.address_groups),
               node0_applied_to_groups=len(want0.applied_to_groups),
               statuses=len(statuses),
               peak_rss_gib=resource.getrusage(
                   resource.RUSAGE_SELF).ru_maxrss / 2**20)
    log(f"phase 20 (a): the controller computed {FLEET_NS} namespaces, "
        f"{FLEET_NS * FLEET_PODS_PER_NS} pods, {counts_['networkPolicies']} "
        f"NetworkPolicies ({counts_['addressGroups']} address groups, "
        f"{counts_['appliedToGroups']} appliedTo groups; {emitted} events, "
        f"fanned out to {FLEET_NODES} watchers) in "
        f"{rec['controller_s']:.1f} s; the pump delivered "
        f"{rec['events_delivered']} events (a node: min {per_node[0]}, "
        f"median {rec['events_per_node_median']}, max {per_node[-1]}; "
        f"node-0 {seen0}) in {rec['pump_s']:.1f} s; node-0 holds "
        f"{rec['node0_policies']} policies, {rec['node0_rules']} rules, "
        f"synced in {rec['sync_s']:.1f} s; spans held in "
        f"{rec['converged_check_s']:.1f} s; {len(statuses)} statuses "
        f"Realized on their whole span, aggregated in "
        f"{rec['status_s']:.1f} s; peak RSS {rec['peak_rss_gib']:.2f} GiB")
    del fleet, statuses
    watch0.stop()

    # node-0's engine against one built from the controller's span.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = fleet_engine(want0, dev)
    torch.cuda.synchronize()
    rec["reference_build_s"] = time.perf_counter() - t0
    order = ([p.uid for p in agent.policy_set.policies]
             == [p.uid for p in want0.policies])
    batch = fleet_lanes(FLEET_NS, FLEET_PODS_PER_NS, FLEET_B, 20)
    times, first = [], None
    for k, now in enumerate(NOWS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = lr.run(eng.step, batch, now)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        want = ref.step(batch, now)
        same_lanes(r, want, f"phase 20 (a) step {k}: node-0's engine vs "
                   f"the span's", order)
        if first is None:
            first = r
    steps = step_stats(times)
    code = np.asarray(first.code)
    n_oracle = oracle_sample(agent.policy_set, batch, first,
                             "phase 20 (a) node-0's engine")
    rec.update(**steps, lanes=FLEET_B, allowed=int((code == 0).sum()),
               dropped=int((code != 0).sum()),
               est_last=int(np.asarray(r.est).sum()),
               rule_ids_held=order, oracle_lanes=n_oracle,
               launches=lr.total)
    held = ("too (both in the controller's order)" if order else
            "NOT held (the agent holds the policies in another order)")
    log(f"phase 20 (a): node-0's engine on {FLEET_B} lanes toward its pods "
        f"({rec['allowed']} allowed, {rec['dropped']} dropped by the K8s "
        f"isolation): cold {steps['cold_ms']:.1f} ms, warm "
        f"{steps['warm_ms']:.2f} ms, steady {steps['steady_ms']:.3f} ms "
        f"({steps['steady_pps'] / 1e6:.2f} M packets/s); code, est and "
        f"DNAT bitwise equal to the span's engine (built in "
        f"{rec['reference_build_s']:.1f} s) on all {len(NOWS)} steps, rule "
        f"ids {held}; {n_oracle} lanes held to the scalar Oracle; (B1, B2, "
        f"B3, B3h, S1) launches {lr.total}")
    del eng, ref, agent, ctl, store, agg, first, r, want, batch
    gc.collect()
    torch.cuda.empty_cache()
    return rec, lr.total, lr.held("(a) node-0's engine", dev)


class AgentView:
    """An AgentPolicyController's objects as fleet_converged reads a fake
    agent's tables."""

    def __init__(self, agent):
        self._agent = agent

    @property
    def policies(self):
        return {p.uid: p for p in self._agent.policy_set.policies}

    @property
    def address_groups(self):
        return self._agent.policy_set.address_groups

    @property
    def applied_to_groups(self):
        return self._agent.policy_set.applied_to_groups


class FleetAndAgent:
    """run_churn_storm's fleet: the netwire fake fleet, and node-0's
    NetAgent pumped and synced (its realization reported) every cycle, its
    engine's calls counted and recorded by `lr`."""

    def __init__(self, fleet, na, lr):
        self.fleet, self.na, self.lr = fleet, na, lr
        self.agents = dict(fleet.agents)
        self.agents[na.node] = AgentView(na.agent)

    def pump(self) -> int:
        n = self.fleet.pump() + self.na.pump(wait=0.05)
        self.lr.run(self.na.sync_and_report)
        clean_sync(self.na.agent, "phase 20 (b) node-0")
        return n

    def queue_stats(self):
        return self.fleet.queue_stats()

    def resyncs_seen_total(self):
        return self.fleet.resyncs_seen_total() + self.na.resyncs_total

    def total_events(self):
        return self.fleet.total_events()

    def realization_p99_s(self):
        return self.fleet.realization_p99_s()

    def realization_unstamped_total(self):
        return self.fleet.realization_unstamped_total()


def drive_storm(dev):
    """Phase 20 (b): one DisseminationServer with a StatusAggregator and
    bench_controller.py's fleet_storm knobs over a STORM_NS world, 63
    NetFakeAgents and node-0's NetAgent over mutual TLS (one fake agent's
    sockets reset by a FaultPlan), STORM_ROUNDS rounds of run_churn_storm;
    node-0's engine against one built from the controller's span; antctl
    get policystatus against the port's ControllerApiServer -> (record,
    launches, recorded kernel checks)."""
    import gc
    import os
    import tempfile

    import numpy as np
    import torch

    from antrea_tpu_torch.controller import NetworkPolicyController
    from antrea_tpu_torch.controller.apiserver import ControllerApiServer
    from antrea_tpu_torch.controller.status import (PHASE_REALIZED,
                                                     StatusAggregator)
    from antrea_tpu_torch.dissemination import FaultPlan, RamStore
    from antrea_tpu_torch.dissemination.netwire import (Backoff,
                                                         DisseminationServer,
                                                         NetAgent, make_ca)
    from antrea_tpu_torch.simulator.fleet import (FakeAgentFleet,
                                                  _storm_policy,
                                                  fleet_converged,
                                                  run_churn_storm)

    backend = tls_backend()
    if not backend:
        raise SystemExit("phase 20 (b): neither the cryptography package nor "
                         "the openssl binary is on this machine")
    rec = {"tls": backend, "namespaces": STORM_NS}
    nodes = [f"node-{i}" for i in range(FLEET_NODES)]
    ctl = NetworkPolicyController()
    store = RamStore()
    ctl.subscribe(store.apply)
    t0 = time.perf_counter()
    fleet_populate(ctl, STORM_NS, FLEET_PODS_PER_NS, FLEET_NPS_PER_NS)
    storm_pods(ctl, nodes)
    rec["controller_s"] = time.perf_counter() - t0
    plan = FaultPlan(seed=7)
    plan.prob(f"{nodes[1]}.send", 0.05, "reset", times=2)
    plan.prob(f"{nodes[1]}.recv", 0.05, "reset", times=2)
    concurrency = max(4, FLEET_NODES // 32)
    lr = LaunchReader()
    agg = StatusAggregator(ctl)
    with tempfile.TemporaryDirectory() as certdir:
        t0 = time.perf_counter()
        make_ca(certdir)
        srv = DisseminationServer(
            store, certdir, status_aggregator=agg,
            watcher_max_pending=STORM_CAP, resync_chunk=256,
            resync_concurrency=concurrency, drain_max=256,
            send_budget=100_000)
        fleet = na = api = None
        try:
            fleet = FakeAgentFleet(
                None, nodes[1:], transport="netwire", server=srv,
                certdir=certdir, fault_plan=plan,
                backoff_factory=lambda n: Backoff(base=0.01, cap=0.1,
                                                  node=n))
            eng = fleet_engine(None, dev)
            na = NetAgent(AGENT_NODE, srv.address, certdir, eng)
            srv.wait_connected(FLEET_NODES, timeout=30.0)
            rec["bring_up_s"] = time.perf_counter() - t0
            both = FleetAndAgent(fleet, na, lr)
            t0 = time.perf_counter()
            cycles = 0
            while True:
                both.pump()
                cycles += 1
                if (srv.dissemination_stats()["resyncs_inflight"] == 0
                        and fleet_converged(ctl, both, nodes)):
                    break
                if cycles >= STORM_MAX_CYCLES:
                    raise SystemExit("phase 20 (b): the fleet's first "
                                     "re-list did not converge")
            rec.update(relist_s=time.perf_counter() - t0,
                       relist_cycles=cycles)
            t0 = time.perf_counter()
            try:
                meters = run_churn_storm(
                    ctl, both, nodes, rounds=STORM_ROUNDS,
                    churn=STORM_CHURN, cap=STORM_CAP,
                    resync_concurrency=concurrency,
                    max_cycles=STORM_MAX_CYCLES)
            except AssertionError as e:
                raise SystemExit(f"phase 20 (b): {e}") from None
            rec["storm_s"] = time.perf_counter() - t0
            # The live tail (bench_controller.py's): the storm injects every
            # change before it pumps, so its deliveries are re-list replays,
            # unstamped; same-key rewrites against the converged fleet, one
            # pump a commit, are what the realization histograms measure.
            t0 = time.perf_counter()
            for j in range(STORM_TAIL):
                ctl.upsert_antrea_policy(_storm_policy(
                    "storm-0", f"203.1.{j}.0/24"))
                both.pump()
            both.pump()
            rec["tail_s"] = time.perf_counter() - t0
            meters["realization_p99_s"] = fleet.realization_p99_s()
            meters["realization_measured"] = fleet.realization_hist().count
            # The statuses of the last cycle's syncs arrive with the next
            # server pump.
            storm = {f"storm-{k}" for k in range(STORM_CHURN)}
            for _ in range(20):
                both.pump()
                st = {s.uid: s for s in agg.all_statuses() if s.uid in storm}
                if len(st) == STORM_CHURN and all(
                        s.phase == PHASE_REALIZED
                        and s.current_nodes == s.desired_nodes == FLEET_NODES
                        for s in st.values()):
                    break
            else:
                seen = sorted((s.phase, s.current_nodes) for s in st.values())
                raise SystemExit(f"phase 20 (b): storm statuses {seen[:4]}")
            api = ControllerApiServer(ctl, store=store, status=agg).start()
            t0 = time.perf_counter()
            out = subprocess.run(
                [sys.executable, "-m", "antrea_tpu_torch.antctl", "get",
                 "policystatus", "--server",
                 f"http://127.0.0.1:{api.address[1]}"],
                capture_output=True, text=True, timeout=300, check=True,
                cwd=os.path.dirname(os.path.abspath(__file__)),
                env={**os.environ, "OMP_NUM_THREADS": "1"})
            rec["antctl_s"] = time.perf_counter() - t0
            rows = {r["uid"]: r for r in json.loads(out.stdout)["items"]}
            if not all(rows.get(u, {}).get("phase") == PHASE_REALIZED
                       and rows[u]["currentNodesRealized"] == FLEET_NODES
                       for u in storm):
                raise SystemExit("phase 20 (b): antctl get policystatus does "
                                 "not list every storm policy Realized on "
                                 "every node")
            hist = na.agent.dissemination_hist
            rec.update(meters, policystatus_rows=len(rows),
                       faults_injected=plan.count(),
                       node0_resyncs=na.resyncs_total,
                       node0_syncs=na.agent.sync_hist.count,
                       node0_dissemination_count=hist.count,
                       node0_dissemination_mean_ms=(
                           hist.sum / hist.count * 1e3 if hist.count else 0),
                       node0_dissemination_p99_s=hist.quantile(0.99))
            # node-0's engine against one built from the span.
            want0 = ctl.policy_set_for_node(AGENT_NODE)
            same_policy_sets(na.agent.policy_set, want0,
                             "phase 20 (b) node-0's agent")
            ref = fleet_engine(want0, dev)
            order = ([p.uid for p in na.agent.policy_set.policies]
                     == [p.uid for p in want0.policies])
            batch = storm_lanes(STORM_LANES, "10.200.0.1", 21)
            for k, now in enumerate((100, 101)):
                r = lr.run(eng.step, batch, now)
                same_lanes(r, ref.step(batch, now),
                           f"phase 20 (b) step {k}: node-0's engine vs the "
                           f"span's", True)
            code = np.asarray(r.code)
            n_oracle = oracle_sample(na.agent.policy_set, batch, r,
                                     "phase 20 (b) node-0's engine")
            rec.update(lanes=STORM_LANES, dropped=int((code != 0).sum()),
                       node0_policies=len(want0.policies), same_order=order,
                       oracle_lanes=n_oracle, launches=lr.total)
        finally:
            if api is not None:
                api.stop()
            if na is not None:
                na.close()
            if fleet is not None:
                fleet.stop()
            srv.close()
    log(f"phase 20 (b): {STORM_NS} namespaces over mutual TLS "
        f"({backend}): the controller {rec['controller_s']:.1f} s, PKI and "
        f"{FLEET_NODES} handshakes {rec['bring_up_s']:.1f} s, the first "
        f"re-list converged in {rec['relist_cycles']} cycles, "
        f"{rec['relist_s']:.1f} s; the storm ({STORM_ROUNDS} rounds of "
        f"{STORM_CHURN} upserts and {meters['rewrites']} rewrites, cap "
        f"{STORM_CAP}) {rec['storm_s']:.1f} s, its live tail of "
        f"{STORM_TAIL} rewrites {rec['tail_s']:.1f} s: {json.dumps(meters)}; "
        f"{plan.count()} faults injected; node-0: {na.resyncs_total} "
        f"re-lists, {rec['node0_syncs']} syncs, dissemination_hist count "
        f"{hist.count}, mean {rec['node0_dissemination_mean_ms']:.1f} ms, "
        f"p99 {rec['node0_dissemination_p99_s']:.3f} s; its engine's "
        f"{STORM_LANES} storm lanes ({rec['dropped']} dropped) bitwise "
        f"equal to the span's engine, rule ids included (policy order "
        f"{'the same' if order else 'another'}); {n_oracle} lanes held to "
        f"the scalar Oracle; antctl get policystatus listed {len(rows)} "
        f"policies in {rec['antctl_s']:.1f} s, the {STORM_CHURN} storm "
        f"policies Realized on all {FLEET_NODES} nodes; (B1, B2, B3, B3h, "
        f"S1) launches {lr.total}")
    del eng, ref, na, fleet, ctl, store, agg
    gc.collect()
    torch.cuda.empty_cache()
    return rec, lr.total, lr.held("(b) node-0's engine", dev)


def drive_fleet(dev):
    """Phase 20: (a) drive_fan_out, (b) drive_storm -> (record, {part:
    launches}, {name: kernel record})."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("phase 20 needs CUDA")
    t20 = time.perf_counter()
    rec, parts, checks = {}, {}, {}
    rec["a"], parts["a"], ka = drive_fan_out(dev)
    rec["b"], parts["b"], kb = drive_storm(dev)
    for part, k in (("a", ka), ("b", kb)):
        checks.update({f"({part}) {n}": v for n, v in k.items()})
    rec["seconds"] = time.perf_counter() - t20
    log(f"phase 20 took {rec['seconds']:.1f} s; launches by part (B1, B2, "
        f"B3, B3h, S1) {parts} (B3h and S1 are not on this path)")
    return rec, parts, checks


# The phases run by child processes of the script, each by phase_main.
# ---- phase 21: the static-analysis plane and the card's sync census --------
# Steady steps of each path the census runs twice (under the sync debug
# mode and without it), after a cold and a warm step.
CENSUS_STEPS = 4


def result_digest(r) -> str:
    """sha256 of every field of a StepResult (arrays by their bytes, the
    rule-id lists and counts by their JSON)."""
    import dataclasses
    import hashlib

    import numpy as np

    h = hashlib.sha256()
    for f in dataclasses.fields(r):
        v = getattr(r, f.name)
        h.update(f.name.encode())
        if isinstance(v, np.ndarray):
            h.update(str(v.dtype).encode() + np.ascontiguousarray(v).tobytes())
        else:
            h.update(json.dumps(jsonable(v), sort_keys=True).encode())
    return h.hexdigest()


def census_steps(run, n, census):
    """n steady steps through run(i) -> (digests, seconds per step, (B1, B2,
    B3, B3h, S1) launches, the census or None), under the sync debug mode
    when census is set (a SyncCensus), the launch counts read around the
    steps (never written), the kernels' inputs recorded (KernelInputs)
    while the census runs."""
    import contextlib

    import torch

    ki = KernelInputs()
    before = counts5()
    outs, times = [], []
    with census if census is not None else contextlib.nullcontext(), \
            ki if census is not None else contextlib.nullcontext():
        for i in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs.append(run(i))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    return outs, times, launched(before), ki.seen


def drive_census(cps, svc, ps, services, pod_ips, tr, dev):
    """Phase 21: (a) the port's static-analysis suite over this checkout,
    clean with an empty baseline; (b) the sync census: phase 13's one-pass
    engine and the bare staged fused step, each warmed (a cold and a warm
    step), then CENSUS_STEPS steady steps from one cloned state twice,
    under torch.cuda.set_sync_debug_mode("warn") and without it: every
    StepResult field (the engine) or output (the bare step) and the final
    state bitwise equal, the syncs a step printed by site, every sync in
    models/ or ops/ at a function HOST_SYNCS declares, B3 launched on the
    engine's steps and B1 on the staged step's, the first call of each held
    to its plain version.  -> (record, {path: kernel records}, {path:
    launches})."""
    import gc

    import torch

    from antrea_tpu_torch import analysis
    from antrea_tpu_torch.analysis import host_sync
    from antrea_tpu_torch.datapath import TpuflowDatapath
    from antrea_tpu_torch.models import pipeline as pl
    from antrea_tpu_torch.utils.sync_census import SyncCensus

    t21 = time.perf_counter()
    t0 = time.perf_counter()
    res = analysis.run()
    analysis_s = time.perf_counter() - t0
    baseline, problems = analysis.load_baseline(analysis.REPO)
    if not res.clean or res.suppressed or baseline or problems:
        raise SystemExit(
            "analysis: " + "; ".join([f.render() for f in res.findings]
                                     + res.errors + problems)
            + f" ({len(res.suppressed)} suppressed, baseline rows "
              f"{sorted(baseline)})")
    log(f"analysis: {len(res.pass_ids)} passes clean over "
        f"{analysis.REPO} in {analysis_s:.2f} s, empty baseline: "
        + ", ".join(res.pass_ids))
    declared = host_sync.declared(analysis.REPO)
    rec = dict(analysis_s=analysis_s, passes=res.pass_ids)
    kern, launches, undeclared = {}, {}, []

    def census_of(what, run, reset, final, tags):
        """Both runs of one path: reset() puts the path's state back to
        the warm clone, run(i) steps it (-> a thunk of the step's
        digests, taken after the run), final() digests the state."""
        census = SyncCensus()
        got = {}
        for mode in ("census", "plain"):
            reset()
            outs, times, n, seen = census_steps(
                run, CENSUS_STEPS, census if mode == "census" else None)
            got[mode] = dict(digests=[o() for o in outs], times=times,
                             launches=n, final=final())
            if mode == "census":
                kern[what] = check_phase19(seen, f"21 {what}", tags,
                                           phase=21)
        if (got["census"]["digests"] != got["plain"]["digests"]
                or got["census"]["final"] != got["plain"]["final"]):
            raise SystemExit(f"census {what}: the steps under the sync "
                             f"debug mode differ from the same steps "
                             f"without it")
        if got["census"]["launches"] != got["plain"]["launches"]:
            raise SystemExit(f"census {what}: launches "
                             f"{got['census']['launches']} under the mode, "
                             f"{got['plain']['launches']} without it")
        bad = census.undeclared(declared)
        sites = {f"{r}:{k}": n / CENSUS_STEPS
                 for (r, k), n in census.sites.most_common()}
        held = {f"{r}:{k}": n / CENSUS_STEPS
                for (r, k), n in census.held().items()}
        lines = {f"{r}:{k}:{ln}": n / CENSUS_STEPS
                 for (r, k, ln), n in census.lines.most_common()}
        med = sorted(got["plain"]["times"])[CENSUS_STEPS // 2]
        med_c = sorted(got["census"]["times"])[CENSUS_STEPS // 2]
        out = dict(syncs_per_step=census.total / CENSUS_STEPS,
                   held_per_step=sum(held.values()), sites=sites,
                   lines=lines, unattributed=census.unattributed,
                   frame_matches=census.frame_matches,
                   launches=got["plain"]["launches"], steady_ms=med * 1e3,
                   steady_ms_census=med_c * 1e3)
        log(f"census {what}: {census.total / CENSUS_STEPS:g} syncs a step "
            f"({out['held_per_step']:g} in models/ and ops/, "
            f"{census.unattributed} with no package frame; the warning "
            f"named the attributed frame for {census.frame_matches} of "
            f"{census.total}); steady {med * 1e3:.3f} ms/step, "
            f"{med_c * 1e3:.3f} under the mode; bitwise equal with and "
            f"without the mode; (B1, B2, B3, B3h, S1) launches "
            f"{got['plain']['launches']} in each run")
        for site, n in sites.items():
            log(f"  {n:g} a step  {site}")
        for site, n in lines.items():
            log(f"    {n:g} a step  {site}")
        undeclared.extend(f"{what}: {r}:{k} ({n / CENSUS_STEPS:g} a step)"
                          for (r, k), n in sorted(bad.items()))
        launches[what] = got["plain"]["launches"]
        return out

    # The one-pass engine (phase 13's knobs).
    kw = dict(flow_slots=FLOW_SLOTS, miss_chunk=MISS_CHUNK,
              canary_probes=ENGINE_PROBES, topology=node0_spec(pod_ips),
              fused=True, prune_budget=PRUNE_K)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = TpuflowDatapath(world_copy(ps), services, device=dev, **kw)
    hb = engine_batch(tr.src_ip, tr.dst_ip, tr.proto, tr.src_port,
                      tr.dst_port, pod_ips)
    for now in NOWS[:2]:
        eng.step(hb, now)
    torch.cuda.synchronize()
    rec["engine_build_warm_s"] = time.perf_counter() - t0
    s0 = pl.clone_state(eng._state)

    def reset_engine():
        eng._state = pl.clone_state(s0)

    def step_engine(i):
        r = eng.step(hb, NOWS[2 + i])
        return lambda: result_digest(r)

    rec["engine"] = census_of("one-pass engine", step_engine, reset_engine,
                              lambda: digests([], eng._state)[1], ["B3"])
    if not launches["one-pass engine"][2]:
        raise SystemExit(f"census: B3 did not launch on the engine's steps "
                         f"{launches['one-pass engine']}")
    del eng, s0
    gc.collect()
    torch.cuda.empty_cache()

    # The bare staged fused step.
    t0 = time.perf_counter()
    step, state, (drs, dsvc) = pl.make_pipeline(
        cps, svc, flow_slots=FLOW_SLOTS, miss_chunk=MISS_CHUNK, fused=True,
        device=dev)
    lanes = to_lanes(tr, dev)
    for now in NOWS[:2]:
        state, _ = step(state, drs, dsvc, *lanes, now, 0)
    torch.cuda.synchronize()
    rec["staged_build_warm_s"] = time.perf_counter() - t0
    s0 = pl.clone_state(state)
    cur = {}

    def reset_staged():
        cur["state"] = pl.clone_state(s0)

    def step_staged(i):
        cur["state"], out = step(cur["state"], drs, dsvc, *lanes,
                                 NOWS[2 + i], 0)
        out = {k: v.clone() for k, v in out.items()}
        return lambda: digests([out], ())[0][0]

    rec["staged"] = census_of("staged step", step_staged, reset_staged,
                              lambda: digests([], cur["state"])[1], ["B1"])
    if not launches["staged step"][0]:
        raise SystemExit(f"census: B1 did not launch on the staged step's "
                         f"steps {launches['staged step']}")
    del step, state, drs, dsvc, lanes, s0, cur
    gc.collect()
    torch.cuda.empty_cache()
    if undeclared:
        raise SystemExit("census: syncs in models/ or ops/ at functions no "
                         "HOST_SYNCS row declares: " + ", ".join(undeclared))
    rec["phase_s"] = time.perf_counter() - t21
    log(f"phase 21 took {rec['phase_s']:.1f} s (analysis "
        f"{analysis_s:.2f} s, engine built and warmed in "
        f"{rec['engine_build_warm_s']:.1f} s, the staged step in "
        f"{rec['staged_build_warm_s']:.1f} s)")
    return rec, kern, launches


PHASE_CHILDREN = (16, 18, 20)
# A child's torch intra-op threads: several processes share the host's
# cores, and idle OpenMP threads spin on the cores their neighbours need.
CHILD_THREADS = 2


def jsonable(o):
    """A phase's results as JSON keeps them: str keys, lists for tuples
    and sets, Python numbers for numpy's and torch's."""
    if isinstance(o, dict):
        return {str(k): jsonable(v) for k, v in o.items()}
    if isinstance(o, (list, tuple)):
        return [jsonable(v) for v in o]
    if isinstance(o, (set, frozenset)):
        return sorted(jsonable(v) for v in o)
    if hasattr(o, "tolist"):
        return o.tolist()
    return o


def phase_main(phase, out) -> int:
    """`chip_smoke.py --phase N OUT`: phase 16, 18 or 20 in a process of its
    own (the kernels are built from the checkout's sources, or loaded
    where this checkout built them already; phases 16 and 18 build the
    seeded world anew); its record, kernel records and launches as JSON
    in OUT."""
    import torch

    if not torch.cuda.is_available():
        print(f"chip_smoke --phase {phase}: torch.cuda.is_available() is "
              f"false", file=sys.stderr)
        return 2
    from antrea_tpu_torch import _build

    torch.set_num_threads(CHILD_THREADS)
    _build.build()
    dev = torch.device("cuda")
    if phase == 20:
        rec, launches, kern = drive_fleet(dev)
    else:
        _, _, tr, pool_tr, pod_ips, ps, services = build_world()
        drive = {16: drive_tenants, 18: drive_resize}[phase]
        rec, kern, launches = drive(ps, services, pod_ips, tr, pool_tr, dev)
    with open(out, "w") as f:
        json.dump(jsonable({"rec": rec, "kernels": kern,
                            "launches": launches}), f, default=str)
    return 0


class PhaseChild:
    """A phase run by a child process of this script (phase_main), started
    here and joined with join(); stop() ends it if it still runs."""

    TIMEOUT_S = 900

    def __init__(self, phase):
        import os
        import tempfile

        self.phase = phase
        self._dir = tempfile.mkdtemp(prefix=f"chip-smoke-phase{phase}-")
        self._out = os.path.join(self._dir, f"phase{phase}.json")
        here = os.path.dirname(os.path.abspath(__file__))
        self.proc = subprocess.Popen(
            [sys.executable, os.path.join(here, "chip_smoke.py"), "--phase",
             str(phase), self._out], cwd=here)

    def join(self):
        """-> (record, kernel records, launches)."""
        rc = self.proc.wait(timeout=self.TIMEOUT_S)
        if rc != 0:
            raise SystemExit(f"phase {self.phase}: its process exited with "
                             f"{rc}")
        with open(self._out) as f:
            got = json.load(f)
        return got["rec"], got["kernels"], got["launches"]

    def stop(self):
        import shutil

        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        shutil.rmtree(self._dir, ignore_errors=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    from antrea_tpu_torch import _build
    from antrea_tpu_torch.models import pipeline as pl
    from antrea_tpu_torch.ops import onepass
    from antrea_tpu_torch.ops.match import tables

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
            if ("registers" in line or "spill" in line
                    or "Function properties" in line):
                log(f"  {k}: {line.strip()}")

    # 2. World and the two pipelines.
    t0 = time.perf_counter()
    cps, svc, tr, pool_tr, pod_ips, ps, services = build_world()
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

    # 3. Kernels against their plain versions, on the world's own tables
    # and the batch's own interval rows (B3's inputs on the empty cache:
    # every lane a miss).
    x, otabs, ost, hit = onepass_inputs(ostep, ostate, pdrs, pdsvc, lanes,
                                        100)
    iv, g_in, g_out = lane_probes(x, otabs, ost, hit)
    del x
    stabs = tables(drs)
    b1, b2 = {}, {}
    for b, inner in ((256, 50), (32768, 3)):
        b1[b] = check_consumer(stabs, iv[:b], meta.svcref, meta.in_phases,
                               meta.out_phases, f"first {b} lanes", inner)
    s1 = {b: check_consumer2(stabs, iv[:b], meta.in_phases,
                             meta.out_phases, inner)
          for b, inner in ((256, 50), (32768, 3))}
    for b, inner in ((256, 50), (32768, 5)):
        b2[b] = check_pruned(g_in[:b], g_out[:b], iv[:b], otabs.inc,
                             PRUNE_K, pmeta.svcref, pmeta.in_phases,
                             pmeta.out_phases, inner)
    del iv, g_in, g_out
    torch.cuda.empty_cache()
    b3 = {"cold": check_onepass(ostep, ostate, pdrs, pdsvc, lanes, 100,
                                "empty cache")}
    # B3h on the same inputs: the whole tables (w0 = 0), then each half of
    # a 2-way word split on its own table slices (shard 1 at w0 = W / 2).
    from antrea_tpu_torch.ops.match import ruleset_from_numpy
    from antrea_tpu_torch.parallel import mesh as pm

    x, otabs, ost, _ = onepass_inputs(ostep, ostate, pdrs, pdsvc, lanes, 100)
    b3h = {"cold": check_hits_only(x, otabs, ost, 100, (0, 0),
                                   "empty cache, whole tables")}
    t0 = time.perf_counter()
    host2, _ = pm.host_rule_set(cps, 2, PRUNE_K)
    log(f"2-way rule split built on the host in "
        f"{time.perf_counter() - t0:.1f} s")
    for r in (0, 1):
        sl = pm.rule_slice(host2, 2, r)
        sdrs, w0 = ruleset_from_numpy(sl, dev), pm.first_words(sl)
        b3h[f"shard{r}"] = check_hits_only(
            x, onepass.tables_of(sdrs), ost, 100, w0,
            f"empty cache, rule shard {r} of 2")
        del sdrs
    del x, host2
    torch.cuda.empty_cache()

    # 4. The staged fused step.
    staged, b1_launches = drive_staged(step, state, drs, dsvc, lanes)
    del state
    torch.cuda.empty_cache()

    # 5. The one-pass step; then B3 once more on its warm cache.
    one, op_launches, ostate = drive_onepass(ostep, ostate, pdrs, pdsvc,
                                             lanes)
    now = 7200 * (EXPIRE_STEPS + 1) + 1
    b3["warm"] = check_onepass(ostep, ostate, pdrs, pdsvc, lanes, now,
                               "warm cache")
    # B3h on the warm cache with mixed lane bits: valid = 0, no_commit = 1
    # and fb_force = 1 lanes.
    x, otabs, ost, _ = onepass_inputs(ostep, ostate, pdrs, pdsvc, lanes, now)
    g = torch.Generator().manual_seed(5)
    bits = torch.rand((B, 3), generator=g).to(dev)
    msk = x.msk.clone()
    msk[:, 0] = (bits[:, 0] >= 1 / 16).to(torch.int32)
    msk[:, 1] = (bits[:, 1] < 1 / 16).to(torch.int32)
    msk[:, 2] = (bits[:, 2] < 1 / 64).to(torch.int32)
    b3h["warm"] = check_hits_only(x._replace(msk=msk), otabs, ost, now,
                                  (0, 0), "warm cache, mixed lane bits")
    del x, msk
    # B1 on every fallback lane of an expire-all batch (the one-pass
    # fallback re-walk's own lanes and tables).
    now = 7200 * (EXPIRE_STEPS + 2) + 1
    x, otabs, ost, _ = onepass_inputs(ostep, ostate, pdrs, pdsvc, lanes,
                                      now)
    out = onepass.onepass(x, otabs, now, 0, ost)
    fb = torch.nonzero(out[3][:, 1]).flatten()
    b1["fallback"] = check_consumer(
        otabs.inc, out[4][fb], pmeta.svcref, pmeta.in_phases,
        pmeta.out_phases, f"one-pass expire-all fallback, {fb.shape[0]} of "
        f"{B} lanes", 2)
    del x, out, fb
    del ostate
    torch.cuda.empty_cache()

    # 6. The pruned classify and the staged pruned step.
    pcls, _ = drive_pruned_classify(ostep.meta.match, pdrs, lanes, dev)
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

    # 10. The full per-packet walk at the headline width, one-pass and
    # staged, and its card-vs-CPU cross-checks.
    ft = node0_topology(pod_ips)
    from antrea_tpu_torch.models import forwarding as fw

    dft = fw.fwd_to_device(ft, dev)
    cols = full_lanes(tr, pod_ips, dev)
    full = {"onepass": drive_full(ostep.meta, pdrs, pdsvc, dft, cols, dev,
                                  "one-pass"),
            "staged": drive_full(step.meta, drs, dsvc, dft, cols, dev,
                                 "staged fused")}
    cross_check_full(ostep.meta, pdrs, pdsvc, dft, cols, dev, "one-pass")
    cross_check_full(step.meta, drs, dsvc, dft, cols, dev, "staged fused")
    one_card = table_bytes(pdrs)
    del drs, dsvc, pdrs, pdsvc
    torch.cuda.empty_cache()

    # 11. The (1, 1) mesh on NCCL, one-pass (B3h) and staged.
    mesh11 = {"onepass": drive_mesh11(cps, svc, ft, cols, dev,
                                      full["onepass"][:3], "one-pass",
                                      prune_budget=PRUNE_K, onepass=True,
                                      ct_timeout_s=3600),
              "staged": drive_mesh11(cps, svc, ft, cols, dev,
                                     full["staged"][:3], "staged fused")}

    # 12. The (1, 2) mesh: two gloo processes on the one card, one-pass.
    mesh12 = drive_mesh12(cps, svc, ft, cols, dev, full["onepass"][:3],
                          one_card, prune_budget=PRUNE_K, onepass=True,
                          ct_timeout_s=3600)
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f}"
        f" GiB")

    # 13. The engine, one-pass then staged, one at a time.
    kept13 = {}
    eng_one, eng_op_launches, ref = drive_engine(
        ps, services, pod_ips, tr, dev, "one-pass", keep=kept13, fused=True,
        prune_budget=PRUNE_K)
    eng_st, eng_st_launches, _ = drive_engine(
        ps, services, pod_ips, tr, dev, "staged fused", ref=ref, fused=True)
    del ref
    if not (eng_op_launches[0] and eng_op_launches[1] and eng_op_launches[2]
            and eng_st_launches[0]):
        raise SystemExit(f"engine: (B1, B2, B3) launches one-pass "
                         f"{eng_op_launches}, staged {eng_st_launches}")
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f}"
        f" GiB")

    # 14. The async engine (the flood and the churn cadence, one-pass then
    # staged), the step knobs card against CPU, B3 at the second-chance
    # mask and the knobs' step cost, profile().
    t14 = time.perf_counter()
    flood, churn = {}, {}
    want = churn_reference(ps, services, pod_ips, tr, pool_tr, dev)
    for what, knobs in MODES14:
        flood[what] = drive_flood(ps, services, pod_ips, dev, what, knobs)
        churn[what] = drive_churn(ps, services, pod_ips, tr, pool_tr, dev,
                                  what, knobs, want, CHURN_VARIANTS[what])
    del want
    knobs14, profiles = drive_knobs(ps, services, pod_ips, tr, pool_tr, dev)
    chance, knob_ms = drive_chance(cps, svc, tr, dev, b3)
    log(f"phase 14 took {time.perf_counter() - t14:.1f} s; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")

    # 15. Dual-stack: B1 and B2 on v6 interval rows, the walk, the pruned
    # classify, the engine with v6 churn, the engines card against CPU.
    dual, b1_6, b2_6, b2_6_launches = drive_dual(ps, services, pod_ips, tr,
                                                 dev)

    # 16, 18 and 20 run in child processes of this script (phase_main),
    # started together beside phases 17 and 19 here: each builds what it
    # needs from the seeded world, and most of their time and of 17's and
    # 19's is host-bound Python, each process on its own cores.  One after
    # the other they do not fit the script's time limit.
    children = {n: PhaseChild(n) for n in PHASE_CHILDREN}
    try:
        # 17. The mesh engine at (1, 1), (1, 2) and (2, 1).
        mesh17, k17 = drive_mesh_engine(ps, services, pod_ips, tr, dev,
                                        kept13)
        l17 = {k: v["launches"] for k, v in mesh17.items()}

        # 19. The agent on the card: the watch store, the mTLS wire, a
        # re-list, the surfaces, the pipe transport.
        agent19, l19, k19 = drive_agent(ps, services, pod_ips, tr, dev,
                                        kept13)
        del kept13

        # 16. Tenant worlds and the serving batcher, restart from a persist
        # dir, the scalar twin; 18. live resize and replica-loss failover
        # on the mesh engine; 20. the controller's fan-out and status
        # plane around node-0's agent.
        tenants, k16, l16 = children[16].join()
        resize18, k18, l18 = children[18].join()
        fleet20, k20, l20 = children[20].join()
    finally:
        for child in children.values():
            child.stop()

    # 21. The static-analysis suite over this checkout, and the sync census
    # of the one-pass engine's and the bare staged step's steady steps.
    census21, k21, l21 = drive_census(cps, svc, ps, services, pod_ips, tr,
                                      dev)

    def p17(tag, k=k17):
        return {f"{shape} {name}": at(r) for shape, recs in k.items()
                for name, r in recs.items() if name.startswith(tag)}

    def l18_of(i):
        return dict(launches_phase18=sum(v[i] for v in l18.values()),
                    launches_phase18_by_part={k: v[i]
                                              for k, v in l18.items()},
                    launches_phase19=sum(v[i] for v in l19.values()),
                    launches_phase19_by_part={k: v[i]
                                              for k, v in l19.items()},
                    launches_phase20=sum(v[i] for v in l20.values()),
                    launches_phase20_by_part={k: v[i]
                                              for k, v in l20.items()})

    def l21_of(i):
        return dict(launches_phase21=sum(v[i] for v in l21.values()),
                    launches_phase21_by_path={k: v[i]
                                              for k, v in l21.items()})

    def p21(tag):
        return {f"{path} {name}": at(r) for path, recs in k21.items()
                for name, r in recs.items() if name.split()[0] == tag}

    def p19(tag, k=k19):
        return {name: at(r) for name, r in k.items()
                if name.split()[1] == tag}

    def rec(name, src, replaces, launches, r, **extra):
        keys = ("ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err")
        return {"name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": launches,
                **{k: r[k] for k in keys}, "library_ms": None,
                "call_ms": r["call_ms"], **extra}

    def at(r):
        keys = ("ms", "call_ms", "plain_ms", "bound_ms", "gather_ms",
                "gather_call_ms", "prologue_ms", "prologue_call_ms",
                "bound_per_lane_ms", "share_rows_once", "share_per_lane",
                "miss_lanes")
        return {k: r[k] for k in keys if k in r}

    def rows_bounds(r):
        return {k: r[k] for k in ("gather_ms", "gather_call_ms",
                                  "bound_per_lane_ms",
                                  "share_rows_once", "share_per_lane")}

    kernels = [
        rec("B1 consumer", "antrea_tpu_torch/csrc/consumer.cu",
            "antrea_tpu/ops/match.py:1422", b1_launches, b1[256],
            **rows_bounds(b1[256]), at_B32768=at(b1[32768]),
            onepass_fallback={**at(b1["fallback"]),
                              "lanes": b1["fallback"]["lanes"]},
            launches_onepass_path=op_launches[0],
            launches_async_staged_path=a_st_launches[0],
            launches_async_onepass_path=a_op_launches[0],
            launches_engine_onepass=eng_op_launches[0],
            launches_engine_staged=eng_st_launches[0],
            launches_flood_staged=flood["staged fused"]["launches"][0],
            launches_flood_onepass=flood["one-pass"]["launches"][0],
            launches_churn_staged=churn["staged fused"]["overlap on"][
                "launches"][0],
            launches_step_tenants=l16["b"][0],
            launches_step_tenants_in_tenant_worlds=tenants["b"][
                "launches_in_tenant_worlds"][0],
            launches_tenants_onepass=l16["c"][0],
            tenant_rows=at(k16["b1"]),
            tenant_rows_miss_chunk=at(k16["b1_chunk"]),
            launches_phase17=sum(v[0] for v in l17.values()),
            launches_phase17_by_shape={k: v[0] for k, v in l17.items()},
            phase17=p17("B1"), **l18_of(0), phase18=p17("B1", k18),
            phase19=p19("B1"), phase20=p19("B1", k20), **l21_of(0),
            phase21=p21("B1")),
        rec("B2 pruned consumer", "antrea_tpu_torch/csrc/pruned_consumer.cu",
            "antrea_tpu/ops/match.py:1517", sp_launches[1], b2[256],
            **rows_bounds(b2[256]), at_B32768=at(b2[32768]),
            launches_engine_onepass=eng_op_launches[1],
            launches_flood_onepass=flood["one-pass"]["launches"][1],
            launches_tenant_canary=l16["d_canary"][1],
            launches_phase17=sum(v[1] for v in l17.values()),
            launches_phase17_canary=mesh17["1x2"]["canary_launches"][1],
            phase17=p17("B2"), **l18_of(1), phase18=p17("B2", k18),
            phase19=p19("B2"), phase20=p19("B2", k20),
            tenant_rows=at(k16["b2"]), **l21_of(1)),
        rec("B3 one-pass", "antrea_tpu_torch/csrc/onepass.cu",
            "antrea_tpu/ops/match.py:1854", op_launches[2], b3["cold"],
            batch=B, **{k: v for k, v in at(b3["cold"]).items()
                        if k not in ("ms", "call_ms", "plain_ms",
                                     "bound_ms")},
            warm_cache=at(b3["warm"]),
            chance_mask={"all_miss": at(chance["cold"]),
                         "warm": at(chance["warm"])},
            launches_async_onepass_path=a_op_launches[2],
            launches_engine_onepass=eng_op_launches[2],
            launches_flood_onepass=flood["one-pass"]["launches"][2],
            launches_churn_onepass=churn["one-pass"]["overlap off"][
                "launches"][2],
            launches_tenants_onepass=l16["c"][2],
            launches_in_tenant_worlds=tenants["cd"][
                "launches_in_tenant_worlds"][2],
            tenant_rows=at(k16["b3"]),
            launches_phase17=sum(v[2] for v in l17.values()), **l18_of(2),
            phase19=p19("B3"), phase20=p19("B3", k20), **l21_of(2),
            phase21=p21("B3")),
        rec("B3 one-pass, hits-only", "antrea_tpu_torch/csrc/onepass.cu",
            "antrea_tpu/ops/match.py:1854 (resolve=False)",
            mesh11["onepass"][1][3], b3h["cold"], batch=B,
            **{k: v for k, v in at(b3h["cold"]).items()
               if k not in ("ms", "call_ms", "plain_ms", "bound_ms")},
            rule_shard0=at(b3h["shard0"]), rule_shard1=at(b3h["shard1"]),
            warm_mixed_bits=at(b3h["warm"]),
            launches_mesh_1x2=mesh12["launches_b3h"],
            launches_phase16=sum(v[3] for v in l16.values()),
            launches_phase17=sum(v[3] for v in l17.values()),
            launches_phase17_by_shape={k: v[3] for k, v in l17.items()},
            phase17=p17("B3h"), **l18_of(3), phase18=p17("B3h", k18),
            **l21_of(3)),
        rec("S1 consumer2", "antrea_tpu_torch/csrc/consumer2.cu",
            "bench_cold_study.py:129", s1_launches, s1[32768],
            at_B256=at(s1[256]), study_case4_ms=study_s * 1e3,
            launches_phase16=sum(v[4] for v in l16.values()),
            launches_phase17=sum(v[4] for v in l17.values()), **l18_of(4),
            **l21_of(4)),
        # Phase 15: the same kernels on the dual-stack tables' v6 rows;
        # launches on the dual-stack walk (B1) and pruned classify (B2).
        rec("B1 consumer, dual-stack rows",
            "antrea_tpu_torch/csrc/consumer.cu",
            "antrea_tpu/ops/match.py:1422", dual["walk_launches"][0],
            b1_6[256], **rows_bounds(b1_6[256]), at_B32768=at(b1_6[32768]),
            launches_engine_dual_stack=dual["engine"]["launches"][0],
            v6_rows_of_batch=dual["v6_rows"],
            launches_phase17=sum(v[0] for v in l17.values()), **l18_of(0)),
        rec("B2 pruned consumer, dual-stack rows",
            "antrea_tpu_torch/csrc/pruned_consumer.cu",
            "antrea_tpu/ops/match.py:1517", b2_6_launches[1], b2_6[256],
            **rows_bounds(b2_6[256]), at_B32768=at(b2_6[32768]),
            launches_phase17=sum(v[1] for v in l17.values()), **l18_of(1)),
    ]
    log(json.dumps({"card": card, "staged": staged, "onepass": one,
                    "pruned_classify": pcls, "staged_pruned": spruned,
                    "async_staged": a_staged, "async_onepass": a_one,
                    "full_walk": {k: v[0] for k, v in full.items()},
                    "mesh_1x1": {k: v[0] for k, v in mesh11.items()},
                    "mesh_1x2": mesh12,
                    "engine": {"onepass": eng_one, "staged": eng_st},
                    "flood": flood, "churn": churn, "knobs": knobs14,
                    "profile": profiles, "knob_step_ms": knob_ms,
                    "dual_stack": dual, "tenants": tenants,
                    "mesh_engine": mesh17, "resize": resize18,
                    "agent": agent19, "fleet": fleet20,
                    "census": census21}))
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--phase"]:
        sys.exit(phase_main(int(sys.argv[2]), sys.argv[3]))
    sys.exit(main())
