"""The PyTorch port's replica-loss failover (antrea_tpu_torch/parallel/
failover.py and the mesh engine's failover hooks) on the CPU, the
analogues of tests/test_failover.py without its apiserver and support-
bundle halves (the port has neither yet).

One walk is held bit for bit to the JAX package's MeshDatapath: a replica
killed under churn, probed to quarantine, masked, evacuated by the
certified shrink 2 -> 1 and, once its fault site goes quiet, readmitted by
the certified grow 1 -> 2.  It runs once on the JAX engine in a module
fixture, recorded step by step, and the port must give the same records
(every StepResult field, failover_stats() after every tick,
reshard_stats() spans aside, mesh_stats(), dump_flows(), the
flight-recorder kinds in order and the probe/quarantine/evacuation/
resize events whole, each topology generation); exact equality.  The
other cases hold the port's own invariants against its single-card
TpuflowDatapath and its scalar Oracle, as the JAX tests do.

The plane times its probes and dispatches with wall clocks (probe_deadline_s
1.0 s, dispatch_deadline_s 5.0 s by default).  Every engine here is given
deadlines no CPU step reaches (FO_KW), so only a FaultPlan rule kills or
wedges a replica: replica_dead makes a probe row diverge, replica_wedge
adds its delay_s to the probe's measured time."""

import numpy as np
import pytest

from antrea_tpu.dissemination.faults import FaultPlan as JFaultPlan
from antrea_tpu.simulator.genpolicy import gen_cluster
from antrea_tpu.simulator.genservice import gen_services
from antrea_tpu.simulator.traffic import gen_traffic
from antrea_tpu_torch.dissemination.faults import FaultPlan as TFaultPlan
from antrea_tpu_torch.observability.metrics import render_metrics
from antrea_tpu_torch.oracle import hashing as thash
from antrea_tpu_torch.oracle.interpreter import Oracle as TOracle
from antrea_tpu_torch.parallel import mesh as tpm

from test_torch_engine import port_ps, tb
from test_torch_reshard import (KW, Recorder, copies_equal, jax_engine,
                                jax_trace_bucketed, port_engine, port_twin,
                                same_records, stats_rec, step_rec,
                                verdict_parity)

ASYNC = dict(async_slowpath=True, miss_queue_slots=1 << 10, drain_batch=64)
# Quarantine on 2 failed probes, readmit after 2 quiet rounds, retry a
# vetoed evacuation after 2 ticks; deadlines no CPU step reaches.
FO_KW = dict(probe_fails=2, readmit_passes=2, retry_ticks=2,
             probe_deadline_s=1e6, dispatch_deadline_s=1e6)


@pytest.fixture(scope="module")
def world():
    cluster = gen_cluster(40, n_nodes=4, pods_per_node=6, seed=7)
    services = gen_services(4, cluster.pod_ips, seed=11)
    return cluster, services


@pytest.fixture(scope="module")
def hot(world):
    cluster, services = world
    return gen_traffic(cluster.pod_ips, 64, n_flows=32, seed=3,
                       services=services, svc_fraction=0.3)


def kill(dp, plan_cls=TFaultPlan, replica=1, times=-1, seed=5):
    """Arm a deterministic death of `replica` -> the plan."""
    plan = plan_cls(seed=seed)
    plan.every("n0.replica_dead", 1, f"r{replica}", times=times)
    dp.arm_failover_faults(plan, "n0")
    return plan


def run_until(dp, t, phase, twin=None, b=None, deadline=300):
    """Tick (stepping b each tick, in parity with the twin when given)
    until the plane reaches `phase` -> the next instant."""
    while dp.failover_stats()["phase"] != phase:
        if b is not None:
            r = dp.step(b, t)
            if twin is not None:
                verdict_parity(r, twin.step(b, t), f"t={t}")
        dp.maintenance_tick(now=t)
        t += 1
        assert t < deadline, dp.failover_stats()
    return t


def slots(b, n_slots=KW["flow_slots"]):
    """Each lane's flow-cache slot (the hash does not depend on D)."""
    h = thash.flow_hash(np.asarray(b.src_ip, np.uint32),
                        np.asarray(b.dst_ip, np.uint32), np.asarray(b.proto),
                        np.asarray(b.src_port), np.asarray(b.dst_port))
    return (h & np.uint32(n_slots - 1)).astype(np.int64)


def claims(b, r, n_slots=KW["flow_slots"]):
    """Every slot a batch's commits may claim: the forward slot, the plain
    reverse slot and the DNAT'd reply slot (r: the step's record)."""
    src, dst = np.asarray(b.src_ip, np.uint32), np.asarray(b.dst_ip, np.uint32)
    proto, sport, dport = (np.asarray(b.proto), np.asarray(b.src_port),
                           np.asarray(b.dst_port))
    out = [slots(b, n_slots)]
    for h in (thash.flow_hash(dst, src, proto, dport, sport),
              thash.flow_hash(np.asarray(r["dnat_ip"], np.uint32), src, proto,
                              np.asarray(r["dnat_port"]), sport)):
        out.append((h & np.uint32(n_slots - 1)).astype(np.int64))
    return out


def chain_indices(kinds, chain):
    """Every kind of `chain` occurs, in causal order -> the indices."""
    idx, pos = [], -1
    for want in chain:
        nxt = next((i for i in range(pos + 1, len(kinds))
                    if kinds[i] == want), None)
        assert nxt is not None, (want, kinds)
        idx.append(nxt)
        pos = nxt
    return idx


# ---- the walk held to the JAX engine ----------------------------------------


def walk_kill(dp, cv, plan_cls, world, hot):
    """Kill replica 1 under churn; tick to the evacuation flip; let the
    fault site go quiet; tick to the readmission."""
    cluster, _ = world
    rec = Recorder()
    dp.step(cv(hot), 100)
    rec.add("hot", step_rec(dp.step(cv(hot), 101)))
    plan = kill(dp, plan_cls)
    t = 102
    while dp.failover_stats()["phase"] != "evacuated":
        churn = gen_traffic(cluster.pod_ips, 32, n_flows=16, seed=900 + t)
        rec.add(f"churn t={t}", step_rec(dp.step(cv(churn), t)))
        rec.add(f"hot t={t}", step_rec(dp.step(cv(hot), t)))
        dp.maintenance_tick(now=t)
        rec.add(f"tick t={t}", stats_rec(dp))
        t += 1
        assert t < 200, dp.failover_stats()
    rec.add("evacuated", stats_rec(dp, dump_at=t))
    rec.add("post-evac", step_rec(dp.step(cv(hot), t)))
    rec.add("settled", step_rec(dp.step(cv(hot), t + 1)))
    plan.quiesce()
    t += 2
    while dp.failover_stats()["phase"] != "healthy":
        rec.add(f"hot t={t}", step_rec(dp.step(cv(hot), t)))
        dp.maintenance_tick(now=t)
        rec.add(f"tick t={t}", stats_rec(dp))
        t += 1
        assert t < 300, dp.failover_stats()
    rec.add("readmitted", stats_rec(dp, dump_at=t))
    rec.add("post-readmit", step_rec(dp.step(cv(hot), t)))
    return rec


@pytest.fixture(scope="module")
def jax_walk(world, hot):
    with jax_trace_bucketed():
        return walk_kill(jax_engine(world, failover=True,
                                    failover_knobs=FO_KW),
                         lambda b: b, JFaultPlan, world, hot)


def test_failover_disabled_is_free_and_surfaces_disabled_shape(world, hot):
    """With the plane off the step is the armed engine's (same meta,
    bitwise equal results); the disabled surface is the JAX engine's
    schema; failover_readmit refuses with the JAX engine's words; no
    failover metric family renders."""
    a, b = port_engine(world), port_engine(world, failover=True)
    assert a._meta_step == b._meta_step and b._failover is not None
    ra, rb = a.step(tb(hot), 100), b.step(tb(hot), 100)
    for k in ("code", "svc_idx", "dnat_ip", "dnat_port", "est"):
        np.testing.assert_array_equal(getattr(ra, k), getattr(rb, k), k)
    j = jax_engine(world)
    st = a.failover_stats()
    assert st == j.failover_stats()
    assert st["enabled"] == 0 and st["phase"] == "disabled"
    with pytest.raises(RuntimeError) as ej:
        j.failover_readmit()
    with pytest.raises(RuntimeError) as et:
        a.failover_readmit()
    assert str(et.value) == str(ej.value) == (
        "the failover plane is not enabled (failover=True)")
    assert "antrea_tpu_failover" not in render_metrics(a, node="n0")
    assert a.arm_failover_faults(TFaultPlan(), "n0") is None
    assert "replica-health" in b.maintenance_stats()["tasks"]
    assert "replica-health" not in a.maintenance_stats()["tasks"]


def test_healthy_mesh_probes_clean_and_never_quarantines(world, hot):
    dp = port_engine(world, failover=True, failover_knobs=FO_KW)
    dp.step(tb(hot), 100)
    for t in range(101, 107):
        out = dp.maintenance_tick(now=t)
        assert out["ran"].get("replica-health", 0) > 0
    st = dp.failover_stats()
    assert st["phase"] == "healthy" and st["enabled"] == 1
    assert st["probe_failures_total"] == 0 and st["quarantines_total"] == 0
    assert st["probes_total"] >= 12 and len(st["probe_history"]) == 6
    assert all(rec["failed"] == [] for rec in st["probe_history"])


def test_replica_kill_mid_churn_equals_the_jax_engine(world, hot, jax_walk):
    """Kill replica 1 under churn: probe failures -> quarantine -> the
    skip-source evacuation shrink -> the quiet site's certified grow;
    record for record equal to the JAX engine.  Survivor-resident
    established flows on uncontended slots never flap; the re-miss burst
    is bounded and stops; the journal alone reconstructs the chain;
    verdicts after the readmission are Oracle-true."""
    cluster, _ = world
    dp = port_engine(world, failover=True, failover_knobs=FO_KW)
    rec = walk_kill(dp, tb, TFaultPlan, world, hot)
    same_records(rec, jax_walk)
    copies_equal(dp, "after the readmission")
    log = dict(rec.log)
    b = tb(hot)
    home0 = tpm.shard_of_tuples(b.src_ip, b.dst_ip, b.proto, b.src_port,
                                b.dst_port, 2, 0)
    surv = home0 != 1
    est0 = log["hot"]["est"] != 0
    dead_claims = np.unique(np.concatenate(
        [c[home0 == 1] for c in claims(b, log["hot"])]))
    watch = surv & est0 & ~np.isin(slots(b), dead_claims)
    assert watch.any() and (~surv).any()
    # Survivor-resident established flows never flap while the replica is
    # killed, masked and evacuated, modulo a round's churn lanes claiming
    # the same direct-mapped slot (the ordinary cache dynamic).
    rounds = 0
    for label, v in rec.log:
        if label == "evacuated":
            break
        if label.startswith("churn t="):
            t = int(label.split("=")[1])
            churn = tb(gen_traffic(cluster.pod_ips, 32, n_flows=16,
                                   seed=900 + t))
            busy = np.unique(np.concatenate(claims(churn, v)))
        elif label.startswith("hot t="):
            ok = watch & ~np.isin(slots(b), busy)
            assert v["est"][ok].all(), label
            rounds += 1
    assert rounds >= 3
    ev = log["evacuated"]
    fs = ev["failover"]
    assert ev["topology"][0] == 1 and fs["quarantines_total"] == 1
    assert fs["evacuations_total"] == 1 and fs["mask_active"] == 0
    assert 0 < fs["remiss_total"]
    assert log["post-evac"]["est"][watch].all()
    rd = log["readmitted"]
    assert rd["topology"][0] == 2
    assert rd["failover"]["readmissions_total"] == 1
    assert rd["failover"]["quarantined_shard"] is None
    assert log["post-readmit"]["est"][watch].all()
    kinds = rd["kinds"]
    events = dp.flightrecorder_events()
    idx = chain_indices(kinds, [
        "replica-probe-fail", "replica-quarantine", "reshard-begin",
        "reshard-cutover", "replica-evacuate", "reshard-begin",
        "reshard-cutover", "replica-readmit"])
    assert events[idx[1]]["replica"] == 1
    assert events[idx[2]]["skip_replica"] == 1
    assert "skip_replica" not in events[idx[5]]
    assert events[idx[7]]["gate"] == "resize"
    assert events[idx[7]]["mode"] == "auto"
    text = render_metrics(dp, node="n0")
    for fam in ("antrea_tpu_failover_quarantined",
                "antrea_tpu_failover_probes_total",
                "antrea_tpu_failover_probe_failures_total",
                "antrea_tpu_failover_quarantines_total",
                "antrea_tpu_failover_evacuations_total",
                "antrea_tpu_failover_readmissions_total",
                "antrea_tpu_failover_remiss_total"):
        assert fam in text, fam
    oracle = TOracle(port_ps(cluster.ps))
    r = dp.step(b, 401)
    plain = np.asarray(r.svc_idx) < 0
    assert plain.any()
    for i in np.nonzero(plain)[0]:
        assert int(r.code[i]) == int(oracle.classify(b.packet(int(i))).code)


# ---- the port's own invariants -----------------------------------------------


def test_replica_kill_mid_drain_requeues_dead_queue(world):
    """A kill while the dead replica's queue holds rows and a drain is
    pinned: the tick defers whole; the quarantine then requeues the dead
    queue verbatim onto the survivor, the evacuation carries it across
    the flip, and the drain classifies every row Oracle-true."""
    cluster, _ = world
    dp = port_engine(world, **ASYNC, failover=True, failover_knobs=FO_KW)
    tr = tb(gen_traffic(cluster.pod_ips, 128, n_flows=64, seed=31))
    dp.step(tr, 100)
    assert dp.slowpath_stats()["replica_depths"][1] > 0
    kill(dp)
    sp = dp._slowpath
    assert sp.begin_drain(101, 16)
    out = dp.maintenance_tick(now=102)
    assert out["blocked"] == "inflight-drain"
    assert "replica-health" in out["deferred"]
    assert dp.failover_stats()["phase"] == "healthy"
    sp.finish_drain(103)
    st1 = dp.slowpath_stats()
    depth1, dead_depth = st1["depth"], st1["replica_depths"][1]
    assert depth1 > 0 and dead_depth > 0
    dp._maint_replica_health(104, 64)
    dp._maint_replica_health(105, 64)
    st = dp.failover_stats()
    assert st["phase"] in ("quarantined", "evacuating"), st
    assert st["requeued_total"] == dead_depth
    sps = dp.slowpath_stats()
    assert sps["depth"] == depth1 and sps["replica_depths"][1] == 0
    t = run_until(dp, 106, "evacuated")
    assert len(dp.slowpath_stats()["replica_depths"]) == 1
    dp.drain_slowpath(t)
    oracle = TOracle(port_ps(cluster.ps))
    r = dp.step(tr, t + 1)
    assert (np.asarray(r.pending) == 0).any()
    for i in np.nonzero(np.asarray(r.pending) == 0)[0]:
        assert int(r.code[i]) == int(oracle.classify(tr.packet(int(i))).code)


def test_replica_kill_preempts_inflight_ordinary_resize(world, hot):
    """A kill mid-way through an elective grow: the quarantine aborts it
    and installs the emergency shrink in its place; verdicts stay equal to
    the single-card engine's throughout."""
    dp = port_engine(world, failover=True, failover_knobs=FO_KW)
    twin = port_twin(world)
    b = tb(hot)
    for e in (dp, twin):
        e.step(b, 100)
    dp.reshard_begin(4)
    dp.maintenance_tick(now=101)
    assert dp.reshard_status()["phase"] == "migrate"
    kill(dp)
    t = run_until(dp, 102, "evacuated", twin, b)
    assert dp._n_data == 1
    rs = dp.reshard_stats()
    assert rs["aborts_total"] == 1 and rs["cutovers_total"] == 1
    ev = dp.flightrecorder_events()
    idx = chain_indices([e["kind"] for e in ev], [
        "reshard-begin", "replica-quarantine", "reshard-abort",
        "reshard-begin", "reshard-cutover", "replica-evacuate"])
    assert "quarantine preempts" in ev[idx[2]]["reason"]
    assert "skip_replica" not in ev[idx[0]]
    assert ev[idx[3]]["skip_replica"] == 1
    verdict_parity(dp.step(b, t), twin.step(b, t), "post-preempt")


def test_corrupted_survivor_vetoes_evacuation_old_mesh_serves(world, hot):
    """The survivor topology's rule copies corrupted mid-evacuation: the
    canary vetoes the flip, the old mesh serves with the dead replica
    masked and quarantine pending; the retry places fresh rules and
    flips."""
    dp = port_engine(world, failover=True, failover_knobs=FO_KW)
    twin = port_twin(world)
    b = tb(hot)
    for e in (dp, twin):
        e.step(b, 100)
    kill(dp)
    t = run_until(dp, 101, "evacuating", twin, b)
    assert "replica 0" in dp._reshard.corrupt_target(0)
    t = run_until(dp, t, "quarantined", twin, b)
    st = dp.failover_stats()
    assert (dp._n_data, dp._topo_gen) == (2, 0)
    assert st["mask_active"] == 1 and st["quarantined_shard"] == 1
    assert st["evacuations_total"] == 0
    assert dp.reshard_stats()["aborts_total"] == 1
    kinds = [e["kind"] for e in dp.flightrecorder_events()]
    chain_indices(kinds, ["replica-quarantine", "reshard-begin",
                          "replica-canary-veto", "reshard-abort"])
    assert "replica-evacuate" not in kinds
    verdict_parity(dp.step(b, t), twin.step(b, t), "masked-serving")
    copies_equal(dp, "after the veto")
    text = render_metrics(dp, node="n0")
    line = next(ln for ln in text.splitlines()
                if ln.startswith('antrea_tpu_failover_quarantined{shard="1"'))
    assert line.rsplit(" ", 1)[1] == "1"
    t = run_until(dp, t + 1, "evacuated", twin, b)
    assert dp.failover_stats()["evacuations_total"] == 1 and dp._n_data == 1
    verdict_parity(dp.step(b, t), twin.step(b, t), "post-retry")


def test_probe_heal_before_flip_unmasks_without_resize(world, hot):
    """Two failed rounds then clean probes: the replica heals before the
    evacuation cuts over, so readmission drops the mask, the evacuation
    aborts and the generation never moves."""
    dp = port_engine(world, failover=True, failover_knobs=FO_KW)
    twin = port_twin(world)
    b = tb(hot)
    for e in (dp, twin):
        e.step(b, 100)
    plan = TFaultPlan(seed=5)
    plan.after("n0.replica_dead", 0, "r1", times=2)
    dp.arm_failover_faults(plan, "n0")
    t = run_until(dp, 101, "evacuating", twin, b)
    assert dp.failover_stats()["mask_active"] == 1
    t = run_until(dp, t, "healthy", twin, b)
    st = dp.failover_stats()
    assert (dp._n_data, dp._topo_gen) == (2, 0)
    assert st["readmissions_total"] == 1 and st["evacuations_total"] == 0
    assert st["mask_active"] == 0
    ev = dp.flightrecorder_events()
    readmits = [e for e in ev if e["kind"] == "replica-readmit"]
    assert len(readmits) == 1 and readmits[0]["gate"] == "unmask"
    assert any("healed" in e["reason"] for e in ev
               if e["kind"] == "reshard-abort")
    verdict_parity(dp.step(b, t), twin.step(b, t), "post-unmask")


def test_operator_readmit_drives_the_certified_grow(world, hot):
    """auto_readmit off: the evacuated mesh stays at one replica until the
    operator's failover_readmit starts the certified grow back to two."""
    dp = port_engine(world, failover=True,
                     failover_knobs={**FO_KW, "auto_readmit": False})
    b = tb(hot)
    dp.step(b, 100)
    plan = kill(dp)
    t = run_until(dp, 101, "evacuated")
    plan.quiesce()
    for tt in range(t, t + 6):
        dp.step(b, tt)
        dp.maintenance_tick(now=tt)
    st = dp.failover_stats()
    assert st["phase"] == "evacuated" and st["quarantined_shard"] == 1
    assert st["n_shards"] == 2 and st["probe_history"]
    assert st["tenants_pending_evacuation"] == []
    assert dp.failover_readmit()["phase"] == "readmitting"
    assert dp.failover_readmit()["phase"] == "readmitting"  # idempotent
    t = run_until(dp, t + 6, "healthy", b=b)
    assert dp._n_data == 2 and dp.failover_stats()["readmissions_total"] == 1
    ev = [e for e in dp.flightrecorder_events()
          if e["kind"] == "replica-readmit"]
    assert ev[-1]["mode"] == "operator" and ev[-1]["gate"] == "resize"
    with pytest.raises(RuntimeError, match="no quarantined replica"):
        dp.failover_readmit()


def test_maintenance_stats_render_late_registered_tasks(world, hot):
    """The emergency reshard-migrate task, registered from inside a running
    tick (the replica-health runner's quarantine), shows in
    maintenance_stats() at once, beside replica-health."""
    dp = port_engine(world, failover=True, failover_knobs=FO_KW)
    dp.step(tb(hot), 100)
    assert "replica-health" in dp.maintenance_stats()["tasks"]
    kill(dp)
    run_until(dp, 101, "evacuating")
    ms = dp.maintenance_stats()
    assert "reshard-migrate" in ms["tasks"] and "replica-health" in ms["tasks"]
    assert ms["scheduler_lag"] >= 0.0
    assert dp.failover_stats()["phase"] == "evacuating"


def test_replica_wedge_quarantines_on_the_probe_deadline(world, hot):
    """A wedge is a probe slower than probe_deadline_s: the FaultPlan's
    replica_wedge rule adds its delay_s to replica 1's measured probe time
    (no CPU probe comes near the deadline), so replica 1 alone fails with
    reason "deadline" and is quarantined."""
    dp = port_engine(world, failover=True,
                     failover_knobs={**FO_KW, "probe_deadline_s": 60.0})
    dp.step(tb(hot), 100)
    plan = TFaultPlan(seed=5)
    plan.every("n0.replica_wedge", 1, "r1", times=-1, delay_s=1e4)
    dp.arm_failover_faults(plan, "n0")
    run_until(dp, 101, "evacuating")
    st = dp.failover_stats()
    assert st["quarantined_shard"] == 1 and st["slow_dispatches_total"] == 0
    fails = [e for e in dp.flightrecorder_events()
             if e["kind"] == "replica-probe-fail"]
    assert fails and {(e["replica"], e["reason"]) for e in fails} == {
        (1, "deadline")}
