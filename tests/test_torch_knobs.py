"""The PyTorch port's step knobs (second chance, telemetry, the per-flow
counters of the FlowExporter gate), its deny export and Datapath.profile()
against the JAX package, on the CPU: the same numpy-seeded inputs through
the JAX function and the port's, the pipeline step and the engine, in the
staged fused and the one-pass modes.  Every value is an int32 or u32 word,
so the tolerance is exact equality (outputs, tel_* counters,
telemetry_stats(), the flow-cache and affinity tables with their two-limb
counters, the dump row excluded).  The JAX side runs its Pallas kernels in
interpret mode, as its own tests do."""

import copy

import numpy as np
import pytest
import torch

import jax

from antrea_tpu.compiler.ir import PolicySet as JPolicySet
from antrea_tpu.datapath import TpuflowDatapath as JEngine
from antrea_tpu.features import FeatureGates as JGates
from antrea_tpu.models import pipeline as jpl
from antrea_tpu.models import profile as jprof
from antrea_tpu.ops import match as jm
from antrea_tpu.oracle import Oracle
from antrea_tpu.packet import Packet, PacketBatch
from antrea_tpu.simulator import gen_cluster, gen_traffic
from antrea_tpu.simulator.traffic import gen_cache_thrash
from antrea_tpu.utils import ip as iputil
from antrea_tpu_torch import datapath as td
from antrea_tpu_torch.compiler.compile import compile_policy_set as t_compile
from antrea_tpu_torch.compiler.services import compile_services as t_services
from antrea_tpu_torch.features import FeatureGates as TGates
from antrea_tpu_torch.models import pipeline as tpl
from antrea_tpu_torch.ops import consumer as tc
from antrea_tpu_torch.ops import match as tm
from antrea_tpu_torch.ops import onepass as top

from test_torch_engine import port_ps, port_svcs, same_state, step_both, tb
from test_torch_pipeline import _compare, _lanes, _t, world  # noqa: F401

MODES = {"staged": {"fused": True},
         "onepass": {"fused": True, "prune_budget": 2}}
# The bare step's modes: staged unfused, staged through B1, one-pass.
PIPE_MODES = {"staged": {}, "fused": MODES["staged"],
              "onepass": MODES["onepass"]}
KNOBS = dict(second_chance=True, telemetry=True, count_flow_stats=True)
TEL_KEYS = ("tel_probe_hit", "tel_probe_stale", "tel_probe_miss",
            "tel_dma_hb", "tel_chance_bumps")
CLIENT, SRV = "10.0.1.7", "10.0.0.10"


def _twins(world, **kw):
    """The JAX step and the port's on one world's tables and initial
    state."""
    cluster, services, cps, svc = world
    jstep, jstate, (jdrs, jdsvc) = jpl.make_pipeline(cps, svc, **kw)
    drs_np, _ = jm.to_host(cps, prune_budget=kw.get("prune_budget", 0))
    tdrs = tm.ruleset_from_numpy(drs_np, "cpu")
    tdsvc = tpl.services_from_numpy(jpl.svc_to_host(svc), "cpu")
    tstate = tpl.state_from_numpy(jax.device_get(jstate), "cpu")
    tstep, _, _ = tpl.make_pipeline(
        t_compile(port_ps(cluster.ps)), t_services(port_svcs(services)),
        device="cpu", **kw)
    assert tstep.meta.pref_mask == jstep.meta.pref_mask
    st = {"j": jstate, "t": tstate}

    def run(lanes, now, lens, what):
        st["j"], jout = jpl.pipeline_step(st["j"], jdrs, jdsvc, *lanes, now,
                                          0, meta=jstep.meta, lens=lens)
        st["t"], tout = tstep(st["t"], tdrs, tdsvc, *(_t(a) for a in lanes),
                              now, 0, lens=_t(lens))
        _compare(st["j"], jout, st["t"], tout, what)
        return {k: v.numpy() for k, v in tout.items()}

    return run, st


@pytest.mark.parametrize("mode", PIPE_MODES)
def test_knobs_pipeline_equals_reference(world, mode):
    """Second chance, telemetry and the flow counters together on the bare
    step in a 64-slot cache: cold, reply (CONFIRMs both legs), re-steps
    with lengths near 2**31 (the low limbs wrap past 2**32), a thrash batch
    (protected entries, chance bumps), all bitwise the JAX step's."""
    cluster, services = world[:2]
    kw = dict(flow_slots=1 << 6, aff_slots=1 << 4, miss_chunk=32,
              **PIPE_MODES[mode], **KNOBS)
    run, st = _twins(world, **kw)
    fwd = _lanes(gen_traffic(cluster.pod_ips, 96, n_flows=40, seed=3,
                             services=services, svc_fraction=0.3))
    rev = (fwd[1], fwd[0], fwd[2], fwd[4], fwd[3])
    thrash = _lanes(gen_cache_thrash(cluster.pod_ips, 96, n_flows=1 << 10,
                                     seed=7))
    rng = np.random.default_rng(0)
    outs = []
    for i, lanes in enumerate((fwd, rev, fwd, fwd, thrash, fwd, rev, fwd)):
        lens = rng.integers(2**31 - 64, 2**31 - 1, 96).astype(np.int32)
        lens[::7] = -5  # negative lengths count 0
        outs.append(run(lanes, 100 + i, lens, f"{mode} step {i}"))
    assert sum(int(o["tel_chance_bumps"]) for o in outs) > 0
    assert sum(int(o["tel_probe_hit"]) for o in outs) > 0
    assert (int(outs[0]["tel_dma_hb"]) == 2) == (mode == "onepass")
    hi = st["t"].flow.octets_hi.numpy()[:-1]
    assert (hi >= 2).any()  # carried past 2**32 more than once


def _winner_calls(monkeypatch):
    calls = []
    orig = tpl._winner_mask

    def counting(*a):
        calls.append(a[0])
        return orig(*a)

    monkeypatch.setattr(tpl, "_winner_mask", counting)
    return calls


@pytest.mark.parametrize("mode", ["staged", "onepass"])
def test_knobs_off_same_keys_same_passes(world, mode, monkeypatch):
    """The analogue of tests/test_telemetry.py:52: with every knob off the
    step is what it was (the same output keys, the seven winner-mask passes
    of one commit, no kernel launch on the CPU), explicit False equals the
    default, and each knob adds only its own: telemetry its five keys and
    no pass, second chance one pass a commit, the counters one on the hit
    path and one a commit."""
    cluster, services, cps, svc = world
    tcps = t_compile(port_ps(cluster.ps))
    tsvc = t_services(port_svcs(services))
    lanes = [_t(a) for a in _lanes(gen_traffic(
        cluster.pod_ips, 64, n_flows=64, seed=9))]
    base_keys = {"code", "est", "reply", "reject_kind", "svc_idx",
                 "dnat_ip_f", "dnat_port", "ingress_rule", "egress_rule",
                 "committed", "miss", "snat", "dsr", "n_miss", "n_evict",
                 "n_reclaim"}
    if mode == "onepass":
        base_keys |= {"n_prune_skips", "n_prune_fb", "prune_cand_hist"}
    calls = _winner_calls(monkeypatch)
    seen = {}
    for name, knobs in (("default", {}),
                        ("off", dict(second_chance=False, telemetry=False,
                                     count_flow_stats=False)),
                        ("telemetry", dict(telemetry=True)),
                        ("second_chance", dict(second_chance=True)),
                        ("counters", dict(count_flow_stats=True))):
        step, state, (drs, dsvc) = tpl.make_pipeline(
            tcps, tsvc, flow_slots=1 << 10, aff_slots=1 << 4, miss_chunk=64,
            device="cpu", **MODES[mode], **knobs)
        launches = (tc.launches, top.launches)
        del calls[:]
        state, out = step(state, drs, dsvc, *lanes, 100, 0)
        assert (tc.launches, top.launches) == launches
        seen[name] = (set(out), len(calls), out)
    assert seen["default"][0] == seen["off"][0] == base_keys
    assert seen["default"][1] == seen["off"][1] == 7
    for k in base_keys:
        assert torch.equal(seen["default"][2][k], seen["off"][2][k]), k
    assert seen["telemetry"][0] == base_keys | set(TEL_KEYS)
    assert seen["telemetry"][1] == 7
    assert seen["second_chance"][0] == base_keys
    assert seen["second_chance"][1] == 8
    assert seen["counters"][1] == 9


def _engines(world, mode, **kw):
    """The JAX engine and the port's on one world (canary off)."""
    cluster, services = world[:2]
    kw = dict(dict(flow_slots=1 << 10, aff_slots=1 << 6, miss_chunk=64,
                   canary_probes=0, **MODES[mode]), **kw)
    gates = kw.pop("gates", None)
    j = JEngine(copy.deepcopy(cluster.ps), services,
                **({"feature_gates": JGates(gates)} if gates else {}), **kw)
    t = td.TpuflowDatapath(port_ps(cluster.ps), port_svcs(services),
                           device="cpu",
                           **({"feature_gates": TGates(gates)} if gates
                              else {}), **kw)
    return j, t


def _concat(a, b, na, nb):
    def cut(f):
        return np.concatenate([getattr(a, f)[:na], getattr(b, f)[:nb]])
    return PacketBatch(src_ip=cut("src_ip"), dst_ip=cut("dst_ip"),
                       proto=cut("proto"), src_port=cut("src_port"),
                       dst_port=cut("dst_port"))


@pytest.mark.parametrize("mode", MODES)
def test_telemetry_counter_parity_across_regimes(world, mode):
    """The analogue of tests/test_telemetry.py:112 against the JAX engine:
    cold, steady (one allowed flow, tiled) and churn steps; every tel_*
    counter, the regime histograms' counts and steps_total equal, the probe
    split conserved, and profile(mode="telemetry") equal on both."""
    cluster = world[0]
    j, t = _engines(world, mode, telemetry=True)
    t1 = gen_traffic(cluster.pod_ips, batch=96, seed=5)
    t2 = gen_traffic(cluster.pod_ips, batch=96, seed=6)
    r1 = step_both(j, t, t1, 1, "cold")[1]
    # The last allowed lane's entry cannot have lost a same-step collision
    # (commits land in lane order): tiled, an all-hit batch.
    i = int(np.nonzero(r1.code == 0)[0][-1])
    steady = PacketBatch(**{f: np.repeat(getattr(t1, f)[i:i + 1], 96)
                            for f in ("src_ip", "dst_ip", "proto",
                                      "src_port", "dst_port")})
    step_both(j, t, steady, 2, "steady")
    step_both(j, t, _concat(t1, t2, 72, 24), 3, "churn")
    sj, st = j.telemetry_stats(), t.telemetry_stats()
    assert st["counters"] == sj["counters"]
    c = st["counters"]
    assert c["probe_hit"] >= 96 and c["probe_miss"] > 0
    assert c["probe_hit"] + c["probe_stale"] + c["probe_miss"] == 3 * 96
    assert (c["dma_hb"] > 0) == (mode == "onepass")
    assert set(st["regimes"]["engine"]) == {"cold", "steady", "churn"}
    for regime, row in sj["regimes"]["engine"].items():
        assert st["regimes"]["engine"][regime]["count"] == row["count"]
    assert st["steps_total"] == sj["steps_total"] == 3
    same_state(j, t, mode)
    pt = t.profile(tb(t2), mode="telemetry", now=4)
    assert set(pt["counters"]) == {k[4:] for k in TEL_KEYS}
    assert sum(pt["counters"][k] for k in (
        "probe_hit", "probe_stale", "probe_miss")) == 96
    if mode == "staged":  # one more JAX compile: one mode is enough
        assert pt == j.profile(t2, mode="telemetry", now=4)
    same_state(j, t, f"{mode} after profile")
    dp = td.TpuflowDatapath(device="cpu", flow_slots=16, aff_slots=16)
    assert dp.telemetry_plane is None and dp.telemetry_stats() is None


def _pkt(src, dst, sport=41000, dport=80):
    return Packet(src_ip=iputil.ip_to_u32(src), dst_ip=iputil.ip_to_u32(dst),
                  proto=6, src_port=sport, dst_port=dport)


def _batch(pkts, lens):
    b = PacketBatch.from_packets(pkts)
    b.pkt_len = np.asarray(lens, np.int32)
    return b


def _volumes(dp, now):
    return {(f["src"], f["dst"], f["sport"], f["dport"], f["reply"]):
            (f["packets"], f["bytes"]) for f in dp.dump_flows(now)}


@pytest.mark.parametrize("mode", MODES)
def test_flow_counters_per_direction_and_past_2_32(mode):
    """tests/test_flow_counters.py:44 and :144 against the JAX engine under
    the FlowExporter gate: forward hits count on the forward entry,
    replies on the reply entry, and three near-2**31 lengths cross 2**31
    and the 2**32 carry, exactly (3 * (2**31 - 1) bytes)."""
    kw = dict(flow_slots=1 << 8, aff_slots=1 << 4, miss_chunk=16,
              canary_probes=0, **MODES[mode])
    j = JEngine(JPolicySet(), [], feature_gates=JGates({"FlowExporter": True}),
                **kw)
    t = td.TpuflowDatapath(port_ps(JPolicySet()), [], device="cpu",
                           feature_gates=TGates({"FlowExporter": True}), **kw)
    assert t._meta.count_flow_stats and t._flow_stats
    fwd, big_flow = _pkt(CLIENT, SRV), _pkt(CLIENT, SRV, sport=42000)
    rev = Packet(src_ip=iputil.ip_to_u32(SRV), dst_ip=iputil.ip_to_u32(CLIENT),
                 proto=6, src_port=80, dst_port=41000)
    big = 2**31 - 1
    # Two lanes a step (one compiled shape): the second flow takes three
    # near-2**31 lengths, two of them in one batch.
    for now, pkts, lens in ((1, [fwd, big_flow], [100, big]),
                            (2, [fwd, fwd], [50, 70]),
                            (3, [rev, big_flow], [30, big]),
                            (4, [big_flow, big_flow], [big, 5])):
        step_both(j, t, _batch(pkts, lens), now, f"{mode} {now}")
    v = _volumes(t, 4)
    assert v == _volumes(j, 4)
    assert v[(CLIENT, SRV, 41000, 80, False)] == (3, 220)
    assert v[(SRV, CLIENT, 80, 41000, True)] == (1, 30)
    assert v[(CLIENT, SRV, 42000, 80, False)] == (4, 3 * big + 5)
    assert 3 * big + 5 > 2**32
    same_state(j, t, mode)


def test_flow_counters_survive_audit_scans():
    """tests/test_flow_counters.py:174 against the JAX engine: full audit
    sweeps between steps leave the two-limb volumes exact across the
    carry, and repairing another entry leaves them so."""
    kw = dict(flow_slots=1 << 8, aff_slots=1 << 4, miss_chunk=16,
              fused=True)
    j = JEngine(JPolicySet(), [], feature_gates=JGates({"FlowExporter": True}),
                **kw)
    t = td.TpuflowDatapath(port_ps(JPolicySet()), [], device="cpu",
                           feature_gates=TGates({"FlowExporter": True}), **kw)
    fwd, other = _pkt(CLIENT, SRV), _pkt("10.0.2.9", SRV, sport=42000)
    big = 2**31 - 1
    lens = [big, 17, big, big]
    for now, ln in enumerate(lens, start=1):
        step_both(j, t, _batch([fwd, other], [ln, ln]), now, f"step {now}")
        for dp in (j, t):
            assert dp.audit_scan(now=now, full=True)["divergences"] == 0
    for dp in (j, t):
        assert "verdict" in dp._audit_corrupt("verdict")
        assert dp.audit_scan(now=len(lens), full=True)["repaired"] >= 1
    v = _volumes(t, len(lens))
    assert v == _volumes(j, len(lens))
    assert (len(lens), sum(lens)) in v.values()
    same_state(j, t, "audited")


def _allowed_pairs(cluster, n):
    oracle = Oracle(cluster.ps)
    pods = [iputil.u32_to_ip(int(p)) for p in cluster.pod_ips[:64]]
    out = []
    for i, s in enumerate(pods):
        for d in pods[i + 1:]:
            p = Packet(src_ip=iputil.ip_to_u32(s), dst_ip=iputil.ip_to_u32(d),
                       proto=6, src_port=9000, dst_port=80)
            if oracle.classify(p).code == 0:
                out.append((s, d))
                break
        if len(out) >= n:
            break
    return out[:n]


@pytest.fixture(scope="module")
def thrash_world():
    """8 allowed flows and their reply legs, each tiled to the storm's 128
    lanes (one compiled shape)."""
    cluster = gen_cluster(600, seed=3)
    pairs = _allowed_pairs(cluster, 8) * 16
    est = PacketBatch.from_packets([
        Packet(src_ip=iputil.ip_to_u32(s), dst_ip=iputil.ip_to_u32(d),
               proto=6, src_port=9000 + i % 8, dst_port=80)
        for i, (s, d) in enumerate(pairs)])
    rep = PacketBatch.from_packets([
        Packet(src_ip=int(est.dst_ip[i]), dst_ip=int(est.src_ip[i]), proto=6,
               src_port=int(est.dst_port[i]), dst_port=int(est.src_port[i]))
        for i in range(est.size)])
    return cluster, est, rep


def _thrash(cluster, est, rep, mode, second_chance, with_ref=True):
    """tests/test_match_fused.py:538's drive: establish and CONFIRM 8
    flows, then three storm passes, each followed by the flows' own
    traffic both ways.  -> (did the established rows survive, the port's
    engine)."""
    kw = dict(miss_chunk=256, second_chance=second_chance,
              flow_slots=1 << 6, aff_slots=1 << 4, canary_probes=0,
              flightrec_slots=0, realization_slots=0, **MODES[mode])
    t = td.TpuflowDatapath(port_ps(cluster.ps), [], device="cpu", **kw)
    j = JEngine(copy.deepcopy(cluster.ps), [], **kw) if with_ref else None

    def step(b, now):
        if j is None:
            return t.step(tb(b), now)
        return step_both(j, t, b, now, f"{mode} sc={second_chance}")[1]

    step(est, 1)
    step(rep, 1)
    r = step(est, 2)
    assert list(r.code) == [0] * est.size
    alive = int(r.est.sum())
    assert alive >= 6 * 16
    keys0 = t._state.flow.keys.numpy().copy()
    rows0 = [i for i in range(keys0.shape[0] - 1) if keys0[i, 3] != 0]
    now = 2
    for rnd in range(3):
        step(gen_cache_thrash(cluster.pod_ips, 128, n_flows=1 << 12,
                              seed=50 + rnd), now + 1)
        rd = step(est, now + 2)
        step(rep, now + 2)
        if second_chance:
            assert int(rd.est.sum()) == alive, rnd
        now += 2
    if j is not None:
        same_state(j, t, f"{mode} thrash")
    keys1 = t._state.flow.keys.numpy()
    return all(np.array_equal(keys0[i], keys1[i]) for i in rows0), t


@pytest.mark.parametrize("mode", MODES)
def test_second_chance_pins_established_under_thrash(thrash_world, mode):
    """tests/test_match_fused.py:538 against the JAX engine, in the staged
    fused and the one-pass modes: with second_chance the established rows
    survive a cache-thrash storm, bitwise the JAX engine's tables every
    step; with the knob off the same storm evicts some of them."""
    cluster, est, rep = thrash_world
    survived, t = _thrash(cluster, est, rep, mode, True)
    assert survived
    assert t._meta.pref_mask == tpl.PREF_MASK_CHANCE
    survived_off, _ = _thrash(cluster, est, rep, mode, False, with_ref=False)
    assert not survived_off


def test_deny_export_records_equal_reference(world):
    """enable_deny_export on both engines: policy DROP verdicts of a
    synchronous step and the admission sheds of an async one land in the
    deny ring as the same records."""
    cluster = world[0]
    b = gen_traffic(cluster.pod_ips, batch=96, seed=11)
    for knobs in (dict(), dict(async_slowpath=True, admission="drop",
                               miss_queue_slots=16, drain_batch=8)):
        j, t = _engines(world, "staged", **knobs)
        assert t.enable_deny_export() is t.deny_ring
        j.enable_deny_export()
        for now in (1, 2):
            rj, rt = j.step(b, now), t.step(tb(b), now)
            np.testing.assert_array_equal(rt.code, rj.code)
        got, want = t.deny_drain(), j.deny_drain()
        assert got == want and got
        reasons = {r["reason"] for r in got}
        if knobs:
            assert "queue-overflow" in reasons
        else:
            assert reasons == {"policy"}


_PROFILE_CHAINS = {"sync": jprof.PHASE_CHAIN,
                   "async": jprof.ASYNC_PHASE_CHAIN,
                   "overlap": jprof.OVERLAP_PHASE_CHAIN,
                   "maintenance": jprof.MAINT_PHASE_CHAIN,
                   "prune": jprof.PRUNE_PHASE_CHAIN,
                   "fused": jprof.FUSED_PHASE_CHAIN}


@pytest.mark.parametrize("mode", list(_PROFILE_CHAINS))
def test_profile_modes_sum_and_leave_the_state(world, mode):
    """Datapath.profile() in every mode the JAX method has: the phases are
    the chain's names and sum to the total, and the engine's state and
    cache_stats() are what they were (its invariants, no timing
    threshold).  prune needs a staged pruned engine, fused a one-pass one;
    each refuses the other."""
    cluster = world[0]
    knobs = {"prune": dict(prune_budget=2, fused=False),
             "fused": MODES["onepass"]}.get(mode, MODES["staged"])
    t = td.TpuflowDatapath(port_ps(cluster.ps), port_svcs(world[1]),
                           device="cpu", flow_slots=1 << 10,
                           aff_slots=1 << 6, miss_chunk=64, canary_probes=0,
                           **knobs)
    hot = tb(gen_traffic(cluster.pod_ips, batch=64, n_flows=32, seed=21))
    pool = tb(gen_traffic(cluster.pod_ips, batch=256, n_flows=256, seed=22,
                          one_per_flow=True))
    t.step(hot, 999)
    before = (t.cache_stats(), t._audit_state_digest())
    out = t.profile(hot, pool, mode=mode, n_new=8, now=1000, k_small=1,
                    k_big=2, repeats=1)
    assert list(out["phases_s"]) == [n for n, _ in _PROFILE_CHAINS[mode]]
    assert sum(out["phases_s"].values()) == pytest.approx(out["total_s"],
                                                          rel=1e-9, abs=1e-12)
    assert out["batch"] == 64 and out["device"] == "cpu"
    assert (t.cache_stats(), t._audit_state_digest()) == before
    if mode in ("prune", "fused"):
        other = "fused" if mode == "prune" else "prune"
        with pytest.raises(ValueError, match=other if other == "fused"
                           else "prune"):
            t.profile(hot, pool, mode=other)
    with pytest.raises(ValueError, match="unknown profile mode"):
        t.profile(hot, pool, mode="nope")
