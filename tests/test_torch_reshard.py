"""The PyTorch port's live resize (antrea_tpu_torch/parallel/reshard.py and
the mesh engine's reshard hooks) on the CPU, the analogues of
tests/test_reshard.py.

Two walks are held bit for bit to the JAX package's MeshDatapath: a grow
2 -> 4 and a shrink 4 -> 2 under churn with drains mid-migration, and a
cutover vetoed by a corrupted target replica followed by a clean retry.
Each walk runs once on the JAX engine, in a module fixture that records
its outputs step by step (walk_record); the port then takes the same
world, batches and ticks and must give the same records: every StepResult
field, reshard_status() after every tick, reshard_stats() (spans aside),
mesh_stats(), failover_stats(), slowpath_stats(), dump_flows(), the
flight-recorder kinds in order and the resize events' payloads, and each
(n_data, topology generation, bundle generation).  Every value is an int32
word or a host count, so the tolerance is exact equality.

The JAX walk is the costly side: its audit's fresh walks run the eager
trace, which compiles every operation again for each new row count and
placement.  While a recording runs, jax_trace_bucketed pads those batches
to a power-of-two lane count and runs the same trace function compiled
once a lane count (jax.jit) over host copies of its tables; the trace is
a stateless walk of each lane on its own over integer words, so the real
lanes' outputs are the ones the eager, unpadded call gives.  The grow and
shrink walk keeps its first padded calls, and
test_bucketed_trace_equals_the_eager_trace holds their outputs to the JAX
package's own eager trace on the same arguments.

The other cases hold the port's own invariants against the port's
single-card TpuflowDatapath and its scalar Oracle, as the JAX tests hold
theirs against the JAX single-card engine.  The worlds are smaller than
tests/test_reshard.py's: 2^8 slots a replica, so the default budget of
256 rows a tick migrates in a few ticks."""

import contextlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from antrea_tpu.models import pipeline as jpl
from antrea_tpu.parallel import MeshDatapath as JMesh
from antrea_tpu.parallel import mesh as jpm
from antrea_tpu.parallel import reshard as jreshard
from antrea_tpu.simulator.genpolicy import gen_cluster
from antrea_tpu.simulator.genservice import gen_services
from antrea_tpu.simulator.traffic import gen_traffic
from antrea_tpu_torch import datapath as td
from antrea_tpu_torch.models import pipeline as tpl
from antrea_tpu_torch.observability.metrics import render_metrics
from antrea_tpu_torch.oracle.interpreter import Oracle as TOracle
from antrea_tpu_torch.packet import PacketBatch as TBatch
from antrea_tpu_torch.parallel import MeshDatapath as TMesh
from antrea_tpu_torch.parallel import mesh as tpm
from antrea_tpu_torch.parallel import reshard as treshard

from test_torch_engine import port_ps, port_svcs, tb
from test_torch_meshpath import FIELDS, jps

KW = dict(flow_slots=1 << 8, aff_slots=1 << 6, canary_probes=8)
ASYNC = dict(async_slowpath=True, miss_queue_slots=1 << 10, drain_batch=64)


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


# ---- the walk recorder (shared with the tenant and failover files) ---------


# Padded trace calls a recording keeps for the check against the eager one.
TRACE_SAMPLES = 3


@contextlib.contextmanager
def jax_trace_bucketed(samples=None):
    """While a JAX walk records: the trace behind the JAX engine's audit
    re-proofs runs jitted on a power-of-two lane count (the real lanes
    first, lane 0 repeated after them) over host copies of its tables, so
    one compile serves every call of a lane count; the real lanes'
    outputs are returned.  `samples` (a list) gets the arguments and
    outputs of the first TRACE_SAMPLES calls that were padded."""
    orig = jpl._pipeline_trace
    jitted = jax.jit(orig, static_argnames=("meta",))

    def host(tree):
        return jax.tree.map(lambda x: jnp.asarray(np.asarray(x)), tree)

    def bucketed(state, drs, dsvc, src, dst, proto, sport, dport, now, gen,
                 *, meta, v6=None):
        n = int(src.shape[0])
        if v6 is not None or n == 0:
            return orig(state, drs, dsvc, src, dst, proto, sport, dport,
                        now, gen, meta=meta, v6=v6)
        b = max(64, 1 << (n - 1).bit_length())
        idx = np.concatenate([np.arange(n), np.zeros(b - n, np.int64)])
        cols = [jnp.asarray(np.asarray(c)[idx])
                for c in (src, dst, proto, sport, dport)]
        out = jitted(host(state), host(drs), host(dsvc), *cols,
                     jnp.int32(now), jnp.int32(gen), meta=meta)
        out = {k: v[:n] for k, v in out.items()}
        if samples is not None and b > n and len(samples) < TRACE_SAMPLES:
            samples.append(((state, drs, dsvc, src, dst, proto, sport,
                             dport, now, gen), meta, out))
        return out

    jpl._pipeline_trace = bucketed
    try:
        yield
    finally:
        jpl._pipeline_trace = orig


def step_rec(r) -> dict:
    """Every StepResult field of a step, as host values."""
    out = {f: None if getattr(r, f) is None else np.asarray(getattr(r, f))
           for f in FIELDS}
    out.update(n_miss=int(r.n_miss), ingress_rule=list(r.ingress_rule),
               egress_rule=list(r.egress_rule))
    return out


# Flight-recorder kinds whose payloads the records carry whole.
EVENT_KINDS = ("reshard-", "replica-", "tenant-reshard-", "tenant-rollback",
               "mesh-epoch-swap")


def stats_rec(dp, dump_at=None) -> dict:
    """The engine's resize, failover and mesh surfaces (the span's wall
    times aside), its topology and generations, and its journal: every
    kind in order, the resize/failover events whole (clocks aside)."""
    rs = dict(dp.reshard_stats())
    rs.pop("last_span")
    sp = dp.slowpath_stats()
    if sp is not None:
        sp = dict(sp)
        h = sp.pop("drain_hist")
        sp["drain_hist"] = (list(h._counts), h.sum, h.count)
    ev = dp.flightrecorder_events()
    out = {
        "reshard": rs, "status": dp.reshard_status(),
        "failover": dp.failover_stats(), "mesh": dp.mesh_stats(),
        "slowpath": sp, "cache": dp.cache_stats(),
        "topology": (int(dp._n_data), int(dp._topo_gen), dp.generation),
        "kinds": [e["kind"] for e in ev],
        "events": [{k: v for k, v in e.items()
                    if k not in ("ts", "seq", "wall")}
                   for e in ev if e["kind"].startswith(EVENT_KINDS)],
    }
    if dump_at is not None:
        out["dump"] = dp.dump_flows(dump_at)
    return out


class Recorder:
    """A walk's outputs in order, each under a label."""

    def __init__(self):
        self.log = []

    def add(self, label, value):
        self.log.append((label, value))
        return value


def same_value(got, want, where):
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), (
            where, sorted(got), sorted(want))
        for k in want:
            same_value(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(np.asarray(got), want, err_msg=where)
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), (
            where, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            same_value(g, w, f"{where}[{i}]")
    else:
        assert got == want, (where, got, want)


def same_records(got: Recorder, want: Recorder):
    """The port's walk record equal to the JAX engine's, entry by entry."""
    assert [k for k, _ in got.log] == [k for k, _ in want.log]
    for (label, g), (_, w) in zip(got.log, want.log):
        same_value(g, w, label)


def copies_equal(dp, what=""):
    """Every rule shard's copy of every replica's tables equal to rule
    shard 0's (dump row excluded), in the fleet and every tenant world."""
    states = [dp._state]
    reg = getattr(dp, "_tenants", None)
    if reg is not None:
        states += [w.fields["_state"] for w in reg.worlds.values()]
    for state in states:
        for d, row in enumerate(state):
            for r, st in enumerate(row[1:], 1):
                for a, b, name in zip((*row[0].flow, *row[0].aff),
                                      (*st.flow, *st.aff),
                                      (*tpl.FlowCache._fields,
                                       *tpl.AffinityTable._fields)):
                    assert bool((a[:-1] == b[:-1]).all()), (what, d, r, name)


def run_ticks(dp, t, rec=None, deadline=200):
    """Tick until the in-flight resize finishes -> the next instant."""
    while dp.reshard_status() is not None:
        dp.maintenance_tick(now=t)
        if rec is not None:
            rec.add(f"tick t={t}", stats_rec(dp))
        t += 1
        assert t < deadline, dp.reshard_status()
    return t


def verdict_parity(rm, rs, msg=""):
    """Bitwise verdict parity on every CLASSIFIED lane (pending lanes carry
    the provisional admission verdict, a cache-topology observable)."""
    ok = np.ones(len(np.asarray(rm.code)), bool)
    if rm.pending is not None:
        ok = (np.asarray(rm.pending) == 0) & (np.asarray(rs.pending) == 0)
    for k in ("code", "svc_idx", "dnat_ip", "dnat_port"):
        np.testing.assert_array_equal(
            np.asarray(getattr(rm, k))[ok], np.asarray(getattr(rs, k))[ok],
            err_msg=f"{msg}:{k}")
    assert ([r for r, o in zip(rm.ingress_rule, ok) if o]
            == [r for r, o in zip(rs.ingress_rule, ok) if o]), msg
    assert ([r for r, o in zip(rm.egress_rule, ok) if o]
            == [r for r, o in zip(rs.egress_rule, ok) if o]), msg
    return ok


def jax_engine(world, shape=(2, 2), **extra):
    cluster, services = world
    mesh = jpm.make_mesh(*shape,
                         devices=jax.devices("cpu")[:shape[0] * shape[1]])
    return JMesh(jps(cluster.ps), services, mesh=mesh, **KW, **extra)


def port_engine(world, shape=(2, 2), **extra):
    cluster, services = world
    return TMesh(port_ps(cluster.ps), port_svcs(services), n_data=shape[0],
                 n_rule=shape[1], device="cpu", **KW, **extra)


def port_twin(world, **extra):
    cluster, services = world
    return td.TpuflowDatapath(port_ps(cluster.ps), port_svcs(services),
                              device="cpu", **KW, **extra)


# ---- the two walks held to the JAX engine -----------------------------------


def walk_grow_shrink(dp, cv, world, hot):
    """Grow 2 -> 4 then shrink 4 -> 2 under churn: each tick steps a churn
    batch and the established batch, drains, then ticks the maintenance
    plane (migration windows, then the certified cutover)."""
    cluster, _ = world
    rec = Recorder()
    dp.step(cv(hot), 100)
    dp.drain_slowpath(101)
    rec.add("hot", step_rec(dp.step(cv(hot), 101)))
    t = 102
    for n in (4, 2):
        rec.add(f"begin {n}", dp.reshard_begin(n))
        while dp.reshard_status() is not None:
            churn = gen_traffic(cluster.pod_ips, 32, n_flows=16, seed=t)
            rec.add(f"churn t={t}", step_rec(dp.step(cv(churn), t)))
            rec.add(f"hot t={t}", step_rec(dp.step(cv(hot), t)))
            dp.drain_slowpath(t)
            dp.maintenance_tick(now=t)
            rec.add(f"tick t={t}", stats_rec(dp))
            t += 1
            assert t < 200, dp.reshard_status()
        rec.add(f"flipped {n}", stats_rec(dp, dump_at=t))
        rec.add(f"post {n}", step_rec(dp.step(cv(hot), t)))
        dp.drain_slowpath(t + 1)
        rec.add(f"drained {n}", step_rec(dp.step(cv(hot), t + 2)))
        t += 3
    rec.add("end", stats_rec(dp, dump_at=t))
    return rec


def walk_veto(dp, cv, world, hot):
    """A grow whose target replica 1 is corrupted before the cutover: the
    target canary vetoes, the resize aborts, the old topology serves; a
    clean retry then cuts over."""
    rec = Recorder()
    rec.add("hot", step_rec(dp.step(cv(hot), 100)))
    rec.add("begin", dp.reshard_begin(4))
    rec.add("corrupt", dp._reshard.corrupt_target(1))
    t = run_ticks(dp, 101, rec)
    rec.add("aborted", stats_rec(dp, dump_at=t))
    rec.add("post-abort", step_rec(dp.step(cv(hot), t)))
    rec.add("retry", dp.reshard_begin(4))
    t = run_ticks(dp, t + 1, rec)
    rec.add("retried", stats_rec(dp, dump_at=t))
    rec.add("post-retry", step_rec(dp.step(cv(hot), t)))
    return rec


@pytest.fixture(scope="module")
def jax_walks(world, hot):
    """Each walk once on the JAX engine, recorded, with the grow and
    shrink walk's first padded trace calls."""
    samples = []
    with jax_trace_bucketed(samples):
        grow_shrink = walk_grow_shrink(jax_engine(world, **ASYNC),
                                       lambda b: b, world, hot)
    with jax_trace_bucketed():
        veto = walk_veto(jax_engine(world), lambda b: b, world, hot)
    return {"grow_shrink": grow_shrink, "veto": veto,
            "trace_samples": samples}


def test_bucketed_trace_equals_the_eager_trace(jax_walks):
    """The padded, jitted trace that stood in for the JAX engine's eager
    _pipeline_trace while the walks recorded gave, on the real lanes of
    the calls it kept, every output word the eager, unpadded trace gives
    on the same arguments."""
    samples = jax_walks["trace_samples"]
    assert samples
    for args, meta, got in samples:
        want = jpl._pipeline_trace(*args, meta=meta)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]), err_msg=k)


def test_versioned_ring_equals_the_jax_ring_and_moves_minimally():
    """shard_of_tuples' topology generations equal the JAX package's: the
    dense map at generation 0, the consistent ring after; direction
    symmetric; the ring depends on the member set only; growing moves only
    the new shards' keys; the tenant salt composes."""
    rng = np.random.default_rng(5)
    n = 4096
    src = rng.integers(1, 2 ** 32, n, dtype=np.uint32)
    dst = rng.integers(1, 2 ** 32, n, dtype=np.uint32)
    proto = np.full(n, 6, np.int32)
    sport = rng.integers(1024, 65535, n).astype(np.int32)
    dport = rng.integers(1, 1024, n).astype(np.int32)
    cols = (src, dst, proto, sport, dport)
    for n_data in (1, 2, 3, 4):
        for gen in (0, 1, 2):
            for tenant in (0, 3):
                got = tpm.shard_of_tuples(*cols, n_data, gen, tenant=tenant)
                np.testing.assert_array_equal(got, jpm.shard_of_tuples(
                    *cols, n_data, gen, tenant=tenant))
                np.testing.assert_array_equal(got, tpm.shard_of_tuples(
                    dst, src, proto, dport, sport, n_data, gen,
                    tenant=tenant))
    np.testing.assert_array_equal(tpm.shard_of_tuples(*cols, 4, 1),
                                  tpm.shard_of_tuples(*cols, 4, 2))
    own4 = tpm.shard_of_tuples(*cols, 4, 1)
    own2 = tpm.shard_of_tuples(*cols, 2, 1)
    stay = own4 < 2
    np.testing.assert_array_equal(own4[stay], own2[stay])
    assert 0.3 < float((~stay).mean()) < 0.7
    assert np.bincount(own4, minlength=4).min() > 512


def test_reshard_manifest_names_every_state_field():
    """The migration manifest names exactly the port's per-replica state
    fields (the migrator copies FlowCache._fields / AffinityTable._fields),
    is the JAX package's literal, and every world-migration entry is a
    member of the mesh engine's per-world swap set."""
    want = ({f"FlowCache.{f}" for f in tpl.FlowCache._fields}
            | {f"AffinityTable.{f}" for f in tpl.AffinityTable._fields})
    assert set(treshard.RESHARD_MANIFEST) == want
    assert treshard.RESHARD_MANIFEST == jreshard.RESHARD_MANIFEST
    assert treshard.WORLD_MIGRATION == jreshard.WORLD_MIGRATION
    assert set(treshard.WORLD_MIGRATION) <= set(TMesh._TENANT_WORLD_FIELDS)
    for name in ("_mesh", "_n_data", "_topo_gen", "_fo_mask"):
        assert name in TMesh._TENANT_WORLD_FIELDS


def test_grow_and_shrink_mid_churn_equals_the_jax_engine(world, hot,
                                                         jax_walks):
    """The grow 2 -> 4 and the shrink 4 -> 2 under churn, drains and
    maintenance, record for record equal to the JAX engine; the rule-shard
    copies stay equal and the established set serves from the migrated
    cache after each flip."""
    dp = port_engine(world, **ASYNC)
    rec = walk_grow_shrink(dp, tb, world, hot)
    same_records(rec, jax_walks["grow_shrink"])
    copies_equal(dp, "after the shrink")
    log = dict(rec.log)
    assert log["flipped 4"]["topology"][:2] == (4, 1)
    assert log["end"]["topology"][:2] == (2, 2)
    for n in (4, 2):
        assert int(log[f"post {n}"]["est"].sum()) > 0
    rs = log["end"]["reshard"]
    assert rs["cutovers_total"] == 2 and rs["aborts_total"] == 0
    assert rs["migrated_rows_total"] > 0
    kinds = [k for k in log["end"]["kinds"] if k.startswith("reshard")]
    assert kinds == ["reshard-begin", "reshard-migrated", "reshard-cutover"] * 2


def test_vetoed_cutover_equals_the_jax_engine(world, hot, jax_walks):
    """corrupt_target(1) vetoes the cutover (reshard-begin ->
    replica-canary-veto -> reshard-abort, generation unchanged, not
    degraded) and a clean retry flips, record for record equal to the JAX
    engine; the copies stay equal after the abort and the flip."""
    dp = port_engine(world)
    rec = walk_veto(dp, tb, world, hot)
    same_records(rec, jax_walks["veto"])
    copies_equal(dp, "after the retry")
    log = dict(rec.log)
    assert "target" in log["corrupt"] and "replica 1" in log["corrupt"]
    ab = log["aborted"]
    assert ab["topology"][:2] == (2, 0)
    assert ab["reshard"]["aborts_total"] == 1
    chain = [k for k in ab["kinds"] if k in (
        "reshard-begin", "replica-canary-veto", "reshard-abort")]
    assert chain == ["reshard-begin", "replica-canary-veto", "reshard-abort"]
    assert log["retried"]["topology"][:2] == (4, 1)
    assert not dp.degraded


# ---- the port's own invariants -----------------------------------------------


def test_rule_shard_copies_stay_equal_across_cutover_and_abort(world, hot):
    """(1, 2) -> (2, 2): a grow under traffic, an aborted shrink and a
    flipped one; after each, every rule shard's copy of every replica's
    tables is equal, and verdicts equal the single-card engine's."""
    dp = port_engine(world, shape=(1, 2))
    sdp = port_twin(world)
    b = tb(hot)
    for e in (dp, sdp):
        e.step(b, 100)
    dp.reshard_begin(2)
    t = 101
    while dp.reshard_status() is not None:
        verdict_parity(dp.step(b, t), sdp.step(b, t), f"t={t}")
        copies_equal(dp, f"mid-grow t={t}")
        dp.maintenance_tick(now=t)
        t += 1
    assert (dp._n_data, dp._n_rule, dp._topo_gen) == (2, 2, 1)
    assert len(dp._drs.rows) == 2 and len(dp._state[1]) == 2
    copies_equal(dp, "after the grow")
    dp.reshard_begin(1)
    dp._reshard.corrupt_target(0)
    t = run_ticks(dp, t)
    assert dp._n_data == 2 and dp.reshard_stats()["aborts_total"] == 1
    copies_equal(dp, "after the abort")
    dp.reshard_begin(1)
    t = run_ticks(dp, t)
    assert (dp._n_data, dp._topo_gen) == (1, 2)
    copies_equal(dp, "after the shrink")
    verdict_parity(dp.step(b, t), sdp.step(b, t), "after the shrink")


def test_reshard_requeues_pending_misses_to_new_homes(world):
    """Queued misses survive the flip: re-homed verbatim under the target
    ring, then drained on their owning replicas to oracle-true verdicts."""
    cluster, _ = world
    dp = port_engine(world, **ASYNC)
    tr = tb(gen_traffic(cluster.pod_ips, 128, n_flows=64, seed=31))
    dp.step(tr, 100)
    depth0 = dp.slowpath_stats()["depth"]
    assert depth0 > 0
    dp.reshard_begin(4)
    t = run_ticks(dp, 101)
    st = dp.slowpath_stats()
    assert st["depth"] == depth0
    assert dp.reshard_stats()["requeued_total"] == depth0
    assert len(st["replica_depths"]) == 4
    dp.drain_slowpath(t)
    oracle = TOracle(port_ps(cluster.ps))
    r = dp.step(tr, t + 1)
    for i in np.nonzero(np.asarray(r.pending) == 0)[0]:
        assert int(r.code[i]) == int(oracle.classify(tr.packet(int(i))).code)


def test_reshard_defers_whole_against_inflight_drain(world):
    """A migration window never interleaves with a pinned drain block: the
    tick defers whole, and migration resumes after finish_drain."""
    cluster, _ = world
    dp = port_engine(world, **ASYNC)
    dp.step(tb(gen_traffic(cluster.pod_ips, 128, n_flows=64, seed=37)), 100)
    dp.reshard_begin(4)
    sp = dp._slowpath
    assert sp.begin_drain(101)
    out = dp.maintenance_tick(now=102)
    assert out["blocked"] == "inflight-drain"
    assert "reshard-migrate" in out["deferred"]
    assert dp.reshard_status()["progress_ratio"] == 0.0
    sp.finish_drain(103)
    out = dp.maintenance_tick(now=104)
    assert out["ran"].get("reshard-migrate", 0) > 0
    run_ticks(dp, 105)
    assert dp._n_data == 4


def test_reshard_mid_commit_absorbs_installs_and_deltas(world, hot):
    """A bundle install and an O(delta) group patch between migration
    windows: the target rules re-place at certification, the catch-up
    re-syncs the remapped attribution, and verdicts after the cutover
    equal the single-card engine's that saw the same sequence."""
    cluster, _ = world
    dp, sdp = port_engine(world), port_twin(world)
    b = tb(hot)
    for e in (dp, sdp):
        e.step(b, 100)
    dp.reshard_begin(4)
    dp.maintenance_tick(now=101)
    assert 0 < dp.reshard_status()["progress_ratio"] < 1
    services2 = port_svcs(gen_services(4, cluster.pod_ips, seed=12))
    group = sorted(cluster.ps.address_groups)[0]
    for e in (dp, sdp):
        e.install_bundle(port_ps(cluster.ps), services2)
        e.apply_group_delta(group, ["172.31.9.9"], [])
    assert dp._n_deltas > 0
    t = run_ticks(dp, 102)
    assert (dp._n_data, dp._topo_gen) == (4, 1)
    assert dp.generation == sdp.generation
    verdict_parity(dp.step(b, t), sdp.step(b, t), "post-cutover")
    tr = tb(gen_traffic(cluster.pod_ips, 64, n_flows=32, seed=41))
    verdict_parity(dp.step(tr, t + 1), sdp.step(tr, t + 1), "fresh")
    copies_equal(dp, "after the cutover")


def test_degraded_datapath_pauses_and_rejects_reshard(world, hot):
    """reshard_begin refuses while degraded, and an in-flight resize sheds
    its task until recovery."""
    from antrea_tpu_torch.datapath import CanaryMismatchError

    cluster, services = world
    dp = port_engine(world)
    dp.step(tb(hot), 100)
    dp.corrupt_replica(1)
    with pytest.raises(CanaryMismatchError):
        dp.install_bundle(None, port_svcs(gen_services(
            4, cluster.pod_ips, seed=12)))
    assert dp.degraded
    with pytest.raises(RuntimeError, match="degraded"):
        dp.reshard_begin(4)
    dp.install_bundle(port_ps(cluster.ps), port_svcs(services))
    assert not dp.degraded
    dp.reshard_begin(4)
    dp._commit.degraded = True
    out = dp.maintenance_tick(now=101)
    assert "reshard-migrate" in out["shed"]
    assert dp.reshard_status()["progress_ratio"] == 0.0
    dp._commit.degraded = False
    run_ticks(dp, 102)
    assert dp._n_data == 4


def test_reshard_begin_rejections_equal_the_jax_engine(world):
    """The refusals word for word: a size equal to the current one, a pool
    too small for the target, no resize to abort, a second resize while
    one is in flight; an abort leaves no plane."""
    j, t = jax_engine(world), port_engine(world)
    calls = [lambda dp: dp.reshard_begin(2), lambda dp: dp.reshard_begin(64),
             lambda dp: dp.reshard_abort()]
    for call in calls:
        with pytest.raises((ValueError, RuntimeError)) as ej:
            call(j)
        with pytest.raises(type(ej.value)) as et:
            call(t)
        assert str(et.value) == str(ej.value)
    assert "equals the current" in str(pytest.raises(
        ValueError, t.reshard_begin, 2).value)
    assert str(pytest.raises(ValueError, t.reshard_begin, 64).value) == \
        "need 128 devices, have 8"
    for dp in (j, t):
        dp.reshard_begin(4)
    with pytest.raises(RuntimeError) as ej:
        j.reshard_begin(4)
    with pytest.raises(RuntimeError) as et:
        t.reshard_begin(4)
    assert str(et.value) == str(ej.value) and "already in flight" in str(
        et.value)
    t.reshard_abort("test teardown")
    assert t.reshard_status() is None
    assert t.reshard_stats()["aborts_total"] == 1


def test_reshard_observability_surfaces(world, hot):
    """The reshard metric families, the resize span (stages telescoping to
    total, recorded on the realization tracer) and the budgeted task in
    the scheduler's ledger."""
    dp = port_engine(world)
    text = render_metrics(dp, node="n0")
    for fam in ("antrea_tpu_reshard_topology_generation",
                "antrea_tpu_reshard_active",
                "antrea_tpu_reshard_progress_ratio",
                "antrea_tpu_reshard_migrated_rows_total",
                "antrea_tpu_reshard_resident_rows",
                "antrea_tpu_reshard_cutovers_total",
                "antrea_tpu_reshard_aborts_total"):
        assert f'{fam}{{node="n0"}}' in text, fam
    assert "antrea_tpu_reshard" not in render_metrics(
        td.TpuflowDatapath(None, None, device="cpu", **KW), node="n0")
    dp.step(tb(hot), 100)
    dp.reshard_begin(4)
    assert render_metrics(dp, node="n0").count(
        'antrea_tpu_reshard_active{node="n0"} 1') == 1
    run_ticks(dp, 101)
    span = dp.reshard_stats()["last_span"]
    assert span["n_data_from"] == 2 and span["n_data_to"] == 4
    total = span["migrate_s"] + span["certify_s"] + span["cutover_s"]
    assert abs(total - span["total_s"]) < 1e-9
    assert all(span[k] >= 0 for k in ("migrate_s", "certify_s", "cutover_s"))
    assert dp.realization_stats()["last_resize"] == span
    assert "reshard-migrate" not in dp.maintenance_stats()["tasks"]
    ticks = [e for e in dp.flightrecorder_events(kind="maint-tick")
             if "reshard-migrate" in e.get("ran", {})]
    assert ticks and max(e["ran"]["reshard-migrate"]
                         for e in ticks[:-1] or ticks) <= 4096


def test_dirty_row_tracking_wiring(world):
    """Live dispatches mark their home (replica, slot) pairs in the plane's
    bitmap; a same-ids bundle leaves the bounded set; a renumbering bundle
    falls back to the full sweep."""
    cluster, _ = world
    dp = port_engine(world)
    hot = tb(gen_traffic(cluster.pod_ips, 64, n_flows=32, seed=898))
    dp.step(hot, 100)
    dp.reshard_begin(4)
    st0 = dp._reshard.status()
    assert st0["dirty_rows"] == 0 and st0["dirty_all"] is False
    dp.step(hot, 101)
    assert 0 < dp._reshard.status()["dirty_rows"] < KW["flow_slots"]
    dp.install_bundle(port_ps(cluster.ps))
    assert dp._reshard.dirty_all is False
    dp.install_bundle(port_ps(gen_cluster(40, n_nodes=4, pods_per_node=6,
                                          seed=78).ps))
    assert dp._reshard.dirty_all is True
    assert dp._reshard.status()["dirty_rows"] == 0
    dp.reshard_abort("wiring pinned")
    assert 'antrea_tpu_reshard_catchup_rows_total{node="n0"}' in \
        render_metrics(dp, node="n0")


def test_dirty_row_catchup_sweeps_touched_set_not_all_slots(world):
    """The cutover catch-up walks the rows touched after their window (far
    under the slot space), the established set keeps its verdicts off the
    migrated cache, and a renumbering bundle mid-resize degrades the
    bounded set to the full sweep."""
    cluster, _ = world
    dp = port_engine(world)
    hot = tb(gen_traffic(cluster.pod_ips, 64, n_flows=32, seed=899))
    dp.step(hot, 100)
    r0 = dp.step(hot, 101)
    dp.reshard_begin(4)
    t = 102
    for i in range(2):
        dp.step(tb(gen_traffic(cluster.pod_ips, 32, n_flows=16,
                               seed=900 + i)), t)
        dp.maintenance_tick(now=t)
        t += 1
    t = run_ticks(dp, t)
    rs = dp.reshard_stats()
    assert rs["cutovers_total"] == 1
    assert 0 < rs["catchup_rows_total"] < 2 * KW["flow_slots"] // 2, rs
    r1 = dp.step(hot, t)
    np.testing.assert_array_equal(r1.code, r0.code)
    assert int(r1.est.sum()) > 0
    dp.reshard_begin(2)
    dp.maintenance_tick(now=t)
    dp.step(hot, t + 1)
    dp.install_bundle(port_ps(cluster.ps))
    assert dp._reshard.dirty_all is False
    dp.install_bundle(port_ps(gen_cluster(40, n_nodes=4, pods_per_node=6,
                                          seed=77).ps))
    assert dp._reshard.dirty_all is True
    run_ticks(dp, t + 2)
    assert dp.reshard_stats()["catchup_rows_total"] > rs["catchup_rows_total"]


def test_offshard_dnat_reply_leg_reclassifies_to_identical_verdict(world):
    """A DNAT'd reply leg homed on another replica than its forward leg
    re-classifies to the verdict the scalar Oracle gives the reply tuple,
    and never flaps the forward leg's established entry."""
    cluster, services = world
    dp = port_engine(world)
    fwd = tb(gen_traffic(cluster.pod_ips, 128, n_flows=64, seed=41,
                         services=services, svc_fraction=1.0))
    dp.step(fwd, 100)
    r = dp.step(fwd, 101)
    svc = (r.svc_idx >= 0) & (r.est == 1) & (r.dnat_ip != fwd.dst_ip)
    assert svc.any()
    rep = TBatch(src_ip=np.asarray(r.dnat_ip).astype(np.uint32),
                 dst_ip=fwd.src_ip, proto=fwd.proto,
                 src_port=np.asarray(r.dnat_port).astype(np.int32),
                 dst_port=fwd.src_port)
    home_fwd = tpm.shard_of_tuples(fwd.src_ip, fwd.dst_ip, fwd.proto,
                                   fwd.src_port, fwd.dst_port, 2)
    home_rep = tpm.shard_of_tuples(rep.src_ip, rep.dst_ip, rep.proto,
                                   rep.src_port, rep.dst_port, 2)
    off = svc & (home_fwd != home_rep)
    assert off.any()
    rr = dp.step(rep, 102)
    oracle = TOracle(port_ps(cluster.ps))
    checked = 0
    for i in np.nonzero(off)[0]:
        if rr.est[i]:
            continue  # aliased onto another flow's committed entry
        checked += 1
        assert int(rr.code[i]) == int(oracle.classify(rep.packet(int(i))).code)
    assert checked > 0
    r2 = dp.step(fwd, 103)
    sel = np.nonzero(svc)[0]
    np.testing.assert_array_equal(r2.code[sel], r.code[sel])
    assert float(r2.est[sel].mean()) > 0.9
