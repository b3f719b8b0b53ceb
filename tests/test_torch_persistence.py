"""Restart persistence on the PyTorch port (datapath/persist.py with the
native store, native/store.py over the port's copy of ovsdb_lite.cc), held
to the JAX package on the CPU.

- The store built from the port's copy: commit, abort, a torn tail, a
  bit-flipped tail, compaction, on both backends; its journal is one
  on-disk format with the JAX package's store, both ways.
- A persist dir restarts the port's engine and its twin with the same
  PolicySet, services, topology and a monotonic generation (the round
  journal covers delta bumps the snapshot missed); a corrupt newest slot
  falls back to the last-known-good one; tenant worlds come back with
  their tids, specs and generations.  Each restart is run on the JAX
  engine given the same calls, and the two agree: generations, tenant
  stats, and every StepResult field after the restart.
- A persist dir written by the JAX engine boots the port's engine with the
  same PolicySet and generation, and the reverse.

Every value is an int32 or u32 word: no tolerance."""

import copy
import os

import pytest

from antrea_tpu.datapath import OracleDatapath as JOracle
from antrea_tpu.datapath import TpuflowDatapath as JEngine
from antrea_tpu.datapath import persist as jpersist
from antrea_tpu.dissemination import serde as jserde
from antrea_tpu.native import ConfigStore as JStore
from antrea_tpu.simulator import gen_cluster, gen_traffic
from antrea_tpu.simulator.genservice import gen_services
from antrea_tpu_torch import datapath as td
from antrea_tpu_torch.compiler import topology as ttopo
from antrea_tpu_torch.datapath import persist as tpersist
from antrea_tpu_torch.dissemination import serde as tserde
from antrea_tpu_torch.native import ConfigStore, native_available
from antrea_tpu_torch.native import store as tstore

from test_torch_engine import node0, port_ps, port_svcs, tb
from test_torch_tenancy import same_result
import torch_cpu  # noqa: F401  (one torch thread a worker)

BACKENDS = ["python", "native"]
KW = dict(flow_slots=1 << 12, aff_slots=1 << 8, canary_probes=8)
ENGINES = {"engine": (td.TpuflowDatapath, JEngine,
                      {"device": "cpu", "miss_chunk": 32}, {"miss_chunk": 32}),
           "twin": (td.OracleDatapath, JOracle, {}, {})}


def _open(path, backend):
    return ConfigStore(str(path), force_python=(backend == "python"))


def test_native_store_builds_from_the_ports_copy():
    """g++ builds the port's own copy of ovsdb_lite.cc into the package's
    build directory, named by the source's hash; the JAX package's source
    directory is not where it lands."""
    assert native_available()
    so = tstore._so_path()
    assert os.path.exists(so)
    assert os.path.dirname(so) == tstore._BUILD_DIR
    assert os.path.basename(os.path.dirname(so)) == "_build"
    assert os.path.dirname(tstore._SRC).endswith(
        os.path.join("antrea_tpu_torch", "native"))


@pytest.mark.parametrize("backend", BACKENDS)
def test_txn_commit_abort_and_reopen(tmp_path, backend):
    p = tmp_path / "db"
    with _open(p, backend) as s:
        assert s.backend == backend
        s.set("round", b"7")
        s.set("iface/pod-a", b'{"ofport": 3}')
        s.commit()
        s.set("round", b"8")
        s.abort()
        assert s.get("round") == b"7"
        s.set("iface/pod-b", b"x")
        s.delete("iface/pod-a")
        s.commit()
    with _open(p, backend) as s:
        assert s.get("round") == b"7"
        assert s.get("iface/pod-a") is None
        assert s.get("iface/pod-b") == b"x"
        assert s.keys() == ["iface/pod-b", "round"]


@pytest.mark.parametrize("backend", BACKENDS)
def test_torn_and_corrupt_tail_records_are_dropped(tmp_path, backend):
    p = tmp_path / "db"
    with _open(p, backend) as s:
        s.set("a", b"1")
        s.commit()
        s.set("b", b"2")
        s.commit()
    with open(p, "r+b") as f:
        f.truncate(os.path.getsize(p) - 3)
    with _open(p, backend) as s:
        assert s.get("a") == b"1" and s.get("b") is None
        s.set("c", b"3")
        s.commit()
    with open(p, "r+b") as f:
        f.seek(-1, os.SEEK_END)
        last = f.read(1)
        f.seek(-1, os.SEEK_END)
        f.write(bytes([last[0] ^ 0xFF]))
    with _open(p, backend) as s:
        assert s.get("a") == b"1" and s.get("c") is None


@pytest.mark.parametrize("backend", BACKENDS)
def test_compaction_preserves_state(tmp_path, backend):
    p = tmp_path / "db"
    with _open(p, backend) as s:
        for i in range(50):
            s.set(f"k{i}", str(i).encode() * 10)
            s.commit()
        for i in range(0, 50, 2):
            s.delete(f"k{i}")
            s.commit()
        before = os.path.getsize(p)
        s.compact()
        assert os.path.getsize(p) < before
        assert s.get("k1") == b"1" * 10 and s.get("k0") is None
    with _open(p, backend) as s:
        assert len(s.keys()) == 25


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_journal_is_wire_compatible_with_the_jax_store(tmp_path, writer):
    """A journal the port's native store writes opens in the JAX package's
    store (native and Python backends), and the reverse; compaction by one
    replays in the other, byte for byte the same file either way."""
    mine, theirs = ((ConfigStore, JStore) if writer == "port"
                    else (JStore, ConfigStore))
    p = tmp_path / "db"
    with mine(str(p)) as s:
        assert s.backend == "native"
        s.set("written-by", writer.encode())
        s.set("gone", b"x")
        s.commit()
        s.delete("gone")
        s.commit()
    for force in (False, True):
        with theirs(str(p), force_python=force) as s:
            assert s.get("written-by") == writer.encode()
            assert s.get("gone") is None
    with theirs(str(p)) as s:
        s.set("also", b"other")
        s.commit()
        s.compact()
    a = p.read_bytes()
    with mine(str(p)) as s:
        assert s.get("also") == b"other"
        assert s.get("written-by") == writer.encode()
        assert s.keys() == ["also", "written-by"]
    q = tmp_path / "db2"
    with mine(str(q)) as s:
        s.set("also", b"other")
        s.set("written-by", writer.encode())
        s.commit()
        s.compact()
    assert q.read_bytes() == a


def _world():
    cluster = gen_cluster(60, n_nodes=4, pods_per_node=8, seed=21)
    services = gen_services(6, cluster.pod_ips, seed=22)
    traffic = gen_traffic(cluster.pod_ips, batch=96, seed=23,
                          services=services, svc_fraction=0.4)
    return cluster, services, traffic


@pytest.mark.parametrize("which", list(ENGINES))
def test_restart_recovers_state_as_the_jax_engine_does(tmp_path, which):
    """Kill and rebuild from the persist dir: the PolicySet, services,
    topology and generation survive; the restarted engine serves as one
    that never restarted (the cache re-commits); a delta bump after the
    last snapshot survives through the round journal.  The JAX engine,
    given the same calls on its own dir, agrees at every step."""
    tcls, jcls, tkw, jkw = ENGINES[which]
    cluster, services, traffic = _world()
    topo = node0(ttopo, cluster, pods_per_node=8)
    jtopo = jserde.decode_topology(tserde.encode_topology(topo))
    dj, dt = str(tmp_path / "jax"), str(tmp_path / "port")
    j = jcls(persist_dir=dj, **KW, **jkw)
    t = tcls(persist_dir=dt, **KW, **tkw)
    assert t._conf_store.backend == "native"
    g1 = j.install_bundle(ps=copy.deepcopy(cluster.ps), services=services)
    assert t.install_bundle(ps=port_ps(cluster.ps),
                            services=port_svcs(services)) == g1
    j.install_topology(jtopo)
    t.install_topology(topo)
    r0 = t.step(tb(traffic), now=10)
    same_result(j.step(traffic, now=10), r0, "before")
    twin = tcls(port_ps(cluster.ps), port_svcs(services), topology=topo,
                **KW, **tkw)
    del j, t
    j = jcls(persist_dir=dj, **KW, **jkw)
    t = tcls(persist_dir=dt, **KW, **tkw)
    assert t.generation == j.generation == g1
    assert tserde.encode_topology(t._topo) == tserde.encode_topology(topo)
    r = t.step(tb(traffic), now=20)
    same_result(j.step(traffic, now=20), r, "after")
    want = twin.step(tb(traffic), now=20)
    for f in ("code", "svc_idx", "dnat_ip", "dnat_port", "reject_kind",
              "snat", "fwd_kind", "out_port"):
        assert getattr(r, f).tolist() == getattr(want, f).tolist(), f
    assert r.ingress_rule == want.ingress_rule
    assert r.code.tolist() == r0.code.tolist()
    assert int(r.est.sum()) == 0 and int(r.committed.sum()) > 0
    assert (t.install_bundle(services=port_svcs(services))
            == j.install_bundle(services=services) == g1 + 1)
    ag = sorted(cluster.ps.address_groups)[0]
    for ip in ("10.77.0.1", "10.77.0.2"):
        assert (t.apply_group_delta(ag, [ip], [])
                == j.apply_group_delta(ag, [ip], []))
    g4 = t.generation
    assert g4 > g1 + 1
    del j, t
    j = jcls(persist_dir=dj, **KW, **jkw)
    t = tcls(persist_dir=dt, **KW, **tkw)
    assert t.generation == j.generation == g4


@pytest.mark.parametrize("which", list(ENGINES))
def test_corrupt_latest_snapshot_falls_back_as_the_jax_engine_does(
        tmp_path, which):
    """A bit-rotted newest slot recovers the last-known-good one (one
    bundle behind), the round journal keeping the generation monotonic;
    a torn newest slot falls back the same way.  Both packages' engines
    land on the same generation and serve the same verdicts."""
    tcls, jcls, tkw, jkw = ENGINES[which]
    ca = gen_cluster(40, n_nodes=2, pods_per_node=6, seed=31)
    cb = gen_cluster(40, n_nodes=2, pods_per_node=6, seed=32)
    traffic = gen_traffic(ca.pod_ips, batch=64, seed=33)
    dirs = {}
    for name, cls, kw, conv, persist in (
            ("jax", jcls, jkw, copy.deepcopy, jpersist),
            ("port", tcls, tkw, port_ps, tpersist)):
        d = str(tmp_path / name)
        dp = cls(persist_dir=d, **KW, **kw)
        dp.install_bundle(ps=conv(ca.ps))
        assert dp.install_bundle(ps=conv(cb.ps)) == 2
        del dp
        latest = persist.snapshot_path(d)
        body = open(latest).read()
        with open(latest, "w") as f:
            f.write(body.replace('"generation":2', '"generation":9'))
        assert persist.load_snapshot(d)[2] == 1
        dirs[name] = d
    j = jcls(persist_dir=dirs["jax"], **KW, **jkw)
    t = tcls(persist_dir=dirs["port"], **KW, **tkw)
    assert t.generation == j.generation == 2
    same_result(j.step(traffic, now=10), t.step(tb(traffic), now=10),
                "lkg")
    twin = tcls(port_ps(ca.ps), **KW, **tkw)
    assert (t.step(tb(traffic), now=11).code.tolist()
            == twin.step(tb(traffic), now=11).code.tolist())
    with open(tpersist.snapshot_path(dirs["port"]), "w") as f:
        f.write('{"v": 2, "genera')
    assert tpersist.load_snapshot(dirs["port"])[2] == 1


@pytest.mark.parametrize("which", list(ENGINES))
def test_tenant_worlds_survive_restart(tmp_path, which):
    """Tenant worlds ride the snapshot: a restart rebuilds the registry
    with tids, specs and per-tenant generations, and every world serves as
    in the JAX engine restarted from its own dir by the same calls (and as
    a twin that never restarted); per-tenant generations keep climbing."""
    tcls, jcls, tkw, jkw = ENGINES[which]
    base = gen_cluster(40, n_nodes=2, pods_per_node=6, seed=51)
    worlds = [gen_cluster(rc, n_nodes=2, pods_per_node=6, seed=52 + i)
              for i, rc in enumerate((8, 40))]
    kw = dict(flow_slots=1 << 10, aff_slots=1 << 8, canary_probes=8)
    tkw2 = dict(quota=1 << 8, aff_quota=1 << 6)

    def build(cls, d, ekw, conv):
        dp = cls(persist_dir=d, **kw, **ekw)
        dp.install_bundle(ps=conv(base.ps))
        tids = [dp.tenant_create(f"t{i}", conv(c.ps), **tkw2)
                for i, c in enumerate(worlds)]
        assert dp.tenant_install_bundle(tids[0], conv(worlds[0].ps)) == 1
        return tids

    dj, dt = str(tmp_path / "jax"), str(tmp_path / "port")
    tids = build(jcls, dj, jkw, copy.deepcopy)
    assert build(tcls, dt, tkw, port_ps) == tids
    twin = tcls(port_ps(base.ps), **kw, **tkw)
    twin_tids = [twin.tenant_create(f"t{i}", port_ps(c.ps), **tkw2)
                 for i, c in enumerate(worlds)]
    twin.tenant_install_bundle(twin_tids[0], port_ps(worlds[0].ps))
    j = jcls(persist_dir=dj, **kw, **jkw)
    t = tcls(persist_dir=dt, **kw, **tkw)
    assert t.tenant_count == len(worlds)
    st = t.tenant_stats()
    assert st == j.tenant_stats()
    assert sorted(st) == tids
    assert st[tids[0]]["generation"] == 1 and st[tids[0]]["name"] == "t0"
    assert st[tids[0]]["quota_slots"] == 1 << 8
    for i, (tid, c) in enumerate(zip(tids, worlds)):
        b = gen_traffic(c.pod_ips, batch=64, n_flows=24, seed=60 + i)
        got = t.tenant_step(tid, tb(b), now=100)
        same_result(j.tenant_step(tid, b, now=100), got, f"tenant {tid}")
        want = twin.tenant_step(twin_tids[i], tb(b), now=100)
        assert got.code.tolist() == want.code.tolist()
        assert got.ingress_rule == want.ingress_rule
        assert int(got.est.sum()) == 0 and int(got.committed.sum()) > 0
    bd = gen_traffic(base.pod_ips, batch=64, seed=70)
    same_result(j.step(bd, now=101), t.step(tb(bd), now=101), "default")
    assert (t.tenant_install_bundle(tids[0], port_ps(worlds[0].ps))
            == j.tenant_install_bundle(tids[0], copy.deepcopy(worlds[0].ps))
            == 2)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_persist_dir_crosses_packages(tmp_path, writer):
    """A persist dir written by one package's engine boots the other's with
    the same PolicySet, services, topology, tenant worlds and generation
    (the JSON snapshot through each package's serde, the round journal
    through each package's native store), and both then serve alike."""
    cluster, services, traffic = _world()
    tenant = gen_cluster(12, n_nodes=2, pods_per_node=6, seed=61)
    topo = node0(ttopo, cluster, pods_per_node=8)
    jtopo = jserde.decode_topology(tserde.encode_topology(topo))
    kw = dict(flow_slots=1 << 12, aff_slots=1 << 8, miss_chunk=32,
              canary_probes=8)
    d = str(tmp_path)
    if writer == "jax":
        w = JEngine(persist_dir=d, **kw)
        w.install_bundle(ps=copy.deepcopy(cluster.ps), services=services)
        w.install_topology(jtopo)
        tid = w.tenant_create("t", copy.deepcopy(tenant.ps), quota=1 << 8)
        w.apply_group_delta(sorted(cluster.ps.address_groups)[0],
                            ["10.77.0.1"], [])
    else:
        w = td.TpuflowDatapath(persist_dir=d, device="cpu", **kw)
        w.install_bundle(ps=port_ps(cluster.ps),
                         services=port_svcs(services))
        w.install_topology(topo)
        tid = w.tenant_create("t", port_ps(tenant.ps), quota=1 << 8)
        w.apply_group_delta(sorted(cluster.ps.address_groups)[0],
                            ["10.77.0.1"], [])
    gen = w.generation
    del w
    snap = jpersist.load_snapshot(d) if writer == "jax" else \
        tpersist.load_snapshot(d)
    assert snap[2] == gen - 1  # the delta bump rode the round journal only
    booted = (td.TpuflowDatapath(persist_dir=d, device="cpu", **kw)
              if writer == "jax" else JEngine(persist_dir=d, **kw))
    assert booted.generation == gen
    assert booted.tenant_count == 1
    # Each package's serde encodes its own objects: the wire form is one.
    mine, theirs = (tserde, jserde) if writer == "jax" else (jserde, tserde)
    assert (mine.encode_policy_set(booted._ps)
            == theirs.encode_policy_set(snap[0]))
    assert ([mine.encode_service_entry(s) for s in booted._services]
            == [theirs.encode_service_entry(s) for s in snap[1]])
    assert (mine.encode_topology(booted._topo)
            == tserde.encode_topology(topo))
    ref = (JEngine(copy.deepcopy(cluster.ps), services, topology=jtopo,
                   **kw) if writer == "jax" else
           td.TpuflowDatapath(port_ps(cluster.ps), port_svcs(services),
                              topology=topo, device="cpu", **kw))
    ref.tenant_create("t", copy.deepcopy(tenant.ps) if writer == "jax"
                      else port_ps(tenant.ps), quota=1 << 8)
    if writer == "jax":
        same_result(ref.step(traffic, now=10), booted.step(tb(traffic), 10),
                    "jax-written dir on the port")
    else:
        same_result(booted.step(traffic, now=10), ref.step(tb(traffic), 10),
                    "port-written dir on the JAX engine")
    b = gen_traffic(tenant.pod_ips, batch=32, n_flows=16, seed=62)
    r1 = booted.tenant_step(tid, b if writer == "port" else tb(b), 11)
    r2 = ref.tenant_step(tid, b if writer == "jax" else tb(b), 11)
    assert r1.code.tolist() == r2.code.tolist()
    assert r1.ingress_rule == r2.ingress_rule
