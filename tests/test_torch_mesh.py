"""The PyTorch port's (data x rule) mesh (antrea_tpu_torch/parallel/mesh.py)
and B3's hits-only variant against the JAX package, on the CPU.  Every
value is an int32 word: the tolerance is exact equality.

  - B3h's plain version against the Pallas kernel with resolve=False in
    interpret mode, on both halves of a 2-way rule split (w0 = 0 and
    w0 > 0), with mixed valid / no_commit / fb_force lane bits;
  - the host routing (_ring, shard_of_tuples);
  - gloo process groups, one spawned group per mesh shape running all of
    that shape's cases, against the JAX mesh on conftest's virtual CPU
    devices: outputs and the per-data-shard state row for row (dump row
    excluded), and every rule shard of a data row returning the same
    outputs.

The world has 2500 rules (1478 ingress, 47 words), so that under pruning
the second rule shard's words (32-63) hold rules: its hits carry w0 > 0.
The staged cases hold make_sharded_pipeline[_full] to the JAX functions
of the same names, which always run the staged rounds; the one-pass cases
(onepass=True) hold them to the JAX mesh engine's step builders at
PipelineMeta.onepass (parallel/meshpath)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from antrea_tpu.compiler import topology as jtopo
from antrea_tpu.compiler.compile import compile_policy_set
from antrea_tpu.compiler.services import compile_services
from antrea_tpu.models import forwarding as jfw
from antrea_tpu.models import pipeline as jpl
from antrea_tpu.ops import match as jm
from antrea_tpu.parallel import mesh as jmesh
from antrea_tpu.parallel import meshpath as jmeshpath
from antrea_tpu.simulator import gen_cluster, gen_services
from antrea_tpu_torch.compiler import topology as ttopo
from antrea_tpu_torch.compiler.compile import compile_policy_set as t_compile
from antrea_tpu_torch.compiler.services import \
    compile_services as t_compile_services
from antrea_tpu_torch.models import forwarding as tfw
from antrea_tpu_torch.models import pipeline as tpl
from antrea_tpu_torch.ops import hashing as thash
from antrea_tpu_torch.ops import match as tm
from antrea_tpu_torch.ops import onepass as top
from antrea_tpu_torch.parallel import mesh as tmesh
from antrea_tpu_torch.simulator import gen_cluster as t_gen_cluster
from antrea_tpu_torch.simulator import gen_services as t_gen_services

import torch_mesh_ranks
from test_torch_forwarding import _node0, _topology, walk_lanes
from test_torch_onepass import _np_probes

B = 128
K = 1
KW = dict(flow_slots=1 << 10, aff_slots=1 << 6, miss_chunk=32)
_N = dict(n_nodes=4, pods_per_node=16, seed=7)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a),
                                                 dtype=np.int32))


# ---- host routing ----------------------------------------------------------


@pytest.mark.parametrize("n_data", [1, 2, 3, 4])
def test_ring_equals_reference(n_data):
    want = jmesh._ring(n_data)
    got = tmesh._ring(n_data)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n_data", [1, 2, 3, 4])
@pytest.mark.parametrize("topo_gen", [0, 1])
@pytest.mark.parametrize("tenant", [0, 5])
def test_shard_of_tuples_equals_reference(n_data, topo_gen, tenant):
    rng = np.random.default_rng(n_data * 10 + topo_gen)
    n = 4096
    cols = (rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32),
            rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32),
            rng.choice(np.array([1, 6, 17], np.int32), n),
            rng.integers(0, 65536, n).astype(np.int32),
            rng.integers(0, 65536, n).astype(np.int32))
    want = jmesh.shard_of_tuples(*cols, n_data, topo_gen=topo_gen,
                                 tenant=tenant)
    got = tmesh.shard_of_tuples(*cols, n_data, topo_gen=topo_gen,
                                tenant=tenant)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    # Direction symmetry: the reply leg lands on the same shard.
    back = tmesh.shard_of_tuples(cols[1], cols[0], cols[2], cols[4],
                                 cols[3], n_data, topo_gen=topo_gen,
                                 tenant=tenant)
    np.testing.assert_array_equal(back, got)


# ---- the world -------------------------------------------------------------


@pytest.fixture(scope="module")
def world():
    cluster = gen_cluster(2500, **_N)
    services = gen_services(16, cluster.pod_ips, affinity_fraction=0.3,
                            no_ep_fraction=0.1, seed=9)
    tcl = t_gen_cluster(2500, **_N)
    tsvcs = t_gen_services(16, tcl.pod_ips, affinity_fraction=0.3,
                           no_ep_fraction=0.1, seed=9)
    spec = _node0(cluster.pod_ips, _N["n_nodes"], _N["pods_per_node"],
                  mcast=[dict(group_ip="239.1.1.1", local_ports=(3, 4))])
    lanes = [walk_lanes(cluster.pod_ips, services, seed=s) for s in (11, 12)]
    return dict(
        cluster=cluster, services=services,
        cps=compile_policy_set(cluster.ps), svc=compile_services(services),
        ft=jtopo.compile_topology(_topology(jtopo, spec)),
        port=dict(cps=t_compile(tcl.ps), svc=t_compile_services(tsvcs),
                  ft=ttopo.compile_topology(_topology(ttopo, spec))),
        lanes=lanes)


# ---- B3h -------------------------------------------------------------------


def test_plain_hits_only_equals_pallas(world):
    """B3h's plain version (onepass_plain(resolve=False)) against
    _onepass_call(resolve=False, interpret=True) on each half of a 2-way
    rule split of the pruned tables (one compile, one padded Pallas call
    per half; shard 1 at w0 = W/2), after a cold step so the batch has hit
    and miss lanes, with valid = 0 lanes (hit and miss), no_commit = 1
    lanes and fb_force = 1 lanes."""
    cps = world["port"]["cps"]
    step, state, (drs, dsvc) = tpl.make_pipeline(
        cps, world["port"]["svc"], device="cpu", fused=True, prune_budget=K,
        **KW)
    meta = step.meta
    lanes = world["lanes"][0]
    cols = [_t(lanes[c]) for c in ("src", "dst", "proto", "sport", "dport")]
    state, _ = step(state, drs, dsvc, *cols, 100, 0)
    fresh = world["lanes"][1]
    cols = [torch.cat([a[:B // 2], _t(fresh[c])[B // 2:]]) for a, c in zip(
        cols, ("src", "dst", "proto", "sport", "dport"))]
    src_f, dst_f, proto, sport, dport = cols
    pp = tpl._pair16(sport, dport)
    h = thash.flow_hash(tpl._raw_bits(src_f), tpl._raw_bits(dst_f), proto,
                        sport, dport)
    now = 101
    hit, _, _, mr, kr0, ts0 = tpl._cache_lookup(
        state.flow, h & (meta.flow_slots - 1), torch.stack([src_f, dst_f], 1),
        pp, proto | 0x100, proto | 0x100 | (tpl.GEN_ETERNAL << 9), now, proto,
        meta)
    hit = hit.numpy()
    rng = np.random.default_rng(2)
    valid = rng.random(B) >= 0.15
    valid[np.flatnonzero(hit)[:2]] = False  # hit lanes outside the mask
    no_commit = rng.random(B) < 0.2
    fb_force = rng.random(B) < 0.2
    x, _, st, _ = tpl._onepass_inputs(
        state.aff, drs, dsvc, src_f, dst_f, proto, sport, dport, pp, h, kr0,
        mr, ts0, now, meta, valid=torch.from_numpy(valid),
        no_commit=torch.from_numpy(no_commit))
    x = x._replace(msk=x.msk.clone())
    x.msk[:, 2] = torch.from_numpy(fb_force.astype(np.int32))
    miss = ~hit & valid
    assert hit.any() and miss.any() and (fb_force & miss).any()

    drs_np, jmeta = jm.to_host(world["cps"], word_multiple=2,
                               prune_budget=K)
    mm = jmeta
    bp = -(-B // 128) * 128
    call = None
    for r in (0, 1):
        sl = tmesh.rule_slice(drs_np, 2, r)
        tabs = top.tables_of(tm.ruleset_from_numpy(sl, "cpu"))
        ing, eg = sl.ingress, sl.egress
        dims = (ing.at, ing.peer, ing.svc, eg.at, eg.peer, eg.svc)
        w0 = (int(ing.word_idx[0]), int(eg.word_idx[0]))
        assert (w0[0] > 0) == (r == 1)
        hits8, aux, iv = top.onepass(x, tabs, now, 0, st, *w0, resolve=False)
        assert [t.dtype for t in (hits8, aux, iv)] == [torch.int32] * 3
        iv_np, aggs, prb, iso_col = _np_probes(
            dims, (sl.iso_in, sl.iso_out), x, miss)

        def pad(a, u32=False):
            a = np.pad(np.asarray(a), ((0, bp - B), (0, 0)))
            return jnp.asarray(a.view(np.uint32) if u32 else a)

        s_in, s_out = aggs[0].shape[1], aggs[3].shape[1]
        if call is None:
            call = jm._onepass_call(bp, s_in, s_out, K, K, mm.in_phases,
                                    mm.out_phases, False, False,
                                    meta.timeouts, meta.flow_slots,
                                    tpl.PREF_MASK, True)
        inc2 = [jnp.asarray(np.ascontiguousarray(t.inc).view(
            np.uint32).reshape(-1, 32)) for t in dims]
        want = call(pad(x.pkt.numpy()), pad(x.kr.numpy()), pad(prb),
                    pad(x.mrow.numpy()), pad(x.msk.numpy()),
                    pad(x.lb.numpy()), *(pad(a, u32=True) for a in aggs),
                    pad(iv_np), jnp.asarray([[now, 0, *w0]], jnp.int32),
                    *inc2)
        want = [np.asarray(w)[:B] for w in want]
        np.testing.assert_array_equal(hits8.numpy(), want[0],
                                      err_msg=f"shard {r} hits8")
        np.testing.assert_array_equal(aux.numpy(), want[1],
                                      err_msg=f"shard {r} aux")
        np.testing.assert_array_equal(iv[:, :7].numpy(), iv_np[:, :7],
                                      err_msg=f"shard {r} iv")
        np.testing.assert_array_equal(iv[:, 7].numpy(), iso_col,
                                      err_msg=f"shard {r} iv isolation")
        h8 = hits8.numpy()
        assert (h8[~miss, :6] == tm.BIG).all() and (h8[:, 6:] == 0).all()
        # Shard r's first matches lie in its own words.
        found = h8[:, :3][h8[:, :3] < tm.BIG]
        assert found.size and (found >= 32 * w0[0]).all()
        a = aux.numpy()
        assert (a[fb_force & miss, 1] == 1).all() and (a[~miss] == 0).all()


# ---- the mesh --------------------------------------------------------------


def _jax_mesh(n_data, n_rule):
    return jmesh.make_mesh(n_data, n_rule, devices=jax.devices("cpu"))


_TUPLE = ("src", "dst", "proto", "sport", "dport")
_FULL = _TUPLE + ("in_port", "flags", "arp_op")


def _steps(world, kind):
    """Two steps (cold, then warm with the teardown flags) of the world's
    first batch, as the rank body takes them."""
    ln = world["lanes"][0]
    zero = np.zeros(B, np.int32)
    if kind == "pipeline":
        return [tuple(ln[c] for c in _TUPLE) + (1000 + t,) for t in (0, 1)]
    return [tuple(ln[c] for c in _TUPLE + ("in_port",))
            + (zero if t == 0 else ln["flags"], ln["arp_op"], 1000 + t)
            for t in (0, 1)]


def _jax_run(world, kind, mesh, knobs, steps):
    """The JAX mesh over the same steps -> [(out, state)] after each step.
    The staged step is make_sharded_pipeline[_full] with the same knobs;
    the one-pass step (onepass=True) is the mesh engine's step builder at
    PipelineMeta.onepass, all lanes valid."""
    cps, svc, ft = world["cps"], world["svc"], world["ft"]
    if not knobs.get("onepass"):
        if kind == "pipeline":
            step, st, tabs = jmesh.make_sharded_pipeline(cps, svc, mesh,
                                                         **KW, **knobs)
        else:
            step, st, tabs = jmesh.make_sharded_pipeline_full(
                cps, svc, ft, mesh, **KW, **knobs)

        def run(st, cols, now):
            return step(st, *tabs, *cols, now, 0)
    else:
        drs, mmeta = jmesh.shard_rule_set(cps, mesh,
                                          prune_budget=knobs["prune_budget"])
        meta = jpl.PipelineMeta(match=mmeta, ct_timeout_s=3600, fused=True,
                                onepass=True, **KW)
        repl = NamedSharding(mesh, P())
        dsvc = jax.tree.map(lambda a: jax.device_put(a, repl),
                            jpl.svc_to_device(svc))
        dft = jax.tree.map(lambda a: jax.device_put(a, repl),
                           jfw.fwd_to_device(ft))
        st = jmesh.shard_state(jpl.init_state(KW["flow_slots"],
                                              KW["aff_slots"]), mesh)
        ones = np.ones(B, bool)
        zb, zi = np.zeros(B, bool), np.zeros(B, np.int32)
        if kind == "pipeline":
            fn = jmeshpath._mesh_step_fn(mesh, meta)

            def run(st, cols, now):
                return fn(st, drs, dsvc, *cols, now, 0, ones, zb, zi, zi)
        else:
            fn = jmeshpath._mesh_step_full_fn(mesh, meta, True)

            def run(st, cols, now):
                return fn(st, drs, dsvc, dft, *cols[:6], now, 0, cols[6],
                          cols[7], ones, zb, zi, zb)
    res = []
    for *cols, now in steps:
        st, out = run(st, tuple(jnp.asarray(c) for c in cols), now)
        res.append((jax.device_get(out), jax.device_get(st)))
    return res


def _assert_case(world, ranks, i, kind, knobs, n_data, n_rule):
    """Case i of a spawned group against the JAX mesh: each data row's rule
    shards agree, and the gathered outputs and state equal the JAX mesh's
    after every step."""
    steps = _steps(world, kind)
    want = _jax_run(world, kind, _jax_mesh(n_data, n_rule), knobs, steps)
    rows = [[ranks[d * n_rule + r][i] for r in range(n_rule)]
            for d in range(n_data)]
    for t, (jout, jstate) in enumerate(want):
        outs = []
        for d, row in enumerate(rows):
            for r, (o, _) in enumerate(row[1:], 1):
                for k, v in row[0][0][t].items():
                    np.testing.assert_array_equal(
                        o[t][k], v, err_msg=f"step {t} row {d}: rule shard "
                        f"{r} differs from shard 0 in {k}")
            outs.append(row[0][0][t])
        got = tmesh.gather_outputs(outs)
        assert set(got) == set(jout)
        for k, v in jout.items():
            assert got[k].dtype == np.int32, k
            np.testing.assert_array_equal(got[k], np.asarray(v),
                                          err_msg=f"step {t}: out[{k}]")
    state = np.concatenate  # per-row states stack on the data axis
    for part in ("flow", "aff"):
        jt = getattr(want[-1][1], part)
        for f in jt._fields:
            g = state([getattr(getattr(row[0][1], part), f) for row in rows])
            np.testing.assert_array_equal(
                g[:, :-1], np.asarray(getattr(jt, f))[:, :-1],
                err_msg=f"{part}.{f}")
    return tmesh.gather_outputs([row[0][0][0] for row in rows])


# One spawned group per mesh shape, running all of that shape's cases.
_ONEPASS = dict(fused=True, prune_budget=K, onepass=True)
_CASES = {
    (1, 2): [("classify", dict(prune_budget=0)),
             ("classify", dict(prune_budget=2)),
             ("full", _ONEPASS),
             ("full", dict(fused=True, prune_budget=K))],
    (2, 2): [("pipeline", _ONEPASS),
             ("pipeline", dict(fused=True)),
             ("full", _ONEPASS)],
    (2, 1): [("full", _ONEPASS)],
}


@pytest.fixture(scope="module")
def groups(world):
    """Spawn each mesh shape's group once -> {shape: per-rank results}."""
    port = world["port"]
    out = {}
    for shape, cases in _CASES.items():
        ln = world["lanes"][0]
        spec = []
        for kind, knobs in cases:
            if kind == "classify":
                steps = [tuple(_t(ln[c]) for c in ("src", "dst", "proto",
                                                    "dport"))]
                spec.append((kind, knobs, steps))
            else:
                spec.append((kind, dict(KW, **knobs), _steps(world, kind)))
        out[shape] = tmesh.spawn(torch_mesh_ranks.run, *shape,
                                 args=(port, spec), device="cpu", threads=1)
    return out


@pytest.mark.parametrize("prune_budget", [0, 2])
def test_sharded_classifier_1x2_equals_reference(world, groups, prune_budget):
    """make_sharded_classifier on (1, 2): codes, rules and, pruned, the
    combined prune observables (skip as AND, fb as OR, cand as MAX)."""
    i = [kn for _, kn in _CASES[(1, 2)]].index(
        dict(prune_budget=prune_budget))
    ranks = groups[(1, 2)]
    ln = world["lanes"][0]
    cols = tuple(ln[c] for c in ("src", "dst", "proto", "dport"))
    fn, _ = jmesh.make_sharded_classifier(world["cps"], _jax_mesh(1, 2),
                                          prune_budget=prune_budget)
    want = jax.device_get(fn(*cols))
    got, other = ranks[0][i][0], ranks[1][i][0]
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)
        np.testing.assert_array_equal(other[k], got[k], err_msg=k)
    if prune_budget:
        assert got["prune_skip"].any() and not got["prune_skip"].all()


@pytest.mark.parametrize("case", [2, 3], ids=["onepass", "staged_pruned"])
def test_sharded_full_walk_1x2_equals_reference(world, groups, case):
    kind, knobs = _CASES[(1, 2)][case]
    out = _assert_case(world, groups[(1, 2)], case, kind, knobs, 1, 2)
    assert out["spoofed"].any() and out["committed"].any()


@pytest.mark.parametrize("case", [0, 1], ids=["onepass", "staged_fused"])
def test_sharded_pipeline_2x2_equals_reference(world, groups, case):
    kind, knobs = _CASES[(2, 2)][case]
    out = _assert_case(world, groups[(2, 2)], case, kind, knobs, 2, 2)
    assert out["n_miss"].shape == (2,) and out["committed"].any()


def test_sharded_full_walk_2x1_equals_reference(world, groups):
    out = _assert_case(world, groups[(2, 1)], 0, "full", _ONEPASS, 2, 1)
    assert out["prune_cand_hist"].shape[0] == 2


def test_state_carries_across(world):
    """shard_state / gather_state: the JAX mesh's (D, slots+1, ...) state
    into each data shard's port state and back, row for row."""
    mesh = _jax_mesh(2, 1)
    st = jmesh.shard_state(jpl.init_state(KW["flow_slots"],
                                          KW["aff_slots"]), mesh)
    rng = np.random.default_rng(4)
    st = jax.tree.map(lambda a: rng.integers(-2**31, 2**31, a.shape,
                                             dtype=np.int64).astype(np.int32),
                      jax.device_get(st))
    shards = [tmesh.shard_state(st, tmesh.Mesh(2, 1, d, 0, None,
                                               torch.device("cpu")))
              for d in range(2)]
    back = tmesh.gather_state(shards)
    for a, b in zip(jax.tree.leaves(st), jax.tree.leaves(tuple(back))):
        np.testing.assert_array_equal(b, a)


def test_local_mesh_full_walk_2x2_equals_spawned_mesh(world, groups):
    """The mesh engine's in-process step (parallel/meshpath._mesh_step_full_fn
    over a LocalMesh: one process, the rule shards in threads meeting at
    each combine) against the spawned gloo ranks of make_sharded_pipeline
    _full, one-pass on (2, 2): every output of both steps and every rule
    shard's copy of each data row's final state bitwise equal."""
    from antrea_tpu_torch.parallel import meshpath as tmeshpath

    port = world["port"]
    i = 2
    kind, knobs = _CASES[(2, 2)][i]
    lm = tmesh.local_mesh(2, 2, "cpu")
    host, mmeta = tmesh.host_rule_set(port["cps"], 2, K)
    grid = tmesh.place_rule_grid(host, lm)
    meta = tpl.PipelineMeta(match=mmeta, ct_timeout_s=3600, fused=True,
                            onepass=True, **KW)
    states = tuple(tuple(tpl.init_state(KW["flow_slots"], KW["aff_slots"],
                                        device="cpu") for _ in range(2))
                   for _ in range(2))
    dsvc = tpl.svc_to_device(port["svc"], "cpu")
    dft = tfw.fwd_to_device(port["ft"], "cpu")
    step = tmeshpath._mesh_step_full_fn(lm, meta, True)
    ones, zb = torch.ones(B, dtype=torch.bool), torch.zeros(B, dtype=torch.bool)
    ranks = groups[(2, 2)]
    for t, (*cols, now) in enumerate(_steps(world, kind)):
        cols = [_t(c) for c in cols]
        states, out = step(states, grid, dsvc, dft, *cols[:6], now, 0,
                           cols[6], cols[7], ones, zb, None, zb)
        want = tmesh.gather_outputs([ranks[d * 2][i][0][t] for d in (0, 1)])
        assert set(out) == set(want), t
        for k, v in want.items():
            np.testing.assert_array_equal(out[k].numpy(), v,
                                          err_msg=f"step {t}: out[{k}]")
    assert int(out["n_miss"].sum()) < B
    for d in (0, 1):
        want = ranks[d * 2][i][1]
        for r in (0, 1):
            for a, b in zip(tmesh.gather_state([states[d][r]]), want):
                for x, y in zip(a, b):
                    np.testing.assert_array_equal(
                        x[:, :-1], y[:, :-1],
                        err_msg=f"row {d}, rule shard {r}'s state")
