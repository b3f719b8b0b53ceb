"""The PyTorch port's CUDA kernels against their plain versions, on the card,
and the pruned pipeline step on the card against the same step on the CPU.

A CUDA kernel has no CPU mode, so these tests skip where there is no card;
chip_smoke.py runs the same comparisons at the full widths.
"""

import numpy as np
import pytest
import torch

from antrea_tpu_torch.ops import consumer

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _words(g, shape, dens, dev):
    """Random int32 words (u32 bits), each bit set with probability dens."""
    bits = torch.rand((*shape, 32), generator=g) < dens
    words = (bits.long() << torch.arange(32)).sum(-1)
    return ((words + 2**31) % 2**32 - 2**31).to(torch.int32).to(dev)


def _tables(g, widths, dens, dev, offset):
    """Six seeded tables (rows, w) int32 with widths (w_in, w_out); with
    offset the table's storage starts one word past an aligned address, so
    every row lies at another alignment than its neighbour's."""
    out = []
    for k, n in enumerate((9, 13, 6, 11, 7, 10)):
        w = widths[k // 3]
        t = _words(g, (n, w), dens, dev)
        t[k % n] = 0  # a row with no rule
        if offset:
            flat = torch.empty(n * w + 1, dtype=torch.int32, device=dev)
            flat[1:] = t.flatten()
            t = flat[1:].view(n, w)
        out.append(t)
    return out


def _interval_rows(g, tabs, b, dev):
    """(b, 8) int32 interval rows, row 0 and the last row of every table
    among them."""
    iv = torch.zeros((b, 8), dtype=torch.int32)
    for k in range(7):
        n = tabs[min(k, 5)].shape[0]
        iv[:, k] = torch.randint(0, n, (b,), generator=g)
        iv[k % 4, k] = 0
        iv[(4 + k) % b, k] = n - 1
    return iv.to(dev)


@pytest.mark.parametrize("b,w_in,w_out,in_ph,out_ph,w0,svcref,offset", [
    # The 100k-rule ingress width (odd rows only 8-byte aligned).
    (256, 1866, 1260, (29432, 29764, 485), (20012, 20004, 303), (0, 0),
     False, False),
    (256, 61, 40, (900, 700, 300), (600, 500, 180), (0, 0), True, False),
    (37, 5, 3, (37, 50, 60), (32, 0, 64), (0, 0), True, True),
    (129, 61, 1866, (300, 40, 10), (21, 300, 40), (3, 7), True, True),
    (33, 7, 9, (60, 100, 10), (100, 40, 100), (0, 5), False, True),
], ids=["w1866", "w61", "w5-offset", "w0-offset", "odd-ragged"])
def test_consumer_kernel_equals_plain(cuda, b, w_in, w_out, in_ph, out_ph, w0,
                                      svcref, offset):
    g = torch.Generator().manual_seed(b + w_in)
    tabs = _tables(g, (w_in, w_out), 0.35, cuda, offset)
    iv = _interval_rows(g, tabs, b, cuda)
    before = consumer.launches
    got = consumer.fused_hits(tabs, iv, svcref, in_ph, out_ph, *w0)
    torch.cuda.synchronize()
    assert consumer.launches == before + 1
    want = consumer.fused_hits_plain(tabs, iv, svcref, in_ph, out_ph, *w0)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    assert (want[:, :6] < consumer.BIG).any()


@pytest.mark.parametrize("b,s_in,s_out,ke_in,ke_out,in_ph,out_ph,svcref", [
    # The 100k-rule widths at K = 4.
    (256, 59, 40, 4, 4, (29432, 29764, 485), (20012, 20004, 303), False),
    (256, 59, 40, 4, 4, (29432, 29764, 485), (20012, 20004, 303), True),
    # Ragged, every candidate count from 0 to S, ke = S and ke = 1.
    (37, 5, 2, 5, 1, (1000, 1500, 600), (1024, 0, 64), True),
    (101, 40, 3, 16, 2, (20000, 500, 300), (40, 20, 40), False),
], ids=["k4", "k4-svcref", "ragged", "k16"])
def test_pruned_consumer_kernel_equals_plain(cuda, b, s_in, s_out, ke_in,
                                             ke_out, in_ph, out_ph, svcref):
    from antrea_tpu_torch.ops import pruned_consumer

    g = torch.Generator().manual_seed(b + s_in + svcref)
    tabs = _tables(g, (32 * s_in, 32 * s_out), 0.4, cuda, False)
    iv = _interval_rows(g, tabs, b, cuda)

    def agg(s):
        # Lane i keeps about (i % (s + 1)) / s of its words: lanes with no
        # candidate, with fewer than ke (the rest fill) and with more.
        keep = torch.rand((b, s), generator=g) < (
            torch.arange(b) % (s + 1) / s)[:, None]
        return torch.where(keep, _words(g, (b, s), 0.5, "cpu"), 0).to(cuda)

    g_in, g_out = agg(s_in), agg(s_out)
    w0 = (0, 64) if svcref else (0, 0)
    before = pruned_consumer.launches
    got = pruned_consumer.pruned_hits(g_in, g_out, iv, tabs, ke_in, ke_out,
                                      svcref, in_ph, out_ph, *w0)
    torch.cuda.synchronize()
    assert pruned_consumer.launches == before + 1
    want = pruned_consumer.pruned_hits_plain(g_in, g_out, iv, tabs, ke_in,
                                             ke_out, svcref, in_ph, out_ph,
                                             *w0)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    assert (want[:, :6] < consumer.BIG).any()


@pytest.fixture(scope="module")
def pruned_world():
    from antrea_tpu_torch.compiler.compile import compile_policy_set
    from antrea_tpu_torch.compiler.services import compile_services
    from antrea_tpu_torch.simulator import (gen_cluster, gen_services,
                                            gen_traffic)

    cluster = gen_cluster(2500, n_nodes=8, pods_per_node=8, seed=12)
    services = gen_services(40, cluster.pod_ips, affinity_fraction=0.3,
                            no_ep_fraction=0.1, seed=4)
    tr = gen_traffic(cluster.pod_ips, 300, n_flows=240, seed=3,
                     services=services, svc_fraction=0.3)
    return (compile_policy_set(cluster.ps), compile_services(services), tr)


def _lanes(tr, dev):
    from antrea_tpu_torch.utils import ip as iputil

    cols = (iputil.flip_u32(tr.src_ip), iputil.flip_u32(tr.dst_ip), tr.proto,
            tr.src_port, tr.dst_port)
    return [torch.from_numpy(np.ascontiguousarray(c, dtype=np.int32)).to(dev)
            for c in cols]


@pytest.mark.parametrize("onepass", [True, False], ids=["onepass", "staged"])
def test_pruned_pipeline_card_equals_cpu(cuda, pruned_world, onepass):
    """The pruned step on the card (B3 or B2, and B1 for the fallback)
    against the same step on the CPU (plain versions): outputs and state
    bitwise equal over cold, warm, teardown and expire-all steps."""
    from antrea_tpu_torch.models import pipeline as pl
    from antrea_tpu_torch.ops import onepass as op
    from antrea_tpu_torch.ops import pruned_consumer

    cps, svc, tr = pruned_world
    kw = dict(flow_slots=1 << 10, aff_slots=1 << 6, miss_chunk=64,
              fused=True, prune_budget=1, onepass=onepass)
    step, sg, (drs, dsvc) = pl.make_pipeline(cps, svc, device=cuda, **kw)
    _, sc, (drs_c, dsvc_c) = pl.make_pipeline(cps, svc, device="cpu", **kw)
    lg = _lanes(tr, cuda)
    lc = [t.cpu() for t in lg]
    fin = torch.where(torch.arange(300) % 2 == 0, pl.TCP_FIN, 0).to(
        torch.int32)
    k0 = (op.launches, pruned_consumer.launches, consumer.launches)
    for now, flags in ((100, None), (101, None), (102, fin), (7400, None)):
        sg, og = step(sg, drs, dsvc, *lg, now, 0,
                      flags=None if flags is None else flags.to(cuda))
        sc, oc = step(sc, drs_c, dsvc_c, *lc, now, 0, flags=flags)
        for k in oc:
            assert torch.equal(og[k].cpu(), oc[k]), (now, k)
        for part in ("flow", "aff"):
            for f, tg, tcpu in zip(getattr(sc, part)._fields,
                                   getattr(sg, part), getattr(sc, part)):
                assert torch.equal(tg[:-1].cpu(), tcpu[:-1]), (now, part, f)
    k1 = (op.launches, pruned_consumer.launches, consumer.launches)
    assert k1[2] > k0[2]  # the fallback went through B1
    if onepass:
        assert k1[0] - k0[0] == 4 and k1[1] == k0[1]
    else:
        assert k1[1] > k0[1] and k1[0] == k0[0]


def _svcref_svc(svc, refs, g):
    """Egress svc DimTable `svc` with interval bounds at SVCREF_BASE + r and
    SVCREF_BASE + r + 1 for each r in refs inserted after its v4 space (a
    toServices-bearing table); each new row copies a v4 row with a nonzero
    aggregate row, chosen by g."""
    from antrea_tpu_torch.compiler.compile import SVCREF_BASE

    n4 = svc.bounds.shape[0]
    new = torch.unique(torch.cat([refs, refs + 1]).cpu().long() + SVCREF_BASE)
    full = torch.nonzero(svc.agg[:n4 + 1].cpu().any(dim=1)).flatten()
    pick = full[torch.randint(0, full.numel(), (new.numel(),), generator=g)]
    rows = torch.cat([torch.arange(n4 + 1), pick,
                      torch.arange(n4 + 1, svc.agg.shape[0])]).to(
                          svc.agg.device)
    return svc._replace(
        bounds=torch.cat([svc.bounds, new.to(svc.bounds)]),
        agg=svc.agg[rows].contiguous(), inc=svc.inc[rows].contiguous())


@pytest.mark.parametrize("svcref,timeouts", [
    (False, (3600, 3600, 3600, 3600)), (True, (30, 3600, 60, 120))])
def test_onepass_kernel_equals_plain(cuda, pruned_world, svcref, timeouts):
    """B3 against its plain version on the pruned world's own tables and
    lanes after a cold step, with per-state timeouts, and with the
    toServices probe forced on (egress svc extended with reference
    intervals, the world's prog_svc)."""
    from antrea_tpu_torch.ops import onepass as op

    x, tabs, st, drs, dsvc = _onepass_case(cuda, pruned_world, timeouts)
    if svcref:
        g = torch.Generator().manual_seed(1)
        svc_lanes = x.lb[:, 0][x.lb[:, 0] >= 0].long()
        refs = torch.unique(dsvc.prog_svc[svc_lanes])[:6]
        svc = _svcref_svc(drs.egress.svc, refs, g)
        tabs = tabs._replace(
            bounds=tabs.bounds[:5] + (svc.bounds,),
            agg=tabs.agg[:5] + (svc.agg,), inc=tabs.inc[:5] + (svc.inc,),
            prog_svc=dsvc.prog_svc)
    # K = 1 < S_in = 2: fallback lanes too.
    st = st._replace(k=1, svcref=svcref)
    before = op.launches
    got = op.onepass(x, tabs, 150, 3, st)
    torch.cuda.synchronize()
    assert op.launches == before + 1
    want = op.onepass_plain(x, tabs, 150, 3, st)
    for g_, w_ in zip(got, want):
        np.testing.assert_array_equal(g_.cpu().numpy(), w_.cpu().numpy())
    assert got[0][:, 11].any() and got[3][:, 1].any()
    if svcref:
        assert (want[4][:, 6] > drs.egress.svc.bounds.shape[0]).any()


def _onepass_case(cuda, pruned_world, timeouts):
    """B3's inputs for the pruned world's lanes after a cold step at
    now = 100, probed at now = 150 -> (x, tabs, st (K = 2), drs, dsvc)."""
    from antrea_tpu_torch.models import pipeline as pl
    from antrea_tpu_torch.ops import hashing

    cps, svc, tr = pruned_world
    step, state, (drs, dsvc) = pl.make_pipeline(
        cps, svc, device=cuda, flow_slots=1 << 10, fused=True,
        prune_budget=2)
    lanes = _lanes(tr, cuda)
    state, _ = step(state, drs, dsvc, *lanes, 100, 0)
    src_f, dst_f, proto, sport, dport = lanes
    t_syn, t_est, t_onew, t_oest = timeouts
    meta = step.meta._replace(ct_syn_timeout_s=t_syn, ct_timeout_s=t_est,
                              ct_other_new_s=t_onew, ct_other_est_s=t_oest)
    n = meta.flow_slots
    pp = pl._pair16(sport, dport)
    h = hashing.flow_hash(pl._raw_bits(src_f), pl._raw_bits(dst_f), proto,
                          sport, dport)
    hit, _, _, mr, kr0, ts0 = pl._cache_lookup(
        state.flow, h & (n - 1), torch.stack([src_f, dst_f], 1), pp,
        proto | 0x100, proto | 0x100 | (pl.GEN_ETERNAL << 9), 150, proto,
        meta)
    x, tabs, st, _ = pl._onepass_inputs(state.aff, drs, dsvc, src_f, dst_f,
                                        proto, sport, dport, pp, h, kr0, mr,
                                        ts0, 150, meta)
    return x, tabs, st._replace(k=2), drs, dsvc


def _rank_tables(g, keys, s, dev):
    """A seeded dimension table over the lanes' keys: its bounds are the
    distinct keys but the least, so the lanes with the least key land on
    row 0 and every other lane on the row of its key's rank; row r keeps
    each aggregate word (as all ones) with probability 1 when r % 3 == 0
    and (r % 11) / 10 otherwise, so the lanes' candidate counts run from 0
    to S; incidence words are seeded.  -> (bounds, agg, inc) int32 on
    dev."""
    bounds = torch.unique(keys.cpu())[1:].to(torch.int32)
    rows = bounds.shape[0] + 2  # the v4 rows and one v6 row
    r = torch.arange(rows)
    keep = torch.rand((rows, s), generator=g) < torch.where(
        r % 3 == 0, 1.0, r % 11 / 10)[:, None]
    agg = torch.where(keep, -1, 0).to(torch.int32)
    return (bounds.to(dev), agg.to(dev),
            _words(g, (rows, 32 * s), 0.45, dev))


@pytest.mark.parametrize("k,svcref", [(3, True), (16, False)])
def test_onepass_candidate_scan_equals_plain(cuda, pruned_world, k, svcref):
    """B3 on the candidate scan it shares with B2 (csrc/candidate_scan.cuh):
    the pruned world's lanes over seeded tables of 40 and 7 superblocks
    whose bounds put the lanes on chosen rows (_rank_tables), so a lane
    has up to 40 candidates in two ballot words, batches of four and a
    short last batch; bitwise to its plain version."""
    from antrea_tpu_torch.compiler.compile import SVCREF_BASE
    from antrea_tpu_torch.ops import onepass as op

    x, tabs, st, _, dsvc = _onepass_case(cuda, pruned_world,
                                         (3600, 3600, 3600, 3600))
    g = torch.Generator().manual_seed(k)
    src, proto = x.pkt[:, 0], x.pkt[:, 2]
    dnat, port = x.lb[:, 2], x.lb[:, 3]
    svc_key = (proto << 16) | port
    keys = (dnat, src, svc_key, src, dnat, svc_key)
    if svcref:
        # The toServices keys of the service lanes get rows of their own.
        ref = dsvc.prog_svc[x.lb[:, 0].clamp(min=0).long()]
        svc_key = torch.where(x.lb[:, 0] >= 0, SVCREF_BASE + ref, svc_key)
        keys = keys[:5] + (torch.cat([keys[5], svc_key]),)
    t = [_rank_tables(g, kk, 40 if i < 3 else 7, cuda)
         for i, kk in enumerate(keys)]
    # No key row matches, so every lane misses and scans.
    x = x._replace(kr=torch.zeros_like(x.kr))
    tabs = tabs._replace(bounds=tuple(a for a, _, _ in t),
                         agg=tuple(b for _, b, _ in t),
                         inc=tuple(c for _, _, c in t),
                         prog_svc=dsvc.prog_svc)
    st = st._replace(k=k, svcref=svcref)
    before = op.launches
    got = op.onepass(x, tabs, 150, 3, st)
    torch.cuda.synchronize()
    assert op.launches == before + 1
    want = op.onepass_plain(x, tabs, 150, 3, st)
    for g_, w_ in zip(got, want):
        np.testing.assert_array_equal(g_.cpu().numpy(), w_.cpu().numpy())
    assert (want[3][:, 2] > 32).any()  # candidates past the first ballot
    assert (want[4][:, :6] == 0).any() and (want[4][:, 0] > 1).any()


def _sorted_keys(g, n, lo, hi):
    """n distinct ascending int32 values in [lo, hi)."""
    pool = torch.unique(torch.randint(lo, hi, (n + n // 4 + 16,),
                                      generator=g, dtype=torch.int64))
    pick = pool[torch.randperm(pool.numel(), generator=g)[:n]]
    return pick.sort().values.to(torch.int32)


def _seeded_b3(g, b, ns, s, hit_share, valid_share, svcref, dev):
    """Seeded B3 inputs and tables with the given bounds lengths ns (six
    dimensions, then iso_in, iso_out) and superblocks s = (S_in, S_out):
    hit_share of the lanes hit (a fresh key row, in one of the current,
    established and reply generations), the rest carry a key row that
    differs or has expired (under per-state timeouts); valid_share of the
    lanes are valid.  Lane keys are the tables' own bounds, their
    neighbours, the address space's ends and random values, so the searches
    reach row 0, row n and everything between.  -> (x, tabs, now, gen_w)."""
    from antrea_tpu_torch.compiler.compile import SVCREF_BASE
    from antrea_tpu_torch.models import pipeline as pl
    from antrea_tpu_torch.ops import onepass as op

    i32 = torch.int32
    imin, imax = -2**31, 2**31 - 1
    n_prog = 7
    bounds = []
    for k, n in enumerate(ns):
        svc_dim = k in (2, 5)
        bd = _sorted_keys(g, n, 0, 1 << 24) if svc_dim else _sorted_keys(
            g, n, imin, imax)
        if k == 5 and svcref:
            ref = torch.arange(0, n_prog + 1, 2, dtype=i32) + SVCREF_BASE
            bd = torch.cat([bd, ref])
        bounds.append(bd)

    def keys(tabs_k, lo, hi):
        # 60% a bound or its neighbour, 15% an end (below every table's
        # first bound, at its last, the range's ends), 25% random.
        def draw(pool):
            pool = pool.to(torch.int64).clamp(lo, hi - 1)
            return pool[torch.randint(0, pool.numel(), (b,), generator=g)]

        near = draw(torch.cat([torch.cat([t, t - 1, t + 1])
                               for t in tabs_k] + [torch.tensor([lo])]))
        ends = draw(torch.cat([torch.tensor([lo, hi - 1])] + [
            t[[0, -1]] - torch.tensor([1, 0]) for t in tabs_k if t.numel()]))
        rand = torch.randint(lo, hi, (b,), generator=g, dtype=torch.int64)
        u = torch.rand(b, generator=g)
        return torch.where(u < 0.6, near, torch.where(u < 0.75, ends,
                                                      rand)).to(i32)

    ip_tabs = [bounds[i] for i in (0, 1, 3, 4, 6, 7)]
    src = keys(ip_tabs, imin, imax + 1)
    dnat = keys(ip_tabs, imin, imax + 1)
    dst = torch.where(torch.rand(b, generator=g) < 0.5, dnat,
                      keys(ip_tabs, imin, imax + 1))
    svc_key = keys([bounds[2], bounds[5]], 0, 1 << 24)
    proto = (svc_key >> 16) & 0xFF
    port = svc_key & 0xFFFF
    sport = torch.randint(0, 1 << 16, (b,), generator=g, dtype=i32)
    dport = torch.randint(0, 1 << 16, (b,), generator=g, dtype=i32)
    pp = pl._pair16(sport, dport)
    z = torch.zeros(b, dtype=i32)

    def bit(p):
        return (torch.rand(b, generator=g) < p).to(i32)

    svc_idx = torch.randint(-1, n_prog, (b,), generator=g, dtype=i32)
    lb = torch.stack([svc_idx, bit(0.1), dnat, port, bit(0.3), bit(0.2),
                      z, z], dim=1)
    now, gen_w = 5000, 3
    gen = torch.randint(0, 3, (b,), generator=g)
    pg_cur = proto | 0x100 | (gen_w << 9)
    pg_est = proto | 0x100 | (pl.GEN_ETERNAL << 9)
    pg = torch.where(gen == 0, pg_cur, torch.where(
        gen == 1, pg_est, pg_est | pl.REPLY_BIT)).to(i32)
    fresh = torch.rand(b, generator=g) < hit_share
    kr = torch.stack([src, dst, pp, pg], dim=1)
    # A missing lane's key row differs in one field, or has expired under
    # every timeout; a fresh one is at most 200 s old (past some per-state
    # timeouts).
    wrong = torch.randint(0, 5, (b,), generator=g)
    for f in range(4):
        kr[:, f] = torch.where(~fresh & (wrong == f), kr[:, f] ^ 0x10,
                               kr[:, f])
    age = torch.where(fresh, torch.randint(0, 200, (b,), generator=g),
                      torch.randint(3601, 10000, (b,), generator=g))
    ts = (now - age).to(i32)
    mrow = torch.randint(imin, imax, (b, 4), generator=g,
                         dtype=torch.int64).to(i32)
    msk = torch.stack([(torch.rand(b, generator=g) < valid_share).to(i32),
                       bit(0.1), bit(0.05), z], dim=1)
    x = op.OnepassInputs(
        pkt=torch.stack([src, dst, proto, sport, dport, pp, z, z], dim=1),
        kr=kr, ts=ts, mrow=mrow, msk=msk, lb=lb)
    rows = [bd.shape[0] + 2 for bd in bounds]
    tabs = op.OnepassTables(
        bounds=tuple(bounds[:6]),
        agg=tuple(torch.where(
            torch.rand((r, s[k // 3]), generator=g)
            < (torch.arange(r) % 7 / 6)[:, None],
            _words(g, (r, s[k // 3]), 0.6, "cpu"), 0)
            for k, r in enumerate(rows[:6])),
        inc=tuple(_words(g, (r, 32 * s[k // 3]), 0.3, "cpu")
                  for k, r in enumerate(rows[:6])),
        iso_bounds=(bounds[6], bounds[7]),
        iso_val=tuple(torch.randint(0, 2, (r,), generator=g, dtype=i32)
                      for r in rows[6:]),
        act_in=torch.randint(0, 4, (32 * 32 * s[0],), generator=g, dtype=i32),
        act_out=torch.randint(0, 4, (32 * 32 * s[1],), generator=g,
                              dtype=i32),
        prog_svc=torch.randint(-1, n_prog, (n_prog,), generator=g, dtype=i32))
    def to(t):
        if isinstance(t, torch.Tensor):
            return t.contiguous().to(dev)
        return tuple(to(u) for u in t)

    return (op.OnepassInputs(*map(to, x)), op.OnepassTables(*map(to, tabs)),
            now, gen_w)


@pytest.mark.parametrize("case,b,hit_share,ns,svcref,timeouts", [
    ("ragged-1", 1, 0.0, (5, 3, 2, 4, 1, 6, 2, 3), False, None),
    ("ragged-37", 37, 0.4, (40, 33, 31, 32, 1, 64, 0, 7), True, None),
    ("ragged-129", 129, 0.5, (300, 17, 9, 1000, 33, 8, 5, 1), False, None),
    ("all-hit", 300, 1.0, (100, 50, 20, 70, 30, 10, 12, 9), True, None),
    ("all-miss", 300, 0.0, (100, 50, 20, 70, 30, 10, 12, 9), False, None),
    ("per-state", 257, 0.6, (64, 64, 16, 64, 64, 16, 8, 8), False,
     (30, 3600, 60, 120)),
    ("svcref", 200, 0.3, (64, 100, 40, 80, 90, 60, 20, 20), True, None),
    ("largest", 256, 0.2, (33431, 2000, 900, 24000, 33431, 700, 3000, 5000),
     True, None),
])
def test_onepass_seeded_equals_plain(cuda, case, b, hit_share, ns, svcref,
                                     timeouts):
    """B3 against its plain version on seeded lanes and tables: ragged B
    (1, 37, 129), all-hit and all-miss batches, per-state timeouts, the
    toServices probe, and searches over the largest table of the headline
    world (33,431 bounds, three 32-ary levels); tables of 0 and 1 bounds
    too.  Invalid, no-commit, forced-fallback and no-endpoint lanes
    throughout."""
    from antrea_tpu_torch.ops import onepass as op

    g = torch.Generator().manual_seed(b * 31 + len(case))
    valid = 1.0 if case in ("all-hit", "all-miss") else 0.9
    x, tabs, now, gen_w = _seeded_b3(g, b, ns, (5, 3), hit_share, valid,
                                     svcref, cuda)
    tmo = timeouts or (3600, 3600, 3600, 3600)
    st = op.OnepassStatic(k=2, in_phases=(1500, 2000, 1620),
                          out_phases=(1000, 1000, 1072), svcref=svcref,
                          timeouts=tmo, n_slots=1 << 12,
                          pref_mask=(1 << 29) - 1)
    before = op.launches
    got = op.onepass(x, tabs, now, gen_w, st)
    torch.cuda.synchronize()
    assert op.launches == before + 1
    want = op.onepass_plain(x, tabs, now, gen_w, st)
    for name, g_, w_ in zip(("main", "keys8", "meta8", "aux", "iv"), got,
                            want):
        np.testing.assert_array_equal(g_.cpu().numpy(), w_.cpu().numpy(),
                                      err_msg=f"{case}: {name}")
    hit = want[0][:, 11] != 0
    if case == "all-hit":
        assert hit.all()
    elif case == "all-miss":
        assert not hit.any()
    elif b > 1:
        assert hit.any() and not hit.all()
    iv = want[4][~hit & (x.msk[:, 0] != 0)]
    if case == "largest":
        assert (iv[:, 0] > 32 * 32).any() and (iv[:, 0] == 0).any()
    if svcref and iv.shape[0]:
        assert (iv[:, 6] > ns[5]).any()


def test_onepass_at_the_second_chance_mask_equals_plain(cuda):
    """B3 at second chance's stamp mask (PREF_MASK_CHANCE) against its plain
    version: seeded lanes whose meta rows carry random collision-counter
    bits, with now past 2**28 (ts shifted with it), so the narrowed stamp
    differs from the full one."""
    from antrea_tpu_torch.models import pipeline as pl
    from antrea_tpu_torch.ops import onepass as op

    g = torch.Generator().manual_seed(27)
    x, tabs, now, gen_w = _seeded_b3(g, 300, (100, 50, 20, 70, 30, 10, 12, 9),
                                     (5, 3), 0.4, 0.9, True, cuda)
    now += 1 << 28
    x = x._replace(ts=x.ts + (1 << 28))
    st = op.OnepassStatic(k=2, in_phases=(1500, 2000, 1620),
                          out_phases=(1000, 1000, 1072), svcref=True,
                          timeouts=(3600,) * 4, n_slots=1 << 12,
                          pref_mask=pl.PREF_MASK_CHANCE)
    got = op.onepass(x, tabs, now, gen_w, st)
    want = op.onepass_plain(x, tabs, now, gen_w, st)
    for name, g_, w_ in zip(("main", "keys8", "meta8", "aux", "iv"), got,
                            want):
        np.testing.assert_array_equal(g_.cpu().numpy(), w_.cpu().numpy(),
                                      err_msg=name)
    ins = want[0][:, 14] != 0
    assert ins.any()
    stamps = want[2][ins][:, 7]
    assert (stamps == now & pl.PREF_MASK_CHANCE).all()
    assert (stamps != now & pl.PREF_MASK).all()


@pytest.mark.parametrize("case,b,hit_share,w0,svcref", [
    ("ragged-1", 1, 0.0, (0, 0), False),
    ("ragged-37", 37, 0.4, (160, 96), True),
    ("ragged-129", 129, 0.5, (3, 1), False),
    ("all-miss", 300, 0.0, (32 * 59, 32 * 40), True),
])
def test_onepass_hits_only_equals_plain(cuda, case, b, hit_share, w0,
                                        svcref):
    """B3h (onepass(resolve=False)) against its plain version on seeded
    lanes and tables: ragged B, a rule shard's global word offsets
    (w0 > 0), the toServices probe, and invalid, no-commit and
    forced-fallback lanes."""
    from antrea_tpu_torch.ops import onepass as op

    g = torch.Generator().manual_seed(b * 17 + len(case))
    x, tabs, now, gen_w = _seeded_b3(
        g, b, (40, 33, 31, 32, 5, 64, 9, 7), (5, 3), hit_share,
        1.0 if case == "all-miss" else 0.9, svcref, cuda)
    st = op.OnepassStatic(k=2, in_phases=(1500, 2000, 1620),
                          out_phases=(1000, 1000, 1072), svcref=svcref,
                          timeouts=(3600,) * 4, n_slots=1 << 12,
                          pref_mask=(1 << 29) - 1)
    before = (op.launches, op.launches_hits)
    got = op.onepass(x, tabs, now, gen_w, st, *w0, resolve=False)
    torch.cuda.synchronize()
    assert (op.launches, op.launches_hits) == (before[0], before[1] + 1)
    want = op.onepass_plain(x, tabs, now, gen_w, st, *w0, resolve=False)
    for name, g_, w_ in zip(("hits8", "aux", "iv"), got, want):
        np.testing.assert_array_equal(g_.cpu().numpy(), w_.cpu().numpy(),
                                      err_msg=f"{case}: {name}")
    hits = want[0][:, :6]
    if b > 1:
        assert (hits < consumer.BIG).any()
        assert (hits[hits < consumer.BIG] >= 32 * min(w0)).all()


@pytest.mark.parametrize("n_rule", [1, 2])
def test_sharded_full_walk_on_the_card_equals_cpu(cuda, pruned_world, n_rule):
    """make_sharded_pipeline_full on the card, on a (1, 1) mesh (NCCL) and
    on a (1, 2) mesh of two gloo processes sharing the card (B3h, and B1
    at the shard's offset for the fallback), against the single-card walk
    on the CPU, over two steps."""
    from antrea_tpu_torch.compiler.topology import Topology, compile_topology
    from antrea_tpu_torch.models import forwarding as fw
    from antrea_tpu_torch.models import pipeline as pl
    from antrea_tpu_torch.parallel import mesh as pm

    import torch_mesh_ranks

    cps, svc, tr = pruned_world
    ft = compile_topology(Topology(pod_cidr="10.0.0.0/24"))
    kw = dict(flow_slots=1 << 10, aff_slots=1 << 6, miss_chunk=64,
              fused=True, prune_budget=1, onepass=True)
    lanes = [t.numpy() for t in _lanes(tr, "cpu")]
    z = np.zeros(300, np.int32)
    steps = [(*lanes, z + 2, z, z, now) for now in (100, 101)]
    ranks = pm.spawn(torch_mesh_ranks.run, 1, n_rule, device="cuda", args=(
        dict(cps=cps, svc=svc, ft=ft), [("full", kw, steps)]))
    step, sc, (drs, dsvc) = pl.make_pipeline(cps, svc, device="cpu", **kw)
    dft = fw.fwd_to_device(ft, "cpu")
    for t, (*cols, now) in enumerate(steps):
        sc, oc = fw.pipeline_step_full(
            sc, drs, dsvc, dft, *(torch.from_numpy(c) for c in cols[:6]),
            now, 0, torch.from_numpy(cols[6]), torch.from_numpy(cols[7]),
            meta=step.meta)
        for r in range(n_rule):
            got = ranks[r][0][0][t]
            for k, v in oc.items():
                if n_rule > 1 and k in ("n_prune_fb", "prune_cand_hist"):
                    continue  # counted per rule shard (match.py:1800)
                want = v.numpy() if k not in pm._COUNTERS else v.numpy()[None]
                np.testing.assert_array_equal(got[k], want,
                                              err_msg=f"{t} {r} {k}")
    for part in ("flow", "aff"):
        for f, tc in zip(getattr(sc, part)._fields, getattr(sc, part)):
            got = getattr(getattr(ranks[0][0][1], part), f)[0]
            np.testing.assert_array_equal(got[:-1], tc.numpy()[:-1],
                                          err_msg=f"{part}.{f}")


@pytest.mark.parametrize("b,w_in,w_out,in_ph,out_ph", [
    # Every phase boundary inside a word.
    (256, 5, 3, (37, 50, 73), (20, 33, 43)),
    # n0 = 0 and nk = 0.
    (37, 4, 4, (0, 70, 58), (40, 0, 88)),
    # The baseline phase starts in the last word.
    (129, 4, 2, (60, 40, 28), (33, 30, 1)),
    # Rows longer than the block's 256 threads.
    (300, 300, 270, (5000, 3000, 1600), (4000, 4000, 640)),
], ids=["in-word", "empty-phases", "baseline-last-word", "wide"])
def test_consumer2_kernel_equals_plain(cuda, b, w_in, w_out, in_ph, out_ph):
    from antrea_tpu_torch.ops import consumer2

    g = torch.Generator().manual_seed(b + w_in)
    m_in, m_out = _words(g, (b, w_in), 0.04, cuda), _words(g, (b, w_out),
                                                           0.04, cuda)
    m_in[::7] = 0
    before = consumer2.launches
    got = consumer2.and_hits(m_in, m_out, in_ph, out_ph)
    torch.cuda.synchronize()
    assert consumer2.launches == before + 1
    want = consumer2.and_hits_plain(m_in, m_out, in_ph, out_ph)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    assert (want[:, :6] < consumer.BIG).any()


@pytest.mark.parametrize("onepass", [True, False], ids=["onepass", "staged"])
def test_async_cadence_card_equals_cpu(cuda, pruned_world, onepass):
    """A cold step, then the async cadence after every entry expired and
    the generation moved: the fast step (phases=0, DROP admission), the
    coalesced drain of the admitted lanes (drain_reclaim=True) and
    _maintain_scan, on the card (B3 or B2, B1) and on the CPU: outputs,
    counts and state bitwise equal, with reclaims."""
    from antrea_tpu_torch.compiler.compile import ACT_DROP
    from antrea_tpu_torch.models import pipeline as pl

    cps, svc, tr = pruned_world
    kw = dict(flow_slots=1 << 8, aff_slots=1 << 6, miss_chunk=64,
              fused=True, prune_budget=1, onepass=onepass)
    res = {}
    for dev in (cuda, torch.device("cpu")):
        step, st, (drs, dsvc) = pl.make_pipeline(cps, svc, device=dev, **kw)
        lanes = _lanes(tr, dev)
        _, cold = step(st, drs, dsvc, *lanes, 100, 0)
        _, fast = pl.pipeline_step(
            st, drs, dsvc, *lanes, 7400, 1,
            meta=step.meta._replace(phases=0, miss_code=ACT_DROP))
        adm = fast["miss"] != 0
        window = [c[adm] for c in lanes]
        _, drain = pl.pipeline_step(
            st, drs, dsvc, *window, 7400, 1,
            meta=step.meta._replace(drain_reclaim=True,
                                    miss_chunk=int(adm.sum())))
        _, aged, stale = pl._maintain_scan(st, 7400, 1,
                                           timeouts=step.meta.timeouts)
        res[dev.type] = (cold, fast, drain, (int(aged), int(stale)), st)
    g, c = res["cuda"], res["cpu"]
    for og, oc in zip(g[:3], c[:3]):
        for k in oc:
            assert torch.equal(og[k].cpu(), oc[k]), k
    assert g[3] == c[3]
    for part in ("flow", "aff"):
        for f, tg, tcpu in zip(getattr(c[4], part)._fields,
                               getattr(g[4], part), getattr(c[4], part)):
            assert torch.equal(tg[:-1].cpu(), tcpu[:-1]), (part, f)
    assert int(c[2]["n_reclaim"]) > 0
    assert (c[1]["code"][c[1]["miss"] != 0] == ACT_DROP).all()


def _engine_world():
    from antrea_tpu_torch.simulator import gen_cluster, gen_services

    cluster = gen_cluster(2500, n_nodes=8, pods_per_node=8, seed=12)
    return cluster, gen_services(40, cluster.pod_ips, seed=4)


def _engine_batch(cluster, services, seed, n=300):
    from antrea_tpu_torch.packet import PacketBatch
    from antrea_tpu_torch.simulator import gen_traffic

    tr = gen_traffic(cluster.pod_ips, n, n_flows=n // 2, seed=seed,
                     services=services, svc_fraction=0.3)
    return PacketBatch(src_ip=tr.src_ip, dst_ip=tr.dst_ip, proto=tr.proto,
                       src_port=tr.src_port, dst_port=tr.dst_port)


@pytest.mark.parametrize("knobs", [dict(fused=True),
                                   dict(fused=True, prune_budget=2)],
                         ids=["staged", "onepass"])
def test_engine_on_the_card_equals_cpu_with_deltas(cuda, knobs):
    """The port's engine on the card against the same engine on the CPU
    through steps, canary-certified group deltas and a step whose lanes the
    pending deltas cover: B1's overlay launch (staged), B3 with fb_force
    lanes and B1 on their overlay (one-pass)."""
    import copy

    from antrea_tpu_torch.datapath import TpuflowDatapath
    from antrea_tpu_torch.ops import onepass as op
    from antrea_tpu_torch.utils import ip as iputil

    cluster, services = _engine_world()
    kw = dict(flow_slots=1 << 12, aff_slots=1 << 8, miss_chunk=64,
              canary_probes=8, **knobs)
    eg = TpuflowDatapath(copy.deepcopy(cluster.ps), services, device=cuda,
                         **kw)
    ec = TpuflowDatapath(copy.deepcopy(cluster.ps), services, device="cpu",
                         **kw)

    def both(b, now, what):
        rg, rc = eg.step(b, now), ec.step(b, now)
        for f in ("code", "est", "svc_idx", "dnat_ip", "dnat_port",
                  "committed", "fwd_kind", "out_port"):
            np.testing.assert_array_equal(getattr(rg, f), getattr(rc, f),
                                          err_msg=f"{what}: {f}")
        assert rg.ingress_rule == rc.ingress_rule, what
        assert rg.egress_rule == rc.egress_rule, what
        for part in ("flow", "aff"):
            for tg, tcpu in zip(getattr(eg._state, part),
                                getattr(ec._state, part)):
                assert torch.equal(tg[:-1].cpu(), tcpu[:-1]), (what, part)

    for i in range(2):
        both(_engine_batch(cluster, services, 3 + i), 100 + i, f"step {i}")
    ag = sorted(cluster.ps.address_groups)[0]
    victim = cluster.ps.address_groups[ag].members[0].ip
    for dp in (eg, ec):
        dp.apply_group_delta(ag, ["10.9.9.9"], [victim])
        dp.apply_group_delta(ag, ["10.9.9.10"], [])
    assert eg._n_deltas == ec._n_deltas >= 2
    assert eg.commit_stats()["canary_probes_total"] > 0
    b = _engine_batch(cluster, services, 9)
    b.src_ip[:100] = iputil.ip_to_u32("10.9.9.9")
    b.dst_ip[100:200] = iputil.ip_to_u32(victim)
    k0 = (consumer.launches, op.launches)
    both(b, 110, "delta step")
    k1 = (consumer.launches, op.launches)
    if knobs.get("prune_budget"):
        assert k1[1] == k0[1] + 1 and k1[0] > k0[0]
        for k in ("skips_total", "fallbacks_total", "classified_total"):
            assert eg.prune_stats()[k] == ec.prune_stats()[k], k
    else:
        assert k1[0] >= k0[0] + 2  # a round's B1 and its overlay launch
    assert eg.dump_flows(111) == ec.dump_flows(111)
    assert eg.trace(b, 111) == ec.trace(b, 111)
    assert eg._audit_rule_digests() == ec._audit_rule_digests()


def test_pruned_classify_with_deltas_card_equals_cpu(cuda, pruned_world):
    """classify_batch pruned with delta slots pending, on the card (B2 and
    its overlay launch, B1 for the fallback) against the CPU."""
    from antrea_tpu_torch.ops import match as tm
    from antrea_tpu_torch.ops import pruned_consumer

    cps, _svc, tr = pruned_world
    drs_np, meta = tm.to_host(cps, delta_slots=8, prune_budget=1)
    src, dst, proto, _sport, dport = _lanes(tr, "cpu")
    dl = drs_np.ip_delta
    rng = np.random.default_rng(5)
    n = 6
    lanes = rng.choice(src.shape[0], n, replace=False)
    dl = dl._replace(n=np.int32(n))
    for i, lane in enumerate(lanes):
        ip = int((src if i % 2 else dst)[lane])
        dl.lo_f[i] = dl.hi_f[i] = ip
        dl.sign[i] = -1 if i % 3 == 1 else 1
        dl.iso[i] = i % 4
        for k in ("at_in", "peer_in", "at_out", "peer_out"):
            m = getattr(dl, k)
            m[i] = (rng.random(m.shape[1]) < 0.05) * np.uint32(0x80000001)
    drs_np = drs_np._replace(ip_delta=dl)
    drs_g = tm.ruleset_from_numpy(drs_np, cuda)
    drs_c = tm.ruleset_from_numpy(drs_np, "cpu")
    before = pruned_consumer.launches
    got = tm.classify_batch(drs_g, src.to(cuda), dst.to(cuda),
                            proto.to(cuda), dport.to(cuda), meta=meta,
                            fused=True, delta_n=n)
    torch.cuda.synchronize()
    assert pruned_consumer.launches == before + 2
    want = tm.classify_batch(drs_c, src, dst, proto, dport, meta=meta,
                             fused=True, delta_n=n)
    for k in want:
        assert torch.equal(got[k].cpu(), want[k]), k


@pytest.mark.parametrize("knobs", [dict(fused=True, admission="hold"),
                                   dict(fused=True, prune_budget=2,
                                        admission="drop")],
                         ids=["staged", "onepass"])
def test_async_engine_with_knobs_on_the_card_equals_cpu(cuda, knobs):
    """The async engine with second chance, telemetry, the FlowExporter
    gate and deny export on the card against the same engine on the CPU:
    hold (staged) or drop (one-pass) admission with source buckets and
    overlapped commits, steps, drains and a maintenance tick; results, the
    queue, telemetry, the deny records and the tables (their counters
    included) equal, B1 or B3 launched in the drains and nothing in the
    fast steps."""
    import copy

    from antrea_tpu_torch.datapath import TpuflowDatapath
    from antrea_tpu_torch.features import FeatureGates
    from antrea_tpu_torch.ops import onepass as op

    cluster, services = _engine_world()
    kw = dict(flow_slots=1 << 8, aff_slots=1 << 6, miss_chunk=64,
              canary_probes=0, async_slowpath=True,
              miss_queue_slots=256, drain_batch=64, overlap_commits=True,
              miss_source_rate=4.0, miss_source_burst=16,
              second_chance=True, telemetry=True,
              feature_gates=FeatureGates({"FlowExporter": True}), **knobs)
    eg = TpuflowDatapath(copy.deepcopy(cluster.ps), services, device=cuda,
                         **kw)
    ec = TpuflowDatapath(copy.deepcopy(cluster.ps), services, device="cpu",
                         **kw)
    for dp in (eg, ec):
        dp.enable_deny_export()
    for i in range(4):
        b = _engine_batch(cluster, services, 3 + i % 2)
        b.pkt_len = np.full(b.size, 2**31 - 1 - 100 * i, np.int32)
        k0 = (consumer.launches, op.launches)
        rg, rc = eg.step(b, 100 + i), ec.step(b, 100 + i)
        assert (consumer.launches, op.launches) == k0
        for f in ("code", "est", "pending", "svc_idx", "dnat_ip",
                  "committed"):
            np.testing.assert_array_equal(getattr(rg, f), getattr(rc, f),
                                          err_msg=f"step {i}: {f}")
        assert eg.drain_slowpath(100 + i) == ec.drain_slowpath(100 + i)
        assert (consumer.launches, op.launches) != k0
    eg.maintenance_tick(110), ec.maintenance_tick(110)
    assert eg.flush_slowpath() == ec.flush_slowpath()
    sg, sc = eg.slowpath_stats(), ec.slowpath_stats()
    sg.pop("drain_hist"), sc.pop("drain_hist")
    assert sg == sc and sg["source_limited_total"] > 0
    assert eg.telemetry_stats()["counters"] == ec.telemetry_stats()["counters"]
    assert eg.deny_drain() == ec.deny_drain()
    assert eg.dump_flows(110) == ec.dump_flows(110)
    for part in ("flow", "aff"):
        for tg, tcpu in zip(getattr(eg._state, part),
                            getattr(ec._state, part)):
            assert torch.equal(tg[:-1].cpu(), tcpu[:-1]), part


@pytest.fixture(scope="module")
def dual_world():
    """A 2500-rule world's dual-stack twin (chip_smoke.py phase 15's
    derivation), its compiled tables and a 512-lane batch, about half v6."""
    import chip_smoke as cs
    from antrea_tpu_torch.compiler.compile import compile_policy_set
    from antrea_tpu_torch.compiler.services import compile_services
    from antrea_tpu_torch.simulator import (gen_cluster, gen_services,
                                            gen_traffic)

    cluster = gen_cluster(2500, n_nodes=4, pods_per_node=32, seed=12)
    services = gen_services(40, cluster.pod_ips, affinity_fraction=0.3,
                            no_ep_fraction=0.1, seed=4)
    ps6, services6 = cs.dual_world(cluster.ps, services, cluster.pod_ips)
    tr = gen_traffic(cluster.pod_ips, 512, n_flows=256, seed=3,
                     services=services, svc_fraction=0.3)
    hb = cs.dual_batch(tr, cluster.pod_ips, services)
    assert 0 < int(hb.is6.sum()) < 512
    return (cs, ps6, services6, compile_policy_set(ps6),
            compile_services(services6), hb, cluster.pod_ips)


def test_b1_b2_on_dual_stack_v6_rows_equal_plain(cuda, dual_world):
    """B1 and B2 (K = 2) on a dual-stack world's tables at a mixed batch's
    post-DNAT interval rows, v6 sub-space rows included, against their
    plain versions."""
    from antrea_tpu_torch.models import pipeline as pl
    from antrea_tpu_torch.ops import match as tm
    from antrea_tpu_torch.ops import pruned_consumer as pc

    cs, _, _, cps, svc, hb, _ = dual_world
    step, state, (drs, dsvc) = pl.make_pipeline(
        cps, svc, flow_slots=1 << 10, fused=True, dual_stack=True,
        device=cuda)
    iv = cs.dual_rows(step, state, drs, dsvc, cs.to_lanes(hb, cuda),
                      cs.v6_lanes(hb, cuda))
    assert cs.v6_row_count(drs, iv) > 0
    meta = step.meta.match
    args = (tm.tables(drs), iv, meta.svcref, meta.in_phases,
            meta.out_phases)
    before = consumer.launches
    got = consumer.fused_hits(*args)
    assert consumer.launches == before + 1
    assert torch.equal(got, consumer.fused_hits_plain(*args))
    pdrs, pmeta = tm.to_device(cps, cuda, prune_budget=2)
    g_in, g_out = cs.agg_and(pdrs, iv, pmeta.svcref)
    pargs = (g_in, g_out, iv, tm.tables(pdrs), min(2, g_in.shape[1]),
             min(2, g_out.shape[1]), pmeta.svcref, pmeta.in_phases,
             pmeta.out_phases)
    before = pc.launches
    got = pc.pruned_hits(*pargs)
    assert pc.launches == before + 1
    assert torch.equal(got, pc.pruned_hits_plain(*pargs))


def test_v6_search_on_the_card_equals_cpu(cuda):
    """The batched v6 interval search on the card against the CPU: sorted
    bounds with the all-ones pad rows, lanes on, beside and between
    them."""
    from antrea_tpu_torch.ops import match as tm

    g = torch.Generator().manual_seed(6)
    tabs = []
    for n in (1, 37, 300, 0):
        w = torch.randint(-(2**31), 2**31, (n, 4), generator=g,
                          dtype=torch.int64)
        k = tm._key2(w.to(torch.int32))
        order = torch.from_numpy(np.lexsort((k[:, 1].numpy(),
                                             k[:, 0].numpy())))
        w = torch.cat([w[order], torch.full((n // 4, 4), 2**31 - 1)])
        tabs.append(w.to(torch.int32))
    lanes = torch.cat([tabs[2], tabs[2] + 1,
                       torch.randint(-(2**31), 2**31, (700, 4), generator=g,
                                     dtype=torch.int64).to(torch.int32)])
    want = tm._searchsorted6_many(tabs, [lanes] * 4)
    got = tm._searchsorted6_many([t.to(cuda) for t in tabs],
                                 [lanes.to(cuda)] * 4)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


def test_dual_stack_engine_on_the_card_equals_cpu(cuda, dual_world):
    """A dual-stack engine (fused, delta slots, canary) on the card against
    the same engine on the CPU: cold and warm steps of a mixed batch, v6
    pod churn on the address groups, a step of fresh v6 flows to the
    churned addresses; every StepResult field (the wide views included),
    the tables, dump_flows() and trace() equal."""
    import copy

    from antrea_tpu_torch.datapath import TpuflowDatapath

    cs, ps6, services6, _, _, hb, pod_ips = dual_world
    kw = dict(flow_slots=1 << 12, aff_slots=1 << 8, miss_chunk=64,
              fused=True, dual_stack=True, canary_probes=8,
              topology=cs.dual_spec(pod_ips), node_ips=cs.DUAL_NODE_IPS)
    eg = TpuflowDatapath(copy.deepcopy(ps6), services6, device=cuda, **kw)
    ec = TpuflowDatapath(copy.deepcopy(ps6), services6, device="cpu", **kw)

    def both(b, now, what):
        cs.same_result(eg.step(b, now), ec.step(b, now), what,
                       cs.DUAL_FIELDS)
        cs.same_engine_state(eg, ec, now, what)

    before = consumer.launches
    both(hb, 100, "cold")
    both(hb, 101, "warm")
    assert consumer.launches > before
    plan = cs.churn_plan6(ec, ps6)
    for dp in (eg, ec):
        for name, added, removed in plan:
            dp.apply_group_delta(name, added, removed)
    assert eg._n_deltas == ec._n_deltas > 0
    assert eg.commit_stats()["canary_probes_total"] > 0
    assert not eg.commit_stats()["degraded"]
    b = cs.delta_batch6(plan, pod_ips, 256, 5)
    both(b, 102, "delta step")
    assert eg.trace(b, 103) == ec.trace(b, 103)


def _tenant_worlds():
    """Three tenant worlds on three rungs, for the tenancy cases."""
    from antrea_tpu_torch.simulator import gen_cluster

    return [gen_cluster(n, n_nodes=4, pods_per_node=8, seed=40 + i)
            for i, n in enumerate((20, 200, 900))]


def _same_worlds(eg, ec, tids, what):
    """Every world's flow and affinity tables, card against CPU, the dump
    row excluded; tenant_stats() and each tenant's dump_flows()."""
    states = [(eg._state, ec._state)] + [
        (eg._tenants.world(t).fields["_state"],
         ec._tenants.world(t).fields["_state"]) for t in tids]
    for sg, sc in states:
        for part in ("flow", "aff"):
            for tg, tcpu in zip(getattr(sg, part), getattr(sc, part)):
                assert torch.equal(tg[:-1].cpu(), tcpu[:-1]), (what, part)
    assert eg.tenant_stats() == ec.tenant_stats(), what
    for t in tids:
        assert eg.tenant_dump_flows(t, 200) == ec.tenant_dump_flows(t, 200)


def _same_results(rg, rc, what):
    import dataclasses

    for f in dataclasses.fields(rc):
        a, b = getattr(rg, f.name), getattr(rc, f.name)
        if b is None:
            assert a is None, (what, f.name)
        elif isinstance(b, list):
            assert a == b, (what, f.name)
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=f"{what}: {f.name}")


@pytest.mark.parametrize("knobs", [dict(fused=True),
                                   dict(fused=True, prune_budget=2)],
                         ids=["staged", "onepass"])
def test_tenant_worlds_on_the_card_equal_cpu(cuda, knobs):
    """Tenant worlds on three rungs on the card against the same engine on
    the CPU: tenant steps cold and warm, a tenant install, a forced canary
    veto on one tenant; every StepResult field and every world's tables
    equal, and B1 (staged) or B3 (one-pass) launched inside the tenant
    worlds on their rung-padded tables."""
    from antrea_tpu_torch.datapath import TpuflowDatapath
    from antrea_tpu_torch.datapath.commit import CanaryMismatchError
    from antrea_tpu_torch.dissemination import serde
    from antrea_tpu_torch.dissemination.faults import FaultPlan
    from antrea_tpu_torch.ops import onepass as op

    cluster, services = _engine_world()
    worlds = _tenant_worlds()
    kw = dict(flow_slots=1 << 12, aff_slots=1 << 8, miss_chunk=64,
              canary_probes=8, **knobs)

    def ps(c):
        return serde.decode_policy_set(serde.encode_policy_set(c.ps))

    eg = TpuflowDatapath(ps(cluster), services, device=cuda, **kw)
    ec = TpuflowDatapath(ps(cluster), services, device="cpu", **kw)
    tids = [eg.tenant_create(f"t{i}", ps(c), quota=1 << 10)
            for i, c in enumerate(worlds)]
    assert [ec.tenant_create(f"t{i}", ps(c), quota=1 << 10)
            for i, c in enumerate(worlds)] == tids
    assert len(eg.tenant_rungs()) == 3
    k0 = (consumer.launches, op.launches)
    for now in (100, 101):
        for tid, c in zip(tids, worlds):
            b = _engine_batch(c, None, tid + now, n=256)
            _same_results(eg.tenant_step(tid, b, now),
                          ec.tenant_step(tid, b, now), f"tenant {tid}")
    k1 = (consumer.launches, op.launches)
    if knobs.get("prune_budget"):
        assert k1[1] > k0[1]
    else:
        assert k1[0] > k0[0]
    for dp in (eg, ec):
        plan = FaultPlan(seed=1)
        plan.after("dp.canary", 0, "fail", times=1)
        dp.arm_commit_faults(plan, "dp")
        with pytest.raises(CanaryMismatchError):
            dp.tenant_install_bundle(tids[1], ps(worlds[0]))
        assert dp.tenant_install_bundle(tids[2], ps(worlds[2])) == 1
    st = eg.tenant_stats()
    assert st[tids[1]]["degraded"] == 1 and st[tids[1]]["generation"] == 0
    assert st[tids[2]]["generation"] == 1 and not eg.degraded
    for tid, c in zip(tids, worlds):
        b = _engine_batch(c, None, tid + 7, n=256)
        _same_results(eg.tenant_step(tid, b, 102),
                      ec.tenant_step(tid, b, 102), f"after veto {tid}")
    _same_worlds(eg, ec, tids, "tenants")


@pytest.mark.parametrize("knobs", [dict(fused=True),
                                   dict(fused=True, prune_budget=2)],
                         ids=["staged", "onepass"])
def test_step_tenants_padded_lanes_on_the_card(cuda, knobs):
    """Mixed-tenant batches through the serving batcher on the card: the
    padding lanes ride `valid` through B1 (staged) or B3's mask column 0
    (one-pass) and change no table; every lane equals the CPU engine's."""
    from antrea_tpu_torch.datapath import TpuflowDatapath
    from antrea_tpu_torch.dissemination import serde
    from antrea_tpu_torch.ops import onepass as op
    from antrea_tpu_torch.packet import PacketBatch

    cluster, services = _engine_world()
    worlds = _tenant_worlds()[:2]
    kw = dict(flow_slots=1 << 12, aff_slots=1 << 8, miss_chunk=64,
              canary_probes=0, serving_batcher=True,
              canonical_sizes=(64, 256), **knobs)

    def ps(c):
        return serde.decode_policy_set(serde.encode_policy_set(c.ps))

    eg = TpuflowDatapath(ps(cluster), services, device=cuda, **kw)
    ec = TpuflowDatapath(ps(cluster), services, device="cpu", **kw)
    tids = [eg.tenant_create(f"t{i}", ps(c), quota=1 << 10)
            for i, c in enumerate(worlds)]
    assert [ec.tenant_create(f"t{i}", ps(c), quota=1 << 10)
            for i, c in enumerate(worlds)] == tids
    parts = [_engine_batch(cluster, services, 5, n=150)] + [
        _engine_batch(c, None, 6 + i, n=70) for i, c in enumerate(worlds)]
    lane_tids = np.concatenate([np.full(p.size, t)
                                for p, t in zip(parts, [0] + tids)])
    b = PacketBatch(**{f: np.concatenate([getattr(p, f) for p in parts])
                       for f in ("src_ip", "dst_ip", "proto", "src_port",
                                 "dst_port")})
    perm = np.random.default_rng(3).permutation(b.size)
    b = PacketBatch(**{f: getattr(b, f)[perm] for f in
                       ("src_ip", "dst_ip", "proto", "src_port",
                        "dst_port")})
    lane_tids = lane_tids[perm]
    k0 = (consumer.launches, op.launches)
    for now in (100, 101):
        _same_results(eg.step_tenants(lane_tids, b, now),
                      ec.step_tenants(lane_tids, b, now), f"@{now}")
    k1 = (consumer.launches, op.launches)
    assert (k1[1] > k0[1]) if knobs.get("prune_budget") else (k1[0] > k0[0])
    st = eg.serving_stats()
    assert st == ec.serving_stats() and st["padded_lanes"] > 0
    _same_worlds(eg, ec, tids, "step_tenants")


def test_persist_dir_restart_on_the_card(cuda, tmp_path):
    """An engine on the card with a persist dir: a bundle, a tenant world
    and its install, then the engine is dropped and rebuilt from the dir.
    The generation is monotonic, the tenant's tid, spec and generation come
    back, the store is the native one, and from the second step on the
    codes and rule ids equal an engine that never restarted."""
    from antrea_tpu_torch.datapath import TpuflowDatapath
    from antrea_tpu_torch.dissemination import serde

    cluster, services = _engine_world()
    world = _tenant_worlds()[1]
    kw = dict(flow_slots=1 << 12, aff_slots=1 << 8, miss_chunk=64,
              canary_probes=8, fused=True, prune_budget=2)

    def ps(c):
        return serde.decode_policy_set(serde.encode_policy_set(c.ps))

    dp = TpuflowDatapath(persist_dir=str(tmp_path), device=cuda, **kw)
    g = dp.install_bundle(ps=ps(cluster), services=services)
    tid = dp.tenant_create("t", ps(world), quota=1 << 10)
    assert dp.tenant_install_bundle(tid, ps(world)) == 1
    b = _engine_batch(cluster, services, 11)
    dp.step(b, 100)
    del dp
    twin = TpuflowDatapath(ps(cluster), services, device=cuda, **kw)
    twin.tenant_create("t", ps(world), quota=1 << 10)
    dp = TpuflowDatapath(persist_dir=str(tmp_path), device=cuda, **kw)
    assert dp._conf_store.backend == "native"
    assert dp.generation == g
    st = dp.tenant_stats()
    assert list(st) == [tid] and st[tid]["generation"] == 1
    assert st[tid]["name"] == "t" and st[tid]["quota_slots"] == 1 << 10
    for now in (101, 102):
        r, w = dp.step(b, now), twin.step(b, now)
    np.testing.assert_array_equal(r.code, w.code)
    assert r.ingress_rule == w.ingress_rule and r.egress_rule == w.egress_rule
    bt = _engine_batch(world, None, 12, n=256)
    for now in (103, 104):
        r, w = dp.tenant_step(tid, bt, now), twin.tenant_step(1, bt, now)
    np.testing.assert_array_equal(r.code, w.code)


@pytest.mark.parametrize("knobs", [dict(fused=True),
                                   dict(fused=True, prune_budget=2)],
                         ids=["staged", "onepass"])
def test_mesh_engine_1x2_on_the_card_equals_cpu(cuda, knobs):
    """The mesh engine at (1, 2) on the card (its two rule shards in two
    threads on one device) against its CPU twin: steps, a group delta, the
    canary's per-replica codes, dump_flows, the rule digests and every rule
    shard's state copy (dump rows excluded) bitwise equal; one-pass
    launches B3's hits-only variant (B3h) and never its resolve variant."""
    import copy

    from antrea_tpu_torch.ops import onepass as op
    from antrea_tpu_torch.parallel import MeshDatapath

    cluster, services = _engine_world()
    kw = dict(n_data=1, n_rule=2, flow_slots=1 << 12, aff_slots=1 << 8,
              miss_chunk=64, canary_probes=8, **knobs)
    eg = MeshDatapath(copy.deepcopy(cluster.ps), services, device=cuda, **kw)
    ec = MeshDatapath(copy.deepcopy(cluster.ps), services, device="cpu",
                      **kw)
    k0 = (op.launches, op.launches_hits)

    def both(b, now, what):
        rg, rc = eg.step(b, now), ec.step(b, now)
        for f in ("code", "est", "svc_idx", "dnat_ip", "dnat_port",
                  "committed", "fwd_kind", "out_port"):
            np.testing.assert_array_equal(getattr(rg, f), getattr(rc, f),
                                          err_msg=f"{what}: {f}")
        assert rg.ingress_rule == rc.ingress_rule, what
        assert rg.egress_rule == rc.egress_rule, what
        for r in range(2):
            for part in ("flow", "aff"):
                for tg, tcpu in zip(getattr(eg._state[0][r], part),
                                    getattr(ec._state[0][r], part)):
                    assert torch.equal(tg[:-1].cpu(), tcpu[:-1]), (what, r)

    for i in range(2):
        both(_engine_batch(cluster, services, 3 + i), 100 + i, f"step {i}")
    ag = sorted(cluster.ps.address_groups)[0]
    for dp in (eg, ec):
        dp.apply_group_delta(ag, ["10.9.9.9"], [])
    b = _engine_batch(cluster, services, 9)
    both(b, 110, "delta step")
    assert eg.dump_flows(111) == ec.dump_flows(111)
    np.testing.assert_array_equal(eg._canary_classify(b, 0),
                                  ec._canary_classify(b, 0))
    assert eg._audit_rule_digests() == ec._audit_rule_digests()
    if knobs.get("prune_budget"):
        assert op.launches == k0[0] and op.launches_hits > k0[1]


def _resize_pair(cuda, **knobs):
    import copy

    from antrea_tpu_torch.parallel import MeshDatapath

    cluster, services = _engine_world()
    kw = dict(n_data=2, n_rule=2, flow_slots=1 << 10, aff_slots=1 << 8,
              miss_chunk=64, canary_probes=8, **knobs)
    eg = MeshDatapath(copy.deepcopy(cluster.ps), services, device=cuda, **kw)
    ec = MeshDatapath(copy.deepcopy(cluster.ps), services, device="cpu",
                      **kw)
    return cluster, services, eg, ec


def _same_engines(eg, ec, rg, rc, now, what):
    """Every StepResult field, dump_flows(), reshard_stats() (spans
    aside), failover_stats() and every rule shard's state copy of the card
    engine equal to the CPU engine's."""
    for f in ("code", "est", "reply", "svc_idx", "dnat_ip", "dnat_port",
              "committed", "fwd_kind", "out_port", "peer_ip"):
        np.testing.assert_array_equal(getattr(rg, f), getattr(rc, f),
                                      err_msg=f"{what}: {f}")
    assert rg.ingress_rule == rc.ingress_rule, what
    assert rg.egress_rule == rc.egress_rule, what
    assert eg.dump_flows(now) == ec.dump_flows(now), what
    sg, sc = eg.reshard_stats(), ec.reshard_stats()
    sg.pop("last_span"), sc.pop("last_span")
    assert sg == sc, what
    fg, fc = eg.failover_stats(), ec.failover_stats()
    assert fg == fc, what
    assert (eg._n_data, eg._topo_gen) == (ec._n_data, ec._topo_gen), what
    for d, (rowg, rowc) in enumerate(zip(eg._state, ec._state)):
        for r, (sg_, sc_) in enumerate(zip(rowg, rowc)):
            for tg, tcpu in zip((*sg_.flow, *sg_.aff), (*sc_.flow, *sc_.aff)):
                assert torch.equal(tg[:-1].cpu(), tcpu[:-1]), (what, d, r)


@pytest.mark.parametrize("knobs", [dict(fused=True),
                                   dict(fused=True, prune_budget=2)],
                         ids=["staged", "onepass"])
def test_mesh_engine_grow_and_shrink_on_the_card_equals_cpu(cuda, knobs):
    """A live grow (2, 2) -> (4, 2) and shrink back to 2 replicas on the
    card, stepping a batch before every maintenance tick, against the same
    engine on the CPU: each step, the journal, dump_flows(), the resize
    meters and every replica's state copies bitwise equal; the target
    canary and the migrated-row audit run the kernels (the card's
    launches grow across the cutover ticks)."""
    from antrea_tpu_torch.ops import consumer as c1
    from antrea_tpu_torch.ops import pruned_consumer as c2

    cluster, services, eg, ec = _resize_pair(cuda, **knobs)
    b = _engine_batch(cluster, services, 3, n=256)
    t = 100
    for dp in (eg, ec):
        dp.step(b, t)
    t += 1
    for n in (4, 2):
        for dp in (eg, ec):
            dp.reshard_begin(n)
        while ec.reshard_status() is not None:
            rg, rc = eg.step(b, t), ec.step(b, t)
            _same_engines(eg, ec, rg, rc, t, f"to {n}, t={t}")
            k0 = (c1.launches, c2.launches)
            outs = [dp.maintenance_tick(now=t)["ran"] for dp in (eg, ec)]
            assert outs[0] == outs[1], t
            if ec.reshard_status() is None:  # the cutover tick
                assert (c1.launches, c2.launches) > k0
            t += 1
            assert t < 150
        assert eg.reshard_status() is None and eg._n_data == n
        rg, rc = eg.step(b, t), ec.step(b, t)
        _same_engines(eg, ec, rg, rc, t, f"after {n}")
        assert int(rg.est.sum()) > 0
        t += 1
    kinds = [e["kind"] for e in eg.flightrecorder_events()]
    assert kinds == [e["kind"] for e in ec.flightrecorder_events()]
    assert eg.reshard_stats()["cutovers_total"] == 2


def test_mesh_engine_failover_on_the_card_equals_cpu(cuda):
    """A replica killed on the card (one-pass, failover=True, deadlines no
    step reaches): quarantine, evacuation to one replica, readmission to
    two, step for step equal to the same engine on the CPU."""
    from antrea_tpu_torch.dissemination.faults import FaultPlan

    knobs = dict(failover=True, failover_knobs=dict(
        probe_fails=2, readmit_passes=2, retry_ticks=2,
        probe_deadline_s=1e6, dispatch_deadline_s=1e6))
    cluster, services, eg, ec = _resize_pair(cuda, fused=True,
                                             prune_budget=2, **knobs)
    b = _engine_batch(cluster, services, 5, n=256)
    plans = []
    for dp in (eg, ec):
        dp.step(b, 100)
        plan = FaultPlan(seed=5)
        plan.every("n0.replica_dead", 1, "r1", times=-1)
        dp.arm_failover_faults(plan, "n0")
        plans.append(plan)
    t = 101
    for goal in ("evacuated", "healthy"):
        while ec.failover_stats()["phase"] != goal:
            rg, rc = eg.step(b, t), ec.step(b, t)
            _same_engines(eg, ec, rg, rc, t, f"to {goal}, t={t}")
            for dp in (eg, ec):
                dp.maintenance_tick(now=t)
            t += 1
            assert t < 200, ec.failover_stats()
        assert eg.failover_stats()["phase"] == goal
        for plan in plans:
            plan.quiesce()
    st = eg.failover_stats()
    assert (st["quarantines_total"], st["evacuations_total"],
            st["readmissions_total"], eg._n_data) == (1, 1, 1, 2)
    rg, rc = eg.step(b, t), ec.step(b, t)
    _same_engines(eg, ec, rg, rc, t, "after the readmission")


def _agent_world(ctl):
    """Six pods on three nodes, a K8s ingress policy and an ACNP drop, all
    spanning node n0 (whose agent is under test)."""
    from antrea_tpu_torch.apis import controlplane as cp
    from antrea_tpu_torch.apis import crd

    sel = crd.LabelSelector.make
    ctl.upsert_namespace(crd.Namespace("default", {}))
    for i, (app, node) in enumerate((("web", "n0"), ("web", "n1"),
                                     ("cli", "n1"), ("cli", "n2"),
                                     ("db", "n2"), ("db", "n0"))):
        ctl.upsert_pod(crd.Pod(namespace="default", name=f"p{i}",
                               ip=f"10.0.{i}.{10 + i}", node=node,
                               labels={"app": app}))
    ctl.upsert_k8s_policy(crd.K8sNetworkPolicy(
        uid="np-web", name="np-web", namespace="default",
        pod_selector=sel({"app": "web"}),
        ingress=[crd.K8sNPRule(
            peers=[crd.K8sPeer(pod_selector=sel({"app": "cli"}))],
            ports=[crd.PortSpec(protocol=6, port=80)])]))
    ctl.upsert_antrea_policy(crd.AntreaNetworkPolicy(
        uid="acnp-db", name="acnp-db", tier_priority=250, priority=1.0,
        applied_to=[crd.AntreaAppliedTo(pod_selector=sel({"app": "db"}))],
        rules=[crd.AntreaNPRule(
            direction=cp.Direction.IN, action=cp.RuleAction.DROP,
            peers=[crd.AntreaPeer(pod_selector=sel({"app": "web"}))])]))


def _agent_batch(sport):
    from antrea_tpu_torch.packet import PacketBatch
    from antrea_tpu_torch.utils import ip as iputil

    ips = [f"10.0.{i}.{10 + i}" for i in range(6)] + ["10.0.9.99"]
    rows = [(s, d, p) for s in ips for d in ips if s != d for p in (80, 443)]
    return PacketBatch(
        src_ip=np.array([iputil.ip_to_u32(s) for s, _, _ in rows], np.uint32),
        dst_ip=np.array([iputil.ip_to_u32(d) for _, d, _ in rows], np.uint32),
        proto=np.full(len(rows), 6, np.int32),
        src_port=np.arange(sport, sport + len(rows), dtype=np.int32),
        dst_port=np.array([p for _, _, p in rows], np.int32))


@pytest.mark.parametrize("knobs", [dict(fused=True),
                                   dict(fused=True, prune_budget=2)],
                         ids=["staged", "onepass"])
def test_agent_on_the_card_equals_cpu(cuda, knobs):
    """Two agents watching one store, one driving the port's engine on the
    card and one the same engine on the CPU: install, a membership delta
    (through apply_group_delta) and a policy deletion, each sync clean and
    each step's every field, dump_flows() included, equal."""
    from antrea_tpu_torch.agent import AgentPolicyController
    from antrea_tpu_torch.apis import crd
    from antrea_tpu_torch.controller import NetworkPolicyController
    from antrea_tpu_torch.datapath import TpuflowDatapath
    from antrea_tpu_torch.dissemination import RamStore

    ctl = NetworkPolicyController()
    store = RamStore()
    ctl.subscribe(store.apply)
    kw = dict(flow_slots=1 << 10, aff_slots=1 << 8, miss_chunk=32,
              canary_probes=4, **knobs)
    agents = [AgentPolicyController("n0", TpuflowDatapath(device=d, **kw),
                                    store) for d in (cuda, "cpu")]
    _agent_world(ctl)
    steps = [("install", None),
             ("delta", lambda: ctl.upsert_pod(crd.Pod(
                 namespace="default", name="p9", ip="10.0.9.99", node="n2",
                 labels={"app": "cli"}))),
             ("delete", lambda: ctl.delete_policy("acnp-db"))]
    for k, (what, change) in enumerate(steps):
        if change is not None:
            change()
        if what == "delta":
            assert agents[0]._deltas and agents[1]._deltas
        for a in agents:
            a.sync()
            assert a.sync_failures_total == 0, a.last_sync_error
            assert a.permanent_failure == "" and a.last_sync_error == ""
        eg, ec = (a.datapath for a in agents)
        assert eg.generation == ec.generation == k + 1
        if what == "delta":
            assert eg._n_deltas == ec._n_deltas > 0
        b = _agent_batch(20000 + 1000 * k)
        rg, rc = eg.step(b, 10 * (k + 1)), ec.step(b, 10 * (k + 1))
        _same_results(rg, rc, what)
        assert eg.dump_flows(10 * (k + 1)) == ec.dump_flows(10 * (k + 1))


def test_subprocess_agent_on_the_card_by_default(cuda):
    """SubprocessAgent(datapath_type="tpuflow") with no device: the child
    agent_proc builds its engine on the card, and its replies equal an
    in-process agent driving the same engine on the CPU."""
    from antrea_tpu_torch.agent import AgentPolicyController
    from antrea_tpu_torch.controller import NetworkPolicyController
    from antrea_tpu_torch.datapath import TpuflowDatapath
    from antrea_tpu_torch.dissemination import RamStore
    from antrea_tpu_torch.dissemination.transport import SubprocessAgent

    ctl = NetworkPolicyController()
    store = RamStore()
    ctl.subscribe(store.apply)
    dp = TpuflowDatapath(device="cpu", miss_chunk=32, flow_slots=1 << 10,
                         aff_slots=1 << 8)
    local = AgentPolicyController("n0", dp, store)
    with SubprocessAgent("n0", store, datapath_type="tpuflow",
                         flow_slots=1 << 10, aff_slots=1 << 8) as sub:
        argv = sub._proc.args
        assert argv[argv.index("--device") + 1] == "cuda"
        _agent_world(ctl)
        sub.pump()
        assert sub.sync()["generation"] == 1
        local.sync()
        b = _agent_batch(30000)
        got, want = sub.step(b, 10), dp.step(b, 10)
        for f in ("code", "est", "svc_idx", "dnat_ip", "dnat_port"):
            assert got[f] == [int(x) for x in getattr(want, f)], f
        assert got["ingress_rule"] == want.ingress_rule
        assert got["egress_rule"] == want.egress_rule
        assert sub._stderr_tail() == ""


def test_fleet_agent_on_the_card_equals_cpu(cuda, tmp_path):
    """tests/test_torch_fleet.py's mTLS fleet (fake agents on node-1 ..
    node-8, node-0's NetAgent driving the port's engine, statuses to one
    StatusAggregator) twice: node-0's engine on the card, then on the CPU.
    Through the install and a policy's deletion, every field of each step
    of node-0's engine equal."""
    import torch_fleet_world as tfw

    got = tfw.walk(str(tmp_path / "card"), cuda)
    want = tfw.walk(str(tmp_path / "cpu"), "cpu")
    assert len(got) == len(want) == 4
    for k, (rg, rc) in enumerate(zip(got, want)):
        _same_results(rg, rc, f"step {k}")


def test_engine_step_syncs_only_where_host_syncs_declares(cuda):
    """One steady one-pass engine step of a small world under
    torch.cuda.set_sync_debug_mode("warn") (utils/sync_census.py): every
    sync whose innermost package frame lies in models/ or ops/ is at a
    function its module's HOST_SYNCS declares, and B3 launched in it."""
    from antrea_tpu_torch.datapath import TpuflowDatapath
    from antrea_tpu_torch.ops import onepass as op
    from antrea_tpu_torch.utils.sync_census import SyncCensus

    cluster, services = _engine_world()
    eng = TpuflowDatapath(cluster.ps, services, device=cuda,
                          flow_slots=1 << 12, aff_slots=1 << 8,
                          miss_chunk=64, canary_probes=0, fused=True,
                          prune_budget=2)
    b = _engine_batch(cluster, services, 3)
    for now in (100, 101):
        eng.step(b, now)
    fresh = _engine_batch(cluster, services, 4, n=64)
    b.src_ip[:64], b.dst_ip[:64] = fresh.src_ip, fresh.dst_ip
    before = op.launches
    with SyncCensus() as census:
        r = eng.step(b, 102)
    assert r.n_miss > 0 and op.launches == before + 1
    assert census.held(), census.sites
    assert census.undeclared() == {}, census.sites
    assert census.unattributed == 0, census.sites
