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


@pytest.mark.parametrize("svcref,timeouts", [
    (False, (3600, 3600, 3600, 3600)), (True, (30, 3600, 60, 120))])
def test_onepass_kernel_equals_plain(cuda, pruned_world, svcref, timeouts):
    """B3 against its plain version on prepared inputs after a cold step,
    with the svcref probe and per-state timeouts forced on."""
    from antrea_tpu_torch.ops import onepass as op

    x, tabs, st, drs = _onepass_case(cuda, pruned_world, timeouts)
    if svcref:
        g = torch.Generator().manual_seed(1)
        iv = x.iv.clone()
        rows = drs.egress.svc.inc.shape[0]
        iv[:, 6] = torch.randint(0, rows, (iv.shape[0],), generator=g).to(
            cuda, torch.int32)
        x = x._replace(iv=iv)
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


def _onepass_case(cuda, pruned_world, timeouts):
    """B3's inputs for the pruned world's lanes after a cold step at
    now = 100, probed at now = 150 -> (x, tabs, st (K = 2), drs)."""
    from antrea_tpu_torch.models import pipeline as pl
    from antrea_tpu_torch.ops import hashing
    from antrea_tpu_torch.ops import onepass as op
    from antrea_tpu_torch.ops.match import tables

    cps, svc, tr = pruned_world
    step, state, (drs, dsvc) = pl.make_pipeline(
        cps, svc, device=cuda, flow_slots=1 << 10, fused=True,
        prune_budget=2)
    lanes = _lanes(tr, cuda)
    state, _ = step(state, drs, dsvc, *lanes, 100, 0)
    src_f, dst_f, proto, sport, dport = lanes
    meta = step.meta
    n = meta.flow_slots
    pp = pl._pair16(sport, dport)
    h = hashing.flow_hash(pl._raw_bits(src_f), pl._raw_bits(dst_f), proto,
                          sport, dport)
    slot = h & (n - 1)
    hit, _, _, mr, kr0, ts0 = pl._cache_lookup(
        state.flow, slot, torch.stack([src_f, dst_f], 1), pp,
        proto | 0x100, proto | 0x100 | (pl.GEN_ETERNAL << 9), 150, proto,
        meta)
    x, _ = pl._onepass_inputs(state.aff, drs, dsvc, src_f, dst_f, proto,
                              sport, dport, pp, h, ~hit, kr0, mr, ts0, 150,
                              meta)
    tabs = op.OnepassTables(inc=tables(drs), act_in=drs.ingress.action,
                            act_out=drs.egress.action)
    mm = meta.match
    st = op.OnepassStatic(k=2, in_phases=mm.in_phases,
                          out_phases=mm.out_phases, svcref=mm.svcref,
                          timeouts=timeouts, n_slots=n,
                          pref_mask=pl.PREF_MASK)
    return x, tabs, st, drs


@pytest.mark.parametrize("k,svcref", [(3, True), (16, False)])
def test_onepass_candidate_scan_equals_plain(cuda, pruned_world, k, svcref):
    """B3 on the candidate scan it shares with B2 (csrc/candidate_scan.cuh):
    the pruned world's lanes over seeded tables of 40 and 7 superblocks and
    seeded aggregate rows, so a lane has up to 40 candidates in two ballot
    words, batches of four and a short last batch; bitwise to its plain
    version."""
    from antrea_tpu_torch.ops import onepass as op

    x, tabs, st, _ = _onepass_case(cuda, pruned_world,
                                   (3600, 3600, 3600, 3600))
    g = torch.Generator().manual_seed(k)
    inc = _tables(g, (32 * 40, 32 * 7), 0.45, cuda, False)
    b = x.iv.shape[0]
    # Lane i keeps each aggregate word with probability (i % 11) / 10, so
    # its candidate count runs from 0 to all of S; no key row matches, so
    # every lane misses and scans.
    keep = (torch.arange(b) % 11 / 10)[:, None]
    agg = tuple(torch.where(torch.rand((b, s), generator=g) < keep, -1, 0)
                .to(cuda, torch.int32) for s in (40, 40, 40, 7, 7, 7))
    x = x._replace(agg=agg, iv=_interval_rows(g, inc, b, cuda),
                   kr=torch.zeros_like(x.kr))
    tabs = tabs._replace(inc=tuple(inc))
    st = st._replace(k=k, svcref=svcref)
    before = op.launches
    got = op.onepass(x, tabs, 150, 3, st)
    torch.cuda.synchronize()
    assert op.launches == before + 1
    want = op.onepass_plain(x, tabs, 150, 3, st)
    for g_, w_ in zip(got, want):
        np.testing.assert_array_equal(g_.cpu().numpy(), w_.cpu().numpy())
    assert (want[3][:, 2] > 32).any()  # candidates past the first ballot


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
