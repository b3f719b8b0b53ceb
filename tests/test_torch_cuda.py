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


@pytest.mark.parametrize("b,w_in,w_out,in_ph,out_ph,w0", [
    (256, 61, 40, (900, 700, 300), (600, 500, 180), (0, 0)),
    (37, 5, 3, (37, 50, 60), (32, 0, 64), (0, 0)),
    (129, 7, 9, (300, 40, 10), (21, 300, 40), (3, 7)),
])
def test_consumer_kernel_equals_plain(cuda, b, w_in, w_out, in_ph, out_ph, w0):
    g = torch.Generator().manual_seed(b)

    def rows(w):
        out = []
        for _ in range(3):
            bits = torch.rand((b, w, 32), generator=g) < 0.25
            words = (bits.long() << torch.arange(32)).sum(-1)
            out.append(((words + 2**31) % 2**32 - 2**31).to(torch.int32))
        return [r.to(cuda) for r in out]

    rin, rout = rows(w_in), rows(w_out)
    before = consumer.launches
    got = consumer.fused_hits(rin, rout, in_ph, out_ph, *w0)
    torch.cuda.synchronize()
    assert consumer.launches == before + 1
    want = consumer.consumer_plain(rin, rout, in_ph, out_ph, *w0)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


def _words(g, shape, dens, dev):
    """Random int32 words (u32 bits), each bit set with probability dens."""
    bits = torch.rand((*shape, 32), generator=g) < dens
    words = (bits.long() << torch.arange(32)).sum(-1)
    return ((words + 2**31) % 2**32 - 2**31).to(torch.int32).to(dev)


@pytest.mark.parametrize("b,ke_in,s_in,ke_out,s_out,in_ph,out_ph", [
    (256, 4, 59, 4, 40, (29432, 29764, 485), (20012, 20004, 303)),
    (37, 3, 5, 1, 2, (1000, 1500, 600), (1024, 0, 64)),
])
def test_pruned_consumer_kernel_equals_plain(cuda, b, ke_in, s_in, ke_out,
                                             s_out, in_ph, out_ph):
    from antrea_tpu_torch.ops import match, pruned_consumer

    g = torch.Generator().manual_seed(b)

    def mats(ke, s):
        cand = torch.sort(torch.randint(0, s, (b, ke), generator=g),
                          dim=1).values
        m = [_words(g, (b, ke * 32), 0.4, cuda) for _ in range(3)]
        m[0][::5] = 0  # lanes with no candidate
        return m + [match.candidate_base(cand).to(cuda)]

    m_in, m_out = mats(ke_in, s_in), mats(ke_out, s_out)
    before = pruned_consumer.launches
    got = pruned_consumer.pruned_hits(m_in, m_out, in_ph, out_ph)
    torch.cuda.synchronize()
    assert pruned_consumer.launches == before + 1
    want = pruned_consumer.pruned_plain(m_in, m_out, in_ph, out_ph)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


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
    from antrea_tpu_torch.models import pipeline as pl
    from antrea_tpu_torch.ops import hashing
    from antrea_tpu_torch.ops import onepass as op

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
    if svcref:
        g = torch.Generator().manual_seed(1)
        iv = x.iv.clone()
        rows = drs.egress.svc.inc.shape[0]
        iv[:, 6] = torch.randint(0, rows, (iv.shape[0],), generator=g).to(
            cuda, torch.int32)
        x = x._replace(iv=iv)
    ing, eg = drs.ingress, drs.egress
    tabs = op.OnepassTables(
        inc=tuple(t.inc for t in (ing.at, ing.peer, ing.svc, eg.at, eg.peer,
                                  eg.svc)),
        act_in=ing.action, act_out=eg.action)
    mm = meta.match
    # K = 1 < S_in = 2: fallback lanes too.
    st = op.OnepassStatic(k=1, in_phases=mm.in_phases,
                          out_phases=mm.out_phases, svcref=svcref,
                          timeouts=timeouts, n_slots=n,
                          pref_mask=pl.PREF_MASK)
    before = op.launches
    got = op.onepass(x, tabs, 150, 3, st)
    torch.cuda.synchronize()
    assert op.launches == before + 1
    want = op.onepass_plain(x, tabs, 150, 3, st)
    for g_, w_ in zip(got, want):
        np.testing.assert_array_equal(g_.cpu().numpy(), w_.cpu().numpy())
    assert got[0][:, 11].any() and got[3][:, 1].any()


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
