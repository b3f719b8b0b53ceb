"""The cell one_ns_10k_svc10k.svc_churn end to end on the CPU: its entry in
BENCHMARK.json, its configuration and mix files with only their counts cut,
run by the benchmark's harness and checked against the plain reference;
its Service LB readers; and its world module at the configuration's own
Service counts."""

import time
from types import SimpleNamespace

import numpy as np

import service_cell
import torch_cpu  # noqa: F401  (one torch thread a worker)
from flowbench import harness
from flowbench.worlds import cluster_services

CELL = "one_ns_10k_svc10k.svc_churn"
READERS = ("svc_miss_share", "aff_hit_share", "aff_overwrite_share")


def test_the_cell_runs_correct_with_its_readers():
    spec = harness.cell_spec(harness.load_bench(service_cell.ROOT), CELL,
                             service_cell.ROOT)
    assert spec["config"]["world"] == "cluster_services"
    assert spec["end_to_end"] == ["pkts_per_s", "setup_s"]
    assert spec["per_layer"] == list(READERS)
    cfg = service_cell.cut_config(spec["config"])
    mix = service_cell.cut_mix(spec["mix"])
    rec = harness.run_cell(cfg, mix, 2**31 + 21, 0.5, False, "cpu",
                           time.perf_counter())
    assert len(rec["plain"]["services"]) == service_cell.SERVICES["count"]
    checked = harness.compare(rec, "cpu")
    line = harness.result_line(rec, spec, True, "cpu", 1, checked)
    assert line["correct"], checked
    # Service replies hit the reply entries their first packets left, and
    # are un-DNATed to the frontend.
    res = list(rec["checked"].values())
    rep = sum(int(((r.svc_idx >= 0) & (r.reply == 1)).sum()) for r in res)
    assert rep > 0
    for r in res:
        back = (r.svc_idx >= 0) & (r.reply == 1)
        assert ((r.dnat_ip[back] >> 20) == 0x0A6).all()
    for name in READERS:
        v = line["metrics"][name]["value"]
        assert isinstance(v, float) and 0 <= v <= 1, (name, v)
    assert 0 < line["metrics"]["svc_miss_share"]["value"] < 1


def test_readers_give_nothing_without_the_lb_field():
    """A program whose StepResult has no lb (the parent of the counters),
    or counted nothing, gives no number."""
    bare = {"checked": {3: SimpleNamespace(n_miss=5),
                        7: SimpleNamespace(n_miss=2)}}
    zero = {"checked": {3: SimpleNamespace(n_miss=0, lb=dict.fromkeys(
        ("lb", "lb_aff", "aff_hit", "no_ep", "aff_learn", "aff_overwrite"),
        0))}}
    for name in READERS:
        assert harness.reader(name)(bare) is None, name
        assert harness.reader(name)(zero) is None, name


def test_the_world_holds_the_configurations_services():
    """The configuration's own `services` over 10,000 Pods: 10,000
    ClusterIPs from 10.96.0.1 up on the port list in turn, 100 without
    endpoints, the others 1-29 of them (about 150,000 rows), about a third
    with ClientIP affinity at 10,800 s."""
    cfg = harness.load_config(service_cell.ROOT / "flowbench/configs"
                              / "one_ns_10k_svc10k.json")
    spec = cfg["services"]
    pods = (0x0A000000 + np.arange(10000)).astype(np.uint32)
    svcs = cluster_services.services(spec, pods)
    assert len(svcs) == 10000
    assert svcs[0].cluster_ip == "10.96.0.1"
    assert svcs[-1].cluster_ip == "10.96.39.16"
    ports = spec["ports"]
    for i in (0, 1, 5, 6, 9999):
        s = svcs[i]
        assert [s.protocol, s.port, s.endpoints[0].port if s.endpoints
                else ports[i % 6][2]] == ports[i % 6]
    n_ep = np.array([len(s.endpoints) for s in svcs])
    assert (n_ep == 0).sum() == 100
    assert n_ep[n_ep > 0].min() == 1 and n_ep.max() == 29
    assert 145000 < n_ep.sum() < 155000
    aff = np.array([s.affinity_timeout_s for s in svcs])
    assert set(aff.tolist()) == {0, 10800}
    assert 0.31 < (aff > 0).mean() < 0.36
    assert all(len({e.ip for e in s.endpoints}) == len(s.endpoints)
               for s in svcs)
