"""Small worlds for the CPU tests of the benchmark: the cells' own shapes
(the scale tests' Namespaces and policies, node-0's span and topology, the
connection-churn mix's classes and proportions) at a size a test run
holds, with a flow cache small enough that slots collide; and the same
worlds with ClusterIP Services (service_world.py), with an affinity table
small enough that pins collide."""

import copy
import sys

import pytest

import service_world

ENGINE = {"fused": True, "prune_budget": 4, "flow_slots": 1 << 11,
          "aff_slots": 1 << 5, "miss_chunk": 256, "ct_timeout_s": 3600,
          "canary_probes": 2}


def small_config(kind="small_ns"):
    """xlarge_small_ns (small Namespaces) or one_ns_10k (one Namespace)
    at a test's size."""
    if kind == "small_ns":
        cluster = {"namespaces": 300, "pods_per_namespace": 4,
                   "pod_labels": ["app-0", "app-1"], "nodes": 24, "node": 0,
                   "world_seed": 1}
        policies = [{"name": f"np-{k}", "count": 1,
                     "select": f"app-{k % 2}", "from": f"app-{(k + 1) % 2}",
                     "ports": [[6, 80]]} for k in range(3)]
    else:
        cluster = {"namespaces": 1, "pods_per_namespace": 600,
                   "pod_labels": ["app-1"], "nodes": 12, "node": 0,
                   "world_seed": 1}
        policies = [{"name": "np", "count": 60, "select": "app-1",
                     "from": "app-1", "ports": []}]
    return {"world": "np_scale_test", "cluster": cluster,
            "policies": policies, "engine": dict(ENGINE)}


SMALL_MIX = {"batch": 512, "new_per_step": 64, "life_steps": 4,
             "templates": 8, "reply_share": 0.5,
             "classes": [
                 {"name": "admitted_in", "kind": "policy_in", "share": 0.55,
                  "replies": True},
                 {"name": "pod_out", "kind": "local_out", "share": 0.3,
                  "replies": True},
                 {"name": "outside_in", "kind": "external_in", "share": 0.1,
                  "replies": False},
                 {"name": "outside_out", "kind": "external_out",
                  "share": 0.05, "replies": True}],
             "ports": [[6, 80], [6, 443], [6, 8080], [17, 53], [6, 5432]],
             "now_start": 100, "now_step": 1, "warm_steps": 4}


@pytest.fixture
def small():
    return small_config(), copy.deepcopy(SMALL_MIX)


# Services over the small worlds' Pods: with and without ClientIP
# affinity, two without endpoints, on TCP and UDP.
SERVICES = {"count": 40, "endpoints": [1, 4], "no_endpoints": 2,
            "affinity_share": 0.4, "affinity_s": 10800, "seed": 3,
            "ports": [[6, 80, 8080], [6, 443, 8443], [17, 53, 5353],
                      [6, 80, 80]]}


def service_config(kind="one_ns"):
    """small_config(kind) with Services (flowbench.worlds.service_world,
    which the fixture below provides)."""
    cfg = small_config(kind)
    cfg["world"] = "service_world"
    cfg["services"] = copy.deepcopy(SERVICES)
    return cfg


# SMALL_MIX with a class of local Pods to Services, skewed frontends.
SVC_MIX = copy.deepcopy(SMALL_MIX)
SVC_MIX["classes"] = [dict(k, share=k["share"] * 0.6)
                      for k in SVC_MIX["classes"]] + [
    {"name": "to_service", "kind": "service", "share": 0.4,
     "replies": True, "popularity": 1.0}]


@pytest.fixture(autouse=True)
def service_world_module(monkeypatch):
    """The tests' Service world, found by build_world as a world module
    of the name service_world, as a cell's would be."""
    monkeypatch.setitem(sys.modules, "flowbench.worlds.service_world",
                        service_world)
