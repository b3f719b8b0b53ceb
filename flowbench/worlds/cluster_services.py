"""A node that proxies every ClusterIP Service of its cluster: the world of
np_scale_test (the Namespaces, Pods and policies of Antrea's controller
scale tests, the agent's node's policy span and topology), plus the
configuration's `services`, which the agent holds in full, since
AntreaProxy, like kube-proxy, programs every Service on every Node:

- count: ClusterIP Services, frontends from 10.96.0.1 upward (Kubernetes'
  default Service range, 10.96.0.0/12), Service i on ports[i % len] =
  [protocol, port, target port];
- endpoints: [lo, hi], each Service's endpoint count, uniform, drawn
  without repeats over every Pod of the cluster (a Pod backs several
  Services); no_endpoints of the Services, drawn at random, have none;
- affinity_share: each Service's chance of ClientIP session affinity,
  with the timeout affinity_s;
- seed: the draw of all of it.

build(config) -> (PolicySet, Services, Topology, pod addresses of the
cluster, the agent's node's pod addresses), as every world module."""

from __future__ import annotations

import numpy as np

from antrea_tpu_torch.apis.service import Endpoint, ServiceEntry
from flowbench.worlds import np_scale_test
from flowbench.worlds.np_scale_test import u32_to_ip

_SERVICE_NET = 0x0A600000   # 10.96.0.0/12


def services(spec: dict, pods: np.ndarray) -> list:
    rng = np.random.default_rng(spec["seed"])
    n = int(spec["count"])
    if n >= 1 << 20:
        raise ValueError("more Services than 10.96.0.0/12 holds")
    lo, hi = spec["endpoints"]
    n_ep = rng.integers(lo, hi + 1, n)
    n_ep[rng.permutation(n)[:int(spec.get("no_endpoints", 0))]] = 0
    aff = rng.random(n) < float(spec["affinity_share"])
    out = []
    for i in range(n):
        proto, port, target = spec["ports"][i % len(spec["ports"])]
        eps = rng.choice(len(pods), int(n_ep[i]), replace=False)
        out.append(ServiceEntry(
            cluster_ip=u32_to_ip(_SERVICE_NET + 1 + i), port=port,
            protocol=proto, name=f"svc-{i}", namespace="ns-0",
            endpoints=[Endpoint(ip=u32_to_ip(int(pods[e])), port=target)
                       for e in eps],
            affinity_timeout_s=int(spec["affinity_s"]) if aff[i] else 0))
    return out


def build(config: dict):
    ps, _, topo, pods, local = np_scale_test.build(config)
    return ps, services(config["services"], pods), topo, pods, local
