"""A world with ClusterIP Services, for the tests and for a trial of
Service traffic: np_scale_test's cluster, span and topology, plus the
configuration's `services`:

- count: ClusterIP Services, frontends 10.96.0.0/12 upward (Kubernetes'
  default Service range), each on a (protocol, port, target port) of
  `ports` in turn;
- endpoints: [lo, hi], each Service's endpoint count, uniform, drawn
  over every Pod of the cluster (the agent proxies for the whole
  cluster); `no_endpoints` of the Services have none;
- affinity_share of the Services use ClientIP affinity with the timeout
  affinity_s;
- seed: the draw of all of it.

As a world module it is flowbench/worlds/<world>.py's shape: build(config)
-> (PolicySet, Services, Topology, pod addresses, local pod addresses)."""

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
