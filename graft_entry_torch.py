"""Driver entry points of the PyTorch port: a single-card step and a
multi-shard dry run (the port's counterpart of __graft_entry__.py).

entry(device=None) returns the port's single-card forward step, the full
per-packet walk (flow-cache fast path, ServiceLB/DNAT, conjunctive-match
classification, forwarding; models/forwarding.pipeline_step_full), with
small example args on `device` (None: the card, which raises without
CUDA).  The step is eager PyTorch: fn(*args) runs it, nothing compiles.

dryrun_multichip(n) builds the mesh engine (parallel/meshpath
.MeshDatapath) on an in-process mesh of n shards on the CPU, (n/2, 2)
(n/2 data replicas, 2 rule shards; (1, n) when n is odd), steps a tiny
world twice and checks the verdicts against the single-card engine and
that the second step serves established flows from the replicas' caches.

    python3 -c "import graft_entry_torch as g; g.dryrun_multichip(8)"
"""

import numpy as np


def _tiny_world(seed: int = 7):
    """A 96-rule, 16-service world seen from node-0, and a 256-lane batch
    with mixed in_ports (some spoofed) and FIN lanes -> (PolicySet,
    services, Topology, PacketBatch)."""
    from antrea_tpu_torch.compiler.topology import NodeRoute, Topology
    from antrea_tpu_torch.packet import PacketBatch
    from antrea_tpu_torch.simulator import (gen_cluster, gen_services,
                                            gen_traffic)
    from antrea_tpu_torch.utils import ip as iputil

    cluster = gen_cluster(96, n_nodes=4, pods_per_node=8, seed=seed)
    services = gen_services(16, cluster.pod_ips, seed=seed + 1)
    # Node-0's pods are local (ofports 3..), node-1's pod CIDR the remote
    # route, so cross-node lanes tunnel and mixed in_ports spoof.
    topo = Topology(
        node_name="node-0", pod_cidr="10.0.0.0/24",
        local_pods=[(iputil.u32_to_ip(int(u)), 3 + i)
                    for i, u in enumerate(cluster.pod_ips[:8])],
        remote_nodes=[NodeRoute(name="node-1", node_ip="192.168.0.2",
                                pod_cidr="10.0.1.0/24")])
    tr = gen_traffic(cluster.pod_ips, 256, n_flows=64, seed=seed + 2,
                     services=services, svc_fraction=0.3)
    b = tr.src_ip.shape[0]
    batch = PacketBatch(
        src_ip=tr.src_ip, dst_ip=tr.dst_ip, proto=tr.proto,
        src_port=tr.src_port, dst_port=tr.dst_port,
        in_port=np.array([(-1, 1, 2, 3, 4, 5)[i % 6] for i in range(b)],
                         np.int32),
        tcp_flags=np.where(np.arange(b) % 7 == 0, 1, 0).astype(np.int32))
    return cluster.ps, services, topo, batch


def entry(device=None):
    """-> (fn, example_args): the single-card full walk and its inputs on
    `device`; fn(*example_args) -> (state, outputs)."""
    import torch

    from antrea_tpu_torch.compiler.compile import compile_policy_set
    from antrea_tpu_torch.compiler.services import compile_services
    from antrea_tpu_torch.compiler.topology import compile_topology
    from antrea_tpu_torch.models import forwarding as fwd
    from antrea_tpu_torch.models import pipeline as pl
    from antrea_tpu_torch.utils import ip as iputil

    ps, services, topo, b = _tiny_world()
    step, state, (drs, dsvc) = pl.make_pipeline(
        compile_policy_set(ps), compile_services(services),
        flow_slots=1 << 12, aff_slots=1 << 10, miss_chunk=128,
        device=device)
    dev = state.flow.keys.device
    dft = fwd.fwd_to_device(compile_topology(topo), dev)
    meta = step.meta

    def lane(a):
        a = np.ascontiguousarray(a)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        return torch.from_numpy(a.astype(np.int32)).to(dev)

    def fn(state, drs, dsvc, dft, src_f, dst_f, proto, sport, dport,
           in_port, flags, now, gen):
        return fwd.pipeline_step_full(state, drs, dsvc, dft, src_f, dst_f,
                                      proto, sport, dport, in_port, now, gen,
                                      flags, meta=meta)

    example_args = (
        state, drs, dsvc, dft, lane(iputil.flip_u32(b.src_ip)),
        lane(iputil.flip_u32(b.dst_ip)), lane(b.proto), lane(b.src_port),
        lane(b.dst_port), lane(b.in_ports()), lane(b.flags()), 100, 0)
    return fn, example_args


def dryrun_multichip(n_devices: int) -> None:
    """Build and step the mesh engine on an in-process mesh of n_devices
    shards on the CPU; raises AssertionError if a check fails."""
    from antrea_tpu_torch.datapath import TpuflowDatapath
    from antrea_tpu_torch.parallel import MeshDatapath

    n = int(n_devices)
    n_data, n_rule = (n // 2, 2) if n % 2 == 0 else (1, n)
    ps, services, topo, b = _tiny_world()
    kw = dict(flow_slots=1 << 12, aff_slots=1 << 10, topology=topo,
              device="cpu")
    mesh = MeshDatapath(ps, services, n_data=n_data, n_rule=n_rule, **kw)
    one = TpuflowDatapath(ps, services, **kw)
    for now in (100, 101):
        got, want = mesh.step(b, now), one.step(b, now)
        assert got.code.shape == (b.size,)
        for f in ("code", "svc_idx", "dnat_ip", "dnat_port", "spoofed",
                  "fwd_kind", "out_port"):
            assert np.array_equal(getattr(got, f), getattr(want, f)), f
        assert got.ingress_rule == want.ingress_rule
        assert got.egress_rule == want.egress_rule
    assert int(got.est.sum()) > 0  # the replicas' caches served
    st = mesh.mesh_stats()
    assert st["mesh"] == {"data": n_data, "rule": n_rule}
    print(f"[dryrun] mesh ({n_data}, {n_rule}) on the CPU: 2 steps of "
          f"{b.size} lanes, verdicts equal to one card, "
          f"{int(got.est.sum())} established hits", flush=True)
