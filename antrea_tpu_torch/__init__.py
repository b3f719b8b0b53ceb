"""antrea_tpu_torch: the PyTorch/CUDA port of the tpuflow datapath.

A second package beside the JAX one, laid out the same way so every module
has an obvious counterpart:

  apis/, utils/ip.py, compiler/, packet.py, simulator/
               host-side numpy code, kept as this package's own copies;
               simulator/fleet.py is the watch-only fake-agent fleet
               (inproc or over the mTLS wire) and its churn storm
  ops/         the classifier with its aggregate-pruned walk (match.py),
               the FNV hashes (hashing.py) and the wrappers of the
               hand-written CUDA kernels: B1 (consumer.py), B2
               (pruned_consumer.py), B3 (onepass.py) and the cold-path
               study's S1 (consumer2.py)
  models/      the v4 pipeline step, staged or one-pass, with its phase
               masks and maintenance scans (pipeline.py), and the phase
               profiler (profile.py)
  csrc/        CUDA C++ sources for sm_90a, built on first use by _build.py
  utils/timing.py
               CUDA-event timing (device_time, device_loop_time)
  datapath/    the engine (tpuflow.py) with its planes, tenant worlds
               included, and the scalar twin engine (oracle_dp.py)
  serving/     the serving batcher in front of step_tenants
  native/      the journaled config store (ovsdb_lite.cc, built with g++
               on first use) that persist_dir's round journal uses
  parallel/    the torch.distributed mesh (mesh.py) and the mesh engine
               in one process (meshpath.py), with live resharding
               (reshard.py) and replica-loss failover (failover.py)
  oracle/      the scalar Oracle and the scalar twin's pipeline
  controller/  the NetworkPolicy controller and its grouping index, the
               status plane (status.py: StatusAggregator), the
               controller's API server (apiserver.py), traceflow and the
               endpoint querier, and the engine-free controllers
               (certificates, egress, externalippool, serviceexternalip,
               externalnode, stats)
  dissemination/
               the watch store, the mTLS wire, the pipe transport to a
               child agent process, serde and fault injection
  agent/       the agent that drives the engine (controller.py), its
               surfaces (apiserver, noderoute, fqdn, packetcapture) and
               its host programs: packet-in, IGMP snooping (multicast),
               NodePortLocal, CNI and secondary networks, memberlist and
               gossip, BGP, IP assigner, IPsec, WireGuard, routes, the
               monitor tool
  multicluster/
               ClusterSet service export and import, ACNP replication,
               the gateways
  observability/
               audit logging, metrics, the flight recorder, realization
               tracing, telemetry, flow export, agentinfo, support bundles
  antctl.py, clusteridentity.py
               the CLI; the cluster's identity

Every tensor on the datapath is an int32 word; u32 tables are kept as int32
tensors with identical bits.  Entry points run on the card unless the caller
passes device="cpu"; on CPU tensors the kernel wrappers run their plain
PyTorch versions.
"""

__version__ = "0.1.0"
