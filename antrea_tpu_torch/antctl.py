"""antctl: the operator CLI.

The analog of the reference's antctl command surface
(pkg/antctl/antctl.go command table; raw commands under
pkg/antctl/raw — traceflow, query, supportbundle): operates on the on-disk
state this build persists (datapath snapshots from datapath/persist.py,
agent filestores) — the way the reference's antctl reads controller/agent
APIs backed by the same state.

Usage (python -m antrea_tpu_torch.antctl ...):
  get networkpolicies  --state DIR        list policies in a snapshot
  get addressgroups    --state DIR
  get appliedtogroups  --state DIR
  get services         --state DIR
  traceflow --state DIR --src IP --dst IP [--proto N] [--sport N] [--dport N]
        ofproto/trace analog: builds a datapath from the snapshot and
        reports the per-stage observations for a crafted probe packet.
  query endpoint --state DIR --namespace NS --pod NAME --ip IP
        endpoint querier over snapshot policies (group membership by ip).
  version

Live-agent mode (the reference's antctl "agent mode" over the localhost
API, docs/design/architecture.md:82-90; server: agent/apiserver.py):
  get {networkpolicies,addressgroups,appliedtogroups,podinterfaces,
       ovsflows,memberlist,featuregates,agentinfo,cache} --server URL
  traceflow --server URL --src IP --dst IP [...]
  metrics --server URL
  audit --server URL [--force] [--now N]
        continuous-revalidator status (GET /audit: cursor position,
        coverage ratio, last divergence); --force triggers a synchronous
        full-cache sweep on the agent before reporting
  maintenance --server URL [--tick] [--now N] [--budget B]
        unified background-plane scheduler state (GET /maintenance:
        per-task runs/budget-spent/deferrals/shed, scheduler lag);
        --tick runs one synchronous budgeted scheduler round first
  failover --server URL [--readmit]
        replica-loss failover state (GET /failover: phase, quarantined
        shard, probe/evacuation/readmission totals, tenant worlds
        pending evacuation); --readmit re-admits a healed replica via
        the certified path
  realization --server URL [--uid POLICY] [--json]
        realization-tracing span table (GET /realization: per-policy
        stage timelines controller-commit -> first live hit); default
        output is a per-span stage table, --json the raw body
  flightrecorder --server URL [--tail N] [--kind EVENT] [--json]
        post-mortem event journal (GET /flightrecorder: drop-oldest ring,
        monotonic seq, tick-clock timestamps); default output is one
        line per event in sequence order, --json the raw body
  telemetry --server URL [--json]
        hot-path telemetry plane (GET /telemetry: counter totals,
        per-scope per-regime latencies, sentinel state)
  serving --server URL [--json]
        serving-batcher state (GET /serving: canonical ladder + flush
        knobs, admission/shed/flush meters, per-world staged depth and
        staging-wait p99)
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

VERSION = "0.3.0-tpu"

# Verdict code -> name (single copy for this CLI; .get-safe like
# observability/audit.py's map).
_VERDICT = {0: "Allow", 1: "Drop", 2: "Reject"}


def _load(state_dir: str):
    from .datapath import persist

    snap = persist.load_snapshot(state_dir)
    if snap is None:
        raise SystemExit(f"antctl: no readable snapshot in {state_dir}")
    return snap


def _fetch(server: str, path: str) -> str:
    from urllib.error import HTTPError, URLError
    from urllib.request import urlopen

    try:
        with urlopen(server.rstrip("/") + path, timeout=10) as r:
            return r.read().decode()
    except HTTPError as e:
        raise SystemExit(f"antctl: agent returned {e.code} for {path}")
    except (URLError, OSError) as e:
        raise SystemExit(f"antctl: cannot reach agent at {server}: {e}")


def _cmd_get(args) -> int:
    if getattr(args, "server", None):
        if args.kind == "services":
            raise SystemExit(
                "antctl: services is snapshot-only (--state); the live "
                "agent serves the installed frontends via ovsflows/cache"
            )
        # policystatus/controllerinfo are served by the CONTROLLER api
        # server (controller/apiserver.py) — same fetch path, the kind is
        # simply a controller route (realization phases per policy,
        # status_controller.go analog).
        print(json.dumps(json.loads(_fetch(args.server, "/" + args.kind)),
                         indent=2))
        return 0
    if args.state is None:
        raise SystemExit("antctl: get needs --state or --server")
    if args.kind in ("policystatus", "controllerinfo"):
        raise SystemExit(
            f"antctl: {args.kind} is only served live by the controller "
            "api server (--server)"
        )
    if args.kind not in (
        "networkpolicies", "addressgroups", "appliedtogroups", "services"
    ):
        raise SystemExit(f"antctl: {args.kind} is only served live (--server)")
    ps, services, gen = _load(args.state)
    if args.kind == "networkpolicies":
        rows = [
            {
                "uid": p.uid, "name": p.name, "namespace": p.namespace,
                "type": p.type.value, "tierPriority": p.tier_priority,
                "priority": p.priority, "rules": len(p.rules),
            }
            for p in ps.policies
        ]
    elif args.kind == "addressgroups":
        rows = [
            {"name": k, "members": len(g.members), "ipBlocks": len(g.ip_blocks)}
            for k, g in sorted(ps.address_groups.items())
        ]
    elif args.kind == "appliedtogroups":
        rows = [
            {"name": k, "members": len(g.members)}
            for k, g in sorted(ps.applied_to_groups.items())
        ]
    elif args.kind == "services":
        rows = [
            {
                "name": s.name or s.cluster_ip, "clusterIP": s.cluster_ip,
                "port": s.port, "protocol": s.protocol,
                "endpoints": len(s.endpoints), "nodePort": s.node_port,
                "externalIPs": list(s.external_ips),
            }
            for s in services
        ]
    else:  # pragma: no cover - argparse restricts choices
        raise SystemExit(f"unknown kind {args.kind}")
    print(json.dumps({"generation": gen, "items": rows}, indent=2))
    return 0


def _cmd_traceflow(args) -> int:
    from .datapath import OracleDatapath
    from .packet import PacketBatch
    from .utils import ip as iputil

    if args.live:
        # Live-traffic mode (the reference's liveTraffic Traceflow):
        # samples a REAL packet from the node's traffic, so it only works
        # against a live agent.  Unset ports/proto wildcard the filter.
        if not getattr(args, "server", None):
            raise SystemExit("antctl: traceflow --live needs --server "
                             "(live traffic is sampled on the agent)")
        qs = (f"/traceflow?live=1&src={args.src or ''}&dst={args.dst or ''}"
              f"&proto={args.proto if args.proto is not None else 0}"
              f"&sport={args.sport or 0}&dport={args.dport or 0}"
              f"&sampling={args.sampling}&wait={args.wait}"
              + ("&dropped_only=1" if args.dropped_only else ""))
        st = json.loads(_fetch(args.server, qs))
        print(json.dumps(st, indent=2, default=str))
        return 0 if st.get("phase") == "Succeeded" else 1
    if not args.src or not args.dst:
        raise SystemExit("antctl: traceflow needs --src and --dst")
    args.proto = 6 if args.proto is None else args.proto
    args.sport = 40000 if args.sport is None else args.sport
    args.dport = 80 if args.dport is None else args.dport
    if getattr(args, "server", None):
        qs = (f"/traceflow?src={args.src}&dst={args.dst}&proto={args.proto}"
              f"&sport={args.sport}&dport={args.dport}")
        obs = json.loads(_fetch(args.server, qs))
        obs["verdict"] = _VERDICT.get(obs["code"], "?")
        print(json.dumps(obs, indent=2, default=str))
        return 0
    if args.state is None:
        raise SystemExit("antctl: traceflow needs --state or --server")
    ps, services, _gen = _load(args.state)
    dp = OracleDatapath(ps, services, flow_slots=1 << 10, aff_slots=1 << 8)
    batch = PacketBatch(
        src_ip=np.array([iputil.ip_to_u32(args.src)], np.uint32),
        dst_ip=np.array([iputil.ip_to_u32(args.dst)], np.uint32),
        proto=np.array([args.proto], np.int32),
        src_port=np.array([args.sport], np.int32),
        dst_port=np.array([args.dport], np.int32),
    )
    obs = dp.trace(batch, now=0)[0]
    obs["verdict"] = _VERDICT.get(obs["code"], "?")
    obs["dnat_ip"] = iputil.u32_to_ip(obs["dnat_ip"])
    print(json.dumps(obs, indent=2, default=str))
    return 0


def _cmd_supportbundle(args) -> int:
    """Collect a support bundle from persisted state (the antctl
    supportbundle raw command, ref pkg/antctl/raw/supportbundle): rebuilds
    a datapath from the snapshot and tars its observable surfaces."""
    from .datapath import OracleDatapath
    from .observability.supportbundle import collect_bundle

    _load(args.state)  # fail fast with the CLI error on a bad state dir
    # Reconstruct THROUGH the persistence path so the bundle's meta.json
    # carries the snapshot's real generation (cookie round), not 0.
    dp = OracleDatapath(flow_slots=1 << 10, aff_slots=1 << 8,
                        persist_dir=args.state)
    members = collect_bundle(
        dp, args.out, node=args.node, now=0, persist_dir=args.state,
    )
    print(json.dumps({"bundle": args.out, "members": members}, indent=2))
    return 0


def _cmd_check(args) -> int:
    """Installation checkers (ref pkg/antctl/raw/check: post-install
    validation probes run as test pods; here: in-process self-diagnostics
    over the same surfaces).  Exit 0 iff every check passes.  The
    engines run on the card unless --device cpu is given; without CUDA
    the command raises before any check runs."""
    import tempfile

    from .ops.match import resolve_device

    device = resolve_device(args.device)
    checks: list[tuple[str, str]] = []

    def run(name, fn):
        try:
            fn()
            checks.append((name, "ok"))
        except Exception as e:
            checks.append((name, f"FAIL: {type(e).__name__}: {e}"))

    def chk_native():
        from .native import ConfigStore, native_available

        with tempfile.TemporaryDirectory() as d:
            s = ConfigStore(d + "/c.db")
            s.set("k", b"v")
            s.commit()
            assert s.get("k") == b"v"
            # The check is named native-store: a silent Python-journal
            # fallback must FAIL it, not masquerade as healthy.
            assert native_available(), (
                "native backend unavailable (python fallback active)"
            )

    def chk_datapath_parity():
        import copy

        from .datapath import OracleDatapath, TpuflowDatapath
        from .packet import PacketBatch
        from .simulator import gen_cluster, gen_traffic

        cluster = gen_cluster(40, n_nodes=2, pods_per_node=4, seed=99)
        b = gen_traffic(cluster.pod_ips, 32, n_flows=16, seed=98)
        tpu = TpuflowDatapath(copy.deepcopy(cluster.ps), flow_slots=1 << 10,
                              aff_slots=1 << 8, miss_chunk=32, device=device)
        orc = OracleDatapath(copy.deepcopy(cluster.ps), flow_slots=1 << 10,
                             aff_slots=1 << 8)
        ra, rb = tpu.step(b, now=1), orc.step(b, now=1)
        assert ra.code.tolist() == rb.code.tolist()

    def chk_persistence():
        from .datapath import TpuflowDatapath

        with tempfile.TemporaryDirectory() as d:
            dp = TpuflowDatapath(flow_slots=1 << 10, aff_slots=1 << 8,
                                 miss_chunk=32, persist_dir=d, device=device)
            g = dp.install_bundle()
            dp2 = TpuflowDatapath(flow_slots=1 << 10, aff_slots=1 << 8,
                                  miss_chunk=32, persist_dir=d, device=device)
            assert dp2.generation >= g

    run("native-store", chk_native)
    run("datapath-parity", chk_datapath_parity)
    run("persistence-roundtrip", chk_persistence)
    for name, status in checks:
        print(f"{name}: {status}")
    return 0 if all(s == "ok" for _, s in checks) else 1


def _cmd_audit(args) -> int:
    """Continuous-revalidator status / forced full sweep over the live
    agent API (datapath/audit.py; route GET /audit on agent/apiserver)."""
    path = "/audit"
    if args.force:
        path += f"?force=1&now={args.now}"
    print(json.dumps(json.loads(_fetch(args.server, path)), indent=2))
    return 0


def _cmd_maintenance(args) -> int:
    """Unified maintenance-scheduler status / forced synchronous tick
    over the live agent API (datapath/maintenance.py; route
    GET /maintenance on agent/apiserver)."""
    path = "/maintenance"
    if not args.tick and (args.budget is not None or args.now):
        # A budget/now with no tick would be dropped on the floor while
        # the command prints plain status as if it took effect.
        print("antctl maintenance: --budget/--now require --tick",
              file=sys.stderr)
        return 2
    if args.tick:
        path += "?tick=1"
        if args.now:
            path += f"&now={args.now}"  # 0/unset: the scheduler clock advances itself
        if args.budget is not None:
            path += f"&budget={args.budget}"
    print(json.dumps(json.loads(_fetch(args.server, path)), indent=2))
    return 0


def _cmd_failover(args) -> int:
    """Replica-loss failover status / operator re-admission over the
    live agent API (parallel/failover.py; route GET /failover on
    agent/apiserver).  The body includes `tenants_pending_evacuation`
    — the tenant worlds still serving masked or latched behind the
    fleet topology.  --readmit triggers the certified re-admission: a
    pre-flip heal unmasks, an evacuated replica rejoins via the
    ordinary certified grow-resize — never a blind flip."""
    path = "/failover"
    if args.readmit:
        path += "?readmit=1"
    print(json.dumps(json.loads(_fetch(args.server, path)), indent=2))
    return 0


def _cmd_realization(args) -> int:
    """Realization span timelines over the live agent API
    (observability/tracing.py; route GET /realization)."""
    path = "/realization"
    if args.uid:
        from urllib.parse import quote
        path += f"?uid={quote(args.uid, safe='')}"
    body = json.loads(_fetch(args.server, path))
    if args.json:
        print(json.dumps(body, indent=2))
        return 0
    print(f"spans: pending={body['pending']} "
          f"awaiting_first_hit={body['awaiting_first_hit']} "
          f"closed={body['closed']} "
          f"dropped={body['spans_dropped_total']} "
          f"unstamped={body['unstamped_total']} "
          f"p99_s={body['p99_s']}")
    stages = body["stages"]
    hdr = ["UID", "GEN", "BUNDLE", "STATE", *[s.upper() for s in stages],
           "TOTAL_S"]
    rows = []
    for sp in body["spans"]:
        st = sp.get("stages_s") or {}
        rows.append([
            sp["uid"], str(sp["generation"]),
            str(sp.get("bundle_generation", "-")), sp["state"],
            *[f"{st[s]:.6f}" if s in st else "-" for s in stages],
            f"{sp['total_s']:.6f}" if "total_s" in sp else "-",
        ])
    _print_table(hdr, rows)
    return 0


def _cmd_flightrecorder(args) -> int:
    """Flight-recorder journal over the live agent API
    (observability/flightrec.py; route GET /flightrecorder)."""
    path = "/flightrecorder"
    q = []
    if args.tail is not None:
        q.append(f"tail={args.tail}")
    if args.kind:
        from urllib.parse import quote
        q.append(f"kind={quote(args.kind, safe='')}")
    if q:
        path += "?" + "&".join(q)
    body = json.loads(_fetch(args.server, path))
    if args.json:
        print(json.dumps(body, indent=2))
        return 0
    print(f"journal: seq={body['seq']} retained={body['retained']}/"
          f"{body['capacity']} dropped={body['dropped_total']}")
    rows = []
    for e in body["events"]:
        extra = {k: v for k, v in e.items()
                 if k not in ("seq", "ts", "kind")}
        rows.append([str(e["seq"]), str(e["ts"]), e["kind"],
                     " ".join(f"{k}={v}" for k, v in extra.items())])
    _print_table(["SEQ", "TS", "KIND", "FIELDS"], rows)
    return 0


def _cmd_telemetry(args) -> int:
    """Hot-path telemetry plane over the live agent API
    (observability/telemetry.py; route GET /telemetry)."""
    body = json.loads(_fetch(args.server, "/telemetry"))
    if args.json:
        print(json.dumps(body, indent=2))
        return 0
    print("counters: " + " ".join(
        f"{k}={v}" for k, v in body["counters"].items()))
    print(f"steps={body['steps_total']} sweeps={body['sweeps_total']} "
          f"regressions={body['regressions_total']}")
    rows = []
    for scope, regs in body["regimes"].items():
        for regime, row in regs.items():
            rows.append([scope, regime, str(row["count"]),
                         f"{row['p50_seconds']:.6f}",
                         f"{row['p99_seconds']:.6f}"])
    _print_table(["SCOPE", "REGIME", "STEPS", "P50-S", "P99-S"], rows)
    srows = [
        [regime, str(row["window_samples"]), str(row["baseline_samples"]),
         f"{row['baseline_p99_seconds']:.6f}"]
        for regime, row in body["sentinel"].items()
    ]
    _print_table(["REGIME", "WINDOW", "BASELINE", "BASE-P99-S"], srows)
    return 0


def _cmd_serving(args) -> int:
    """Serving-batcher state over the live agent API
    (serving/batcher.py; route GET /serving)."""
    body = json.loads(_fetch(args.server, "/serving"))
    if args.json:
        print(json.dumps(body, indent=2))
        return 0
    sizes = ",".join(str(s) for s in body["canonical_sizes"])
    print(f"ladder=[{sizes}] flush_depth={body['flush_depth']} "
          f"flush_deadline={body['flush_deadline']} "
          f"ring_slots={body['ring_slots']}")
    print(f"submitted={body['submitted_lanes']} shed={body['shed_lanes']} "
          f"flushed={body['flushed_lanes']} padded={body['padded_lanes']} "
          f"dispatches={body['dispatches']} "
          f"deadline_exceeded={body['deadline_exceeded']}")
    print("flushes: " + " ".join(
        f"{k}={v}" for k, v in sorted(body["flushes"].items())))
    rows = [
        [str(tid), str(row["staged_lanes"]), str(row["flushed_lanes"]),
         str(row["starved"]), f"{row['wait_p99_ticks']:.1f}"]
        for tid, row in body["worlds"].items()
    ]
    _print_table(["TENANT", "STAGED", "FLUSHED", "STARVED", "WAIT-P99-T"],
                 rows)
    return 0


def _print_table(header: list, rows: list) -> None:
    """Fixed-width column table (the reference antctl's output shape)."""
    widths = [len(h) for h in header]
    for r in rows:
        for i, cell in enumerate(r):
            widths[i] = max(widths[i], len(cell))
    for r in [header] + rows:
        print("  ".join(cell.ljust(w) for cell, w in zip(r, widths)).rstrip())


def _cmd_query_endpoint(args) -> int:
    """Snapshot-based endpoint query: membership sets computed by pod IP,
    then the shared policy scan (controller/endpoint_querier.scan_policies
    — the live-index variant is query_endpoint there)."""
    from .controller.endpoint_querier import scan_policies

    ps, _services, _gen = _load(args.state)
    applied_groups = {
        k for k, g in ps.applied_to_groups.items()
        if any(m.ip == args.ip for m in g.members)
    }
    peer_groups = {
        k for k, g in ps.address_groups.items()
        if any(m.ip == args.ip for m in g.members)
    }
    applied, ingress_from, egress_to = scan_policies(
        ps.policies, applied_groups, peer_groups
    )
    print(json.dumps({
        "endpoint": {"namespace": args.namespace, "pod": args.pod, "ip": args.ip},
        "appliedPolicies": [
            {"policy": uid, "rules": rules} for uid, rules in applied
        ],
        "ingressFrom": [{"policy": u, "rule": i} for u, i in ingress_from],
        "egressTo": [{"policy": u, "rule": i} for u, i in egress_to],
    }, indent=2))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="antctl")
    sub = ap.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("get", help="list objects (snapshot or live agent)")
    g.add_argument("kind", choices=[
        "networkpolicies", "addressgroups", "appliedtogroups", "services",
        "podinterfaces", "ovsflows", "memberlist", "featuregates",
        "agentinfo", "cache",
        # live-CONTROLLER kinds (--server points at a ControllerApiServer):
        "policystatus", "controllerinfo",
    ])
    g.add_argument("--state", help="datapath persist dir")
    g.add_argument("--server", help="live agent API base URL")
    g.set_defaults(fn=_cmd_get)

    m = sub.add_parser("metrics", help="Prometheus metrics from a live agent")
    m.add_argument("--server", required=True)
    m.set_defaults(fn=lambda a: (print(_fetch(a.server, "/metrics"), end=""), 0)[1])

    t = sub.add_parser(
        "traceflow",
        help="trace a crafted probe packet, or sample live traffic (--live)",
    )
    t.add_argument("--state")
    t.add_argument("--server", help="live agent API base URL")
    t.add_argument("--src", default="")
    t.add_argument("--dst", default="")
    # None = per-mode default: probe mode fills 6/40000/80 (a crafted
    # packet needs concrete fields), live mode wildcards unset fields.
    t.add_argument("--proto", type=int, default=None)
    t.add_argument("--sport", type=int, default=None)
    t.add_argument("--dport", type=int, default=None)
    t.add_argument("--live", action="store_true",
                   help="sample a real packet (liveTraffic mode)")
    t.add_argument("--dropped-only", action="store_true", dest="dropped_only",
                   help="live mode: only capture denied packets")
    t.add_argument("--sampling", type=int, default=1,
                   help="live mode: capture the Nth matching packet")
    t.add_argument("--wait", type=float, default=5.0,
                   help="live mode: seconds to wait for a match")
    t.set_defaults(fn=_cmd_traceflow)

    q = sub.add_parser("query", help="query subcommands")
    qsub = q.add_subparsers(dest="what", required=True)
    qe = qsub.add_parser("endpoint")
    qe.add_argument("--state", required=True)
    qe.add_argument("--namespace", default="default")
    qe.add_argument("--pod", default="")
    qe.add_argument("--ip", required=True)
    qe.set_defaults(fn=_cmd_query_endpoint)

    au = sub.add_parser(
        "audit", help="cache-revalidator status / forced full sweep"
    )
    au.add_argument("--server", required=True, help="live agent API base URL")
    au.add_argument("--force", action="store_true",
                    help="run a synchronous full-cache sweep first")
    au.add_argument("--now", type=int, default=0,
                    help="packet-clock seconds for the forced sweep")
    au.set_defaults(fn=_cmd_audit)

    mt = sub.add_parser(
        "maintenance",
        help="background-plane scheduler status / forced tick",
    )
    mt.add_argument("--server", required=True, help="live agent API base URL")
    mt.add_argument("--tick", action="store_true",
                    help="run one synchronous scheduler tick first")
    mt.add_argument("--now", type=int, default=0,
                    help="tick-clock seconds for the forced tick")
    mt.add_argument("--budget", type=int, default=None,
                    help="total budget units for the forced tick")
    mt.set_defaults(fn=_cmd_maintenance)

    fo = sub.add_parser(
        "failover",
        help="replica-loss failover status / certified re-admission",
    )
    fo.add_argument("--server", required=True, help="live agent API base URL")
    fo.add_argument("--readmit", action="store_true",
                    help="re-admit the quarantined replica (certified "
                         "grow-resize; pre-flip heal just unmasks)")
    fo.set_defaults(fn=_cmd_failover)

    rz = sub.add_parser(
        "realization",
        help="per-policy realization span timelines (tracing plane)",
    )
    rz.add_argument("--server", required=True, help="live agent API base URL")
    rz.add_argument("--uid", default="", help="filter to one policy uid")
    rz.add_argument("--json", action="store_true", help="raw JSON body")
    rz.set_defaults(fn=_cmd_realization)

    fr = sub.add_parser(
        "flightrecorder",
        help="post-mortem event journal (flight-recorder plane)",
    )
    fr.add_argument("--server", required=True, help="live agent API base URL")
    fr.add_argument("--tail", type=int, default=None,
                    help="keep only the last N events (after filtering)")
    fr.add_argument("--kind", default="",
                    help="filter by event kind (see EVENT_KINDS)")
    fr.add_argument("--json", action="store_true", help="raw JSON body")
    fr.set_defaults(fn=_cmd_flightrecorder)

    tl = sub.add_parser(
        "telemetry",
        help="hot-path telemetry counters / regime latencies / sentinel",
    )
    tl.add_argument("--server", required=True, help="live agent API base URL")
    tl.add_argument("--json", action="store_true", help="raw JSON body")
    tl.set_defaults(fn=_cmd_telemetry)

    sv = sub.add_parser(
        "serving",
        help="serving-batcher ladder / flush meters / per-world wait p99",
    )
    sv.add_argument("--server", required=True, help="live agent API base URL")
    sv.add_argument("--json", action="store_true", help="raw JSON body")
    sv.set_defaults(fn=_cmd_serving)

    c = sub.add_parser("check", help="installation self-diagnostics")
    c.add_argument("--device", default=None,
                   help="the engines' device (default: the card; cpu to "
                        "run them on the CPU)")
    c.set_defaults(fn=_cmd_check)

    sb = sub.add_parser("supportbundle", help="collect a diagnostic bundle")
    sb.add_argument("--state", required=True)
    sb.add_argument("--out", required=True, help="output .tar.gz path")
    sb.add_argument("--node", default="")
    sb.set_defaults(fn=_cmd_supportbundle)

    v = sub.add_parser("version")
    v.set_defaults(fn=lambda a: (print(VERSION), 0)[1])

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
