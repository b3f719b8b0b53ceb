"""Agent API server: localhost REST for the operator CLI.

The analog of pkg/agent/apiserver (3,800 LoC): the agent
serves a loopback HTTPS API that antctl reaches for live node state —
handlers under pkg/agent/apiserver/handlers/: agentinfo, podinterface,
ovsflows, ovstracing, networkpolicy, memberlist, featuregates, plus the
Prometheus metrics endpoint (pkg/agent/metrics).

Here: a stdlib ThreadingHTTPServer bound to 127.0.0.1 serving JSON (and
Prometheus text for /metrics) straight off the live objects the agent
already holds — the same state those reference handlers query.  antctl's
`--server` mode consumes it (antctl.py), mirroring the reference's antctl
"agent mode" via the localhost endpoint (docs/design/architecture.md:82-90).

Routes:
  GET /agentinfo        AntreaAgentInfo heartbeat body (observability/agentinfo)
  GET /metrics          Prometheus text (observability/metrics)
  GET /podinterfaces    interface store rows
  GET /networkpolicies  agent-held computed policies
  GET /addressgroups    agent-held address groups
  GET /appliedtogroups  agent-held appliedTo groups
  GET /ovsflows?now=N   conntrack/flow-cache dump (Datapath.dump_flows)
  GET /cache            flow-cache census (Datapath.cache_stats)
  GET /commitplane      bundle commit-plane state (Datapath.commit_stats:
                        degraded flag, LKG generation/age, per-stage
                        commit outcomes, rollback/canary counters — the
                        operator's first stop when a policy push is
                        rejected; see datapath/commit.py)
  GET /audit            continuous-revalidator status (datapath/audit.py:
                        cursor position, coverage ratio, per-kind
                        divergences, scrub outcomes, last divergence);
                        ?force=1 runs a synchronous full-cache sweep first
                        (the antctl audit --force path), serialized by the
                        maintenance scheduler
  GET /maintenance      unified background-plane scheduler state
                        (datapath/maintenance.py: tick/blocked counters,
                        per-task runs/budget-spent/deferrals/shed,
                        scheduler lag); ?tick=1[&now=N&budget=B] runs one
                        synchronous scheduler tick first (the antctl
                        maintenance --tick path)
  GET /realization      realization-tracing span table (observability/
                        tracing.py: per-policy stage timelines controller
                        commit -> first live hit, plus tracer occupancy/
                        drop meters); ?uid= filters to one policy
  GET /flightrecorder   post-mortem event journal (observability/
                        flightrec.py: ring stats + events in sequence
                        order); ?tail=N keeps the last N, ?kind= filters
                        by event kind
  GET /telemetry        hot-path telemetry plane (observability/
                        telemetry.py: in-kernel counter totals, per-scope
                        per-regime step-latency summaries, sentinel
                        window/baseline state); 404 when the datapath was
                        built telemetry=False
  GET /serving          serving-batcher state (serving/batcher.py:
                        canonical ladder + flush knobs, admission/shed/
                        flush meters, per-world staged depth, starvation
                        and staging-wait p99); 404 when the batcher was
                        never materialized
  GET /memberlist       alive members of the gossip cluster
  GET /featuregates     feature gate states
  GET /traceflow?src=IP&dst=IP[&proto=N&sport=N&dport=N&in_port=N&now=N]
                        live ofproto/trace analog (Datapath.trace probe)
  GET /traceflow?live=1&...[&dropped_only=1&sampling=N&wait=S]
                        live-traffic Traceflow (the reference's
                        liveTraffic mode): samples the next REAL packet
                        matching the filter from the node's stepped
                        traffic (requires a TraceflowController tap wired
                        at construction) and returns its per-stage path
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

# The handler-thread contract: every datapath attribute a request
# handler may touch, either directly in the routes below or through the
# /metrics renderers (observability/metrics.py functions taking the
# datapath as a parameter — they run on the handler thread too).  The
# ThreadingHTTPServer gives each request its OWN thread, racing the
# engine thread's steps/drains/world swaps, so everything named here
# must serve from snapshots (the `tenant_stats`/`spans()` discipline).
# In the JAX package the analysis `thread-safety`
# pass fails the build when a handler touches an undeclared attribute,
# when an entry goes stale, or when a declared method's body enters
# `_world_ctx` / mutates engine state (analysis/threads.py there holds
# the reasoned waivers).
HANDLER_SAFE = (
    "stats",
    "dump_flows",
    "cache_stats",
    "commit_stats",
    "audit_stats",
    "maintenance_stats",
    "maintenance_tick",
    "maintenance_force_audit",
    "realization_stats",
    "realization_tracer",
    "realization_tracer.spans",
    "flightrecorder_stats",
    "flightrecorder_events",
    "telemetry_stats",
    "serving_stats",
    # /metrics: the histogram rows are snapshot tuples; Histogram reads
    # are monotonic-counter fetches like step_hist's.
    "telemetry_plane",
    "serving_plane",
    "trace",
    # /agentinfo collector (observability/agentinfo.collect_agent_info
    # receives the live object; generation/datapath_type are single
    # atomic attribute reads).
    "generation",
    "datapath_type",
    # /metrics renderers (render_metrics reads these off the live
    # object; each returns plain host dicts/snapshots).
    "slowpath_stats",
    "prune_stats",
    "mesh_stats",
    "reshard_stats",
    # /failover + /metrics: snapshot dicts off the failover plane; the
    # readmit action delegates to the plane's single-threaded state
    # machine (same operator-action shape as maintenance_tick).
    "failover_stats",
    "failover_readmit",
    "tenant_stats",
    "step_hist",
)


class AgentApiServer:
    def __init__(
        self,
        datapath,
        node: str = "",
        agent=None,  # AgentPolicyController (policy_set)
        ifaces=None,  # InterfaceStore
        memberlist=None,  # MemberlistCluster
        gates=None,  # FeatureGates
        tf_controller=None,  # TraceflowController (live-traffic traceflow)
        host: str = "127.0.0.1",
        port: int = 0,
    ):
        self._dp = datapath
        self._node = node
        self._agent = agent
        self._ifaces = ifaces
        self._memberlist = memberlist
        self._gates = gates
        self._tfc = tf_controller
        # itertools.count: atomic under CPython — concurrent live-trace
        # handlers must never mint the same session name.
        import itertools

        self._live_seq = itertools.count(1)
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet test output
                pass

            def do_GET(self):
                try:
                    body, ctype = outer._route(self.path)
                except KeyError:
                    self.send_error(404)
                    return
                except ValueError as e:
                    self.send_error(400, str(e))
                    return
                except Exception as e:  # noqa: BLE001 — handler boundary:
                    # any other failure (e.g. a datapath raising mid-dump)
                    # must surface to antctl as a diagnosable 500, not a
                    # dropped connection.
                    self.send_error(500, f"{type(e).__name__}: {e}")
                    return
                data = body if isinstance(body, bytes) else body.encode()
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )

    @property
    def address(self) -> str:
        h, p = self._httpd.server_address[:2]
        return f"http://{h}:{p}"

    def start(self) -> "AgentApiServer":
        self._thread.start()
        return self

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()

    # -- routing -------------------------------------------------------------

    def _route(self, path: str):
        u = urlparse(path)
        q = {k: v[0] for k, v in parse_qs(u.query).items()}
        route = u.path.rstrip("/")
        if route == "/metrics":
            from ..observability.metrics import render_metrics

            return render_metrics(self._dp, node=self._node), "text/plain"
        return json.dumps(self._json_route(route, q)), "application/json"

    def _json_route(self, route: str, q: dict):
        from ..utils import ip as iputil

        if route == "/agentinfo":
            from ..observability.agentinfo import collect_agent_info

            return collect_agent_info(
                self._dp, self._node, agent=self._agent,
                now=int(q.get("now", 0)),
            )
        if route == "/podinterfaces":
            rows = self._ifaces.all() if self._ifaces is not None else []
            return [
                {"containerID": ic.container_id, "namespace": ic.pod_namespace,
                 "pod": ic.pod_name, "ip": ic.ip, "ofport": ic.ofport}
                for ic in rows
            ]
        if route in ("/networkpolicies", "/addressgroups", "/appliedtogroups"):
            ps = self._agent.policy_set if self._agent is not None else None
            if ps is None:
                return []
            if route == "/networkpolicies":
                # Per-policy traffic volumes: sum this policy's rule
                # counters from the datapath stats (the NetworkPolicyStats
                # API shape, pkg/apis/stats — rule ids embed the policy
                # uid, compiler/ir.rule_id).
                st = self._dp.stats()
                # One pass per table (rule ids are "{uid}/dir/idx",
                # compiler/ir.rule_id), not a per-policy scan.
                pk, by = {}, {}
                for table, acc in ((st.ingress, pk), (st.egress, pk),
                                   (st.ingress_bytes, by),
                                   (st.egress_bytes, by)):
                    for k, v in (table or {}).items():
                        uid = k.split("/", 1)[0]
                        acc[uid] = acc.get(uid, 0) + v
                return [
                    {"uid": p.uid, "name": p.name, "namespace": p.namespace,
                     "type": p.type.value, "rules": len(p.rules),
                     "packets": pk.get(p.uid, 0),
                     "bytes": by.get(p.uid, 0)}
                    for p in ps.policies
                ]
            table = (
                ps.address_groups if route == "/addressgroups"
                else ps.applied_to_groups
            )
            return [
                {"name": k, "members": len(g.members)}
                for k, g in sorted(table.items())
            ]
        if route == "/ovsflows":
            return self._dp.dump_flows(now=int(q.get("now", 0)))
        if route == "/cache":
            return self._dp.cache_stats()
        if route == "/commitplane":
            cs = getattr(self._dp, "commit_stats", None)
            body = cs() if cs is not None else None
            if body is None:
                # Datapath without a commit plane (the Datapath base
                # default returns None): 404, not a literal null body.
                raise KeyError(route)
            return body
        if route == "/audit":
            austats = getattr(self._dp, "audit_stats", None)
            body = austats() if austats is not None else None
            if body is None:
                raise KeyError(route)  # datapath without an audit plane
            if q.get("force", "0") not in ("", "0"):
                # Operator-triggered full sweep (antctl audit --force):
                # run it synchronously THROUGH the maintenance scheduler
                # (the one serialization point against drains/overlap —
                # analysis pass `maintenance` forbids a direct audit_scan
                # call site here), then report the refreshed status with
                # the sweep's own findings attached.
                scan = self._dp.maintenance_force_audit(
                    now=int(q.get("now", 0)))
                body = self._dp.audit_stats()
                body["last_scan"] = scan
            return body
        if route == "/maintenance":
            ms = getattr(self._dp, "maintenance_stats", None)
            body = ms() if ms is not None else None
            if body is None:
                raise KeyError(route)  # datapath without a scheduler
            if q.get("tick", "0") not in ("", "0"):
                # Operator-triggered synchronous tick (antctl maintenance
                # --tick): run one budgeted round, then report refreshed
                # state with the tick's own outcome attached.
                now = int(q["now"]) if "now" in q else None
                budget = int(q["budget"]) if "budget" in q else None
                tick = self._dp.maintenance_tick(now=now, budget=budget)
                body = self._dp.maintenance_stats()
                body["last_tick"] = tick
            return body
        if route == "/failover":
            fs = getattr(self._dp, "failover_stats", None)
            body = fs() if fs is not None else None
            if body is None:
                raise KeyError(route)  # datapath without a mesh/failover
            if q.get("readmit", "0") not in ("", "0"):
                # Operator-triggered certified re-admission (antctl
                # failover --readmit): pre-flip heal unmasks; an
                # evacuated replica rejoins via the ordinary certified
                # grow-resize.  Report refreshed state.
                body = self._dp.failover_readmit()
                body["last_readmit"] = body.get("phase")
            return body
        if route == "/realization":
            rz = getattr(self._dp, "realization_stats", None)
            body = rz() if rz is not None else None
            if body is None:
                raise KeyError(route)  # datapath without the tracer
            tracer = self._dp.realization_tracer
            body["spans"] = tracer.spans(uid=q.get("uid") or None)
            return body
        if route == "/flightrecorder":
            fr = getattr(self._dp, "flightrecorder_stats", None)
            body = fr() if fr is not None else None
            if body is None:
                raise KeyError(route)  # datapath without a recorder
            tail = int(q["tail"]) if "tail" in q else None
            kind = q.get("kind") or None
            if kind is not None:
                from ..observability.flightrec import EVENT_KINDS

                if kind not in EVENT_KINDS:
                    raise ValueError(
                        f"unknown event kind {kind!r} (declared kinds: "
                        f"{', '.join(sorted(EVENT_KINDS))})")
            body["events"] = self._dp.flightrecorder_events(tail=tail,
                                                            kind=kind)
            return body
        if route == "/telemetry":
            tl = getattr(self._dp, "telemetry_stats", None)
            body = tl() if tl is not None else None
            if body is None:
                raise KeyError(route)  # datapath built telemetry=False
            return body
        if route == "/serving":
            sv = getattr(self._dp, "serving_stats", None)
            body = sv() if sv is not None else None
            if body is None:
                raise KeyError(route)  # batcher never materialized
            return body
        if route == "/memberlist":
            if self._memberlist is None:
                return []
            alive = self._memberlist.alive
            return sorted(alive() if callable(alive) else alive)
        if route == "/featuregates":
            if self._gates is None:
                return {}
            return self._gates.as_dict()
        if route == "/traceflow":
            if q.get("live"):
                return self._live_traceflow(q)
            if "src" not in q or "dst" not in q:
                raise ValueError("traceflow needs src= and dst=")
            from ..packet import PacketBatch

            batch = PacketBatch(
                src_ip=np.array([iputil.ip_to_u32(q["src"])], np.uint32),
                dst_ip=np.array([iputil.ip_to_u32(q["dst"])], np.uint32),
                proto=np.array([int(q.get("proto", 6))], np.int32),
                src_port=np.array([int(q.get("sport", 0))], np.int32),
                dst_port=np.array([int(q.get("dport", 0))], np.int32),
                in_port=np.array([int(q.get("in_port", -1))], np.int32),
            )
            obs = self._dp.trace(batch, now=int(q.get("now", 0)))[0]
            obs["dnat_ip"] = iputil.u32_to_ip(obs["dnat_ip"])
            return obs
        raise KeyError(route)

    def _live_traceflow(self, q: dict) -> dict:
        """Open a live-traffic Traceflow session and wait (bounded) for
        the node's stepped traffic to complete it — the synchronous HTTP
        face of TraceflowController.start_live for antctl."""
        import time as _time

        from ..controller.traceflow import TraceflowSpec, TraceflowStatus

        if self._tfc is None:
            raise ValueError(
                "live traceflow needs a TraceflowController tap wired to "
                "this agent's datapath"
            )
        if not q.get("src") and not q.get("dst"):
            raise ValueError("live traceflow needs src= or dst=")
        name = f"live-{self._node}-{next(self._live_seq)}"
        tf = TraceflowSpec(
            name=name,
            src_ip=q.get("src", ""),
            dst_ip=q.get("dst", ""),
            proto=int(q.get("proto", 0)),
            src_port=int(q.get("sport", 0)),
            dst_port=int(q.get("dport", 0)),
            live_traffic=True,
            dropped_only=q.get("dropped_only", "0") not in ("", "0"),
            sampling=int(q.get("sampling", 1)),
        )
        st = self._tfc.start_live(tf, self._node)
        deadline = _time.monotonic() + float(q.get("wait", 5.0))
        while st.phase == "Running" and _time.monotonic() < deadline:
            _time.sleep(0.02)
            st = self._tfc.results[name]
        if st.phase == "Running":
            # Settle the timeout UNDER the controller lock: the stepping
            # thread may complete the session between our last poll and
            # here — a capture that actually happened must win over the
            # timeout verdict.
            with self._tfc.lock:
                st = self._tfc.results[name]
                if st.phase == "Running":
                    self._tfc.release(name)
                    st = self._tfc.results[name] = TraceflowStatus(
                        name, st.tag, "Failed",
                        [{"component": "LiveTraffic",
                          "action": "no matching live packet within wait"}],
                    )
        # One-shot HTTP session: its result ships in this response, so
        # evict it from the controller — a monitoring job polling --live
        # periodically must not grow results without bound.
        self._tfc.results.pop(name, None)
        return {
            "name": st.name, "tag": st.tag, "phase": st.phase,
            "verdict": st.verdict, "observations": st.observations,
        }
