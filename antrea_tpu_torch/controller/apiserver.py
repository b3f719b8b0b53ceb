"""Controller API server: localhost REST for the operator CLI.

The analog of the reference's controller apiserver handlers
(pkg/apiserver/handlers/: endpoint, networkpolicy info +
the controllerinfo CRD surface): a loopback HTTP endpoint antctl's
`--controller` mode consumes for CENTRAL state — controllerinfo heartbeat,
computed policies, and the NetworkPolicy realization statuses the
StatusAggregator maintains (status_controller.go:270 aggregation).

Routes:
  GET /controllerinfo   AntreaControllerInfo heartbeat (incl. realization)
  GET /policystatus     per-policy realization statuses (phase, counts)
  GET /networkpolicies  internal computed NetworkPolicies (summary rows)
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


class ControllerApiServer:
    def __init__(self, controller, *, store=None, status=None,
                 host: str = "127.0.0.1", port: int = 0):
        self._controller = controller
        self._store = store
        self._status = status
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet test output
                pass

            def do_GET(self):
                try:
                    body = outer._route(self.path)
                except KeyError:
                    self.send_error(404)
                    return
                except Exception as e:  # noqa: BLE001 — handler boundary
                    self.send_error(500, f"{type(e).__name__}: {e}")
                    return
                data = json.dumps(body, indent=2).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )

    @property
    def address(self):
        return self._httpd.server_address

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()

    def _route(self, path: str):
        path = path.split("?", 1)[0].rstrip("/")
        if path == "/controllerinfo":
            from ..observability.agentinfo import collect_controller_info

            return collect_controller_info(
                self._controller, store=self._store, status=self._status
            )
        if path == "/policystatus":
            if self._status is None:
                return {"items": []}
            return {"items": [
                {
                    "uid": s.uid,
                    "phase": s.phase,
                    "observedGeneration": s.observed_generation,
                    "currentNodesRealized": s.current_nodes,
                    "desiredNodesRealized": s.desired_nodes,
                    "failedNodes": s.failed_nodes,
                }
                for s in self._status.all_statuses()
            ]}
        if path == "/networkpolicies":
            ps = self._controller.policy_set()
            return {"items": [
                {
                    "uid": p.uid, "name": p.name, "namespace": p.namespace,
                    "type": p.type.value, "generation": p.generation,
                    "rules": len(p.rules),
                }
                for p in ps.policies
            ]}
        raise KeyError(path)
