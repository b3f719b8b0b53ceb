"""Feature gates: named on/off switches with maturity levels.

The analog of the reference's k8s component-base feature gates
(pkg/features/antrea_features.go:193-226 — 31 gates with
Alpha/Beta/GA maturity and per-component applicability).  The registry
below mirrors the reference's gate NAMES for the subsystems this build
implements; gates for not-yet-built subsystems are registered (so configs
referencing them parse) but nothing consults them yet.

Wired consumers:
  AntreaPolicy       NetworkPolicyController rejects ACNP/ANNP when off
  NetworkPolicyStats datapaths skip per-rule counters when off
  Traceflow          Datapath.trace() refuses when off
  AuditLogging       observability.AuditLogger refuses construction when off
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class _Gate:
    default: bool
    maturity: str  # Alpha / Beta / GA


# name -> (default, maturity); names mirror antrea_features.go.
REGISTRY: dict[str, _Gate] = {
    "AntreaPolicy": _Gate(True, "GA"),
    "AntreaProxy": _Gate(True, "GA"),
    "NetworkPolicyStats": _Gate(True, "Beta"),
    "Traceflow": _Gate(True, "Beta"),
    "AuditLogging": _Gate(True, "Beta"),
    "Egress": _Gate(True, "Beta"),
    "FlowExporter": _Gate(False, "Alpha"),
    "EndpointSlice": _Gate(True, "GA"),
    "NodePortLocal": _Gate(True, "GA"),
    "ServiceExternalIP": _Gate(False, "Alpha"),
    "Multicast": _Gate(False, "Alpha"),
    "Multicluster": _Gate(False, "Alpha"),
    "SecondaryNetwork": _Gate(False, "Alpha"),
    "TrafficControl": _Gate(False, "Alpha"),
    "L7NetworkPolicy": _Gate(False, "Alpha"),
    "AdminNetworkPolicy": _Gate(False, "Alpha"),
    "TopologyAwareHints": _Gate(True, "Beta"),
    "LoadBalancerModeDSR": _Gate(False, "Alpha"),
    "CleanupStaleUDPSvcConntrack": _Gate(True, "Beta"),
    "NodeNetworkPolicy": _Gate(False, "Alpha"),
    "BGPPolicy": _Gate(False, "Alpha"),
    "NodeLatencyMonitor": _Gate(False, "Alpha"),
    "PacketCapture": _Gate(False, "Alpha"),
}


class FeatureGates:
    """Immutable-after-parse gate set (component-base semantics: unknown
    gate names are a config error, not silently ignored)."""

    def __init__(self, overrides: dict | None = None):
        self._enabled = {name: g.default for name, g in REGISTRY.items()}
        for name, val in (overrides or {}).items():
            if name not in REGISTRY:
                raise ValueError(f"unknown feature gate {name!r}")
            self._enabled[name] = bool(val)

    def enabled(self, name: str) -> bool:
        if name not in REGISTRY:
            raise ValueError(f"unknown feature gate {name!r}")
        return self._enabled[name]

    def as_dict(self) -> dict:
        return dict(self._enabled)


DEFAULT_GATES = FeatureGates()
