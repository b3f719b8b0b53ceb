"""Typed configuration for the agent and controller processes.

The analog of the reference's YAML ConfigMap -> typed config structs path
(pkg/config/agent, pkg/config/controller, parsed and
validated by cmd/antrea-agent/options.go): a YAML (or JSON) document maps
onto dataclasses with defaults, validation, and a featureGates section
checked against the registry (features.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from .features import FeatureGates


class ConfigError(ValueError):
    """A configuration knob combination that cannot work was rejected at
    CONSTRUCTION time, with the reason — instead of failing deep inside
    the first drain/scan it would have broken.  Subclasses ValueError so
    pre-existing callers that catch/raise ValueError keep working."""


@dataclass
class AgentConfig:
    """antrea-agent.conf analog (the subset this build consumes)."""

    node_name: str = ""
    node_ips: list = field(default_factory=list)
    # Datapath sizing (tpuflow tensors).
    flow_slots: int = 1 << 20
    aff_slots: int = 1 << 18
    ct_timeout_s: int = 3600
    miss_chunk: int = 4096
    delta_slots: int = 128
    # Unified maintenance scheduler (datapath/maintenance.py): total
    # budget units per tick across every registered background task
    # (None = unlimited; per-task quanta still clamp each task).
    maint_budget: Optional[int] = None
    datapath_type: str = "tpuflow"  # ovsconfig.OVSDatapathType analog
    persist_dir: Optional[str] = None
    filestore_dir: Optional[str] = None
    audit_log_path: Optional[str] = None
    feature_gates: FeatureGates = field(default_factory=FeatureGates)

    def validate(self) -> None:
        for name, v in (("flow_slots", self.flow_slots),
                        ("aff_slots", self.aff_slots)):
            if v < 2 or v & (v - 1):
                raise ValueError(f"{name} must be a power of two >= 2, got {v}")
        if self.datapath_type not in ("tpuflow", "oracle"):
            raise ValueError(f"unknown datapathType {self.datapath_type!r}")
        if self.miss_chunk < 1:
            raise ValueError("missChunk must be >= 1")
        if self.maint_budget is not None and self.maint_budget <= 0:
            raise ConfigError(
                f"maintBudget must be positive (or unset for unlimited), "
                f"got {self.maint_budget}"
            )


@dataclass
class ControllerConfig:
    """antrea-controller.conf analog."""

    feature_gates: FeatureGates = field(default_factory=FeatureGates)


_AGENT_KEYS = {
    "nodeName": "node_name",
    "nodeIPs": "node_ips",
    "flowSlots": "flow_slots",
    "affinitySlots": "aff_slots",
    "ctTimeoutSeconds": "ct_timeout_s",
    "missChunk": "miss_chunk",
    "deltaSlots": "delta_slots",
    "maintBudget": "maint_budget",
    "datapathType": "datapath_type",
    "persistDir": "persist_dir",
    "filestoreDir": "filestore_dir",
    "auditLogPath": "audit_log_path",
}


def _load_doc(path: str) -> dict:
    import yaml

    with open(path) as f:
        doc = yaml.safe_load(f) or {}
    if not isinstance(doc, dict):
        raise ValueError(f"config {path}: top level must be a mapping")
    return doc


def load_agent_config(path: str) -> AgentConfig:
    doc = _load_doc(path)
    cfg = AgentConfig()
    for key, val in doc.items():
        if key == "featureGates":
            cfg.feature_gates = FeatureGates(val or {})
        elif key in _AGENT_KEYS:
            setattr(cfg, _AGENT_KEYS[key], val)
        else:
            raise ValueError(f"unknown agent config key {key!r}")
    cfg.validate()
    return cfg


def load_controller_config(path: str) -> ControllerConfig:
    doc = _load_doc(path)
    cfg = ControllerConfig()
    for key, val in doc.items():
        if key == "featureGates":
            cfg.feature_gates = FeatureGates(val or {})
        else:
            raise ValueError(f"unknown controller config key {key!r}")
    return cfg


def build_datapath(cfg: AgentConfig):
    """Config -> a constructed Datapath (the initializer seam,
    ref agent.go setupOVSBridge/initOpenFlowPipeline)."""
    from .datapath import OracleDatapath, TpuflowDatapath

    cls = TpuflowDatapath if cfg.datapath_type == "tpuflow" else OracleDatapath
    kw = dict(
        flow_slots=cfg.flow_slots, aff_slots=cfg.aff_slots,
        ct_timeout_s=cfg.ct_timeout_s,
        node_ips=list(cfg.node_ips), node_name=cfg.node_name,
        persist_dir=cfg.persist_dir,
        feature_gates=cfg.feature_gates,
        maint_budget=cfg.maint_budget,
    )
    if cls is TpuflowDatapath:
        kw.update(miss_chunk=cfg.miss_chunk, delta_slots=cfg.delta_slots)
    return cls(**kw)
