"""Dissemination plane of the PyTorch port (ref: pkg/apiserver RAM store +
watch fan-out), copies of the JAX package's modules: the wire
serialization of the control-plane types (serde.py), the watch store
(store.py), the mTLS wire (netwire.py), the pipe transport to an agent
subprocess (transport.py, agent_proc.py) and the deterministic fault
plans (faults.py)."""

from .faults import FaultPlan
from .store import RamStore

__all__ = ["FaultPlan", "RamStore"]
