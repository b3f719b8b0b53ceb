"""Datapath plugin boundary of the PyTorch port (the JAX package's
datapath/): the engine (tpuflow.TpuflowDatapath) with its commit, audit,
maintenance, persistence and tenancy planes."""

from .audit import AuditPlane
from .commit import BundleQuarantinedError, CanaryMismatchError, CommitPlane
from .interface import Datapath, DatapathType, StepResult
from .tenancy import TenantedDatapath, TenantRegistry, TenantSpec
from .tpuflow import TpuflowDatapath, refuse

# ROADMAP.md queue A item that re-homes the scalar twin engine.
ITEM_ORACLE = 9


class OracleDatapath:
    """The scalar twin engine (the JAX package's datapath/oracle_dp.py) is
    not re-homed yet: constructing it raises NotImplementedError."""

    def __init__(self, *args, **kwargs):
        raise refuse("OracleDatapath", ITEM_ORACLE)


def make_datapath(kind: DatapathType | str, *args, **kwargs) -> Datapath:
    """Factory keyed on DatapathType.  TPUFLOW builds the port's engine
    (on the card unless device="cpu" is passed); ORACLE raises
    NotImplementedError."""
    kind = DatapathType(kind)
    if kind == DatapathType.TPUFLOW:
        return TpuflowDatapath(*args, **kwargs)
    if kind == DatapathType.ORACLE:
        return OracleDatapath(*args, **kwargs)
    raise ValueError(f"unknown datapath type {kind}")


__all__ = [
    "AuditPlane",
    "BundleQuarantinedError",
    "CanaryMismatchError",
    "CommitPlane",
    "Datapath",
    "DatapathType",
    "OracleDatapath",
    "StepResult",
    "TenantedDatapath",
    "TenantRegistry",
    "TenantSpec",
    "TpuflowDatapath",
    "make_datapath",
]
