"""Datapath plugin boundary of the PyTorch port (the JAX package's
datapath/): the engine (tpuflow.TpuflowDatapath) with its commit, audit,
maintenance, persistence and tenancy planes, and its scalar twin
(oracle_dp.OracleDatapath, host-only numpy: the differential reference)."""

from .audit import AuditPlane
from .commit import BundleQuarantinedError, CanaryMismatchError, CommitPlane
from .interface import Datapath, DatapathType, StepResult
from .oracle_dp import OracleDatapath
from .tenancy import TenantedDatapath, TenantRegistry, TenantSpec
from .tpuflow import TpuflowDatapath


def make_datapath(kind: DatapathType | str, *args, **kwargs) -> Datapath:
    """Factory keyed on DatapathType.  TPUFLOW builds the port's engine
    (on the card unless device="cpu" is passed); ORACLE builds the scalar
    twin, which runs on the host and takes no device."""
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
