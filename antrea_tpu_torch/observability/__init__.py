"""Observability plane of the PyTorch port: NP audit logging, the metrics
surface, the flight-recorder event journal, realization tracing, the
telemetry accumulator and flow export (copies of the JAX package's modules)."""

from .audit import AuditLogger
from .flightrec import EVENT_KINDS, FlightRecorder
from .metrics import (
    METRICS,
    Histogram,
    render_dissemination_metrics,
    render_metrics,
)
from .tracing import REALIZATION_STAGES, RealizationTracer

__all__ = [
    "AuditLogger",
    "EVENT_KINDS",
    "FlightRecorder",
    "Histogram",
    "METRICS",
    "REALIZATION_STAGES",
    "RealizationTracer",
    "render_dissemination_metrics",
    "render_metrics",
]
