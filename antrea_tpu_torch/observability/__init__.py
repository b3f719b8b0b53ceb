"""Observability plane of the PyTorch port: the metrics surface, the
flight-recorder event journal, realization tracing, the telemetry
accumulator and flow export (copies of the JAX package's modules)."""

from .flightrec import EVENT_KINDS, FlightRecorder
from .metrics import METRICS, Histogram, render_metrics
from .tracing import REALIZATION_STAGES, RealizationTracer

__all__ = [
    "EVENT_KINDS",
    "FlightRecorder",
    "Histogram",
    "METRICS",
    "REALIZATION_STAGES",
    "RealizationTracer",
    "render_metrics",
]
