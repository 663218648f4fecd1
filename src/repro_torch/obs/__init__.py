"""Observability layer: flight recorder, decision provenance, metrics.

Zero-cost when off: engines/fabrics/clusters hold `_rec = None` until a
`FlightRecorder` is attached via `attach_recorder`, and every record site
is a single `is not None` guard per *batch* (never per slice). See
docs/OBSERVABILITY.md for the event schema and the explain-CLI walkthrough.
"""
from . import events
from .metrics import Counter, Histogram, MetricsRegistry
from .recorder import FlightRecorder
from .trace import export_chrome_trace, to_json, validate_trace

__all__ = [
    "Counter",
    "FlightRecorder",
    "Histogram",
    "MetricsRegistry",
    "events",
    "export_chrome_trace",
    "to_json",
    "validate_trace",
]
