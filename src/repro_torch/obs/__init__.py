"""Observability: the flight-recorder event kinds and the metrics registry
(`Counter`, `Histogram`, `MetricsRegistry`), carried over from `repro.obs`.
The flight recorder, trace exporter and explain tools are not ported yet."""
from . import events
from .metrics import Counter, Histogram, MetricsRegistry

__all__ = ["Counter", "Histogram", "MetricsRegistry", "events"]
