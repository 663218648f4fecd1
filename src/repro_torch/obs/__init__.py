"""Observability: the flight-recorder event kinds. The recorder, metrics
and trace exporter are not ported yet."""
from . import events

__all__ = ["events"]
