"""Serving substrate of the port: the read-latency telemetry the stripe
store's degraded-read path records into."""
from .telemetry import LatencyRecorder  # noqa: F401
