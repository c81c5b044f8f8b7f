"""Serving substrate of the port: the read-latency telemetry the stripe
store's degraded-read path records into, and the multi-client block-read
front end over a stripe store (``BlockServer``, driven by the Zipfian
``zipf_requests`` stream). The continuous-batching model engine comes with
the model scaffold in a later slice."""
from .blocks import BlockServer, zipf_requests  # noqa: F401
from .telemetry import LatencyRecorder  # noqa: F401
