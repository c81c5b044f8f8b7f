"""Serving substrate of the port: the continuous-batching model engine
(``ServeEngine``, ``Request``: greedy decoding of a decoder-only model from
``repro_torch.configs`` on the card, with per-slot prefill and one batched
decode step a tick), the read-latency telemetry that both the engine and
the stripe store's degraded-read path record into, and the multi-client
block-read front end over a stripe store (``BlockServer``, driven by the
Zipfian ``zipf_requests`` stream).

The engine's names resolve lazily (PEP 562): the stripe store imports
``repro_torch.serve.telemetry`` on its read path, and must not drag the
model stack in with it.
"""
from .blocks import BlockServer, zipf_requests  # noqa: F401
from .telemetry import LatencyRecorder  # noqa: F401

_LAZY = {"Request": "engine", "ServeEngine": "engine"}

__all__ = sorted(["BlockServer", "zipf_requests", "LatencyRecorder", *_LAZY])


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(f".{_LAZY[name]}", __name__),
                       name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
