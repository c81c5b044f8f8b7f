"""Serving-path telemetry: thread-safe latency reservoirs with tail quantiles.

Import-light on purpose: the stripe store's read path records into a
:class:`LatencyRecorder` on every request, so this module must not drag the
model/serving stack (``repro_torch.serve.engine``) in with it. Both serving front
ends — the LLM continuous-batching engine and the degraded block server —
share this recorder, so "p99" means the same thing on both paths.
"""
from __future__ import annotations

import threading

import numpy as np


class LatencyRecorder:
    """Bounded per-request latency reservoir with percentile queries.

    Keeps the most recent ``max_samples`` latencies in a ring buffer (old
    samples are overwritten — a serving tail metric should reflect recent
    traffic, not startup transients) plus exact lifetime counters for
    requests and bytes. All methods are thread-safe; ``record`` is O(1).
    """

    def __init__(self, max_samples: int = 8192):
        if max_samples <= 0:
            raise ValueError("max_samples must be positive")
        self.max_samples = max_samples
        self._buf = np.zeros(max_samples, np.float64)
        self._pos = 0
        self._filled = 0
        self.count = 0
        self.bytes = 0
        self._lock = threading.Lock()

    def record(self, seconds: float, nbytes: int = 0) -> None:
        """Record one request's wall latency (and bytes served, if any)."""
        with self._lock:
            self._buf[self._pos] = seconds
            self._pos = (self._pos + 1) % self.max_samples
            self._filled = min(self._filled + 1, self.max_samples)
            self.count += 1
            self.bytes += nbytes

    def _samples(self) -> np.ndarray:
        return self._buf[:self._filled].copy()

    def percentile(self, p: float) -> float:
        """The p-th latency percentile (seconds) over the retained window."""
        with self._lock:
            samples = self._samples()
        if samples.size == 0:
            return 0.0
        return float(np.percentile(samples, p))

    def snapshot(self) -> dict:
        """Counters plus p50/p99/mean/max over the retained window."""
        with self._lock:
            samples = self._samples()
            count, nbytes = self.count, self.bytes
        if samples.size == 0:
            return {"count": count, "bytes": nbytes, "p50_ms": 0.0,
                    "p99_ms": 0.0, "mean_ms": 0.0, "max_ms": 0.0}
        return {
            "count": count,
            "bytes": nbytes,
            "p50_ms": float(np.percentile(samples, 50)) * 1e3,
            "p99_ms": float(np.percentile(samples, 99)) * 1e3,
            "mean_ms": float(samples.mean()) * 1e3,
            "max_ms": float(samples.max()) * 1e3,
        }

    def reset(self) -> dict:
        """Snapshot, then clear the window and counters."""
        snap = self.snapshot()
        with self._lock:
            self._pos = self._filled = 0
            self.count = self.bytes = 0
        return snap
