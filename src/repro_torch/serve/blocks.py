"""Degraded-read front end: multi-client block serving over a stripe store.

A thin serving layer over ``StripeStore.read``/``read_range`` (which owns
the reconstruction, coalescing and caching — DESIGN.md §10): this module
adds the *client* side — a thread pool standing in for concurrent readers,
per-request wall-latency recording into a shared
:class:`~repro_torch.serve.telemetry.LatencyRecorder`, and the Zipfian request
generator the tail-latency experiments drive it with. The point of the
split: N front-end clients hammering one lost block must collapse onto one
decode launch *inside* the store, so any number of front ends stay correct
by construction.
"""
from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np

from .telemetry import LatencyRecorder


class BlockServer:
    """Concurrent block-read front end over one stripe store.

    ``read`` serves a single request synchronously; ``run`` replays a
    request stream through ``clients`` worker threads — the multi-client
    load shape of a production object store, where many readers race onto
    the same hot lost block. Front-end latency (queueing + store time)
    lands in ``latency``; the store's own counters stay the source of truth
    for coalescing/cache behavior (``repro_torch.ftx.read_report``).
    """

    def __init__(self, store, clients: int = 8,
                 latency: Optional[LatencyRecorder] = None):
        if clients < 1:
            raise ValueError("need at least one client thread")
        self.store = store
        self.clients = clients
        self.latency = latency if latency is not None else LatencyRecorder()

    def read(self, sid: int, block: int, lo: int = 0,
             hi: Optional[int] = None) -> np.ndarray:
        t0 = time.perf_counter()
        data = self.store.read_range(sid, block, lo, hi)
        self.latency.record(time.perf_counter() - t0, int(data.size))
        return data

    def run(self, requests: Sequence[tuple],
            timed: bool = False) -> list:
        """Serve ``(sid, block)`` (or ``(sid, block, lo, hi)``) requests
        across the client pool; responses come back in request order.
        ``timed=True`` returns ``(data, seconds)`` pairs so load generators
        can split tail latency by request class (e.g. degraded vs live)."""

        def one(rq):
            t0 = time.perf_counter()
            data = self.read(*rq)
            return (data, time.perf_counter() - t0) if timed else data

        with ThreadPoolExecutor(self.clients) as pool:
            return list(pool.map(one, requests))

    def report(self):
        """The store-side :class:`~repro_torch.ftx.DegradedReadReport`."""
        from repro_torch.ftx.fleet import read_report

        return read_report(self.store)


def zipf_requests(store, num_requests: int, *, alpha: float = 1.1,
                  seed: int = 0,
                  block_pool: str = "data") -> list[tuple[int, int]]:
    """A Zipfian ``(sid, block)`` request stream over a store's stripes.

    Block popularity follows ``rank^-alpha`` over the pool of addressable
    blocks (``"data"`` restricts to the k data blocks per stripe — the
    object-serving shape — ``"all"`` includes parities); ranks are assigned
    by a seeded shuffle so the hot set spreads across stripes and nodes
    instead of clustering on stripe 0. Deterministic for a given
    ``(store contents, num_requests, alpha, seed)``, which is what lets the
    benchmark gate *counts* (coalescing ratio, local fraction) rather than
    timings.
    """
    if block_pool not in ("data", "all"):
        raise ValueError(f"unknown block_pool {block_pool!r}")
    width = store.cfg.k if block_pool == "data" else store.scheme.n
    pairs = [(sid, b) for sid in sorted(store.stripes) for b in range(width)]
    if not pairs:
        raise ValueError("store has no sealed stripes to read")
    rng = np.random.default_rng(seed)
    ranks = rng.permutation(len(pairs))
    weights = 1.0 / (1.0 + ranks.astype(np.float64)) ** alpha
    weights /= weights.sum()
    picks = rng.choice(len(pairs), size=num_requests, p=weights)
    return [pairs[i] for i in picks]
