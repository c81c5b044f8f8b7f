"""Failure injection + trace replay + elastic re-striping.

``FailureInjector`` drives Poisson node failures over simulated time against
a StripeStore, invoking repair and tracking exposure (time at reduced
redundancy) — the ingredients of the paper's MTTDL story, executed against
real encoded bytes instead of a closed-form chain. It emits the
unified :mod:`repro_torch.ftx.events` schema (``NodeFailEvent`` +
``RepairDoneEvent`` pairs) and can *replay* any event trace in that schema
against another store (:meth:`FailureInjector.replay`) — the same
vocabulary the event-driven fleet simulator (``repro_torch.sim``) speaks, so
injector logs, simulator output, and future real-cluster traces are
interchangeable.

``restripe`` implements elastic scaling: when the fleet grows or shrinks,
re-encode open stripes to a new geometry with bandwidth accounting (the
wide-stripe generation cost that StripeMerge-style systems optimize).
"""
from __future__ import annotations

from typing import Iterable, Optional

import numpy as np

from .events import (FleetEvent, NodeFailEvent, RackFailEvent,
                     RepairDoneEvent, sort_events)
from .options import RepairOptions
from .rebalance import rebalance
from .stripestore import StoreConfig, StripeStore


class FailureInjector:
    def __init__(self, store: StripeStore, mttf_hours: float = 1000.0,
                 seed: int = 0, pipeline: Optional[bool] = None):
        self.store = store
        self.mttf_hours = mttf_hours
        self.rng = np.random.default_rng(seed)
        self.events: list[FleetEvent] = []
        self.clock = 0.0
        # None: the store's default (pipelined when cfg.pipeline_window > 0);
        # simulated repair *time* is identical either way — the pipeline
        # changes wall-clock, not the bandwidth model.
        self.pipeline = pipeline

    def _fail_and_repair(self, t: float, node: int,
                         repair: bool) -> list[FleetEvent]:
        """Fail ``node`` at ``t`` (and repair it through the real pipeline
        when ``repair``), returning the emitted schema events."""
        out: list[FleetEvent] = [NodeFailEvent(t=t, node=node)]
        self.store.fail_node(node)
        if repair:
            tele = self.store.repair_all(
                options=RepairOptions(pipeline=self.pipeline))
            self.store.revive_node(node)
            out.append(RepairDoneEvent(
                t=t + tele["sim_seconds"] / 3600.0,
                unit=node, kind="node", started_at=t,
                blocks_read=tele["blocks_read"],
                sim_seconds=tele["sim_seconds"],
                local=tele["repairs_global"] == 0))
        return out

    def run(self, hours: float,
            repair_immediately: bool = True) -> list[FleetEvent]:
        """Simulate ``hours`` of operation; each failure repairs onto the
        same node id (a fresh replacement host) before the next event.

        Returns the full emitted event log (``NodeFailEvent`` followed by
        its ``RepairDoneEvent`` when repairs run), also accumulated on
        ``self.events``.
        """
        n = self.store.num_nodes
        rate = n / self.mttf_hours
        t = self.clock
        end = self.clock + hours
        while True:
            t += float(self.rng.exponential(1.0 / rate))
            if t >= end:
                break
            node = int(self.rng.integers(n))
            self.events.extend(
                self._fail_and_repair(t, node, repair_immediately))
        self.clock = end
        return self.events

    def replay(self, events: Iterable[FleetEvent],
               repair_immediately: bool = True) -> list[FleetEvent]:
        """Consume an event trace: apply every ``NodeFailEvent`` against
        the store in canonical order, repairing through the real pipeline.

        The consuming half of the unified schema: a trace emitted by
        another injector (different store geometry), by the fleet
        simulator, or parsed from a real cluster log replays against this
        store's actual codec and repair pipeline. Non-failure events
        (repair-done, scrub, ...) in the input are ignored — repairs are
        re-executed here, so the returned log carries *this* store's repair
        costs. Advances ``self.clock`` to the last event time.
        """
        out: list[FleetEvent] = []
        for ev in sort_events(events):
            if isinstance(ev, NodeFailEvent):
                if not 0 <= ev.node < self.store.num_nodes:
                    raise ValueError(f"trace node {ev.node} outside store "
                                     f"with {self.store.num_nodes} nodes")
                out.extend(self._fail_and_repair(ev.t, ev.node,
                                                 repair_immediately))
                self.clock = max(self.clock, ev.t)
        self.events.extend(out)
        return out

    def failures(self) -> list[NodeFailEvent]:
        """Just the failure events of the accumulated log."""
        return [e for e in self.events if isinstance(e, NodeFailEvent)]

    def repairs(self) -> list[RepairDoneEvent]:
        """Just the repair-done events of the accumulated log."""
        return [e for e in self.events if isinstance(e, RepairDoneEvent)]


def replay_trace(store: StripeStore, events: Iterable[FleetEvent], *,
                 options: Optional[RepairOptions] = None,
                 revive: bool = True,
                 rebalance_after: bool = False) -> dict:
    """Replay a failure trace with *correlated-arrival* repair batching.

    The orchestration entry point: where
    :meth:`FailureInjector.replay` repairs one node at a time,
    this groups every failure sharing a timestamp — the correlated
    rack/burst arrivals the trace fixtures encode — fails the whole batch,
    and runs **one** ``repair_all`` over it, which is exactly when the
    cross-window assignment (``options.schedule="global"``) and
    topology-aware destinations (``options.destinations="topology"``)
    have room to win. ``RackFailEvent`` rows expand to the rack's nodes
    through the store topology; nodes already DOWN are skipped.

    Args:
        store: the store to drive; mutated in place.
        events: any :mod:`repro_torch.ftx.events` trace (only failure events are
            consumed; repair-done rows are re-earned here).
        options: forwarded to every ``repair_all`` batch.
        revive: bring failed nodes back UP after their batch repairs
            (fresh replacements). ``False`` leaves them DOWN — the
            permanent-loss mode destination selection exists for.
        rebalance_after: run one ``repro_torch.ftx.rebalance`` pass after the
            last batch and report it.

    Returns:
        ``{"batches": [...], "events": [...], "totals": {...},
        "rebalance": ...}`` — one row per correlated batch carrying its
        time, failed nodes, and the repair telemetry deltas the
        orchestration benchmark gates (local/total reads, scheduled vs
        contiguous locality, blocks relocated); totals aggregate them.
    """
    options = options or RepairOptions()
    batches: dict[float, list[int]] = {}
    for ev in sort_events(events):
        nodes: list[int] = []
        if isinstance(ev, NodeFailEvent):
            nodes = [ev.node]
        elif isinstance(ev, RackFailEvent):
            nodes = store.topology.nodes_in(ev.rack)
        for n in nodes:
            if not 0 <= n < store.num_nodes:
                raise ValueError(f"trace node {n} outside store "
                                 f"with {store.num_nodes} nodes")
            batches.setdefault(ev.t, []).append(n)

    rows: list[dict] = []
    out_events: list[FleetEvent] = []
    for t in sorted(batches):
        failed = sorted(set(n for n in batches[t]
                            if store.nodes[n].name == "UP"))
        if not failed:
            continue
        for n in failed:
            store.fail_node(n)
            out_events.append(NodeFailEvent(t=t, node=n))
        before = store.telemetry.copy()
        tele = store.repair_all(options=options)
        diff = store.telemetry
        row = {"t": t, "nodes": failed,
               "blocks_read": tele["blocks_read"],
               "sim_seconds": tele["sim_seconds"],
               "local_reads": diff.local_reads - before.local_reads,
               "remote_reads": diff.remote_reads - before.remote_reads,
               "scheduled_local": tele.get("scheduled_local_reads", 0),
               "contiguous_local": tele.get("contiguous_local_reads", 0),
               "schedule_total": tele.get("schedule_total_reads", 0),
               "blocks_relocated": tele.get("blocks_relocated", 0),
               "repairs_local": tele["repairs_local"],
               "repairs_global": tele["repairs_global"]}
        rows.append(row)
        done_t = t + tele["sim_seconds"] / 3600.0
        for n in failed:
            if revive:
                store.revive_node(n)
            out_events.append(RepairDoneEvent(
                t=done_t, unit=n, kind="node", started_at=t,
                blocks_read=tele["blocks_read"],
                sim_seconds=tele["sim_seconds"],
                local=tele["repairs_global"] == 0))

    totals = {k: sum(r[k] for r in rows) for k in
              ("blocks_read", "local_reads", "remote_reads",
               "scheduled_local", "contiguous_local", "schedule_total",
               "blocks_relocated", "repairs_local", "repairs_global")}
    totals["sim_seconds"] = sum(r["sim_seconds"] for r in rows)
    result = {"batches": rows, "events": sort_events(out_events),
              "totals": totals, "rebalance": None}
    if rebalance_after:
        rep = rebalance(store)
        result["rebalance"] = {
            "planned": rep.planned, "moved": rep.moved,
            "windows": rep.windows, "bytes_moved": rep.bytes_moved,
            "imbalance_before": rep.imbalance_before,
            "imbalance_after": rep.imbalance_after}
    return result


def restripe(store: StripeStore, new_cfg: StoreConfig, root) -> tuple[StripeStore, dict]:
    """Re-encode every object into a store with new geometry (elastic
    scaling), on ``store``'s device. Returns (new store, bandwidth
    telemetry)."""
    new_store = StripeStore(root, new_cfg, device=store.device)
    before = store.telemetry.copy()
    for key, meta in list(store.objects.items()):
        if key.endswith("#cont"):
            continue  # continuation objects ride along with their head
        payload = store.get(key)
        new_store.put(key, payload.tobytes())
    new_store.seal()
    new_store.save_manifest()
    t = store.telemetry
    tele = {"bytes_moved": t.bytes_read - before.bytes_read,
            "blocks_read": t.blocks_read - before.blocks_read,
            "sim_seconds": t.sim_seconds - before.sim_seconds}
    return new_store, tele
