"""One fleet-event vocabulary for simulation and trace files.

The event-driven fleet simulator (``repro_torch.sim``) emits these events
from both its batched engine and its pure-Python oracle, which is what
lets the bit-identity tests compare the two paths event by event; the same
schema is what a failure injector driving a live store, trace replay, or
a real-cluster trace parser would read and write.

All events are frozen dataclasses with a simulated timestamp ``t`` in
hours. ``to_doc``/``from_doc`` round-trip them through plain dicts (JSON
traces); :func:`event_order` is the canonical sort key — time first, then a
fixed kind rank (failures before repairs at equal times, matching the
simulator's event-selection tie-break), then the unit id.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable


@dataclasses.dataclass(frozen=True)
class FleetEvent:
    """Base event: something happened at simulated time ``t`` (hours)."""
    t: float


@dataclasses.dataclass(frozen=True)
class DiskFailEvent(FleetEvent):
    """A disk (the block-holding unit) failed; its blocks are lost until a
    repair rebuilds them. ``node``/``rack`` carry the enclosing units when
    the emitter knows the hierarchy (-1 otherwise)."""
    disk: int = 0
    node: int = -1
    rack: int = -1


@dataclasses.dataclass(frozen=True)
class NodeFailEvent(FleetEvent):
    """A whole node failed — every disk (and block) it holds goes down at
    once. A stripe store's nodes hold one block per stripe; the simulator
    emits one per correlated node-level burst."""
    node: int = 0
    rack: int = -1


@dataclasses.dataclass(frozen=True)
class RackFailEvent(FleetEvent):
    """A rack-level correlated failure: every node in the rack (a topology
    failure domain) loses its disks simultaneously."""
    rack: int = 0


@dataclasses.dataclass(frozen=True)
class SectorErrorEvent(FleetEvent):
    """A latent sector error surfaced on ``disk``: ``block`` (when known)
    is unreadable until the next scrub or rebuild touches it. These are
    silent — they cost nothing until a repair needs the affected block."""
    disk: int = 0
    block: int = -1


@dataclasses.dataclass(frozen=True)
class ScrubEvent(FleetEvent):
    """A scrub pass completed, clearing latent sector errors on ``disk``
    (``-1`` = a fleet-wide sweep, the simulator's periodic scrub)."""
    disk: int = -1


@dataclasses.dataclass(frozen=True)
class RepairDoneEvent(FleetEvent):
    """A repair finished at ``t``: unit ``unit`` (of ``kind``) is whole
    again. ``started_at`` dates the triggering failure; ``blocks_read`` /
    ``sim_seconds`` carry the real repair pipeline's bandwidth accounting
    when the emitter ran one (a live store's repair does; the simulator
    carries the modelled transfer cost)."""
    unit: int = 0
    kind: str = "node"              # "disk" | "node" | "rack"
    started_at: float = 0.0
    blocks_read: int = 0
    sim_seconds: float = 0.0
    local: bool = True


@dataclasses.dataclass(frozen=True)
class DataLossEvent(FleetEvent):
    """The failure pattern went undecodable: data loss at ``t``. ``blocks``
    is the erased-block pattern that crossed the line (down plus latent)."""
    blocks: tuple[int, ...] = ()


# kind tag <-> class, for serialization and replay dispatch.
EVENT_TYPES: dict[str, type] = {
    "disk_fail": DiskFailEvent,
    "node_fail": NodeFailEvent,
    "rack_fail": RackFailEvent,
    "sector_error": SectorErrorEvent,
    "scrub": ScrubEvent,
    "repair_done": RepairDoneEvent,
    "data_loss": DataLossEvent,
}
_KIND_OF_TYPE = {cls: kind for kind, cls in EVENT_TYPES.items()}
# Sort rank at equal timestamps: failures and sector errors land before the
# repair/scrub that would clear them — the same tie-break the simulator's
# column-ordered argmin applies.
_KIND_RANK = {"disk_fail": 0, "node_fail": 1, "rack_fail": 2,
              "sector_error": 3, "repair_done": 4, "scrub": 5,
              "data_loss": 6}


def kind_of(event: FleetEvent) -> str:
    """The schema tag of ``event`` (``"node_fail"``, ``"repair_done"``...).

    Subclasses report their closest registered ancestor.
    """
    for cls in type(event).__mro__:
        tag = _KIND_OF_TYPE.get(cls)
        if tag is not None:
            return tag
    raise TypeError(f"not a registered fleet event: {type(event).__name__}")


def event_order(event: FleetEvent) -> tuple:
    """Canonical sort key: ``(t, kind rank, unit id)``."""
    unit = next((getattr(event, f) for f in ("disk", "node", "rack", "unit")
                 if hasattr(event, f)), -1)
    return (event.t, _KIND_RANK[kind_of(event)], unit)


def to_doc(event: FleetEvent) -> dict:
    """Serialize to a plain dict: ``{"event": <schema tag>, **fields}``.

    The discriminator key is ``"event"`` (not ``"kind"``) so it can never
    collide with a field — ``RepairDoneEvent.kind`` names the repaired
    unit's level and must survive the round-trip.
    """
    doc = dataclasses.asdict(event)
    doc["event"] = kind_of(event)
    return doc


def from_doc(doc: dict) -> FleetEvent:
    """Rebuild an event from :func:`to_doc` output (JSON trace rows)."""
    doc = dict(doc)
    kind = doc.pop("event")
    cls = EVENT_TYPES.get(kind)
    if cls is None:
        raise ValueError(f"unknown fleet-event kind {kind!r} "
                         f"(known: {', '.join(EVENT_TYPES)})")
    fields = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in doc.items() if k in fields})


def sort_events(events: Iterable[FleetEvent]) -> list[FleetEvent]:
    """Events in canonical order (stable under :func:`event_order`)."""
    return sorted(events, key=event_order)


def dump_trace(events: Iterable[FleetEvent], path) -> None:
    """Write an event trace as a JSON file, canonically ordered.

    The on-disk shape is ``{"events": [to_doc(e), ...]}`` with sorted
    dict keys and a fixed indent — byte-stable for a given event list, so
    committed trace fixtures diff cleanly and a dump->load->dump cycle is
    the identity (the golden-file property the replay tests pin).
    """
    import json
    from pathlib import Path

    docs = [to_doc(e) for e in sort_events(events)]
    Path(path).write_text(
        json.dumps({"events": docs}, indent=2, sort_keys=True) + "\n")


def load_trace(path) -> list[FleetEvent]:
    """Read a :func:`dump_trace` file back into canonically ordered events.

    Accepts the ``{"events": [...]}`` envelope or a bare JSON list of
    event docs (hand-written fixtures)."""
    import json
    from pathlib import Path

    doc = json.loads(Path(path).read_text())
    rows = doc["events"] if isinstance(doc, dict) else doc
    return sort_events(from_doc(r) for r in rows)
