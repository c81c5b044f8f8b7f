"""Fleet repair orchestration and the degraded-read report.

``repair_failed_nodes`` is the fleet-repair entrypoint: mark nodes down and
rebuild every affected stripe through the store's batched engine, which
groups stripes by failure pattern and issues one compiled plan + one kernel
launch per pattern chunk instead of a Python loop over stripes.
``read_report`` summarizes the degraded-read serving path, which
``repro_torch.serve.BlockServer`` drives with many clients. Fleet
durability sizing (``size_fleet``/``evaluate``) needs the port's own copy
of ``core/reliability.py`` and comes with it in a later slice (ROADMAP
queue 1), ahead of the reliability simulator.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

import torch

from repro_torch.device import resolve_device

from .options import RepairOptions


# --------------------------------------------------------------------------
# fleet repair orchestration
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class FleetRepairReport:
    """What a node-failure repair cost, fleet-wide."""
    failed_nodes: tuple[int, ...]
    stripes_repaired: int
    patterns: int               # distinct per-stripe failure patterns seen
    launches: int               # batched kernel launches issued
    blocks_read: int
    bytes_read: int
    sim_seconds: float          # link-model time (paper's repair-time metric)
    wall_seconds: float
    repairs_local: int
    repairs_global: int
    plan_cache: dict            # planner hit/miss/eviction counters
    devices: int = 1            # widest device span of any launch
    device_launches: int = 0    # per-device kernel executions, all launches
    # Async-pipeline observability (repro_torch.ftx.pipeline): per-stage wall
    # spans plus how much of them the double buffer hid. Zero on the
    # synchronous paths except the stage spans, which are accounted there
    # too (serially, so overlap_seconds stays 0).
    pipelined: bool = False
    windows: int = 0            # pipeline windows executed
    replans: int = 0            # windows re-planned after mid-repair failures
    read_seconds: float = 0.0
    compute_seconds: float = 0.0
    write_seconds: float = 0.0
    overlap_seconds: float = 0.0
    # Locality accounting (repro_torch.dist.placement.PlacementMap): repair reads
    # served shard-locally vs. across shards, and the gather bytes each
    # shard pulled — the per-shard split of the batched read stack.
    local_reads: int = 0
    remote_reads: int = 0
    gather_bytes_per_shard: dict = dataclasses.field(default_factory=dict)
    # Locality-aware stripe scheduling (repro_torch.dist.schedule): which
    # stripe->device-shard assignment ran ("locality" or "none") and the
    # predicted shard-local read fraction it achieved vs. what the
    # contiguous assignment would have — the scheduler's uplift, observable
    # per repair. Both are 1.0 when nothing was batched/predicted.
    schedule: str = "none"
    scheduled_local_read_fraction: float = 1.0
    contiguous_local_read_fraction: float = 1.0
    # Rebuild-destination selection (repro_torch.dist.topology.pick_destinations):
    # which write-back policy ran ("in_place" or "topology"), how many
    # rebuilt blocks were re-homed onto surviving nodes, and what fraction
    # of those landed in a domain the stripe already occupied (copyset
    # preservation — the spread policy's width bound, observable).
    destinations: str = "in_place"
    blocks_relocated: int = 0
    destination_copyset_fraction: float = 1.0
    # The kernel formulation the repair launches actually executed
    # (repro_torch.kernels.ops.effective_backend): equals the store's
    # configured backend except the one documented substitution — a "gf"
    # batch on the CPU runs the plain table path and reports "ref". On the
    # card a "gf" repair reports "gf": it ran the CUDA kernel. Recorded per
    # repair so no backend choice is ever silently downgraded.
    effective_backend: str = ""

    @property
    def stripes_per_launch(self) -> float:
        return self.stripes_repaired / max(1, self.launches)

    @property
    def schedule_uplift(self) -> float:
        """Scheduled over contiguous predicted local fraction (1.0 = the
        scheduler found nothing to improve, or scheduling was off; ``inf``
        when it improved on a contiguous assignment with zero locality)."""
        if self.contiguous_local_read_fraction <= 0:
            return 1.0 if self.scheduled_local_read_fraction <= 0 \
                else float("inf")
        return (self.scheduled_local_read_fraction
                / self.contiguous_local_read_fraction)

    @property
    def overlap_ratio(self) -> float:
        """Fraction of stage time hidden by pipelining (0 = fully serial)."""
        busy = self.read_seconds + self.compute_seconds + self.write_seconds
        return self.overlap_seconds / busy if busy > 0 else 0.0

    @property
    def local_read_fraction(self) -> float:
        """Fraction of repair reads served from the reading shard's nodes."""
        total = self.local_reads + self.remote_reads
        return self.local_reads / total if total else 1.0


@dataclasses.dataclass(frozen=True)
class DegradedReadReport:
    """What the degraded-read serving path did, fleet-wide.

    The serving-side sibling of :class:`FleetRepairReport`: built from the
    store's serving counters (``StripeStore.read``/``read_range``) plus the
    read-latency reservoir, by :func:`read_report`. All counters are exact;
    the latency quantiles cover the recorder's retained window.
    """
    direct_reads: int           # requests served straight from live blocks
    degraded_reads: int         # requests that landed on a lost block
    coalesced_reads: int        # degraded requests served by another
    #                             request's in-flight decode
    decode_launches: int        # engine launches the serving path issued
    local_decodes: int          # ... with a local (group/cascade) plan
    global_decodes: int         # ... that fell back to a global decode
    replans: int                # decodes re-planned after a source died
    cache_hits: int
    cache_misses: int
    cache_invalidations: int    # hot entries dropped by repair/write-back
    served_bytes: int           # payload bytes returned to clients
    blocks_read: int            # source blocks fetched (all paths)
    bytes_read: int
    latency: dict               # count/bytes/p50_ms/p99_ms/mean_ms/max_ms

    @property
    def coalescing_ratio(self) -> float:
        """Degraded requests per decode launch: how many reads each launch
        amortized over (1.0 = naive per-request decode; cache hits and
        coalesced waiters both push this up)."""
        return self.degraded_reads / max(1, self.decode_launches)

    @property
    def cache_hit_rate(self) -> float:
        lookups = self.cache_hits + self.cache_misses
        return self.cache_hits / lookups if lookups else 0.0

    @property
    def local_decode_fraction(self) -> float:
        """Fraction of serving decodes satisfied without a global decode —
        the paper's low-bandwidth degraded-read claim, counted."""
        total = self.local_decodes + self.global_decodes
        return self.local_decodes / total if total else 1.0

    @property
    def p50_ms(self) -> float:
        return self.latency.get("p50_ms", 0.0)

    @property
    def p99_ms(self) -> float:
        return self.latency.get("p99_ms", 0.0)


def read_report(store, *, reset: bool = False) -> DegradedReadReport:
    """Snapshot the store's degraded-read serving telemetry.

    ``reset=True`` also zeroes the serving counters and the latency window
    (repair/locality telemetry is left untouched), so per-scenario load
    generators can diff cleanly.
    """
    t = store.telemetry
    with store._tele_lock:
        snap = t.copy()
    latency = (store.read_latency.reset() if reset
               else store.read_latency.snapshot())
    if reset:
        with store._tele_lock:
            t.direct_reads = t.degraded_reads = t.coalesced_reads = 0
            t.serve_decode_launches = 0
            t.serve_local_decodes = t.serve_global_decodes = 0
            t.serve_replans = 0
            t.cache_hits = t.cache_misses = t.cache_invalidations = 0
            t.served_bytes = 0
    return DegradedReadReport(
        direct_reads=snap.direct_reads,
        degraded_reads=snap.degraded_reads,
        coalesced_reads=snap.coalesced_reads,
        decode_launches=snap.serve_decode_launches,
        local_decodes=snap.serve_local_decodes,
        global_decodes=snap.serve_global_decodes,
        replans=snap.serve_replans,
        cache_hits=snap.cache_hits,
        cache_misses=snap.cache_misses,
        cache_invalidations=snap.cache_invalidations,
        served_bytes=snap.served_bytes,
        blocks_read=snap.blocks_read,
        bytes_read=snap.bytes_read,
        latency=latency,
    )


def repair_failed_nodes(store, nodes: Iterable[int], *,
                        spare_of: Optional[dict[int, int]] = None,
                        revive: bool = True,
                        options: Optional[RepairOptions] = None,
                        device: str | torch.device = "cuda"
                        ) -> FleetRepairReport:
    """Fail ``nodes`` and rebuild every affected stripe in the store.

    All stripes whose blocks lived on the failed nodes are grouped by
    failure pattern and repaired through the store's batched engine — one
    launch per (pattern, chunk). ``options``
    (:class:`repro_torch.ftx.options.RepairOptions`) carries the execution
    knobs.

    ``options.pipeline`` (default: on when ``cfg.pipeline_window > 0``)
    overlaps each window's disk reads, device launch and write-back
    through the async pipeline; the report's ``read/compute/write_seconds``
    and ``overlap_seconds`` fields make the overlap observable.
    ``options.mesh_rules`` (or an ambient ``with_rules`` context)
    device-shards each launch's stripe axis; the report's
    ``devices``/``device_launches`` fields record the resulting per-device
    launch counts. ``options.placement`` (a
    ``repro_torch.dist.placement.PlacementMap``; defaults to the store's, else
    one derived from the node->shard default for the mesh's stripe-axis
    span) drives the per-shard gather and the local/remote read accounting
    reported via ``local_reads``/``remote_reads``/
    ``gather_bytes_per_shard``. ``options.schedule`` (default
    ``cfg.stripe_schedule``) picks the stripe -> device-shard assignment of
    each batched chunk: ``"locality"`` (``repro_torch.dist.schedule``) permutes
    chunks onto the shards owning most of their surviving blocks,
    bit-identically and never predicted worse than the contiguous
    ``"none"`` default; the report's ``scheduled_local_read_fraction`` vs
    ``contiguous_local_read_fraction`` (and ``schedule_uplift``) make the
    difference observable. ``revive`` marks the nodes UP again after
    the rebuild (blocks were re-materialized in place or onto spares).

    ``device`` names where the repair runs — the card unless the caller
    asks for the CPU — and must be the store's device.
    """
    dev = resolve_device(device)
    if dev != store.device:
        raise ValueError(f"repair on {dev} but the store runs on "
                         f"{store.device}")
    o = options if options is not None else RepairOptions()
    nodes = tuple(nodes)
    for node in nodes:
        store.fail_node(node)
    before = store.codec.planner.stats.snapshot()
    tele = store.repair_all(spare_of=spare_of, options=o)
    after = store.codec.planner.stats.snapshot()
    if revive:
        for node in nodes:
            store.revive_node(node)
    return FleetRepairReport(
        failed_nodes=nodes,
        stripes_repaired=tele["stripes_repaired"],
        patterns=tele["patterns"],
        launches=tele["launches"],
        devices=tele.get("devices", 1),
        device_launches=tele.get("device_launches", tele["launches"]),
        blocks_read=tele["blocks_read"],
        bytes_read=tele["bytes_read"],
        sim_seconds=tele["sim_seconds"],
        wall_seconds=tele["wall_seconds"],
        repairs_local=tele["repairs_local"],
        repairs_global=tele["repairs_global"],
        plan_cache={k: after[k] - before[k] for k in after},
        pipelined=tele.get("pipelined", False),
        windows=tele.get("windows", 0),
        replans=tele.get("replans", 0),
        read_seconds=tele.get("read_seconds", 0.0),
        compute_seconds=tele.get("compute_seconds", 0.0),
        write_seconds=tele.get("write_seconds", 0.0),
        overlap_seconds=tele.get("overlap_seconds", 0.0),
        local_reads=tele.get("local_reads", 0),
        remote_reads=tele.get("remote_reads", 0),
        gather_bytes_per_shard=tele.get("gather_bytes_per_shard", {}),
        schedule=tele.get("schedule", "none"),
        scheduled_local_read_fraction=tele.get(
            "scheduled_local_read_fraction", 1.0),
        contiguous_local_read_fraction=tele.get(
            "contiguous_local_read_fraction", 1.0),
        destinations=tele.get("destinations", "in_place"),
        blocks_relocated=tele.get("blocks_relocated", 0),
        destination_copyset_fraction=tele.get(
            "destination_copyset_fraction", 1.0),
        effective_backend=tele.get("effective_backend",
                                   store.cfg.backend),
    )
