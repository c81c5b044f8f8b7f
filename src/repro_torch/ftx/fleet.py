"""Fleet-level durability sizing and fleet repair orchestration.

The paper's MTTDL analysis is per-stripe; an operator provisioning an
erasure-coded checkpoint store for an N-node training fleet needs the
fleet-level view: with S independent stripes, MTTDL_fleet ≈ MTTDL_stripe / S
(competing exponentials), and the overhead/durability frontier across
schemes and (k, r, p). ``size_fleet`` sweeps candidate geometries and
returns those meeting a target fleet MTTDL at minimal storage overhead;
``evaluate`` prices one geometry through the Markov chain of
``repro_torch.core.reliability``.

``repair_failed_nodes`` is the fleet-repair entrypoint: mark nodes down and
rebuild every affected stripe through the store's batched engine, which
groups stripes by failure pattern and issues one compiled plan + one kernel
launch per pattern chunk instead of a Python loop over stripes.
``read_report`` summarizes the degraded-read serving path, which
``repro_torch.serve.BlockServer`` drives with many clients.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

import torch

from repro_torch.core.reliability import ReliabilityParams, stripe_mttdl_years
from repro_torch.core.schemes import make_scheme
from repro_torch.device import resolve_device

from .options import RepairOptions
from .stripestore import SERVE_FIELDS


@dataclasses.dataclass(frozen=True)
class FleetSpec:
    nodes: int                 # hosts contributing checkpoint shards
    state_bytes: int           # total protected state (params + moments)
    block_bytes: int = 1 << 28
    target_mttdl_years: float = 1e6
    params: ReliabilityParams = ReliabilityParams()


@dataclasses.dataclass(frozen=True)
class Candidate:
    scheme: str
    k: int
    r: int
    p: int
    overhead: float            # (n/k) - 1
    stripes: int
    stripe_mttdl_years: float
    fleet_mttdl_years: float

    @property
    def meets(self) -> bool:
        return self.fleet_mttdl_years >= 0


def evaluate(spec: FleetSpec, scheme: str, k: int, r: int, p: int,
             samples: int = 400, model: str = "paper") -> Candidate:
    s = make_scheme(scheme, k, r, p)
    stripes = max(1, -(-spec.state_bytes // (k * spec.block_bytes)))
    per = stripe_mttdl_years(s, spec.params, samples=samples, model=model)
    return Candidate(scheme=scheme, k=k, r=r, p=p,
                     overhead=s.n / k - 1.0, stripes=stripes,
                     stripe_mttdl_years=per,
                     fleet_mttdl_years=per / stripes)


def size_fleet(spec: FleetSpec,
               schemes: tuple[str, ...] = ("azure", "cp-azure", "cp-uniform"),
               geometries: Optional[list[tuple[int, int, int]]] = None,
               samples: int = 300, model: str = "paper") -> list[Candidate]:
    """All candidates meeting the target, cheapest overhead first."""
    geometries = geometries or [(12, 2, 2), (24, 2, 2), (24, 3, 3),
                                (48, 4, 3), (48, 4, 4), (96, 5, 4)]
    out = []
    for scheme in schemes:
        for (k, r, p) in geometries:
            if k + r + p > spec.nodes:
                continue
            try:
                c = evaluate(spec, scheme, k, r, p, samples=samples,
                             model=model)
            except Exception:
                continue
            out.append(c)
    ok = [c for c in out if c.fleet_mttdl_years >= spec.target_mttdl_years]
    pool = ok or out
    return sorted(pool, key=lambda c: (c.overhead, -c.fleet_mttdl_years))


# --------------------------------------------------------------------------
# fleet repair orchestration
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class FleetRepairReport:
    """What a node-failure repair cost, fleet-wide. Each field but
    ``failed_nodes`` and ``plan_cache`` is the key of the same name of
    ``StripeStore.repair_all``'s result, and this is where each is
    documented."""
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
    read_seconds: float = 0.0   # window gathers, submit to last read
    compute_seconds: float = 0.0  # copy in, kernel and copy out
    write_seconds: float = 0.0  # write-backs
    overlap_seconds: float = 0.0  # read + compute + write beyond the wall
    # The calling thread's split of those stages: planning (grouping,
    # plans, destinations) and window creation; blocked on a window's
    # reads; the copy to the device, the kernel (the engine's own timing)
    # and the copy back, which make compute_seconds; blocked on the last
    # write-backs (0 on the synchronous paths, like read_wait). Spans of a
    # torch.profiler trace when one records the caller (repair.plan,
    # pipeline.read_wait, ...; repro_torch.ftx.pipeline).
    plan_seconds: float = 0.0
    read_wait_seconds: float = 0.0
    copy_in_seconds: float = 0.0
    kernel_seconds: float = 0.0
    copy_out_seconds: float = 0.0
    drain_wait_seconds: float = 0.0
    # The readers: wall time summed over block reads, each from its file
    # read to the end of its link sleep, out of reader_threads x
    # wall_seconds (reader_threads: the pools' width; 1 on the synchronous
    # paths, which read inline).
    reader_busy_seconds: float = 0.0
    reader_threads: int = 1
    # The reads' own time in parts, summed over reads (divide by
    # blocks_read for one read): opening, sizing and closing the block
    # file on the slot path; the bytes into the slot (the whole
    # np.fromfile call on the other paths); the link sleep asked for; the
    # sleep's wall time beyond it; waits to enter the read's two sections
    # under the store's telemetry lock; on a reader pool, from when a read
    # could be taken (submitted, and the thread's previous read ended) to
    # its start; and the reader pools' threads' CPU time, from each
    # thread's start to the pool's end (their reads and the hand-offs).
    # Hand-off and CPU time are 0 on the synchronous paths.
    read_open_seconds: float = 0.0
    read_copy_seconds: float = 0.0
    read_sleep_seconds: float = 0.0
    read_overshoot_seconds: float = 0.0
    read_lock_seconds: float = 0.0
    read_handoff_seconds: float = 0.0
    read_cpu_seconds: float = 0.0
    # The call's wall time with no block read in flight.
    no_read_seconds: float = 0.0
    # Bytes of the launches' stacks moved from the host to the device, each
    # block read once; and of those the bytes copied from page-locked
    # memory (0 on the CPU).
    h2d_bytes: int = 0
    h2d_pinned_bytes: int = 0
    # Windows whose gather buffer the staging pool reused, and those that
    # needed a new one (repro_torch.ftx.pipeline.STAGING).
    staging_reused: int = 0
    staging_allocated: int = 0
    # Planning and the GF(2^8) kernel: multi-node plans compiled (planner
    # cache misses, each a planner.compile span inside repair.plan) and
    # their seconds, inside plan_seconds; stripes of repairs_local whose
    # plan has a cascade step; the surviving blocks read for the stripes
    # of repairs_global (their plans' reads, a stripe each, out of
    # blocks_read); the launches' coefficient table chunks,
    # ceil(reads / 64) a launch on each device slice, counted by the
    # engine (0 where the GF(2^8) kernel does not run, as on the CPU).
    plans_compiled: int = 0
    plan_compile_seconds: float = 0.0
    repairs_cascaded: int = 0
    reads_global: int = 0
    kernel_table_chunks: int = 0
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
    def reader_occupancy(self) -> float:
        """Share of the readers' wall time spent in a read (0 with no
        reads)."""
        slots = self.reader_threads * self.wall_seconds
        return self.reader_busy_seconds / slots if slots > 0 else 0.0

    @property
    def read_rest_seconds(self) -> float:
        """The readers' busy time outside the timed parts of their reads
        (open, copy, sleep, overshoot, lock): Python between the steps."""
        return self.reader_busy_seconds - (
            self.read_open_seconds + self.read_copy_seconds
            + self.read_sleep_seconds + self.read_overshoot_seconds
            + self.read_lock_seconds)

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
            for name in SERVE_FIELDS:
                setattr(t, name, 0)
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
    through the async pipeline. ``options.mesh_rules`` (or an ambient
    ``with_rules`` context) device-shards each launch's stripe axis.
    ``options.placement`` (a ``repro_torch.dist.placement.PlacementMap``;
    defaults to the store's, else one derived from the node->shard
    default for the mesh's stripe-axis span) drives the per-shard gather
    and the local/remote read accounting. ``options.schedule`` (default
    ``cfg.stripe_schedule``) picks the stripe -> device-shard assignment of
    each batched chunk: ``"locality"`` (``repro_torch.dist.schedule``) permutes
    chunks onto the shards owning most of their surviving blocks,
    bit-identically and never predicted worse than the contiguous
    ``"none"`` default. The report's fields say what each of these did
    (:class:`FleetRepairReport`). ``revive`` marks the nodes UP again after
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
        plan_cache={k: after[k] - before[k] for k in after},
        **{f.name: tele[f.name] for f in dataclasses.fields(FleetRepairReport)
           if f.name in tele})
