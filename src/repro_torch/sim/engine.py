"""Batched event-driven fleet reliability simulator (DESIGN.md §12).

Simulates many independent trials of one stripe's disk fleet — Weibull disk
lifetimes, correlated node/rack bursts, latent sector errors with periodic
scrubbing, and one-at-a-time repairs whose mean duration comes from the
*real* repair cost model (``StripeModel.tau_hours`` — planner plan costs or
the Markov chain's average profile, through the shared
``reliability.repair_hours``) — and estimates MTTDL from observed losses.

The vectorization strategy is **trials in lockstep**: every trial owns an
independent simulated clock, so there is no global event ordering to
respect — each *epoch* processes exactly one event per still-active trial:

1. **select** (torch, on the device): the per-process next-event matrices
   go over in one copy; each trial's per-process minima stack into a
   ``(T, 6)`` candidate matrix — disk-fail, node-burst, rack-burst,
   latent-error, repair-done, scrub — and a min/argmin picks the event;
   time, column and unit come back in one copy. Ties break by fixed
   column priority then lowest unit id (``argmin``'s first-index rule),
   mirroring ``repro_torch.ftx.events.event_order``.
2. **decide** (host): outcome logic — accept/reject/loss, decodability via
   the memoized ``StripeModel`` — touches dict caches and frozensets, so
   it stays in Python; crucially no outcome depends on a random value, so
   every draw the epoch needs is known *before* drawing.
3. **draw** (torch, on the device): the epoch's draws across all trials
   evaluate as one counter-based batch (``repro_torch.sim.rng``).
4. **apply** (host, numpy): fill the drawn durations back into the
   per-trial schedule on the float32 time grid.

Because every random value is addressed by ``(trial, stream, seq)`` and
every timestamp is rounded once on the shared float32 grid, this engine is
**bit-identical** to the pure-Python per-trial oracle
(``repro_torch.sim.oracle``) — same events, same times, same losses — which is
what the property tests pin.

Model semantics (shared with the oracle):

* ``model="paper"``: a *single-disk* failure that would make the erased
  pattern undecodable at ``f <= p + r`` is **rejected** — the disk draws a
  fresh lifetime and stays up. This is thinning: the accepted failure rate
  from state ``f`` is ``(n-f) * lambda * (1 - q_{f+1})``, exactly the
  paper-model Markov chain's slowed descent. Loss happens when failures
  exceed ``p + r``. Correlated bursts and latent errors (not part of the
  chain) are always strict.
* ``model="strict"``: the failure stands; the first undecodable pattern is
  data loss — the rank-faithful semantics.
* Repairs fix one disk at a time (lowest id first), exponential duration
  with mean ``tau(down)``; any change of the down-set *redraws* the
  completion (memoryless, so the closed-form chain's repair rates are
  reproduced exactly when ``cost_model="average"``).
* A latent sector error marks a live block unreadable (silent until
  counted against decodability); a scrub clears all of them; rebuilding a
  disk clears its latent error.

MTTDL is the censoring-correct exponential MLE: total observed fleet-hours
over observed losses.

Both device calls run on ``device`` — the card unless the caller asks for
the host with ``device="cpu"``, which runs the same torch code there; the
result is the same bit for bit either way. ``SimResult`` splits the wall
time: ``select_seconds`` and ``bits_seconds`` are the two device calls
with their copies (each ends in a copy to the host, so it includes the
wait for the device); the rest is the host loop.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core.reliability import HOURS_PER_YEAR
from repro_torch.core.schemes import LRCScheme
from repro_torch.device import resolve_device
from repro_torch.dist.topology import Topology
from repro_torch.ftx.events import (DataLossEvent, DiskFailEvent, FleetEvent,
                              NodeFailEvent, RackFailEvent, RepairDoneEvent,
                              ScrubEvent, SectorErrorEvent)

from .rng import BitSource, exp_hours, later, weibull_hours
from .units import SimParams, StripeModel, UnitHierarchy

_INF = np.float32(np.inf)

# Candidate-column priority (ties break left to right, matching the kind
# ranks in repro_torch.ftx.events): disk fail, node burst, rack burst, latent
# error, repair done, scrub.
COL_DISK, COL_NODE, COL_RACK, COL_LSE, COL_REPAIR, COL_SCRUB = range(6)


def select(schedule: tuple[np.ndarray, ...], device: torch.device
           ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Each trial's next event: ``(time, column, unit)`` per row of the
    ``(next_fail, next_node, next_rack, next_lse, repair_t, next_scrub)``
    schedule — ``(T, D)``, ``(T, N)``, ``(T, R)``, ``(T, D)`` float32
    matrices and two ``(T,)`` vectors — in one copy to ``device`` and one
    back. Ties take the first column, then the lowest unit (``argmin``'s
    first-index rule); an all-``inf`` row picks column 0, unit 0."""
    nf, nn, nr, nl, rt, ns = schedule
    widths = [nf.shape[1], nn.shape[1], nr.shape[1], nl.shape[1], 1, 1]
    host = np.concatenate([nf, nn, nr, nl, rt[:, None], ns[:, None]], 1)
    parts = torch.from_numpy(host).to(device).split(widths, 1)
    cols = torch.stack([m.min(1).values for m in parts], 1)
    col = torch.argmin(cols, 1)
    units = torch.stack([m.argmin(1) for m in parts[:4]]
                        + [torch.zeros_like(col)] * 2, 1)
    unit = units.gather(1, col[:, None])[:, 0]
    tmin = cols.gather(1, col[:, None])[:, 0]
    out = torch.stack([tmin.view(torch.int32).long(), col, unit])
    out = out.cpu().numpy()
    return out[0].astype(np.int32).view(np.float32), out[1], out[2]


def select_np(schedule: tuple[np.ndarray, ...]
              ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """:func:`select` in numpy on the host: the plain version, for checks
    only."""
    nf, nn, nr, nl, rt, ns = schedule
    cols = np.stack([nf.min(1), nn.min(1), nr.min(1), nl.min(1), rt, ns], 1)
    col = np.argmin(cols, 1)
    zero = np.zeros_like(col)
    units = np.stack([nf.argmin(1), nn.argmin(1), nr.argmin(1),
                      nl.argmin(1), zero, zero], 1)
    rows = np.arange(len(col))
    return cols[rows, col], col, units[rows, col]


@dataclasses.dataclass
class SimResult:
    """One simulation run's accounting."""
    scheme: str
    trials: int
    horizon_hours: float
    seed: int
    losses: int
    observed_hours: float          # summed exposure, censoring-aware
    loss_times: list[float]
    events: int                    # events processed (one per active trial
    #                                per epoch, no-ops included)
    epochs: int                    # batched selection rounds executed
    rejected: int                  # paper-model thinned disk failures
    counts: dict[str, int]         # processed events by kind
    wall_seconds: float
    event_log: Optional[list[list[FleetEvent]]] = None  # per trial
    select_seconds: float = 0.0    # device selects, copies and waits
    bits_seconds: float = 0.0      # device draws, copies and waits

    @property
    def mttdl_hours(self) -> float:
        """Censoring-correct exponential MLE: exposure over losses."""
        return (self.observed_hours / self.losses if self.losses
                else float("inf"))

    @property
    def mttdl_years(self) -> float:
        return self.mttdl_hours / HOURS_PER_YEAR

    @property
    def event_parallelism(self) -> float:
        """Mean events retired per batched epoch — how much lockstep
        batching amortizes each selection/draw launch over (1.0 = a pure
        sequential event loop). Deterministic given (config, seed)."""
        return self.events / max(1, self.epochs)


class _Draw:
    """One pending draw order: filled after the epoch's batched RNG call."""
    __slots__ = ("trial", "stream", "seq", "kind", "mean", "tt", "slot")

    def __init__(self, trial, stream, seq, kind, mean, tt, slot):
        self.trial = trial
        self.stream = stream
        self.seq = seq
        self.kind = kind          # "weibull" | "exp"
        self.mean = mean          # exp mean hours (weibull uses params)
        self.tt = tt              # event time the duration adds onto
        self.slot = slot          # ("fail", d) | ("node", i) | ("rack", j)
        #                           | ("lse", d) | ("repair",)


def simulate(scheme: LRCScheme, params: SimParams, *, trials: int,
             horizon_hours: float, seed: int = 0,
             hierarchy: Optional[UnitHierarchy] = None,
             topology: Optional[Topology] = None,
             policy: str = "contiguous",
             record_events: bool = False,
             device: str | torch.device = "cuda") -> SimResult:
    """Run ``trials`` lockstep trials to ``horizon_hours`` (or loss),
    selecting and drawing on ``device``."""
    dev = resolve_device(device)
    hier = hierarchy or UnitHierarchy.from_topology(scheme.n, topology,
                                                   policy)
    if hier.num_disks != scheme.n:
        raise ValueError(f"hierarchy has {hier.num_disks} disks, "
                         f"scheme needs n={scheme.n}")
    model = StripeModel(scheme, params)
    src = BitSource(seed, dev)
    spent = {"select": 0.0, "bits": 0.0}
    t_wall = time.perf_counter()

    T, D = int(trials), hier.num_disks
    N, R = max(1, hier.num_nodes), max(1, hier.num_racks)
    horizon = np.float32(horizon_hours)
    p = params

    # -------------------------------------------------------------- state
    next_fail = np.full((T, D), _INF, np.float32)
    next_node = np.full((T, N), _INF, np.float32)
    next_rack = np.full((T, R), _INF, np.float32)
    next_lse = np.full((T, D), _INF, np.float32)
    repair_t = np.full(T, _INF, np.float32)
    repair_sched = np.zeros(T, np.float32)
    repair_cost = np.zeros(T, np.float64)
    next_scrub = np.full(T, np.float32(p.scrub_hours) if p.scrub_hours > 0
                         else _INF, np.float32)
    down = [set() for _ in range(T)]
    lse = [set() for _ in range(T)]
    seq = [dict() for _ in range(T)]        # stream id -> draws consumed
    active = np.ones(T, bool)
    observed = np.zeros(T, np.float64)
    loss_times: list[float] = []
    log: Optional[list[list[FleetEvent]]] = \
        [[] for _ in range(T)] if record_events else None
    counts = {"disk_fail": 0, "disk_fail_rejected": 0, "node_fail": 0,
              "rack_fail": 0, "sector_error": 0, "scrub": 0,
              "repair_done": 0, "data_loss": 0, "noop": 0}

    def take(trial: int, stream: int) -> int:
        s = seq[trial]
        got = s.get(stream, 0)
        s[stream] = got + 1
        return got

    # Initial lifetimes (all disks) and burst/error arrivals, one batch.
    init: list[_Draw] = []
    for trial in range(T):
        for d in range(D):
            st = hier.stream_disk_fail(d)
            init.append(_Draw(trial, st, take(trial, st), "weibull", 0.0,
                              np.float32(0.0), ("fail", d)))
        if p.node_burst_hours > 0:
            for i in range(hier.num_nodes):
                st = hier.stream_node_fail(i)
                init.append(_Draw(trial, st, take(trial, st), "exp",
                                  p.node_burst_hours, np.float32(0.0),
                                  ("node", i)))
        if p.rack_burst_hours > 0:
            for j in range(hier.num_racks):
                st = hier.stream_rack_fail(j)
                init.append(_Draw(trial, st, take(trial, st), "exp",
                                  p.rack_burst_hours, np.float32(0.0),
                                  ("rack", j)))
        if p.lse_hours > 0:
            for d in range(D):
                st = hier.stream_lse(d)
                init.append(_Draw(trial, st, take(trial, st), "exp",
                                  p.lse_hours, np.float32(0.0), ("lse", d)))

    def settle(orders: list[_Draw]) -> None:
        """Batched RNG for the epoch's orders, then fill the schedule."""
        if not orders:
            return
        triples = np.array([[o.trial, o.stream, o.seq] for o in orders],
                           np.uint32)
        t0 = time.perf_counter()
        bits = src.bits(triples)
        spent["bits"] += time.perf_counter() - t0
        for o, b in zip(orders, bits):
            dur = (weibull_hours(b, p.weibull_scale_hours, p.weibull_shape)
                   if o.kind == "weibull" else exp_hours(b, o.mean))
            at = later(o.tt, dur)
            kind, tr = o.slot[0], o.trial
            if kind == "fail":
                next_fail[tr, o.slot[1]] = at
            elif kind == "node":
                next_node[tr, o.slot[1]] = at
            elif kind == "rack":
                next_rack[tr, o.slot[1]] = at
            elif kind == "lse":
                next_lse[tr, o.slot[1]] = at
            else:
                repair_t[tr] = at
                repair_sched[tr] = o.tt

    settle(init)

    def emit(trial: int, ev: FleetEvent) -> None:
        if log is not None:
            log[trial].append(ev)

    def retire(trial: int, hours: float) -> None:
        active[trial] = False
        observed[trial] = hours
        next_fail[trial] = next_node[trial] = _INF
        next_rack[trial] = next_lse[trial] = _INF
        repair_t[trial] = next_scrub[trial] = _INF

    def lose(trial: int, tt: np.float32, mask: frozenset[int]) -> None:
        counts["data_loss"] += 1
        loss_times.append(float(tt))
        emit(trial, DataLossEvent(t=float(tt), blocks=tuple(sorted(mask))))
        retire(trial, float(tt))

    def order_repair(trial: int, tt: np.float32,
                     orders: list[_Draw]) -> None:
        """(Re)draw the in-flight repair for the current down-set."""
        pattern = frozenset(down[trial])
        tau = model.tau_hours(pattern)
        repair_cost[trial] = model.cost_blocks(pattern)
        orders.append(_Draw(trial, hier.stream_repair,
                            take(trial, hier.stream_repair), "exp", tau, tt,
                            ("repair",)))

    # --------------------------------------------------------------- loop
    events = epochs = 0
    while active.any():
        t0 = time.perf_counter()
        tmin, col, unit = select((next_fail, next_node, next_rack, next_lse,
                                  repair_t, next_scrub), dev)
        spent["select"] += time.perf_counter() - t0
        epochs += 1
        orders: list[_Draw] = []
        for trial in np.flatnonzero(active):
            trial = int(trial)
            tt = np.float32(tmin[trial])
            if not tt < horizon:          # censored (inf-only schedules too)
                retire(trial, float(horizon))
                continue
            events += 1
            c, u = int(col[trial]), int(unit[trial])
            dn, er = down[trial], lse[trial]
            if c == COL_DISK:
                mask = frozenset(dn | er | {u})
                f_after = len(dn) + 1
                if f_after > model.fmax:
                    counts["disk_fail"] += 1
                    emit(trial, DiskFailEvent(
                        t=float(tt), disk=u, node=hier.node_of_disk[u],
                        rack=hier.rack_of_node[hier.node_of_disk[u]]))
                    lose(trial, tt, mask)
                    continue
                if not model.decodable(mask) and p.model == "paper":
                    # Thinning: the failure is rejected; fresh lifetime.
                    counts["disk_fail_rejected"] += 1
                    st = hier.stream_disk_fail(u)
                    orders.append(_Draw(trial, st, take(trial, st),
                                        "weibull", 0.0, tt, ("fail", u)))
                    continue
                counts["disk_fail"] += 1
                emit(trial, DiskFailEvent(
                    t=float(tt), disk=u, node=hier.node_of_disk[u],
                    rack=hier.rack_of_node[hier.node_of_disk[u]]))
                if not model.decodable(mask):      # strict: loss stands
                    lose(trial, tt, mask)
                    continue
                dn.add(u)
                next_fail[trial, u] = _INF
                order_repair(trial, tt, orders)
            elif c in (COL_NODE, COL_RACK):
                if c == COL_NODE:
                    st = hier.stream_node_fail(u)
                    mean, slot = p.node_burst_hours, ("node", u)
                    burst = hier.disks_of_node(u)
                else:
                    st = hier.stream_rack_fail(u)
                    mean, slot = p.rack_burst_hours, ("rack", u)
                    burst = hier.disks_of_rack(u)
                orders.append(_Draw(trial, st, take(trial, st), "exp", mean,
                                    tt, slot))
                newly = [d for d in burst if d not in dn]
                if not newly:
                    counts["noop"] += 1
                    continue
                counts["node_fail" if c == COL_NODE else "rack_fail"] += 1
                emit(trial, NodeFailEvent(
                    t=float(tt), node=u,
                    rack=hier.rack_of_node[u]) if c == COL_NODE
                    else RackFailEvent(t=float(tt), rack=u))
                dn.update(newly)
                next_fail[trial, newly] = _INF
                mask = frozenset(dn | er)
                if not model.decodable(frozenset(dn)) or \
                        not model.decodable(mask):
                    lose(trial, tt, mask)
                    continue
                order_repair(trial, tt, orders)
            elif c == COL_LSE:
                st = hier.stream_lse(u)
                orders.append(_Draw(trial, st, take(trial, st), "exp",
                                    p.lse_hours, tt, ("lse", u)))
                if u in dn or u in er:
                    counts["noop"] += 1
                    continue
                counts["sector_error"] += 1
                er.add(u)
                emit(trial, SectorErrorEvent(t=float(tt), disk=u))
                mask = frozenset(dn | er)
                if not model.decodable(mask):
                    lose(trial, tt, mask)
            elif c == COL_REPAIR:
                target = min(dn)
                counts["repair_done"] += 1
                emit(trial, RepairDoneEvent(
                    t=float(tt), unit=target, kind="disk",
                    started_at=float(repair_sched[trial]),
                    blocks_read=int(round(repair_cost[trial])),
                    sim_seconds=float((tt - repair_sched[trial]) * 3600.0),
                    local=bool(repair_cost[trial] < scheme.k)))
                dn.discard(target)
                er.discard(target)
                st = hier.stream_disk_fail(target)
                orders.append(_Draw(trial, st, take(trial, st), "weibull",
                                    0.0, tt, ("fail", target)))
                if dn:
                    order_repair(trial, tt, orders)
                else:
                    repair_t[trial] = _INF
            else:                          # COL_SCRUB
                counts["scrub"] += 1
                er.clear()
                emit(trial, ScrubEvent(t=float(tt), disk=-1))
                next_scrub[trial] = later(tt, np.float32(p.scrub_hours))
        settle(orders)

    return SimResult(
        scheme=getattr(scheme, "name", scheme.__class__.__name__),
        trials=T, horizon_hours=float(horizon_hours), seed=seed,
        losses=counts["data_loss"], observed_hours=float(observed.sum()),
        loss_times=loss_times, events=events, epochs=epochs,
        rejected=counts["disk_fail_rejected"], counts=counts,
        wall_seconds=time.perf_counter() - t_wall, event_log=log,
        select_seconds=spent["select"], bits_seconds=spent["bits"])
