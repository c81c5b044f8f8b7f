"""Pure-Python event-loop oracle for the batched simulator.

Runs each trial to completion with an ordinary one-event-at-a-time loop —
no batching, no lockstep — consuming the *same* counter-addressed random
bits (``repro_torch.sim.rng``) and the same float32 time grid as
``repro_torch.sim.engine``. Because a draw's identity is its
``(trial, stream, seq)`` triple and every timestamp rounds through
``later``, the two paths must produce bit-identical event sequences;
the tests pin that on small horizons with every failure process switched
on. Keep any semantic change mirrored in both files.

Each draw is one ``BitSource.bit1`` call on ``device``: on the card that
is one device round trip per draw, so the oracle is for small trial
counts; ``device="cpu"`` draws the same bits on the host.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core.schemes import LRCScheme
from repro_torch.device import resolve_device
from repro_torch.dist.topology import Topology
from repro_torch.ftx.events import (DataLossEvent, DiskFailEvent, FleetEvent,
                              NodeFailEvent, RackFailEvent, RepairDoneEvent,
                              ScrubEvent, SectorErrorEvent)

from .engine import (COL_DISK, COL_LSE, COL_NODE, COL_RACK, COL_REPAIR,
                     SimResult)
from .rng import BitSource, exp_hours, later, weibull_hours
from .units import SimParams, StripeModel, UnitHierarchy

_INF = np.float32(np.inf)


def simulate_oracle(scheme: LRCScheme, params: SimParams, *, trials: int,
                    horizon_hours: float, seed: int = 0,
                    hierarchy: Optional[UnitHierarchy] = None,
                    topology: Optional[Topology] = None,
                    policy: str = "contiguous",
                    record_events: bool = False,
                    device: str | torch.device = "cuda") -> SimResult:
    """Sequential reference run; same signature and result as
    :func:`repro_torch.sim.engine.simulate`."""
    dev = resolve_device(device)
    hier = hierarchy or UnitHierarchy.from_topology(scheme.n, topology,
                                                    policy)
    if hier.num_disks != scheme.n:
        raise ValueError(f"hierarchy has {hier.num_disks} disks, "
                         f"scheme needs n={scheme.n}")
    model = StripeModel(scheme, params)
    src = BitSource(seed, dev)
    t_wall = time.perf_counter()
    horizon = np.float32(horizon_hours)
    p = params
    D, N, R = hier.num_disks, hier.num_nodes, hier.num_racks

    counts = {"disk_fail": 0, "disk_fail_rejected": 0, "node_fail": 0,
              "rack_fail": 0, "sector_error": 0, "scrub": 0,
              "repair_done": 0, "data_loss": 0, "noop": 0}
    observed = 0.0
    loss_times: list[float] = []
    log: Optional[list[list[FleetEvent]]] = \
        [[] for _ in range(trials)] if record_events else None
    events = 0

    for trial in range(trials):
        seq: dict[int, int] = {}

        def take(stream: int) -> int:
            got = seq.get(stream, 0)
            seq[stream] = got + 1
            return got

        def lifetime(disk: int, tt) -> np.float32:
            st = hier.stream_disk_fail(disk)
            b = src.bit1(trial, st, take(st))
            return later(tt, weibull_hours(b, p.weibull_scale_hours,
                                           p.weibull_shape))

        def exp_at(stream: int, mean: float, tt) -> np.float32:
            b = src.bit1(trial, stream, take(stream))
            return later(tt, exp_hours(b, mean))

        next_fail = [lifetime(d, np.float32(0.0)) for d in range(D)]
        next_node = [exp_at(hier.stream_node_fail(i), p.node_burst_hours,
                            np.float32(0.0)) if p.node_burst_hours > 0
                     else _INF for i in range(N)]
        next_rack = [exp_at(hier.stream_rack_fail(j), p.rack_burst_hours,
                            np.float32(0.0)) if p.rack_burst_hours > 0
                     else _INF for j in range(R)]
        next_lse = [exp_at(hier.stream_lse(d), p.lse_hours, np.float32(0.0))
                    if p.lse_hours > 0 else _INF for d in range(D)]
        repair_t = _INF
        repair_sched = np.float32(0.0)
        repair_cost = 0.0
        next_scrub = (np.float32(p.scrub_hours) if p.scrub_hours > 0
                      else _INF)
        down: set[int] = set()
        er: set[int] = set()

        def emit(ev: FleetEvent) -> None:
            if log is not None:
                log[trial].append(ev)

        def order_repair(tt) -> None:
            nonlocal repair_t, repair_sched, repair_cost
            pattern = frozenset(down)
            repair_cost = model.cost_blocks(pattern)
            repair_t = exp_at(hier.stream_repair,
                              model.tau_hours(pattern), tt)
            repair_sched = tt

        while True:
            # Same tie-breaks as the engine's argmin: column priority,
            # then lowest unit id (min() returns the first minimum).
            picks = []
            for arr in (next_fail, next_node, next_rack, next_lse):
                u = min(range(len(arr)), key=arr.__getitem__)
                picks.append((arr[u], u))
            picks.append((repair_t, 0))
            picks.append((next_scrub, 0))
            tt = min(t for t, _ in picks)
            if not tt < horizon:                       # censored
                observed += float(horizon)
                break
            c = next(i for i, (t, _) in enumerate(picks) if t == tt)
            u = picks[c][1]
            events += 1
            lost = False
            if c == COL_DISK:
                mask = frozenset(down | er | {u})
                if len(down) + 1 > model.fmax:
                    counts["disk_fail"] += 1
                    emit(DiskFailEvent(
                        t=float(tt), disk=u, node=hier.node_of_disk[u],
                        rack=hier.rack_of_node[hier.node_of_disk[u]]))
                    lost = True
                elif not model.decodable(mask) and p.model == "paper":
                    counts["disk_fail_rejected"] += 1
                    next_fail[u] = lifetime(u, tt)
                else:
                    counts["disk_fail"] += 1
                    emit(DiskFailEvent(
                        t=float(tt), disk=u, node=hier.node_of_disk[u],
                        rack=hier.rack_of_node[hier.node_of_disk[u]]))
                    if not model.decodable(mask):      # strict: stands
                        lost = True
                    else:
                        down.add(u)
                        next_fail[u] = _INF
                        order_repair(tt)
            elif c in (COL_NODE, COL_RACK):
                if c == COL_NODE:
                    next_node[u] = exp_at(hier.stream_node_fail(u),
                                          p.node_burst_hours, tt)
                    burst = hier.disks_of_node(u)
                else:
                    next_rack[u] = exp_at(hier.stream_rack_fail(u),
                                          p.rack_burst_hours, tt)
                    burst = hier.disks_of_rack(u)
                newly = [d for d in burst if d not in down]
                if not newly:
                    counts["noop"] += 1
                else:
                    counts["node_fail" if c == COL_NODE
                           else "rack_fail"] += 1
                    emit(NodeFailEvent(t=float(tt), node=u,
                                       rack=hier.rack_of_node[u])
                         if c == COL_NODE
                         else RackFailEvent(t=float(tt), rack=u))
                    down.update(newly)
                    for d in newly:
                        next_fail[d] = _INF
                    mask = frozenset(down | er)
                    if not model.decodable(frozenset(down)) or \
                            not model.decodable(mask):
                        lost = True
                    else:
                        order_repair(tt)
            elif c == COL_LSE:
                next_lse[u] = exp_at(hier.stream_lse(u), p.lse_hours, tt)
                if u in down or u in er:
                    counts["noop"] += 1
                else:
                    counts["sector_error"] += 1
                    er.add(u)
                    emit(SectorErrorEvent(t=float(tt), disk=u))
                    mask = frozenset(down | er)
                    if not model.decodable(mask):
                        lost = True
            elif c == COL_REPAIR:
                target = min(down)
                counts["repair_done"] += 1
                emit(RepairDoneEvent(
                    t=float(tt), unit=target, kind="disk",
                    started_at=float(repair_sched),
                    blocks_read=int(round(repair_cost)),
                    sim_seconds=float((tt - repair_sched) * 3600.0),
                    local=repair_cost < scheme.k))
                down.discard(target)
                er.discard(target)
                next_fail[target] = lifetime(target, tt)
                if down:
                    order_repair(tt)
                else:
                    repair_t = _INF
            else:                                      # COL_SCRUB
                counts["scrub"] += 1
                er.clear()
                emit(ScrubEvent(t=float(tt), disk=-1))
                next_scrub = later(tt, np.float32(p.scrub_hours))
            if lost:
                counts["data_loss"] += 1
                loss_times.append(float(tt))
                mask = frozenset(down | er | ({u} if c == COL_DISK else
                                              set()))
                emit(DataLossEvent(t=float(tt),
                                   blocks=tuple(sorted(mask))))
                observed += float(tt)
                break

    return SimResult(
        scheme=getattr(scheme, "name", scheme.__class__.__name__),
        trials=trials, horizon_hours=float(horizon_hours), seed=seed,
        losses=counts["data_loss"], observed_hours=observed,
        loss_times=loss_times, events=events, epochs=events,
        rejected=counts["disk_fail_rejected"], counts=counts,
        wall_seconds=time.perf_counter() - t_wall, event_log=log)
