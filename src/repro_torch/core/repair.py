"""Repair planning for LRC stripes.

Implements the paper's repair algorithms (Sections IV-C / IV-D):

* **single-node**: typed repair — data / grouped blocks within their local
  repair group; cascaded-group members (local parities and G_r in CP-LRCs)
  within the cascaded group; non-grouped global parities by recomputation.
* **multi-node**: "local-first, global-as-fallback". A failed block can be
  repaired locally by any *unit* (local repair group or the cascaded group)
  that contains it, provided the unit's other members are alive or already
  repaired. Repairs cascade: repairing L_1 from its group can unlock the
  cascaded-group repair of G_r, etc. If any failure cannot be covered this
  way, a global decode happens; per the paper, the k-block decode set is
  chosen to include blocks already read by local repairs, so a pattern that
  needs global repair costs exactly k reads (never more).

Costs are counted in *distinct surviving blocks read* (node accesses), the
paper's metric. Blocks reconstructed earlier in the plan are reusable for
free (they are at the proxy already).

The multi-node planner searches over repair-unit assignments and orders for
the minimum-read schedule (exact for small failure counts — this is what
reproduces Table III's ARC2 wide-stripe cells to the cent — and greedy for
larger patterns, which only arise in MTTDL sampling).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Optional

import numpy as np

from .gf import GF_INV_TABLE, GF_MUL_TABLE
from .schemes import DATA, GLOBAL, LOCAL, LRCScheme


@dataclasses.dataclass(frozen=True)
class RepairPlan:
    """A single-block repair: read ``reads``, combine with ``method``."""
    target: int
    reads: frozenset[int]
    method: str  # "group" | "cascade" | "recompute" | "global"

    @property
    def cost(self) -> int:
        return len(self.reads)


@dataclasses.dataclass(frozen=True)
class MultiRepairPlan:
    failed: frozenset[int]
    reads: frozenset[int]
    all_local: bool
    feasible: bool
    steps: tuple[tuple[int, str], ...]  # (block, method) in execution order
    local_possible: bool = False        # does ANY all-local schedule exist?
    best_local_cost: Optional[int] = None

    @property
    def cost(self) -> int:
        return len(self.reads)


# --------------------------------------------------------------------------
# repair units
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class _Unit:
    uid: int
    kind: str  # "group" | "cascade"
    members: frozenset[int]

    def sources_for(self, b: int) -> frozenset[int]:
        return self.members - {b}


def repair_units(scheme: LRCScheme) -> list[_Unit]:
    units = [
        _Unit(uid=g.gid, kind="group", members=frozenset(g.members()))
        for g in scheme.groups
    ]
    if scheme.cascade is not None:
        units.append(_Unit(uid=len(units), kind="cascade",
                           members=frozenset(scheme.cascade.members)))
    return units


# --------------------------------------------------------------------------
# single-node repair
# --------------------------------------------------------------------------
def single_repair_candidates(scheme: LRCScheme, b: int) -> list[RepairPlan]:
    """All structural repair options for block b (everything else alive)."""
    plans = []
    for g in scheme.groups_of_item(b):
        reads = frozenset(g.items) - {b} | {g.parity}
        plans.append(RepairPlan(b, reads, "group"))
    g = scheme.group_of_parity(b)
    if g is not None:
        plans.append(RepairPlan(b, frozenset(g.items), "recompute"))
    if scheme.in_cascade(b):
        reads = frozenset(scheme.cascade.members) - {b}
        plans.append(RepairPlan(b, reads, "cascade"))
    if scheme.kind(b) == GLOBAL:
        plans.append(RepairPlan(b, frozenset(scheme.data_ids), "global"))
    if not plans:  # ungrouped data block cannot happen by construction
        raise AssertionError(f"no repair candidate for block {b}")
    return plans


def single_repair_plan(scheme: LRCScheme, b: int,
                       policy: str = "paper") -> RepairPlan:
    """Pick the plan the paper's repair algorithm would pick.

    policy="paper": cascaded-group members always repair within the cascaded
    group (this is what the paper's evaluation tables use — see
    EXPERIMENTS.md on the min{g,p} text/table discrepancy at P4); everything
    else takes its cheapest local option, with global recomputation only for
    non-grouped global parities.
    policy="min": strictly cheapest candidate (the paper text's min{g,p}).
    """
    plans = single_repair_candidates(scheme, b)
    if policy == "paper" and scheme.in_cascade(b):
        cas = [pl for pl in plans if pl.method == "cascade"]
        if cas:
            return cas[0]
    non_global = [pl for pl in plans if pl.method != "global"]
    pool = non_global if non_global else plans
    return min(pool, key=lambda pl: (pl.cost, pl.method != "group"))


# --------------------------------------------------------------------------
# rank utilities for global decode-set selection
# --------------------------------------------------------------------------
def _greedy_rank_k_set(scheme: LRCScheme, ordered_pool: list[int]) -> Optional[list[int]]:
    """Greedy: walk the pool, keep rows that grow the GF(2^8) rank, stop at k."""
    k = scheme.k
    basis: list[np.ndarray] = []  # rows in echelon form (leading-one normalized)
    lead: list[int] = []
    chosen: list[int] = []
    for b in ordered_pool:
        row = scheme.gen[b].copy()
        for lrow, lc in zip(basis, lead):
            c = row[lc]
            if c:
                row ^= GF_MUL_TABLE[np.uint8(c), lrow]
        nz = np.nonzero(row)[0]
        if nz.size == 0:
            continue
        lc = int(nz[0])
        inv = GF_INV_TABLE[row[lc]]
        row = GF_MUL_TABLE[np.uint8(inv), row]
        basis.append(row)
        lead.append(lc)
        chosen.append(b)
        if len(chosen) == k:
            return chosen
    return None


def global_decode_set(scheme: LRCScheme, alive: frozenset[int],
                      prefer: frozenset[int] = frozenset()) -> Optional[list[int]]:
    """A rank-k set of alive blocks, preferring already-read blocks, then data
    blocks, then parities (mirrors the paper's read-reuse rule)."""
    pool = sorted(alive, key=lambda b: (b not in prefer, scheme.kind(b) != DATA, b))
    return _greedy_rank_k_set(scheme, pool)


# --------------------------------------------------------------------------
# multi-node repair
# --------------------------------------------------------------------------
def _local_closure(units: list[_Unit], failed: frozenset[int], alive: frozenset[int],
                   assignment: dict[int, _Unit]) -> Optional[tuple[frozenset[int], tuple[tuple[int, str], ...]]]:
    """Execute an assignment failure->unit to a fixed point.

    Returns (reads, steps) if every assigned failure gets repaired (dependency
    order respected), else None. Failures not in the assignment are treated as
    unrepairable locally (they go to the global phase by the caller).
    """
    pending = set(assignment)
    repaired: set[int] = set()
    reads: set[int] = set()
    steps: list[tuple[int, str]] = []
    progress = True
    while pending and progress:
        progress = False
        for b in sorted(pending):
            unit = assignment[b]
            sources = unit.sources_for(b)
            if sources & failed <= repaired:  # failed sources must be repaired already
                reads |= {s for s in sources if s in alive}
                repaired.add(b)
                pending.discard(b)
                steps.append((b, unit.kind))
                progress = True
    if pending:
        return None
    return frozenset(reads), tuple(steps)


def _units_for(scheme: LRCScheme, units: list[_Unit], b: int) -> list[_Unit]:
    out = []
    for u in units:
        if b not in u.members:
            continue
        if u.kind == "group":
            out.append(u)
        else:  # cascade
            out.append(u)
    return out


def multi_repair_plan(scheme: LRCScheme, failed, *, max_exact: int = 4,
                      allow_global_shortcut: bool = True) -> MultiRepairPlan:
    """Min-read repair schedule for a failure pattern.

    Exact search over unit assignments for ``len(failed) <= max_exact``
    (every failure independently picks one of its covering units, or the
    global phase; at most one failure per unit); greedy fixed-point beyond.
    Patterns that need the global phase cost exactly k reads (the decode set
    subsumes local reads — verified via explicit rank-k set construction).
    """
    failed = frozenset(failed)
    n = scheme.n
    alive = frozenset(range(n)) - failed
    if not scheme.decodable(failed):
        return MultiRepairPlan(failed, frozenset(), False, False, ())
    units = repair_units(scheme)

    best: Optional[tuple[frozenset[int], tuple, bool]] = None  # (reads, steps, all_local)
    best_local: Optional[int] = None

    def consider(reads, steps, all_local):
        nonlocal best, best_local
        if all_local and (best_local is None or len(reads) < best_local):
            best_local = len(reads)
        # Local-first on ties: prefer the all-local schedule at equal cost.
        key = (len(reads), not all_local)
        if best is None or key < (len(best[0]), not best[2]):
            best = (reads, steps, all_local)

    cand_units = {b: _units_for(scheme, units, b) for b in failed}

    if len(failed) <= max_exact:
        # Exact: each failure picks a covering unit or None (=> global phase).
        # Units may serve at most one failure each.
        choices = [cand_units[b] + [None] for b in sorted(failed)]
        ordered = sorted(failed)
        for combo in itertools.product(*choices):
            used = [u.uid for u in combo if u is not None]
            if len(used) != len(set(used)):
                continue
            assignment = {b: u for b, u in zip(ordered, combo) if u is not None}
            local_part = _local_closure(units, failed, alive, assignment)
            if local_part is None:
                continue
            reads, steps = local_part
            leftovers = [b for b in ordered if b not in assignment]
            if leftovers:
                decode = global_decode_set(scheme, alive, prefer=reads)
                if decode is None:
                    continue
                reads = reads | frozenset(decode)
                steps = steps + tuple((b, "global") for b in leftovers)
                consider(reads, steps, all_local=False)
            else:
                consider(reads, steps, all_local=True)
    else:
        # Greedy fixed point: repeatedly apply the cheapest currently-feasible
        # unit repair; remaining failures go global.
        pending = set(failed)
        repaired: set[int] = set()
        reads: set[int] = set()
        steps: list[tuple[int, str]] = []
        used_units: set[int] = set()
        while pending:
            candidates = []
            for b in pending:
                for u in cand_units[b]:
                    if u.uid in used_units:
                        continue
                    sources = u.sources_for(b)
                    if sources & failed <= repaired:
                        new = {s for s in sources if s in alive} - reads
                        candidates.append((len(new), b, u))
            if not candidates:
                break
            _, b, u = min(candidates, key=lambda t: (t[0], t[1]))
            reads |= {s for s in u.sources_for(b) if s in alive}
            repaired.add(b)
            pending.discard(b)
            used_units.add(u.uid)
            steps.append((b, u.kind))
        if pending:
            decode = global_decode_set(scheme, alive, prefer=frozenset(reads))
            if decode is None:
                return MultiRepairPlan(failed, frozenset(), False, False, ())
            reads |= set(decode)
            steps.extend((b, "global") for b in sorted(pending))
            consider(frozenset(reads), tuple(steps), all_local=False)
        else:
            consider(frozenset(reads), tuple(steps), all_local=True)

    # Pure-global option (always considered; this is the k-read fallback).
    decode = global_decode_set(scheme, alive, prefer=frozenset())
    if decode is not None:
        consider(frozenset(decode), tuple((b, "global") for b in sorted(failed)), False)

    if best is None:
        return MultiRepairPlan(failed, frozenset(), False, False, ())

    reads, steps, all_local = best
    return MultiRepairPlan(failed, reads, all_local, True, steps,
                           local_possible=best_local is not None,
                           best_local_cost=best_local)
