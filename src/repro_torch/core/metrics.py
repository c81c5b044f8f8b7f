"""Repair-cost and locality metrics (paper Section II-B / VI-A).

* ADRC   — average degraded read cost over data blocks.
* ARC_1  — average single-node repair cost over all blocks.
* ARC_2  — average two-node repair cost (exhaustive pair enumeration).
* ARC_f  — sampled average f-node repair cost (feeds the MTTDL model).
* local-repair portion / effective local-repair portion (Tables IV, V).
* unrecoverable_fraction — q_f = P(random f-failure pattern undecodable)
  (exact for small C(n, f), Monte Carlo otherwise).
"""
from __future__ import annotations

import itertools
import math

import numpy as np

from .repair import multi_repair_plan, single_repair_plan
from .schemes import LRCScheme


def adrc(scheme: LRCScheme, policy: str = "paper") -> float:
    costs = [single_repair_plan(scheme, b, policy).cost for b in scheme.data_ids]
    return sum(costs) / scheme.k


def arc1(scheme: LRCScheme, policy: str = "paper") -> float:
    costs = [single_repair_plan(scheme, b, policy).cost for b in range(scheme.n)]
    return sum(costs) / scheme.n


def arc2(scheme: LRCScheme) -> float:
    n = scheme.n
    total = 0
    for pair in itertools.combinations(range(n), 2):
        plan = multi_repair_plan(scheme, pair)
        if not plan.feasible:
            # Two failures are always decodable for d >= 3 codes; treat an
            # (impossible here) undecodable pair as a full-stripe read.
            total += n - 2
            continue
        total += plan.cost
    return total / math.comb(n, 2)


def local_portion(scheme: LRCScheme) -> float:
    """Table IV: fraction of two-node patterns repairable fully locally."""
    n = scheme.n
    hits = 0
    for pair in itertools.combinations(range(n), 2):
        plan = multi_repair_plan(scheme, pair)
        if plan.feasible and plan.local_possible:
            hits += 1
    return hits / math.comb(n, 2)


def effective_local_portion(scheme: LRCScheme) -> float:
    """Table V: all-local AND strictly cheaper than the k-read global decode."""
    n = scheme.n
    hits = 0
    for pair in itertools.combinations(range(n), 2):
        plan = multi_repair_plan(scheme, pair)
        if (plan.feasible and plan.local_possible
                and plan.best_local_cost is not None
                and plan.best_local_cost < scheme.k):
            hits += 1
    return hits / math.comb(n, 2)


def _patterns(n: int, f: int, samples: int, seed: int, exact_cap: int):
    if math.comb(n, f) <= exact_cap:
        yield from itertools.combinations(range(n), f)
        return
    rng = np.random.default_rng(seed)
    for _ in range(samples):
        yield tuple(sorted(rng.choice(n, size=f, replace=False).tolist()))


def arc_f(scheme: LRCScheme, f: int, samples: int = 400, seed: int = 0,
          exact_cap: int = 2000) -> float:
    """Sampled mean repair cost for f simultaneous failures (recoverable
    patterns only; unrecoverable ones are data loss, not repair)."""
    n = scheme.n
    total, count = 0, 0
    for pat in _patterns(n, f, samples, seed, exact_cap):
        plan = multi_repair_plan(scheme, pat, max_exact=3 if f > 3 else 4)
        if plan.feasible:
            total += plan.cost
            count += 1
    return total / max(count, 1)


def unrecoverable_fraction(scheme: LRCScheme, f: int, samples: int = 3000,
                           seed: int = 1, exact_cap: int = 20000) -> float:
    """q_f: probability a uniformly random f-failure pattern is undecodable."""
    n = scheme.n
    if f <= 0:
        return 0.0
    if f > scheme.p + scheme.r:
        return 1.0  # more failures than parity blocks: some data must be lost
    bad, count = 0, 0
    for pat in _patterns(n, f, samples, seed, exact_cap):
        count += 1
        if not scheme.decodable(frozenset(pat)):
            bad += 1
    return bad / max(count, 1)


def summarize(scheme: LRCScheme) -> dict[str, float]:
    return {
        "ADRC": adrc(scheme),
        "ARC1": arc1(scheme),
        "ARC2": arc2(scheme),
        "local_portion": local_portion(scheme),
        "effective_local_portion": effective_local_portion(scheme),
    }
