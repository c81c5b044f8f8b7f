"""MTTDL reliability model (paper Section II-B, Figure 2; Table VI).

Continuous-time Markov chain over the number of failed blocks in a stripe:

* state f -> f+1: failure rate (n - f) * lambda, split by the hazard that the
  (f+1)-th failure makes the pattern undecodable (-> absorbing data loss).
  The hazard is derived from q_f = P(random f-pattern undecodable):
  h_f = (q_{f+1} - q_f) / (1 - q_f) (exchangeable-pattern approximation;
  exact enumeration of q_f where C(n, f) is small).
* state f -> f-1: repair at rate 1 / tau_f where
  tau_f = T_detect(f) + cost_f * block_bytes / repair_bandwidth
  and cost_f is the scheme's average f-failure repair cost in blocks
  (ARC_1, ARC_2, sampled ARC_f) — this is exactly where CP-LRCs' lower
  repair bandwidth turns into higher MTTDL.

MTTDL = expected absorption time from state 0, via the standard linear solve
on the embedded generator.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from . import metrics as metrics_lib
from .schemes import LRCScheme

HOURS_PER_YEAR = 24.0 * 365.25


@dataclasses.dataclass(frozen=True)
class ReliabilityParams:
    """Defaults follow the evaluation's cloud setup (64 MB blocks, 1 Gbps)
    with a 4-year mean life per node and 30-minute multi-failure detection."""
    node_mttf_years: float = 4.0
    block_mb: float = 64.0
    bandwidth_gbps: float = 1.0
    detect_hours_single: float = 0.05
    detect_hours_multi: float = 0.5
    # Global time scale knob used once to line our absolute numbers up with
    # the paper's Table VI (their lambda/bandwidth constants are not given);
    # relative scheme-to-scheme ratios are insensitive to it.
    repair_time_scale: float = 1.0


def repair_hours(cost_blocks: float, f: int, p: ReliabilityParams) -> float:
    """Mean hours to repair an ``f``-failure state that reads
    ``cost_blocks`` blocks: detection plus transfer at the repair
    bandwidth, times the global calibration scale.

    This is the single repair-time model shared by the closed-form Markov
    chain below and the event-driven simulator (``repro_torch.sim``): both
    turn a plan's block-read cost into a vulnerability-window duration through
    exactly this function, so their MTTDLs are comparable by construction.
    """
    transfer_hours = (cost_blocks * p.block_mb * 8.0 / 1000.0
                      / p.bandwidth_gbps / 3600.0)
    detect = p.detect_hours_single if f == 1 else p.detect_hours_multi
    return (detect + transfer_hours) * p.repair_time_scale


def repair_cost_profile(scheme: LRCScheme, fmax: Optional[int] = None,
                        samples: int = 200, seed: int = 7) -> np.ndarray:
    """Mean repair cost in blocks per failure count: ``cost[f]`` for
    ``f = 0..fmax`` (``cost[0] = 0``).

    Exactly the per-state costs the Markov chain uses (ARC_1, ARC_2,
    sampled ARC_f with the chain's sampling seeds), exported so the
    event-driven simulator's ``cost_model="average"`` mode reproduces the
    closed form's repair rates bit-for-bit.
    """
    fmax = scheme.p + scheme.r if fmax is None else fmax
    cost = np.zeros(fmax + 1)
    for f in range(1, fmax + 1):
        if f == 1:
            cost[f] = metrics_lib.arc1(scheme)
        elif f == 2:
            cost[f] = metrics_lib.arc2(scheme)
        else:
            cost[f] = metrics_lib.arc_f(scheme, f, samples=samples,
                                        seed=seed + 31 * f)
    return cost


def unrecoverable_profile(scheme: LRCScheme, fmax: Optional[int] = None,
                          samples: int = 1500, seed: int = 7) -> np.ndarray:
    """Undecodable-pattern fractions ``q[f]`` for ``f = 0..fmax+1``,
    monotone-guarded exactly as the Markov chain consumes them."""
    fmax = scheme.p + scheme.r if fmax is None else fmax
    q = np.zeros(fmax + 2)
    for f in range(1, fmax + 2):
        q[f] = metrics_lib.unrecoverable_fraction(scheme, f, samples=samples,
                                                  seed=seed + f)
    return np.maximum.accumulate(q)


def stripe_mttdl_years(scheme: LRCScheme,
                       params: Optional[ReliabilityParams] = None,
                       samples: int = 1500, seed: int = 7,
                       model: str = "paper") -> float:
    """MTTDL (years) of one stripe under the Markov model above.

    model="paper": the paper's Figure-2 semantics, read literally — when
    failed > r the *downward* transition rate becomes (n-f)*lambda*(1-p_f)
    (an undecodable-pattern probability only slows the descent; data loss
    happens solely at p+r+1 failures). This reproduces Table VI's ordering:
    CP-LRCs win because their faster repairs (higher mu) dominate.

    model="strict": rank-faithful — the first transition into an undecodable
    pattern is absorbed as data loss (hazard (q_{f+1}-q_f)/(1-q_f)). Under
    this stricter model CP-LRCs pay for their minimum distance of r+1 (vs
    r+2 for Azure LRC).
    """
    p = params or ReliabilityParams()
    n = scheme.n
    fmax = scheme.p + scheme.r  # beyond this some data is necessarily lost
    lam = 1.0 / (p.node_mttf_years * HOURS_PER_YEAR)

    # Undecodable-pattern fractions q_0..q_{fmax+1} and mean repair cost per
    # state (blocks read) — the shared profiles the simulator also consumes.
    q = unrecoverable_profile(scheme, fmax, samples=samples, seed=seed)
    cost = repair_cost_profile(scheme, fmax, seed=seed)

    # Transient states 0..fmax; absorbing DL.
    nstates = fmax + 1
    rate_fail = np.array([(n - f) * lam for f in range(nstates)])
    hazard = np.zeros(nstates)  # P(next failure is fatal | state f)
    slow = np.ones(nstates)     # paper model: descent slow-down factor
    if model == "strict":
        for f in range(nstates):
            denom = 1.0 - q[f]
            hazard[f] = 0.0 if denom <= 0 else min(1.0, max(0.0, (q[f + 1] - q[f]) / denom))
    elif model == "paper":
        for f in range(nstates - 1):
            slow[f] = 1.0 - q[f + 1]
        hazard[nstates - 1] = 1.0  # p+r+1 failures: data loss
    else:
        raise ValueError(f"unknown reliability model {model!r}")
    mu = np.zeros(nstates)
    for f in range(1, nstates):
        mu[f] = 1.0 / repair_hours(cost[f], f, p)

    # Expected absorption time T_f: (sum of outflow rates) * T_f =
    # 1 + rate_up_ok * T_{f+1} + mu * T_{f-1}; from the top state every new
    # failure is fatal (f = fmax + 1 always exceeds parity count).
    #
    # Rates span ~12 orders of magnitude (per-hour failure rates vs 1e17-year
    # horizons), which destroys float64 Gaussian elimination — solve exactly
    # over rationals instead (the system is tiny: <= r + p + 1 states).
    from fractions import Fraction

    a = [[Fraction(0) for _ in range(nstates)] for _ in range(nstates)]
    b = [Fraction(1) for _ in range(nstates)]
    for f in range(nstates):
        eff_fail = Fraction(rate_fail[f]) * Fraction(slow[f])
        out = eff_fail + (Fraction(mu[f]) if f > 0 else Fraction(0))
        a[f][f] = out
        up_ok = eff_fail * (Fraction(1) - Fraction(hazard[f]))
        if f + 1 < nstates:
            a[f][f + 1] -= up_ok
        # from fmax, any new failure is data loss (hazard[fmax] == 1).
        if f > 0:
            a[f][f - 1] -= Fraction(mu[f])
    t = _solve_fractions(a, b)
    return float(t[0] / HOURS_PER_YEAR)


def _solve_fractions(a: list[list], b: list) -> list:
    """Exact Gaussian elimination over Fractions (tiny systems only)."""
    n = len(b)
    m = [row[:] + [b[i]] for i, row in enumerate(a)]
    for c in range(n):
        piv = next(rr for rr in range(c, n) if m[rr][c] != 0)
        m[c], m[piv] = m[piv], m[c]
        inv = 1 / m[c][c]
        m[c] = [v * inv for v in m[c]]
        for rr in range(n):
            if rr != c and m[rr][c] != 0:
                fac = m[rr][c]
                m[rr] = [v - fac * w for v, w in zip(m[rr], m[c])]
    return [m[i][n] for i in range(n)]


def calibrate_scale(scheme: LRCScheme, target_years: float,
                    params: Optional[ReliabilityParams] = None,
                    **kw) -> ReliabilityParams:
    """1-D search on repair_time_scale so that stripe_mttdl_years(scheme)
    matches a target (used once to anchor absolute numbers to Table VI)."""
    base = params or ReliabilityParams()
    lo, hi = 1e-4, 1e4
    for _ in range(60):
        mid = (lo * hi) ** 0.5
        cand = dataclasses.replace(base, repair_time_scale=mid)
        got = stripe_mttdl_years(scheme, cand, **kw)
        # Longer repairs => lower MTTDL (monotone decreasing in scale).
        if got > target_years:
            lo = mid
        else:
            hi = mid
    return dataclasses.replace(base, repair_time_scale=(lo * hi) ** 0.5)
