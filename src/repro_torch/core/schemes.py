"""LRC scheme constructions.

Implements the paper's two contributions (CP-Azure, CP-Uniform) and the four
baselines it compares against (Azure LRC, Azure LRC+1, Optimal Cauchy LRC,
Uniform Cauchy LRC), for arbitrary (k, r, p).

Block index layout (fixed across schemes):
    data     D_1..D_k   -> indices 0 .. k-1
    locals   L_1..L_p   -> indices k .. k+p-1
    globals  G_1..G_r   -> indices k+p .. k+p+r-1

Every scheme carries:
  * ``gen``: the (n, k) generator over GF(2^8) — row b gives block b as a
    linear combination of the data blocks. Data rows are identity. This is the
    single source of truth for encoding, decodability (rank checks) and MDS /
    distance analysis.
  * ``groups``: local repair groups. ``items`` are the blocks protected by the
    group (data and possibly global parities); ``parity`` is the local parity
    block; ``coeffs[i]`` is the GF coefficient of ``items[i]`` so that
    ``parity = XOR_i gf_mul(coeffs[i], items[i])``.
  * ``cascade``: for CP-LRCs, the cascaded parity group
    ``[L_1, .., L_p, G_r]`` — any member equals the XOR of the others.

Grouping conventions (reverse-engineered from the paper's Tables I/III; see
EXPERIMENTS.md for the handful of table cells where the paper is internally
inconsistent):
  * item lists are chopped **sequentially**; when sizes differ, the
    floor-sized groups come first and ceil-sized groups last (the paper's
    (6,2,2) CP-Uniform example: (D1,D2,D3), (D4,D5,D6,G1)).
  * Uniform Cauchy groups all of [D_1..D_k, G_1..G_r]; CP-Uniform groups
    [D_1..D_k, G_1..G_{r-1}] (G_r lives in the cascaded group).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from . import cauchy as cauchy_lib
from .gf import gf_mul, gf_matmul

DATA, LOCAL, GLOBAL = "data", "local", "global"


@dataclasses.dataclass(frozen=True)
class Group:
    gid: int
    items: tuple[int, ...]
    parity: int
    coeffs: tuple[int, ...]  # parity = XOR_i coeffs[i] * items[i]

    def members(self) -> tuple[int, ...]:
        return self.items + (self.parity,)


@dataclasses.dataclass(frozen=True)
class Cascade:
    members: tuple[int, ...]  # [L_1..L_p, G_r]; each = XOR of the others


@dataclasses.dataclass(frozen=True)
class LRCScheme:
    name: str
    k: int
    r: int
    p: int
    gen: np.ndarray  # (n, k) uint8
    groups: tuple[Group, ...]
    cascade: Optional[Cascade]
    tolerance: int = 0  # any <= tolerance failures are guaranteed decodable

    # ---------------------------------------------------------------- layout
    @property
    def n(self) -> int:
        return self.k + self.p + self.r

    @property
    def data_ids(self) -> range:
        return range(0, self.k)

    @property
    def local_ids(self) -> range:
        return range(self.k, self.k + self.p)

    @property
    def global_ids(self) -> range:
        return range(self.k + self.p, self.n)

    def kind(self, b: int) -> str:
        if b < self.k:
            return DATA
        if b < self.k + self.p:
            return LOCAL
        return GLOBAL

    def label(self, b: int) -> str:
        if b < self.k:
            return f"D{b + 1}"
        if b < self.k + self.p:
            return f"L{b - self.k + 1}"
        return f"G{b - self.k - self.p + 1}"

    # ------------------------------------------------------------- structure
    def groups_of_item(self, b: int) -> list[Group]:
        return [g for g in self.groups if b in g.items]

    def group_of_parity(self, b: int) -> Optional[Group]:
        for g in self.groups:
            if g.parity == b:
                return g
        return None

    def in_cascade(self, b: int) -> bool:
        return self.cascade is not None and b in self.cascade.members

    # --------------------------------------------------------------- algebra
    def parity_matrix(self) -> np.ndarray:
        """(p + r, k): rows for L_1..L_p then G_1..G_r."""
        return self.gen[self.k:]

    def decodable(self, failed: frozenset[int] | set[int]) -> bool:
        if len(failed) <= self.tolerance:
            return True  # guaranteed by the scheme's minimum distance
        alive = [b for b in range(self.n) if b not in failed]
        from .gf import gf_rank

        return gf_rank(self.gen[alive]) == self.k

    def encode(self, data: np.ndarray) -> np.ndarray:
        """numpy-tier stripe encode: data (k, B) uint8 -> (n, B)."""
        data = np.asarray(data, dtype=np.uint8)
        parity = gf_matmul(self.parity_matrix(), data)
        return np.concatenate([data, parity], axis=0)


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------
def split_sizes(total: int, parts: int) -> list[int]:
    """Near-even sizes, floor-sized groups first, ceil-sized last."""
    if parts <= 0 or total < parts:
        raise ValueError(f"cannot split {total} items into {parts} groups")
    base, extra = divmod(total, parts)
    return [base] * (parts - extra) + [base + 1] * extra


def chop(seq: list[int], sizes: list[int]) -> list[list[int]]:
    out, pos = [], 0
    for s in sizes:
        out.append(seq[pos:pos + s])
        pos += s
    assert pos == len(seq)
    return out


def _compose_row(scheme_gen_rows: dict[int, np.ndarray], items, coeffs, k: int) -> np.ndarray:
    """Express a parity (sum of coeff*block over items) in terms of data."""
    row = np.zeros(k, dtype=np.uint8)
    for b, c in zip(items, coeffs):
        row ^= gf_mul(np.uint8(c), scheme_gen_rows[b])
    return row


def _assemble(name, k, r, p, coding, group_specs, cascade_members,
              tolerance) -> LRCScheme:
    """Build the (n,k) generator from a coding matrix plus group specs.

    ``coding``: (r, k) global-parity coefficients.
    ``group_specs``: list of (items, coeffs) for L_1..L_p, where items may
    reference global blocks (their rows get substituted).
    ``tolerance``: failure count guaranteed decodable (min distance - 1),
    used as a fast path to skip rank checks in hot enumeration loops.
    """
    n = k + p + r
    rows: dict[int, np.ndarray] = {}
    for i in range(k):
        e = np.zeros(k, dtype=np.uint8)
        e[i] = 1
        rows[i] = e
    for j in range(r):
        rows[k + p + j] = coding[j].astype(np.uint8)
    groups = []
    for gid, (items, coeffs) in enumerate(group_specs):
        parity_id = k + gid
        rows[parity_id] = _compose_row(rows, items, coeffs, k)
        groups.append(Group(gid=gid, items=tuple(items), parity=parity_id,
                            coeffs=tuple(int(c) for c in coeffs)))
    gen = np.stack([rows[b] for b in range(n)], axis=0)
    cascade = Cascade(members=tuple(cascade_members)) if cascade_members else None
    scheme = LRCScheme(name=name, k=k, r=r, p=p, gen=gen,
                       groups=tuple(groups), cascade=cascade,
                       tolerance=tolerance)
    _check_scheme(scheme)
    return scheme


def _check_scheme(s: LRCScheme) -> None:
    # Local parity identity: parity row equals composed row (by construction),
    # and the cascade identity XOR(L_1..L_p) == G_r where present.
    if s.cascade is not None:
        acc = np.zeros(s.k, dtype=np.uint8)
        for b in s.cascade.members[:-1]:
            acc ^= s.gen[b]
        if not np.array_equal(acc, s.gen[s.cascade.members[-1]]):
            raise AssertionError(f"{s.name}: cascade identity violated")
    # All parity coefficients of the coding matrix must be nonzero for the
    # CP decomposition to make sense (guaranteed by Cauchy construction).


# --------------------------------------------------------------------------
# Baseline constructions
# --------------------------------------------------------------------------
def azure_lrc(k: int, r: int, p: int) -> LRCScheme:
    """Azure LRC: Vandermonde globals, p XOR local groups over data."""
    coding = cauchy_lib.vandermonde_matrix(k, r)
    data = list(range(k))
    groups = [(grp, [1] * len(grp)) for grp in chop(data, split_sizes(k, p))]
    # The r+1 tolerance the paper quotes holds for Azure's maximally-
    # recoverable coefficient choice; generic systematic-Vandermonde
    # coefficients only guarantee r (we found a counterexample at (9,3,3) —
    # see tests/test_schemes.py). Beyond r, decodability is rank-checked.
    return _assemble("azure", k, r, p, coding, groups, None, tolerance=r)


def azure_lrc_plus1(k: int, r: int, p: int) -> LRCScheme:
    """Azure LRC+1: (k, r, p-1) Azure + one XOR local parity over the globals."""
    if p < 2:
        raise ValueError("azure+1 requires p >= 2 (one group is the parity group)")
    coding = cauchy_lib.vandermonde_matrix(k, r)
    data = list(range(k))
    groups = [(grp, [1] * len(grp)) for grp in chop(data, split_sizes(k, p - 1))]
    global_ids = list(range(k + p, k + p + r))
    groups.append((global_ids, [1] * r))
    return _assemble("azure+1", k, r, p, coding, groups, None, tolerance=r)


def optimal_cauchy_lrc(k: int, r: int, p: int) -> LRCScheme:
    """Optimal Cauchy LRC: Cauchy globals; L_j = XOR(group data) + XOR(all globals)."""
    coding = cauchy_lib.cauchy_matrix(k, r)
    data = list(range(k))
    global_ids = list(range(k + p, k + p + r))
    groups = []
    for grp in chop(data, split_sizes(k, p)):
        items = grp + global_ids
        groups.append((items, [1] * len(items)))
    return _assemble("optimal", k, r, p, coding, groups, None, tolerance=r)


def uniform_cauchy_lrc(k: int, r: int, p: int) -> LRCScheme:
    """Uniform Cauchy LRC: Cauchy globals; [D_1..D_k, G_1..G_r] chopped into p
    XOR groups (floor-sized first => globals land in the tail groups)."""
    coding = cauchy_lib.cauchy_matrix(k, r)
    items = list(range(k)) + list(range(k + p, k + p + r))
    groups = [(grp, [1] * len(grp)) for grp in chop(items, split_sizes(k + r, p))]
    return _assemble("uniform", k, r, p, coding, groups, None, tolerance=r)


# --------------------------------------------------------------------------
# CP-LRC constructions (the paper's contribution)
# --------------------------------------------------------------------------
def cp_azure_lrc(k: int, r: int, p: int, coding: Optional[np.ndarray] = None) -> LRCScheme:
    """CP-Azure: decompose G_r's data coefficients across p local parities.

    L_j = sum over group-j data of beta_i * D_i with beta = coding[r-1],
    hence XOR(L_1..L_p) = G_r (cascaded parity group).
    """
    if coding is None:
        coding = cauchy_lib.cauchy_matrix(k, r)
    beta = coding[r - 1]
    if np.any(beta == 0):
        raise ValueError("G_r coefficients must be nonzero for CP decomposition")
    data = list(range(k))
    groups = [(grp, [int(beta[i]) for i in grp])
              for grp in chop(data, split_sizes(k, p))]
    cascade = list(range(k, k + p)) + [k + p + r - 1]
    return _assemble("cp-azure", k, r, p, coding, groups, cascade, tolerance=r)


def cp_uniform_lrc(k: int, r: int, p: int) -> LRCScheme:
    """CP-Uniform: group [D_1..D_k, G_1..G_{r-1}] into p groups; coefficients
    from the Appendix Theorem 1 identity G_r = sum gamma_i D_i + sum eta_j G_j.
    """
    coding = cauchy_lib.cauchy_matrix(k, r)
    if r >= 2:
        gamma, eta = cauchy_lib.uniform_combination_coefficients(k, r)
    else:
        # r == 1: G_r = G_1 = its own data coefficients; no eta terms.
        gamma, eta = coding[0].copy(), np.zeros(0, dtype=np.uint8)
    items = list(range(k)) + list(range(k + p, k + p + r - 1))
    coeff_of = {i: int(gamma[i]) for i in range(k)}
    for j in range(r - 1):
        coeff_of[k + p + j] = int(eta[j])
    groups = []
    for grp in chop(items, split_sizes(k + r - 1, p)):
        groups.append((grp, [coeff_of[b] for b in grp]))
    cascade = list(range(k, k + p)) + [k + p + r - 1]
    return _assemble("cp-uniform", k, r, p, coding, groups, cascade, tolerance=r)


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------
SCHEMES = {
    "azure": azure_lrc,
    "azure+1": azure_lrc_plus1,
    "optimal": optimal_cauchy_lrc,
    "uniform": uniform_cauchy_lrc,
    "cp-azure": cp_azure_lrc,
    "cp-uniform": cp_uniform_lrc,
}

SCHEME_DISPLAY = {
    "azure": "Azure LRC",
    "azure+1": "Azure LRC+1",
    "optimal": "Optimal Cauchy LRC",
    "uniform": "Uniform Cauchy LRC",
    "cp-azure": "CP-Azure",
    "cp-uniform": "CP-Uniform",
}

# The paper's Table II parameter sets.
PAPER_PARAMS = {
    "P1": (6, 2, 2),
    "P2": (12, 2, 2),
    "P3": (16, 3, 2),
    "P4": (20, 3, 5),
    "P5": (24, 2, 2),
    "P6": (48, 4, 3),
    "P7": (72, 4, 4),
    "P8": (96, 5, 4),
}


def make_scheme(name: str, k: int, r: int, p: int) -> LRCScheme:
    try:
        fn = SCHEMES[name]
    except KeyError:
        raise KeyError(f"unknown scheme {name!r}; have {sorted(SCHEMES)}") from None
    return fn(k, r, p)
