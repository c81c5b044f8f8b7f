"""Base MDS stripes: Cauchy and Vandermonde Reed-Solomon generator matrices,
plus the paper's Appendix Theorem 1 coefficient construction.

Everything here is planning-tier numpy over GF(2^8) (see ``repro_torch.core.gf``).
"""
from __future__ import annotations

import numpy as np

from .gf import (
    FIELD,
    GF_INV_TABLE,
    gf_inv,
    gf_matmul,
    gf_mul,
    gf_pow,
    gf_rank,
)


def cauchy_points(k: int, r: int) -> tuple[np.ndarray, np.ndarray]:
    """Canonical k+r distinct evaluation points a_1..a_k, b_1..b_r in GF(2^8).

    Jerasure convention: a_i = i + r - 1? We keep it simple and auditable:
    a_i = r + i - 1 for i in 1..k and b_j = j - 1 for j in 1..r, i.e.
    b = {0..r-1}, a = {r..r+k-1}. Requires k + r <= 256.
    """
    if k + r > FIELD:
        raise ValueError(f"k+r={k + r} exceeds GF(2^8) field size")
    b = np.arange(r, dtype=np.uint8)
    a = np.arange(r, r + k, dtype=np.uint8)
    return a, b


def cauchy_matrix(k: int, r: int) -> np.ndarray:
    """(r, k) Cauchy coding matrix: alpha[j, i] = 1 / (b_j - a_i) = 1/(b_j ^ a_i)."""
    a, b = cauchy_points(k, r)
    diff = (b[:, None] ^ a[None, :]).astype(np.uint8)  # subtraction == XOR
    return gf_inv(diff)


def vandermonde_matrix(k: int, r: int) -> np.ndarray:
    """(r, k) coding matrix derived from a systematic Vandermonde construction.

    Classic Azure-LRC-style generator: start from the (k+r, k) Vandermonde
    V[i, j] = x_i^j, row-reduce to systematic form [I; M]; M is guaranteed to
    make [I; M] MDS for distinct x_i (standard RS systematic construction).
    """
    if k + r > FIELD:
        raise ValueError(f"k+r={k + r} exceeds GF(2^8) field size")
    n = k + r
    v = np.zeros((n, k), dtype=np.uint8)
    for i in range(n):
        for j in range(k):
            v[i, j] = gf_pow(i + 1, j)
    # Systematize: column operations to turn the top kxk block into I.
    # Equivalent to V @ inv(V_top).
    from .gf import gf_mat_inv

    top_inv = gf_mat_inv(v[:k])
    sys = gf_matmul(v, top_inv)
    m = sys[k:]
    if np.any(m == 0):
        # Zero coefficients would break LRC coefficient decomposition; Cauchy
        # matrices never have zeros, Vandermonde-systematic rarely does. Patch
        # by falling back to Cauchy (still MDS, same role).
        return cauchy_matrix(k, r)
    return m


def theorem1_coefficients(k: int, r: int) -> tuple[np.ndarray, np.ndarray]:
    """Appendix Theorem 1: nonzero (gamma_bar, eta_bar) with
    gamma_bar_i + sum_j eta_bar_j * alpha[j, i] = 0 for the Cauchy code.

    gamma_bar_i = prod_z (a_i - b_z)^-1;  eta_bar_j = prod_{z != j} (b_j - b_z)^-1.
    Returns (gamma_bar (k,), eta_bar (r,)).
    """
    a, b = cauchy_points(k, r)
    gamma = np.ones(k, dtype=np.uint8)
    for i in range(k):
        for z in range(r):
            gamma[i] = gf_mul(gamma[i], gf_inv(a[i] ^ b[z]))
    eta = np.ones(r, dtype=np.uint8)
    for j in range(r):
        for z in range(r):
            if z != j:
                eta[j] = gf_mul(eta[j], gf_inv(b[j] ^ b[z]))
    return gamma, eta


def uniform_combination_coefficients(k: int, r: int) -> tuple[np.ndarray, np.ndarray]:
    """Eq. (10) coefficients: G_r = sum_i gamma_i D_i + sum_{j<r} eta_j G_j.

    Normalize Theorem 1's identity by eta_bar_r (Corollary 1):
    gamma_i = gamma_bar_i / eta_bar_r, eta_j = eta_bar_j / eta_bar_r.
    All coefficients are nonzero by construction.
    """
    gamma_bar, eta_bar = theorem1_coefficients(k, r)
    inv_last = gf_inv(eta_bar[r - 1])
    gamma = gf_mul(gamma_bar, inv_last)
    eta = gf_mul(eta_bar[: r - 1], inv_last)
    return gamma, eta


def verify_mds(coding: np.ndarray, trials: int = 64, seed: int = 0) -> bool:
    """Spot-check the MDS property of a systematic code [I; coding]:
    every kxk submatrix of the (k+r, k) generator is invertible. Exhaustive for
    small n, randomized for wide stripes.
    """
    r, k = coding.shape
    n = k + r
    gen = np.concatenate([np.eye(k, dtype=np.uint8), coding], axis=0)
    rng = np.random.default_rng(seed)
    import itertools

    ncomb = 1
    for i in range(r):
        ncomb *= (n - i)
    exhaustive = ncomb <= 200_000  # C(n, r) small enough
    if exhaustive:
        combos = itertools.combinations(range(n), k)
    else:
        combos = (sorted(rng.choice(n, size=k, replace=False)) for _ in range(trials))
    for idx, rows in enumerate(combos):
        if not exhaustive and idx >= trials:
            break
        if gf_rank(gen[list(rows)]) < k:
            return False
    return True
