"""GF(2^8) arithmetic — the algebraic substrate for every LRC in this repo.

The numpy planning tier: coefficient generation, Gaussian elimination /
rank / inverse for repair planning and fault-tolerance enumeration. Mirrors
what the paper's coordinator does in C++/Jerasure. The data path (the byte
crunching) lives in ``repro_torch.kernels``: the CUDA kernel and its plain
PyTorch versions in ``repro_torch.kernels.ref``.

Field: GF(2^8) with the AES/Jerasure-standard primitive polynomial
``x^8 + x^4 + x^3 + x^2 + 1`` (0x11D). Addition is XOR; w=8 supports stripes
with k + r + p up to 255 blocks — ample for the paper's widest (96, 5, 4).
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np

PRIM_POLY = 0x11D
FIELD = 256
ORDER = FIELD - 1  # multiplicative group order


# --------------------------------------------------------------------------
# Table construction (module import time; ~microseconds).
# --------------------------------------------------------------------------
def _build_tables() -> tuple[np.ndarray, np.ndarray]:
    exp = np.zeros(2 * ORDER, dtype=np.uint8)
    log = np.zeros(FIELD, dtype=np.int32)
    x = 1
    for i in range(ORDER):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= PRIM_POLY
    exp[ORDER:] = exp[:ORDER]
    return exp, log


GF_EXP, GF_LOG = _build_tables()


def _build_mul_table() -> np.ndarray:
    a = np.arange(FIELD, dtype=np.int32)
    t = GF_EXP[(GF_LOG[a][:, None] + GF_LOG[a][None, :]) % ORDER].astype(np.uint8)
    t[0, :] = 0
    t[:, 0] = 0
    return t


GF_MUL_TABLE = _build_mul_table()  # (256, 256) uint8
GF_INV_TABLE = np.zeros(FIELD, dtype=np.uint8)
GF_INV_TABLE[1:] = GF_EXP[(ORDER - GF_LOG[np.arange(1, FIELD)]) % ORDER]


# --------------------------------------------------------------------------
# numpy tier
# --------------------------------------------------------------------------
def gf_mul(a, b):
    """Elementwise GF(2^8) product (numpy, broadcasting)."""
    a = np.asarray(a, dtype=np.uint8)
    b = np.asarray(b, dtype=np.uint8)
    return GF_MUL_TABLE[a, b]


def gf_inv(a):
    a = np.asarray(a, dtype=np.uint8)
    if np.any(a == 0):
        raise ZeroDivisionError("GF(2^8) inverse of 0")
    return GF_INV_TABLE[a]


def gf_div(a, b):
    return gf_mul(a, gf_inv(b))


def gf_pow(a: int, e: int) -> int:
    if e == 0:
        return 1
    if a == 0:
        return 0
    return int(GF_EXP[(int(GF_LOG[a]) * e) % ORDER])


def gf_matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Matrix product over GF(2^8): (m,k) @ (k,n) -> (m,n). numpy tier.

    XOR-reduction of table-looked-up partial products. Memory O(m*k*n) —
    fine for planning-sized matrices (k <= 128); the data path uses
    ``repro_torch.kernels`` instead.
    """
    a = np.asarray(a, dtype=np.uint8)
    b = np.asarray(b, dtype=np.uint8)
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"gf_matmul shape mismatch {a.shape} @ {b.shape}")
    prods = GF_MUL_TABLE[a[:, :, None], b[None, :, :]]  # (m,k,n)
    return np.bitwise_xor.reduce(prods, axis=1)


def gf_matvec(a: np.ndarray, v: np.ndarray) -> np.ndarray:
    return gf_matmul(a, v.reshape(-1, 1)).reshape(-1)


def gf_eliminate(m: np.ndarray) -> tuple[np.ndarray, int, list[int]]:
    """Row-reduce over GF(2^8). Returns (rref, rank, pivot_cols)."""
    m = np.array(m, dtype=np.uint8, copy=True)
    rows, cols = m.shape
    rank = 0
    pivots: list[int] = []
    for c in range(cols):
        if rank >= rows:
            break
        pivot = None
        for rr in range(rank, rows):
            if m[rr, c]:
                pivot = rr
                break
        if pivot is None:
            continue
        if pivot != rank:
            m[[rank, pivot]] = m[[pivot, rank]]
        inv = GF_INV_TABLE[m[rank, c]]
        m[rank] = GF_MUL_TABLE[np.uint8(inv), m[rank]]
        mask = m[:, c].copy()
        mask[rank] = 0
        nz = np.nonzero(mask)[0]
        if nz.size:
            m[nz] ^= GF_MUL_TABLE[mask[nz][:, None], m[rank][None, :]]
        pivots.append(c)
        rank += 1
    return m, rank, pivots


def gf_rank(m: np.ndarray) -> int:
    return gf_eliminate(m)[1]


def gf_mat_inv(m: np.ndarray) -> np.ndarray:
    """Invert a square matrix over GF(2^8) (Gauss-Jordan)."""
    m = np.asarray(m, dtype=np.uint8)
    n = m.shape[0]
    if m.shape != (n, n):
        raise ValueError(f"not square: {m.shape}")
    aug = np.concatenate([m, np.eye(n, dtype=np.uint8)], axis=1)
    rref, rank, _ = gf_eliminate(aug)
    if rank < n:
        raise np.linalg.LinAlgError("singular over GF(2^8)")
    return rref[:, n:]


def gf_solve(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Solve a @ x = b over GF(2^8) for square invertible a."""
    return gf_matmul(gf_mat_inv(a), b.reshape(a.shape[0], -1)).reshape(b.shape)


def gf_solve_any(a: np.ndarray, y: np.ndarray) -> Optional[np.ndarray]:
    """Any solution x of a @ x = y over GF(2^8) (a may be non-square /
    rank-deficient); returns None if inconsistent. Free variables are 0.

    Used to derive reconstruction coefficients: to rebuild block b from a
    read-set R, solve gen[R].T @ x = gen[b]."""
    a = np.asarray(a, dtype=np.uint8)
    y = np.asarray(y, dtype=np.uint8).reshape(-1)
    rows, cols = a.shape
    aug = np.concatenate([a, y[:, None]], axis=1)
    rref, rank, pivots = gf_eliminate(aug)
    x = np.zeros(cols, dtype=np.uint8)
    for rr, c in enumerate(pivots):
        if c == cols:  # pivot in the y column -> inconsistent system
            return None
        x[c] = rref[rr, cols]
    # Verify (guards against pivots beyond rank rows).
    if not np.array_equal(gf_matvec(a, x), y):
        return None
    return x


# --------------------------------------------------------------------------
# Bitmatrix (CRS) representation: GF(2^8) coefficient -> 8x8 binary matrix.
# Column j of M_c holds the bits of c * x^j; then for byte vectors seen as
# bit-packets, multiplication by c is a GF(2) matrix product — pure XOR.
# --------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _coeff_bitmatrix_cached(c: int) -> bytes:
    m = np.zeros((8, 8), dtype=np.uint8)
    for j in range(8):
        v = gf_mul(c, 1 << j)
        for i in range(8):
            m[i, j] = (int(v) >> i) & 1
    return m.tobytes()


def coeff_bitmatrix(c: int) -> np.ndarray:
    """8x8 GF(2) matrix of multiplication by c (row i = output bit i)."""
    return np.frombuffer(_coeff_bitmatrix_cached(int(c)), dtype=np.uint8).reshape(8, 8).copy()


def matrix_to_bitmatrix(m: np.ndarray) -> np.ndarray:
    """(rows, cols) GF(2^8) matrix -> (rows*8, cols*8) GF(2) bitmatrix."""
    m = np.asarray(m, dtype=np.uint8)
    rows, cols = m.shape
    out = np.zeros((rows * 8, cols * 8), dtype=np.uint8)
    for i in range(rows):
        for j in range(cols):
            out[i * 8:(i + 1) * 8, j * 8:(j + 1) * 8] = coeff_bitmatrix(m[i, j])
    return out
