"""GF(2^8) over the polynomial x^8 + x^4 + x^3 + x^2 + 1 (0x11D).

The field's tables and the small coefficient algebra (products, inverses,
ranks of matrices) are NumPy. The multiplication table is built by
shift-and-add (carry-less multiply, then reduction), not from exp/log
tables, so it shares no construction with the code under test.

The bulk product over blocks (:func:`apply`) is plain PyTorch table
lookups, on whichever device its blocks lie: on the card it checks a
run's 64 stripes in well under a second, where NumPy's single-threaded
lookups take about 8 s.
"""
from __future__ import annotations

import numpy as np
import torch

POLY = 0x11D


def _carryless_mul(a: int, b: int) -> int:
    out = 0
    while b:
        if b & 1:
            out ^= a
        a <<= 1
        if a & 0x100:
            a ^= POLY
        b >>= 1
    return out


MUL = np.array([[_carryless_mul(a, b) for b in range(256)]
                for a in range(256)], dtype=np.uint8)
INV = np.zeros(256, dtype=np.uint8)
for _a in range(1, 256):
    INV[_a] = int(np.flatnonzero(MUL[_a] == 1)[0])
del _a


def mul(a, b) -> np.ndarray:
    """Elementwise product of two uint8 arrays (broadcasting)."""
    return MUL[np.asarray(a, np.uint8), np.asarray(b, np.uint8)]


def inv(a) -> np.ndarray:
    a = np.asarray(a, np.uint8)
    if np.any(a == 0):
        raise ZeroDivisionError("0 has no inverse in GF(2^8)")
    return INV[a]


def matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(m, k) x (k, n) over GF(2^8), for small coefficient matrices."""
    a = np.asarray(a, np.uint8)
    b = np.asarray(b, np.uint8)
    out = np.zeros((a.shape[0], b.shape[1]), np.uint8)
    for j in range(a.shape[1]):
        out ^= MUL[a[:, j][:, None], b[j][None, :]]
    return out


def _eliminate(a: np.ndarray, ncols: int) -> int:
    """Reduce ``a`` in place to reduced row echelon form over its first
    ``ncols`` columns; returns the rank found there."""
    r = 0
    for col in range(ncols):
        rows = np.flatnonzero(a[r:, col]) + r
        if rows.size == 0:
            continue
        piv = rows[0]
        a[[r, piv]] = a[[piv, r]]
        a[r] = MUL[INV[a[r, col]], a[r]]
        for i in range(a.shape[0]):
            if i != r and a[i, col]:
                a[i] ^= MUL[a[i, col], a[r]]
        r += 1
        if r == a.shape[0]:
            break
    return r


def rank(m: np.ndarray) -> int:
    a = np.array(m, np.uint8)
    return _eliminate(a, a.shape[1])


def mat_inv(m: np.ndarray) -> np.ndarray:
    """Inverse of a square matrix; raises ``np.linalg.LinAlgError`` when
    it is singular."""
    n = m.shape[0]
    aug = np.concatenate([np.asarray(m, np.uint8), np.eye(n, dtype=np.uint8)],
                         axis=1)
    if _eliminate(aug, n) < n:
        raise np.linalg.LinAlgError("singular matrix over GF(2^8)")
    return aug[:, n:]


def apply(coef: np.ndarray, blocks: torch.Tensor, *,
          xor_only: bool = False) -> torch.Tensor:
    """``coef (m, k)`` times ``blocks (S, k, B)`` -> ``(S, m, B)`` uint8 on
    the blocks' device: output row i of a stripe is the XOR over j of
    ``coef[i, j] * blocks[:, j]``, each product one lookup in the row of
    :data:`MUL` that belongs to its coefficient.

    ``xor_only`` drops the coefficients (every nonzero one counts as 1),
    which is GF(2) arithmetic: the control's lower precision.
    """
    coef = np.asarray(coef, np.uint8)
    m, k = coef.shape
    if blocks.dtype != torch.uint8 or blocks.ndim != 3 \
            or blocks.shape[1] != k:
        raise ValueError(f"coef {coef.shape} does not match blocks "
                         f"{tuple(blocks.shape)} {blocks.dtype}")
    table = torch.from_numpy(MUL).to(blocks.device)
    out = torch.zeros((blocks.shape[0], m, blocks.shape[2]), dtype=torch.uint8,
                      device=blocks.device)
    for j in range(k):
        col = coef[:, j]
        if not col.any():
            continue
        src = blocks[:, j]
        index = None if xor_only or np.all(col <= 1) else src.long()
        for i in np.flatnonzero(col):
            c = int(col[i])
            out[:, i] ^= src if xor_only or c == 1 else table[c][index]
    return out
