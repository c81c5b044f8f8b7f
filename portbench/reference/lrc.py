"""The CP-Azure and CP-Uniform generator matrices, encode and decode, and
the contiguous block placement, written down from the paper's
construction (arXiv 2512.10425, Sections III-IV and the Appendix).

Block order in a stripe: data D_1..D_k (0..k-1), local parities
L_1..L_p (k..k+p-1), global parities G_1..G_r (k+p..n-1).

- Global parities: a Cauchy code, alpha[j, i] = 1 / (x_i + y_j) with
  x_i = r + i (i < k) and y_j = j (j < r).
- CP-Azure: the data are cut into p groups in order, the smaller groups
  first; L_g is the sum over its group of alpha[r-1, i] * D_i, so the p
  local parities add up to G_r (the cascaded parity group L_1..L_p, G_r).
- CP-Uniform: the items D_1..D_k, G_1..G_{r-1} are cut into p groups the
  same way; L_g is the sum of gamma_i * D_i and eta_j * G_j over its
  group, with gamma and eta from the Appendix's Theorem 1 divided by
  eta_r, so that again the local parities add up to G_r.
"""
from __future__ import annotations

import numpy as np
import torch

from . import gf256


def _sizes(total: int, parts: int) -> list[int]:
    base, extra = divmod(total, parts)
    return [base] * (parts - extra) + [base + 1] * extra


def _cut(items: list[int], parts: int) -> list[list[int]]:
    out, pos = [], 0
    for size in _sizes(len(items), parts):
        out.append(items[pos:pos + size])
        pos += size
    return out


def cauchy(k: int, r: int) -> np.ndarray:
    """(r, k) global coefficients alpha[j, i] = 1 / ((r + i) xor j)."""
    x = np.arange(r, r + k, dtype=np.uint8)
    y = np.arange(r, dtype=np.uint8)
    return gf256.inv(y[:, None] ^ x[None, :])


def generator(scheme: str, k: int, r: int, p: int) -> np.ndarray:
    """(k + p + r, k) generator: block b is row b times the data."""
    alpha = cauchy(k, r)
    rows = {i: np.eye(k, dtype=np.uint8)[i] for i in range(k)}
    for j in range(r):
        rows[k + p + j] = alpha[j]
    if scheme == "cp-azure":
        coeff = {i: int(alpha[r - 1, i]) for i in range(k)}
        items = list(range(k))
    elif scheme == "cp-uniform":
        x = np.arange(r, r + k, dtype=np.uint8)
        y = np.arange(r, dtype=np.uint8)
        gamma = np.ones(k, np.uint8)
        for i in range(k):
            for z in range(r):
                gamma[i] = gf256.mul(gamma[i], gf256.inv(x[i] ^ y[z]))
        eta = np.ones(r, np.uint8)
        for j in range(r):
            for z in range(r):
                if z != j:
                    eta[j] = gf256.mul(eta[j], gf256.inv(y[j] ^ y[z]))
        scale = gf256.inv(eta[r - 1])
        coeff = {i: int(gf256.mul(gamma[i], scale)) for i in range(k)}
        for j in range(r - 1):
            coeff[k + p + j] = int(gf256.mul(eta[j], scale))
        items = list(range(k)) + list(range(k + p, k + p + r - 1))
    else:
        raise ValueError(f"unknown scheme {scheme!r}: cp-azure or cp-uniform")
    for g, group in enumerate(_cut(items, p)):
        row = np.zeros(k, np.uint8)
        for b in group:
            row ^= gf256.mul(coeff[b], rows[b])
        rows[k + g] = row
    gen = np.stack([rows[b] for b in range(k + p + r)])
    cascade = np.bitwise_xor.reduce(gen[k:k + p], axis=0)
    if not np.array_equal(cascade, gen[k + p + r - 1]):
        raise AssertionError(f"{scheme}: the local parities do not add up "
                             f"to G_r")
    return gen


def placement(policy: str, num_nodes: int, sid: int, n: int,
              stride: int) -> list[int]:
    """Nodes of stripe ``sid``'s blocks: a contiguous arc of ``n`` nodes
    that starts ``stride`` nodes further on for each stripe."""
    if policy != "contiguous":
        raise ValueError(f"unknown placement {policy!r}: contiguous")
    base = sid * stride % num_nodes
    return [(base + b) % num_nodes for b in range(n)]


def encode(gen: np.ndarray, data: torch.Tensor) -> torch.Tensor:
    """(S, k, B) data -> (S, n - k, B) parity blocks."""
    return gf256.apply(gen[gen.shape[1]:], data)


def decode(gen: np.ndarray, lost: list[int], survivors: dict,
           *, xor_only: bool = False) -> torch.Tensor:
    """The ``lost`` blocks of stripes whose surviving blocks are
    ``survivors`` (block index -> (S, B) tensor): k independent survivors,
    taken in index order, solve for the data, and each lost block is its
    generator row over that solution. ``xor_only`` computes the product
    with every coefficient taken as 1 (the control)."""
    k = gen.shape[1]
    chosen: list[int] = []
    for b in sorted(survivors):
        if gf256.rank(gen[chosen + [b]]) == len(chosen) + 1:
            chosen.append(b)
        if len(chosen) == k:
            break
    if len(chosen) < k:
        raise ValueError(f"lost {sorted(lost)}: not decodable")
    coef = gf256.matmul(gen[lost], gf256.mat_inv(gen[chosen]))
    blocks = torch.stack([survivors[b] for b in chosen], dim=1)
    return gf256.apply(coef, blocks, xor_only=xor_only)
