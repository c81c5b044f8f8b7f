"""The generator matrices of the paper's two constructions and of the four
baselines it compares them with, encode and decode, and the contiguous
block placement, each written down from its published description.

Block order in a stripe, in every scheme: data D_1..D_k (0..k-1), local
parities L_1..L_p (k..k+p-1), global parities G_1..G_r (k+p..n-1). A list
is cut into groups in order, the smaller groups first.

- Cauchy globals: alpha[j, i] = 1 / (x_i + y_j) with x_i = r + i (i < k)
  and y_j = j (j < r).
- Vandermonde globals (Huang et al., "Erasure Coding in Windows Azure
  Storage", USENIX ATC 2012): the systematic form of V[i, j] = (i+1)^j
  (i < k + r, j < k); the globals are rows k..k+r-1 of V V[:k]^-1.
- CP-Azure and CP-Uniform (arXiv 2512.10425, Sections III-IV and the
  Appendix), on Cauchy globals. CP-Azure cuts the data into p groups;
  L_g is the sum over its group of alpha[r-1, i] D_i, so the p local
  parities add up to G_r (the cascaded parity group L_1..L_p, G_r).
  CP-Uniform cuts D_1..D_k, G_1..G_{r-1} into p groups; L_g is the sum of
  gamma_i D_i and eta_j G_j over its group, with gamma and eta from the
  Appendix's Theorem 1 divided by eta_r, so that again the local parities
  add up to G_r.
- Azure-LRC (Huang et al., as above), on Vandermonde globals: L_g is the
  XOR of data group g, of p groups.
- Azure-LRC+1 (Kadekodi et al., "Practical Design Considerations for
  Wide Locally Recoverable Codes", FAST 2023), on Vandermonde globals:
  Azure-LRC's local parities over p-1 data groups, and L_p the XOR of
  the r globals.
- Optimal Cauchy LRC (Kadekodi et al., as above), on Cauchy globals: L_g
  is the XOR of data group g, of p groups, and of all r globals.
- Uniform Cauchy LRC (Kadekodi et al., as above), on Cauchy globals:
  D_1..D_k, G_1..G_r are cut into p groups, and L_g is the XOR of its
  group.
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


def vandermonde(k: int, r: int) -> np.ndarray:
    """(r, k) global coefficients of the systematic Vandermonde code: rows
    k..k+r-1 of V V[:k]^-1, where V[i, j] = (i+1)^j."""
    x = np.arange(1, k + r + 1, dtype=np.uint8)
    v = np.ones((k + r, k), np.uint8)
    for j in range(1, k):
        v[:, j] = gf256.mul(v[:, j - 1], x)
    coding = gf256.matmul(v, gf256.mat_inv(v[:k]))[k:]
    if not coding.all():
        raise ValueError(f"({k}, {r}): a systematic Vandermonde global "
                         f"coefficient is 0")
    return coding


SCHEMES = ("cp-azure", "cp-uniform", "azure", "azure+1", "optimal",
           "uniform")


def generator(scheme: str, k: int, r: int, p: int) -> np.ndarray:
    """(k + p + r, k) generator: block b is row b times the data."""
    if scheme not in SCHEMES:
        raise ValueError(f"unknown scheme {scheme!r}: one of "
                         f"{', '.join(SCHEMES)}")
    alpha = vandermonde(k, r) if scheme in ("azure", "azure+1") \
        else cauchy(k, r)
    rows = {i: np.eye(k, dtype=np.uint8)[i] for i in range(k)}
    globs = list(range(k + p, k + p + r))
    for j, b in enumerate(globs):
        rows[b] = alpha[j]
    data = list(range(k))
    coeff = dict.fromkeys(data + globs, 1)
    if scheme == "cp-azure":
        coeff = {i: int(alpha[r - 1, i]) for i in data}
        groups = _cut(data, p)
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
        coeff = {i: int(gf256.mul(gamma[i], scale)) for i in data}
        for j in range(r - 1):
            coeff[globs[j]] = int(gf256.mul(eta[j], scale))
        groups = _cut(data + globs[:-1], p)
    elif scheme == "azure":
        groups = _cut(data, p)
    elif scheme == "azure+1":
        if p < 2:
            raise ValueError("azure+1: p >= 2 (L_p covers the globals)")
        groups = _cut(data, p - 1) + [globs]
    elif scheme == "optimal":
        groups = [group + globs for group in _cut(data, p)]
    else:                               # uniform
        groups = _cut(data + globs, p)
    for g, group in enumerate(groups):
        row = np.zeros(k, np.uint8)
        for b in group:
            row ^= gf256.mul(coeff[b], rows[b])
        rows[k + g] = row
    gen = np.stack([rows[b] for b in range(k + p + r)])
    if scheme.startswith("cp-"):
        cascade = np.bitwise_xor.reduce(gen[k:k + p], axis=0)
        if not np.array_equal(cascade, gen[k + p + r - 1]):
            raise AssertionError(f"{scheme}: the local parities do not add "
                                 f"up to G_r")
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
