"""Plain PyTorch versions of the GF(2^8) kernels.

Each function computes exactly what its CUDA kernel computes, so the tests
hold the two byte for byte (erasure coding is integer math — there is no
tolerance). The port runs these for tensors that lie on the CPU only; a
CUDA tensor always goes through the hand-written kernel. The bit-plane
oracles (packetize, bitmatrix encode, mod-2 matmul) come with the
bit-plane kernels in a later slice.
"""
from __future__ import annotations

import torch

from repro_torch.core.gf import GF_MUL_TABLE, PRIM_POLY

_BITS = 8
_TABLES: dict[torch.device, torch.Tensor] = {}


def _mul_table(device: torch.device) -> torch.Tensor:
    """The flat 64 KB multiplication table on ``device`` (cached)."""
    table = _TABLES.get(device)
    if table is None:
        table = torch.from_numpy(GF_MUL_TABLE.reshape(-1).copy()).to(device)
        _TABLES[device] = table
    return table


def gf256_matmul_batched_ref(coef: torch.Tensor,
                             data: torch.Tensor) -> torch.Tensor:
    """``coef (m,k) @ data (S,k,B) -> (S,m,B)`` over GF(2^8), table path.

    One table gather per input row, XOR-accumulated over k, so memory
    stays at one ``(S, m, B)`` index tensor whatever k is.
    """
    table = _mul_table(data.device)
    s, k, b = data.shape
    m = coef.shape[0]
    rows = coef.to(data.device, torch.int64) * 256          # (m, k)
    out = torch.zeros((s, m, b), dtype=torch.uint8, device=data.device)
    for j in range(k):
        idx = rows[:, j].view(1, m, 1) + data[:, j:j + 1, :].to(torch.int64)
        out ^= table[idx]
    return out


def gf256_matmul_ref(coef: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``coef (m,k) @ data (k,B) -> (m,B)`` over GF(2^8), table path."""
    return gf256_matmul_batched_ref(coef, data[None])[0]


def gf256_matmul_shift_ref(coef: torch.Tensor,
                           data: torch.Tensor) -> torch.Tensor:
    """The same flat product by table-free shift-and-XOR ("Russian
    peasant") multiplication: an oracle for the algorithm, not just the
    result."""
    cf = coef.to(torch.int32)[:, :, None]                   # (m, k, 1)
    cur = data.to(torch.int32)[None, :, :]                  # (1, k, B)
    shape = (coef.shape[0], coef.shape[1], data.shape[1])
    acc = torch.zeros(shape, dtype=torch.int32, device=data.device)
    cur = cur.expand(shape)
    cf = cf.expand(shape)
    for _ in range(_BITS):
        acc = acc ^ torch.where((cf & 1) != 0, cur, 0)
        cur = ((cur << 1) & 0xFF) ^ torch.where((cur & 0x80) != 0,
                                                PRIM_POLY & 0xFF, 0)
        cf = cf >> 1
    out = torch.zeros((shape[0], shape[2]), dtype=torch.int32,
                      device=data.device)
    for j in range(shape[1]):
        out ^= acc[:, j, :]
    return out.to(torch.uint8)
