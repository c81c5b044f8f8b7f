"""Plain PyTorch versions of the erasure-coding kernels.

Each function computes exactly what its CUDA kernel computes, so the tests
hold the two byte for byte (erasure coding is integer math — there is no
tolerance). The port runs these for tensors that lie on the CPU only; a
CUDA tensor always goes through the hand-written kernel.

Two families: the GF(2^8) table products (``gf256_matmul*``) and the
bit-plane ones of the crs/mxu backends (``bitmatrix_encode*``,
``mod2_matmul_encode*``), which apply a packed GF(2) bitmatrix to the
packets that :func:`packetize` lays out. ``packetize``/``unpacketize``
are glue that runs on the card as plain PyTorch, as the reference runs
them as jnp outside its kernels.
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


# --------------------------------------------------------------------------
# Bit-plane layout: packet j*8+i is bit-plane i of block j; bit t of packed
# byte p is bit i of source byte 8p+t (the reference's ``packetize``).
# --------------------------------------------------------------------------
# Masks of the three rounds of an 8x8 bit transpose on one int64 word whose
# byte r holds row r (bit 8r+c is row r, column c). All fit a signed int64
# and clear the bits an arithmetic right shift smears in.
_TRANSPOSE_ROUNDS = ((7, 0x00AA00AA00AA00AA), (14, 0x0000CCCC0000CCCC),
                     (28, 0x00000000F0F0F0F0))


def _transpose8(words: torch.Tensor) -> torch.Tensor:
    """Transpose the 8x8 bit matrix in each int64 word (its own inverse)."""
    x = words
    for shift, mask in _TRANSPOSE_ROUNDS:
        t = ((x >> shift) ^ x) & mask
        x = x ^ t ^ (t << shift)
    return x


def _bytes_as_words(x: torch.Tensor) -> torch.Tensor:
    """``x (..., 8n)`` uint8 viewed as ``(..., n)`` little-endian int64."""
    if not x.is_contiguous() or x.storage_offset() % 8:
        x = x.clone(memory_format=torch.contiguous_format)
    return x.view(torch.int64)


def packetize_batched(blocks: torch.Tensor) -> torch.Tensor:
    """``(S, k, B)`` byte blocks -> ``(S, k*8, B//8)`` packed bit-planes.

    Each run of 8 source bytes is one int64 word; transposing its 8x8 bit
    matrix puts plane i in byte i, and a permute lays the planes out as
    rows.
    """
    s, k, b = blocks.shape
    if b % _BITS:
        raise ValueError(f"block bytes {b} must be divisible by 8")
    planes = _transpose8(_bytes_as_words(blocks)).view(torch.uint8)
    return planes.view(s, k, b // _BITS, _BITS).transpose(2, 3).reshape(
        s, k * _BITS, b // _BITS)


def unpacketize_batched(packets: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`packetize_batched`: ``(S, k*8, P) -> (S, k, 8P)``."""
    s, k8, p = packets.shape
    if k8 % _BITS:
        raise ValueError(f"packet rows {k8} must be divisible by 8")
    k = k8 // _BITS
    runs = packets.reshape(s, k, _BITS, p).transpose(2, 3).reshape(
        s, k, p * _BITS)
    return _transpose8(_bytes_as_words(runs)).view(torch.uint8)


def packetize(blocks: torch.Tensor) -> torch.Tensor:
    """``(k, B)`` byte blocks -> ``(k*8, B//8)`` packed bit-plane packets."""
    return packetize_batched(blocks[None])[0]


def unpacketize(packets: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`packetize`: ``(k*8, B//8) -> (k, B)``."""
    return unpacketize_batched(packets[None])[0]


def bitmatrix_encode_batched_ref(bitmatrix: torch.Tensor,
                                 packets: torch.Tensor) -> torch.Tensor:
    """``bitmatrix (R8, K8) x packets (S, K8, P) -> (S, R8, P)`` over GF(2):
    ``out[s, i] = XOR of packets[s, j] over every j with bm[i, j] != 0``.

    One select-and-XOR per input row, so memory stays at one output-sized
    tensor whatever K8 is.
    """
    s, k8, p = packets.shape
    r8 = bitmatrix.shape[0]
    sel = (bitmatrix != 0).to(device=packets.device, dtype=torch.uint8)
    out = torch.zeros((s, r8, p), dtype=torch.uint8, device=packets.device)
    for j in range(k8):
        out ^= packets[:, j:j + 1, :] * sel[:, j].view(1, r8, 1)
    return out


def bitmatrix_encode_ref(bitmatrix: torch.Tensor,
                         packets: torch.Tensor) -> torch.Tensor:
    """Flat :func:`bitmatrix_encode_batched_ref`: ``(K8, P) -> (R8, P)``."""
    return bitmatrix_encode_batched_ref(bitmatrix, packets[None])[0]


# Packed bytes of one packet row per matmul in the mod-2 version: the 0/1
# float32 operand is (K8, 8 * _MOD2_CHUNK), 512 KiB for each of its rows.
_MOD2_CHUNK = 1 << 14


def mod2_matmul_encode_batched_ref(bitmatrix: torch.Tensor,
                                   packets: torch.Tensor) -> torch.Tensor:
    """The same product as :func:`bitmatrix_encode_batched_ref`, computed as
    the mxu kernel does: unpack packets to 0/1 bits, an ordinary matmul,
    ``count & 1``, repack 8 bits a byte.

    The matmul is float32 (exact: a count is at most K8 < 2^24), one
    stripe and one chunk of packed bytes at a time so the unpacked operand
    stays small.
    """
    s, k8, p = packets.shape
    r8 = bitmatrix.shape[0]
    dev = packets.device
    bm = (bitmatrix != 0).to(device=dev, dtype=torch.float32)
    shifts = torch.arange(_BITS, device=dev, dtype=torch.int32)
    out = torch.empty((s, r8, p), dtype=torch.uint8, device=dev)
    for si in range(s):
        for lo in range(0, p, _MOD2_CHUNK):
            hi = min(p, lo + _MOD2_CHUNK)
            pk = packets[si, :, lo:hi].to(torch.int32)
            bits = ((pk[:, :, None] >> shifts) & 1).to(torch.float32)
            counts = bm @ bits.view(k8, (hi - lo) * _BITS)
            odd = (counts.to(torch.int32) & 1).view(r8, hi - lo, _BITS)
            out[si, :, lo:hi] = (odd << shifts).sum(-1).to(torch.uint8)
    return out


def mod2_matmul_encode_ref(bitmatrix: torch.Tensor,
                           packets: torch.Tensor) -> torch.Tensor:
    """Flat :func:`mod2_matmul_encode_batched_ref`: ``(K8, P) -> (R8, P)``."""
    return mod2_matmul_encode_batched_ref(bitmatrix, packets[None])[0]
