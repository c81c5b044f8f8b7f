"""The card's published peak and the least time of the GF(2^8) kernel's
launches.

NVIDIA H100 SXM (data sheet, at the full 700 W): HBM3 at 3.35 TB/s.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12


def gf256_matmul_seconds(read_blocks: int, written_blocks: int,
                         block_size: int) -> float:
    """Least time of launches of the GF(2^8) product that read
    ``read_blocks`` source blocks and write ``written_blocks`` rebuilt
    blocks of ``block_size`` bytes: every byte once at the HBM rate.

    Left out, so the bound is never too high: the coefficient matrices
    (``m * k`` bytes a launch, at most 48 at P5) and the operations (one
    32-bit multiply-add a source byte a target, at 67 TFLOP/s of float32
    a time under a tenth of the bytes' at P5, where ``m <= 2``).
    """
    return (read_blocks + written_blocks) * block_size / HBM_BYTES_PER_S
