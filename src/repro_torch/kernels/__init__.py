"""Erasure-coding kernels of the port: the hand-written CUDA GF(2^8)
matmul (``gf256_matmul``) and GF(2) bit-plane products
(``bitmatrix_encode``), their plain PyTorch versions (``ref``) and the
backend dispatch layer (``ops``)."""
from .ops import (crs_encode_op, encode_batch_op, encode_op,  # noqa: F401
                  gf_matmul_batch_op, gf_matmul_op)
from . import bitmatrix_encode, ref  # noqa: F401
