"""GF(2^8) kernels of the port: the hand-written CUDA matmul
(``gf256_matmul``), its plain PyTorch versions (``ref``) and the backend
dispatch layer (``ops``)."""
from .ops import encode_op, gf_matmul_batch_op, gf_matmul_op  # noqa: F401
from . import ref  # noqa: F401
