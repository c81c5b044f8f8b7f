"""Public ops for the erasure-coding kernels.

Dispatch layer over the hand-written kernels. ``backend``:

  "gf"    — GF(2^8) table product (``kernels.gf256_matmul``)
  "crs"   — select-and-XOR on packed bit-planes (``kernels.bitmatrix_encode``)
  "mxu"   — mod-2 matmul on the tensor cores (``kernels.bitmatrix_encode``)
  "ref"   — the plain PyTorch table path (``kernels.ref``)

Every backend supports every op — encode, repair/decode combines, flat and
batched. The bit-plane backends (crs/mxu) run a general GF(2^8) matmul as
the packed GF(2) expansion of its coefficient matrix
(``core.gf.matrix_to_bitmatrix``) applied to bit-plane packets; callers
that hold a compiled plan pass its cached expansion via ``bitmatrix=``.

Every op runs where its data lies: a CUDA tensor goes through the kernel,
a CPU tensor through the plain version (the kernel wrappers decide that
from the tensor, never by catching an error). The kernels mask a ragged
width themselves: nothing is padded for gf/ref, and crs/mxu pad B only
to the multiple of 8 that ``packetize`` needs. No op ever substitutes
another backend. :func:`effective_backend` names the one documented
difference between the configured and the executed formulation — a "gf"
batch on the CPU runs the plain version and reports "ref".
"""
from __future__ import annotations

import os

import numpy as np
import torch

from repro_torch.core.gf import matrix_to_bitmatrix
from repro_torch.dist.stripes import ShardedBatch, sharded_launch
from repro_torch.device import as_u8

from . import ref as ref_lib
from .bitmatrix_encode import (bitmatrix_encode, bitmatrix_encode_batched,
                               mod2_matmul_encode, mod2_matmul_encode_batched)
from .gf256_matmul import gf256_matmul, gf256_matmul_batched

BACKENDS = ("gf", "crs", "mxu", "ref")
# Backends whose general matmul runs on packed bit-planes (GF(2) algebra).
BIT_BACKENDS = ("crs", "mxu")


def require_backend(backend: str) -> str:
    """Validate a backend name, raising a clear error for unknown ones."""
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown kernel backend {backend!r}; expected one of {BACKENDS}")
    return backend


def effective_backend(backend: str, device: str | torch.device = "cuda"
                      ) -> str:
    """The formulation a batched GF matmul with ``backend`` runs on
    ``device``: ``backend`` itself, except that a "gf" batch on the CPU
    runs the plain table path and reports "ref". The bit-plane backends
    run their own formulation (select-and-XOR, mod-2 matmul) everywhere,
    so they report themselves."""
    require_backend(backend)
    if backend == "gf" and torch.device(device).type == "cpu":
        return "ref"
    return backend


def _pad_bytes(x: torch.Tensor) -> tuple[torch.Tensor, int]:
    """``x`` with its last axis zero-padded to a multiple of 8 (what
    ``packetize`` needs), and the width before padding."""
    pad = -x.shape[-1] % 8
    return (torch.nn.functional.pad(x, (0, pad)) if pad else x), x.shape[-1]


def _as_bitmatrix(coef: torch.Tensor, bitmatrix) -> torch.Tensor:
    """The GF(2) expansion of byte coeffs ``coef`` (m, t) on ``coef``'s
    device: the caller's precomputed ``bitmatrix`` (a compiled plan's
    cached expansion) when given — shape-checked against ``coef`` — else
    expanded here."""
    bm = as_u8(matrix_to_bitmatrix(coef.cpu().numpy())
               if bitmatrix is None else bitmatrix, coef.device)
    want = (coef.shape[0] * 8, coef.shape[1] * 8)
    if tuple(bm.shape) != want:
        raise ValueError(f"bitmatrix shape {tuple(bm.shape)} does not match "
                         f"the {tuple(coef.shape)} coefficient matrix "
                         f"(want {want})")
    return bm


def gf_matmul_op(coef, data, *, backend: str = "gf",
                 device: str | torch.device | None = None,
                 bitmatrix=None) -> torch.Tensor:
    """GF(2^8) ``coef (m,k) @ data (k,B) -> (m,B)`` on ``data``'s device.

    gf launches the flat kernel (the plain version for a CPU tensor), ref
    runs the plain table path, and crs/mxu apply the coefficient matrix's
    packed bitmatrix on bit-plane packets (``bitmatrix=`` passes a
    precomputed expansion, e.g. a compiled plan's cached one).
    """
    require_backend(backend)
    data = as_u8(data, device)
    coef = as_u8(coef, data.device)
    if backend == "ref":
        return ref_lib.gf256_matmul_ref(coef, data)
    if backend in BIT_BACKENDS:
        return _crs_bitmatrix_apply(_as_bitmatrix(coef, bitmatrix), data,
                                    backend=backend)
    return gf256_matmul(coef, data)


def _gf_batch_kernel(coef, data, *, backend: str) -> torch.Tensor:
    """Single-device body of the batched GF matmul."""
    if backend == "ref":
        return ref_lib.gf256_matmul_batched_ref(coef, data)
    return gf256_matmul_batched(coef, data)


def _bit_matmul_batch_kernel(bm, data, *, backend: str) -> torch.Tensor:
    """Single-device body of the batched bit-plane matmul.

    ``bm`` is the packed (8m, 8t) GF(2) expansion of a byte coefficient
    matrix, ``data`` the (S, t, B) read stack: pad B to a multiple of 8,
    packetize, one launch of the stripe-batched kernel, unpacketize, cut
    the padding off.
    """
    padded, b = _pad_bytes(data)
    packets = ref_lib.packetize_batched(padded)
    if backend == "crs":
        par = bitmatrix_encode_batched(bm, packets)
    else:
        par = mod2_matmul_encode_batched(bm, packets)
    out = ref_lib.unpacketize_batched(par)
    return out if out.shape[-1] == b else out[..., :b]


def gf_matmul_batch_op(coef, data, *, backend: str = "gf",
                       device: str | torch.device | None = None,
                       mesh_rules=None, bitmatrix=None) -> torch.Tensor:
    """Batched GF(2^8) ``coef (m,k) @ data (S,k,B) -> (S,m,B)``.

    One launch for the whole stripe batch — one per device slice under
    ``mesh_rules`` (:func:`~repro_torch.dist.stripes.sharded_launch`) —
    for every backend: gf/ref run the byte table product, crs/mxu the
    stripe-batched bit-plane kernels on the coefficient matrix's packed
    GF(2) expansion (``bitmatrix=`` passes a precomputed one — the
    batched engine hands in its compiled plan's cached expansion).
    ``data`` may be a host array, a tensor or a
    :class:`~repro_torch.dist.stripes.ShardedBatch`. A batch that stays
    on one device moves to ``device`` (the card unless the caller asks
    for the CPU; where a tensor lies when None); a sharded one is
    scattered slice by slice to its mesh's devices, and its result
    lands on ``device`` (the first slice's when None).
    """
    require_backend(backend)
    if not isinstance(data, (torch.Tensor, ShardedBatch)):
        data = np.ascontiguousarray(data, np.uint8)
    if data.ndim != 3:
        raise ValueError(f"expected (S, k, B) data, got {tuple(data.shape)}")
    coef = as_u8(coef, "cpu")
    if backend in BIT_BACKENDS:
        return sharded_launch(_bit_matmul_batch_kernel,
                              _as_bitmatrix(coef, bitmatrix), data,
                              mesh_rules, device, backend=backend)
    return sharded_launch(_gf_batch_kernel, coef, data, mesh_rules, device,
                          backend=backend)


def _crs_bitmatrix_apply(bm, blocks, *, backend: str) -> torch.Tensor:
    """Bit-plane product of byte blocks (k, B) by a precomputed bitmatrix:
    the flat kernel of ``backend`` (crs, mxu) or the plain select-and-XOR
    (ref)."""
    padded, b = _pad_bytes(blocks)
    packets = ref_lib.packetize(padded)
    if backend == "crs":
        par = bitmatrix_encode(bm, packets)
    elif backend == "mxu":
        par = mod2_matmul_encode(bm, packets)
    elif backend == "ref":
        par = ref_lib.bitmatrix_encode_ref(bm, packets)
    else:
        raise ValueError(f"unknown backend {backend}")
    out = ref_lib.unpacketize(par)
    return out if out.shape[-1] == b else out[:, :b]


def crs_encode_op(coding: np.ndarray, blocks, *, backend: str = "crs",
                  device: str | torch.device | None = None) -> torch.Tensor:
    """CRS path: byte blocks (k, B) -> parity (m, B) via the bitmatrix of
    the GF coding matrix."""
    blocks = as_u8(blocks, device)
    bm = as_u8(matrix_to_bitmatrix(np.asarray(coding, np.uint8)),
               blocks.device)
    return _crs_bitmatrix_apply(bm, blocks, backend=backend)


def encode_op(coding: np.ndarray, blocks, *, backend: str = "gf",
              device: str | torch.device | None = None) -> torch.Tensor:
    """Stripe parity: byte blocks (k, B) -> parity (m, B), every backend."""
    require_backend(backend)
    if backend in ("gf", "ref"):
        return gf_matmul_op(np.asarray(coding, np.uint8), blocks,
                            backend=backend, device=device)
    return crs_encode_op(coding, blocks, backend=backend, device=device)


def encode_batch_op(coding: np.ndarray, blocks, *, backend: str = "gf",
                    device: str | torch.device | None = None,
                    mesh_rules=None, bitmatrix=None) -> torch.Tensor:
    """Batched stripe parity: ``blocks (S, k, B) -> parity (S, m, B)``,
    one launch through :func:`gf_matmul_batch_op` (``bitmatrix=`` passes
    the coding matrix's cached expansion for crs/mxu)."""
    require_backend(backend)
    blocks = as_u8(blocks, device)
    if blocks.ndim != 3:
        raise ValueError(f"expected (S, k, B) blocks, got "
                         f"{tuple(blocks.shape)}")
    return gf_matmul_batch_op(np.asarray(coding, np.uint8), blocks,
                              backend=backend, device=blocks.device,
                              mesh_rules=mesh_rules, bitmatrix=bitmatrix)


def default_backend(fallback: str | None = None) -> str:
    """``REPRO_BACKEND`` when set, else ``fallback`` when given, else "gf"
    (the hand-written kernel). Uncached so a test can monkeypatch the env
    var; constructors resolve it once via
    ``dataclasses.field(default_factory=...)``."""
    env = os.environ.get("REPRO_BACKEND")
    if env:
        return require_backend(env)
    if fallback is not None:
        return require_backend(fallback)
    return "gf"
