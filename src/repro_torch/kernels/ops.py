"""Public ops for the erasure-coding kernels.

Dispatch layer over the GF(2^8) kernels. ``backend``:

  "gf"    — the hand-written CUDA kernel (``kernels.gf256_matmul``)
  "crs"   — bit-plane select-and-XOR (a later slice)
  "mxu"   — tensor-core mod-2 matmul (a later slice)
  "ref"   — the plain PyTorch table path (``kernels.ref``)

Every op runs where its data lies: a CUDA tensor goes through the kernel,
a CPU tensor through the plain version (the kernel wrappers decide that
from the tensor, never by catching an error). The kernel masks a ragged
byte width itself, so nothing here pads or slices. ``crs`` and ``mxu``
are valid names whose ops raise ``NotImplementedError`` until their
kernels land; no op ever substitutes another backend.
:func:`effective_backend` names the one documented difference between
the configured and the executed formulation — a "gf" batch on the CPU
runs the plain version and reports "ref".
"""
from __future__ import annotations

import os

import numpy as np
import torch

from repro_torch.dist.stripes import sharded_launch
from repro_torch.device import resolve_device

from . import ref as ref_lib
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


def _require_ported(backend: str) -> None:
    require_backend(backend)
    if backend in BIT_BACKENDS:
        raise NotImplementedError(
            f"backend {backend!r}: the bit-plane backends come in a later "
            f"slice (ROADMAP)")


def effective_backend(backend: str, device: str | torch.device = "cuda"
                      ) -> str:
    """The formulation a batched GF matmul with ``backend`` runs on
    ``device``: ``backend`` itself, except that a "gf" batch on the CPU
    runs the plain table path and reports "ref"."""
    require_backend(backend)
    if backend == "gf" and torch.device(device).type == "cpu":
        return "ref"
    return backend


def as_u8(x, device: str | torch.device | None = None) -> torch.Tensor:
    """``x`` (tensor or array-like) as a contiguous uint8 tensor on
    ``device``; a tensor stays where it is when ``device`` is None, and
    host data then goes to the card (``resolve_device``)."""
    if isinstance(x, torch.Tensor):
        dev = x.device if device is None else torch.device(device)
    else:
        arr = np.ascontiguousarray(x, np.uint8)
        x = torch.from_numpy(arr if arr.flags.writeable else arr.copy())
        dev = resolve_device("cuda" if device is None else device)
    return x.to(dev, torch.uint8).contiguous()


def gf_matmul_op(coef, data, *, backend: str = "gf",
                 device: str | torch.device | None = None) -> torch.Tensor:
    """GF(2^8) ``coef (m,k) @ data (k,B) -> (m,B)`` on ``data``'s device.

    gf launches the flat kernel (the plain version for a CPU tensor), ref
    runs the plain table path.
    """
    _require_ported(backend)
    data = as_u8(data, device)
    coef = as_u8(coef, data.device)
    if backend == "ref":
        return ref_lib.gf256_matmul_ref(coef, data)
    return gf256_matmul(coef, data)


def _gf_batch_kernel(coef, data, *, backend: str) -> torch.Tensor:
    """Single-device body of the batched GF matmul."""
    if backend == "ref":
        return ref_lib.gf256_matmul_batched_ref(coef, data)
    return gf256_matmul_batched(coef, data)


def gf_matmul_batch_op(coef, data, *, backend: str = "gf",
                       device: str | torch.device | None = None,
                       mesh_rules=None) -> torch.Tensor:
    """Batched GF(2^8) ``coef (m,k) @ data (S,k,B) -> (S,m,B)``.

    One launch for the whole stripe batch. A host numpy stack moves to
    ``device`` (the card unless the caller asks for the CPU) first.
    ``mesh_rules`` goes to :func:`~repro_torch.dist.stripes.sharded_launch`,
    which runs single-device launches only in this slice.
    """
    _require_ported(backend)
    data = as_u8(data, device)
    if data.ndim != 3:
        raise ValueError(f"expected (S, k, B) data, got {tuple(data.shape)}")
    coef = as_u8(coef, data.device)
    return sharded_launch(_gf_batch_kernel, coef, data, mesh_rules,
                          backend=backend)


def encode_op(coding: np.ndarray, blocks, *, backend: str = "gf",
              device: str | torch.device | None = None) -> torch.Tensor:
    """Stripe parity: byte blocks (k, B) -> parity (m, B)."""
    _require_ported(backend)
    return gf_matmul_op(np.asarray(coding, np.uint8), blocks,
                        backend=backend, device=device)


def encode_batch_op(coding: np.ndarray, blocks, *, backend: str = "gf",
                    device: str | torch.device | None = None,
                    mesh_rules=None) -> torch.Tensor:
    """Batched stripe parity: ``blocks (S, k, B) -> parity (S, m, B)``,
    one launch through :func:`gf_matmul_batch_op`."""
    _require_ported(backend)
    blocks = as_u8(blocks, device)
    if blocks.ndim != 3:
        raise ValueError(f"expected (S, k, B) blocks, got "
                         f"{tuple(blocks.shape)}")
    return gf_matmul_batch_op(np.asarray(coding, np.uint8), blocks,
                              backend=backend, mesh_rules=mesh_rules)


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
