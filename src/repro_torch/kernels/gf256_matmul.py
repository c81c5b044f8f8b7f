"""Hand-written CUDA GF(2^8) matrix product: flat and stripe-batched.

``out[s, i, :] = XOR_j gfmul(coef[i, j], data[s, j, :])`` with polynomial
0x11D. One kernel (``csrc/gf256_matmul.cu``) serves both wrappers; the
flat one launches it with S = 1. Each block builds, in its prologue and
from the exp/log table argument, three 8-entry product tables per
coefficient (data bits 0-2, 3-5 and 6-7); a lane holds them in registers
and looks up 4 bytes of a word with one byte permute, for 16 bytes of
each row and all output rows of its tile. It replaces the TPU kernels
``src/repro/kernels/gf256_matmul.py::gf256_matmul_batched`` and
``::gf256_matmul``.

A tensor on the CPU runs the plain PyTorch version
(``repro_torch.kernels.ref``); a CUDA tensor launches the kernel or
raises. Each wrapper counts its launches in a plain integer attribute
(``gf256_matmul.launches``, ``gf256_matmul_batched.launches``), so a run
can show that its main path went through the kernel. A launch over k
input rows builds :func:`table_chunks` ``(k)`` coefficient table chunks
(a k past one chunk builds the next chunk's tables once the first
chunk's rows are done).
"""
from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from repro_torch.core.gf import GF_EXP, GF_LOG

from . import _build
from . import ref as ref_lib

# Layout of the kernel's table argument (see the .cu file): an exp table
# that is cyclic below 510 and zero up to 1040, then 256 little-endian
# uint16 logs with log(0) = 512, so log a + log b indexes the zero tail
# whenever a or b is zero.
_EXP_SIZE = 1040
_LOG_ZERO = 512
# Input rows whose multiply tables a block holds at once (the kernel's
# kChunkK).
TABLE_CHUNK_ROWS = 64

_COUNT_LOCK = threading.Lock()
_TABLES: dict[torch.device, torch.Tensor] = {}
_LAUNCH = None


def launch_tables() -> np.ndarray:
    """The kernel's 1552-byte exp/log table argument."""
    exp = np.zeros(_EXP_SIZE, np.uint8)
    exp[:len(GF_EXP)] = GF_EXP
    log = GF_LOG.astype("<u2")
    log[0] = _LOG_ZERO
    return np.concatenate([exp, log.view(np.uint8)])


def _tables(device: torch.device) -> torch.Tensor:
    table = _TABLES.get(device)
    if table is None:
        table = torch.from_numpy(launch_tables()).to(device)
        _TABLES[device] = table
    return table


def _launcher():
    global _LAUNCH
    if _LAUNCH is None:
        fn = _build.load("gf256_matmul").gf256_matmul_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LAUNCH = fn
    return _LAUNCH


def _check(coef: torch.Tensor, data: torch.Tensor, data_ndim: int) -> None:
    if coef.dtype != torch.uint8 or data.dtype != torch.uint8:
        raise TypeError(f"expected uint8 tensors, got {coef.dtype} and "
                        f"{data.dtype}")
    if coef.ndim != 2 or data.ndim != data_ndim:
        raise ValueError(f"expected a 2-D coef and {data_ndim}-D data, got "
                         f"{tuple(coef.shape)} and {tuple(data.shape)}")
    if coef.shape[1] != data.shape[-2]:
        raise ValueError(f"shape mismatch: coef {tuple(coef.shape)} vs data "
                         f"{tuple(data.shape)}")
    if coef.device != data.device:
        raise ValueError(f"coef on {coef.device} but data on {data.device}")
    if not (coef.is_contiguous() and data.is_contiguous()):
        raise ValueError("coef and data must be contiguous")
    if data.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {data.device}")


def _launch(coef: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """One kernel launch on the current stream: (m,k) x (S,k,B) -> (S,m,B).

    Allocates the output; launches nothing (and returns it empty) when
    the output has no bytes.
    """
    s, k, b = data.shape
    m = coef.shape[0]
    if max(s, m, k) >= 2 ** 31:
        raise ValueError(f"shape {tuple(data.shape)} x {tuple(coef.shape)} "
                         f"exceeds the kernel's int32 dimensions")
    out = torch.empty((s, m, b), dtype=torch.uint8, device=data.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(data.device):
        err = _launcher()(coef.data_ptr(), data.data_ptr(), out.data_ptr(),
                          _tables(data.device).data_ptr(), m, k, b, s,
                          torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"gf256_matmul kernel launch failed: CUDA error "
                           f"{err}")
    return out


def table_chunks(k: int) -> int:
    """Coefficient table chunks one launch over ``k`` input rows builds."""
    return -(-k // TABLE_CHUNK_ROWS)


def _count(wrapper) -> None:
    """One launch of ``wrapper``, counted."""
    with _COUNT_LOCK:
        wrapper.launches += 1


def gf256_matmul_batched(coef: torch.Tensor,
                         data: torch.Tensor) -> torch.Tensor:
    """Batched GF(2^8) product ``coef (m,k) @ data (S,k,B) -> (S,m,B)``.

    One launch covers every stripe of the batch, for any m, k, S and B
    (a ragged B is masked inside the kernel).
    """
    _check(coef, data, 3)
    if data.device.type == "cpu":
        return ref_lib.gf256_matmul_batched_ref(coef, data)
    out = _launch(coef, data)
    if out.numel():
        _count(gf256_matmul_batched)
    return out


def gf256_matmul(coef: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """Flat GF(2^8) product ``coef (m,k) @ data (k,B) -> (m,B)``: the
    batched kernel launched with S = 1."""
    _check(coef, data, 2)
    if data.device.type == "cpu":
        return ref_lib.gf256_matmul_ref(coef, data)
    out = _launch(coef, data[None])[0]
    if out.numel():
        _count(gf256_matmul)
    return out


gf256_matmul_batched.launches = 0
gf256_matmul.launches = 0
