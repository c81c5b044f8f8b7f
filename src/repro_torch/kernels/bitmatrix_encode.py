"""Hand-written CUDA GF(2) bitmatrix products on packed bit-planes.

``out[s, i, :] = XOR of packets[s, j, :] over every j with bm[i, j] != 0``
for a bitmatrix ``(R8, K8)`` of 0/1 and packets ``(S, K8, P)`` in the
layout of ``ref.packetize``. Two kernels compute it:

* ``csrc/bitmatrix_encode.cu`` — select-and-XOR (the crs backend), behind
  :func:`bitmatrix_encode_batched` and :func:`bitmatrix_encode`; they
  replace the TPU kernels ``src/repro/kernels/bitmatrix_encode.py::
  bitmatrix_encode_batched`` and ``::bitmatrix_encode``;
* ``csrc/mod2_matmul.cu`` — unpack to 0/1, an int8 tensor-core matmul,
  ``& 1``, repack (the mxu backend), behind
  :func:`mod2_matmul_encode_batched` and :func:`mod2_matmul_encode`; they
  replace ``::mod2_matmul_encode_batched`` and ``::mod2_matmul_encode``.

Each flat wrapper launches its batched kernel with S = 1. A tensor on the
CPU runs the plain PyTorch version (``repro_torch.kernels.ref``); a CUDA
tensor launches the kernel or raises. Each wrapper counts its launches in
a plain integer attribute (``bitmatrix_encode.launches`` and so on), so a
run can show that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from . import _build
from . import ref as ref_lib

_COUNT_LOCK = threading.Lock()
_LAUNCHERS: dict[str, object] = {}


def _launcher(source: str):
    fn = _LAUNCHERS.get(source)
    if fn is None:
        fn = getattr(_build.load(source), f"{source}_launch")
        fn.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LAUNCHERS[source] = fn
    return fn


def mod2_padded_shape(r8: int, k8: int) -> tuple[int, int]:
    """The (rows, depth) the mod-2 kernel multiplies for an (R8, K8)
    bitmatrix: rows padded to the 16-row MMA groups that share each packet
    fragment (one group for R8 <= 16, else pairs of groups, as
    ``csrc/mod2_matmul.cu`` picks them), depth to its 32-deep k step."""
    rows = 16 if r8 <= 16 else 32
    return -(-r8 // rows) * rows, -(-k8 // 32) * 32


def _check(bitmatrix: torch.Tensor, packets: torch.Tensor,
           packets_ndim: int) -> None:
    if bitmatrix.dtype != torch.uint8 or packets.dtype != torch.uint8:
        raise TypeError(f"expected uint8 tensors, got {bitmatrix.dtype} and "
                        f"{packets.dtype}")
    if bitmatrix.ndim != 2 or packets.ndim != packets_ndim:
        raise ValueError(f"expected a 2-D bitmatrix and {packets_ndim}-D "
                         f"packets, got {tuple(bitmatrix.shape)} and "
                         f"{tuple(packets.shape)}")
    if bitmatrix.shape[1] != packets.shape[-2]:
        raise ValueError(f"shape mismatch: bitmatrix "
                         f"{tuple(bitmatrix.shape)} vs packets "
                         f"{tuple(packets.shape)}")
    if bitmatrix.device != packets.device:
        raise ValueError(f"bitmatrix on {bitmatrix.device} but packets on "
                         f"{packets.device}")
    if not (bitmatrix.is_contiguous() and packets.is_contiguous()):
        raise ValueError("bitmatrix and packets must be contiguous")
    if packets.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {packets.device}")


def _launch(source: str, bitmatrix: torch.Tensor,
            packets: torch.Tensor) -> torch.Tensor:
    """One launch of ``csrc/<source>.cu`` on the current stream:
    (R8, K8) x (S, K8, P) -> (S, R8, P). Allocates the output; launches
    nothing (and returns it empty) when the output has no bytes."""
    s, k8, p = packets.shape
    r8 = bitmatrix.shape[0]
    if max(s, r8, k8) >= 2 ** 31:
        raise ValueError(f"shape {tuple(packets.shape)} x "
                         f"{tuple(bitmatrix.shape)} exceeds the kernel's "
                         f"int32 dimensions")
    out = torch.empty((s, r8, p), dtype=torch.uint8, device=packets.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(packets.device):
        err = _launcher(source)(bitmatrix.data_ptr(), packets.data_ptr(),
                                out.data_ptr(), r8, k8, p, s,
                                torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{source} kernel launch failed: CUDA error {err}")
    return out


def _count(wrapper, out: torch.Tensor) -> None:
    if out.numel():
        with _COUNT_LOCK:
            wrapper.launches += 1


def bitmatrix_encode_batched(bitmatrix: torch.Tensor,
                             packets: torch.Tensor) -> torch.Tensor:
    """Batched select-and-XOR ``bitmatrix (R8, K8) x packets (S, K8, P) ->
    (S, R8, P)``: one launch for every stripe, any R8, K8, S and P (a
    ragged P is masked inside the kernel)."""
    _check(bitmatrix, packets, 3)
    if packets.device.type == "cpu":
        return ref_lib.bitmatrix_encode_batched_ref(bitmatrix, packets)
    out = _launch("bitmatrix_encode", bitmatrix, packets)
    _count(bitmatrix_encode_batched, out)
    return out


def bitmatrix_encode(bitmatrix: torch.Tensor,
                     packets: torch.Tensor) -> torch.Tensor:
    """Flat select-and-XOR ``(R8, K8) x (K8, P) -> (R8, P)``: the batched
    kernel launched with S = 1."""
    _check(bitmatrix, packets, 2)
    if packets.device.type == "cpu":
        return ref_lib.bitmatrix_encode_ref(bitmatrix, packets)
    out = _launch("bitmatrix_encode", bitmatrix, packets[None])[0]
    _count(bitmatrix_encode, out)
    return out


def mod2_matmul_encode_batched(bitmatrix: torch.Tensor,
                               packets: torch.Tensor) -> torch.Tensor:
    """Batched mod-2 tensor-core product ``bitmatrix (R8, K8) x packets
    (S, K8, P) -> (S, R8, P)``, the same function as
    :func:`bitmatrix_encode_batched`."""
    _check(bitmatrix, packets, 3)
    if packets.device.type == "cpu":
        return ref_lib.mod2_matmul_encode_batched_ref(bitmatrix, packets)
    out = _launch("mod2_matmul", bitmatrix, packets)
    _count(mod2_matmul_encode_batched, out)
    return out


def mod2_matmul_encode(bitmatrix: torch.Tensor,
                       packets: torch.Tensor) -> torch.Tensor:
    """Flat mod-2 tensor-core product ``(R8, K8) x (K8, P) -> (R8, P)``:
    the batched kernel launched with S = 1."""
    _check(bitmatrix, packets, 2)
    if packets.device.type == "cpu":
        return ref_lib.mod2_matmul_encode_ref(bitmatrix, packets)
    out = _launch("mod2_matmul", bitmatrix, packets[None])[0]
    _count(mod2_matmul_encode, out)
    return out


bitmatrix_encode_batched.launches = 0
bitmatrix_encode.launches = 0
mod2_matmul_encode_batched.launches = 0
mod2_matmul_encode.launches = 0
