"""Production meshes, as the port's ``Mesh`` names them.

The port of ``src/repro/launch/mesh.py``: functions, so importing this
module touches no device.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.dist.sharding import Mesh, make_mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 (256 devices) single-pod, or 2x16x16 = 512 devices multi-pod.

    Axes: ("data", "model") single-pod; ("pod", "data", "model") multi-pod.
    Raises ``ValueError`` on a machine with fewer cards, as ``Mesh`` does.
    """
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_host_mesh(device: str | torch.device = "cuda") -> Mesh:
    """Every card of this machine as a (data=n, model=1) mesh (the card by
    default; raises without CUDA), or one host position for
    ``device="cpu"``."""
    dev = resolve_device(device)
    n = torch.cuda.device_count() if dev.type == "cuda" else 1
    return make_mesh((n, 1), ("data", "model"))
