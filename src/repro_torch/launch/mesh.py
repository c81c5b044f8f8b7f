"""Production meshes, as the port's ``Mesh`` names them.

The port of ``src/repro/launch/mesh.py``: functions, so importing this
module touches no device.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.device import resolve_device
from repro_torch.dist.sharding import Mesh, make_mesh


def make_production_mesh(*, multi_pod: bool = False,
                         devices: Optional[Sequence] = None) -> Mesh:
    """16x16 (256 devices) single-pod, or 2x16x16 = 512 devices multi-pod.

    Axes: ("data", "model") single-pod; ("pod", "data", "model") multi-pod.
    ``devices`` goes to ``make_mesh`` (repeats allowed: the dry run builds
    the mesh over ``("meta",) * n`` positions). Without it the mesh takes
    the machine's cards and raises ``ValueError`` on a machine with fewer,
    as ``Mesh`` does.
    """
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices)


def make_host_mesh(device: str | torch.device = "cuda") -> Mesh:
    """Every card of this machine as a (data=n, model=1) mesh (the card by
    default; raises without CUDA), or one host position for
    ``device="cpu"``."""
    dev = resolve_device(device)
    n = torch.cuda.device_count() if dev.type == "cuda" else 1
    return make_mesh((n, 1), ("data", "model"))
