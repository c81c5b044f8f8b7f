"""Device meshes and the logical-axis rules of the stripe axis.

A :class:`Mesh` names its axes and their sizes and lists its devices in
row-major mesh order (the order ``jax.make_mesh`` uses). Devices may
repeat: eight positions on one card (``("cuda:0",) * 8``) or on the host
(``("cpu",) * 8``) split a launch eight ways on that one device.

The reference resolves logical axis names ("stripes", "batch", ...) onto
the axes of a device mesh, with divisibility degradation: an axis is
assigned only if it exists in the mesh, is not already claimed by an
earlier dimension, and evenly divides what remains. The port keeps that
resolution and the ambient-context API (``with_rules``/``current_rules``)
so the store, engine and scheduler read the same spans as the reference.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Iterator, Mapping, Optional, Sequence

import torch

# Logical-axis -> candidate mesh axes, tried left to right: the
# reference's entry for the one logical axis the stripe system shards.
DEFAULT_RULES: dict[str, tuple[str, ...]] = {
    "stripes": ("data", "pod"),
}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named mesh axes and their sizes, e.g. ``Mesh({"data": 8, "model":
    1})``, over ``devices`` in row-major mesh order.

    Without ``devices`` a mesh of one position has none (its launches run
    where their data lies), and a larger mesh takes ``cuda:0``,
    ``cuda:1``, ... and raises ``ValueError`` when the machine has fewer
    cards: it never falls back to the CPU.
    """
    shape: Mapping[str, int]
    devices: tuple = ()

    def __post_init__(self):
        size = self.size
        devices = tuple(torch.device(d) for d in self.devices)
        if not devices and size > 1:
            count = torch.cuda.device_count()
            if size > count:
                raise ValueError(
                    f"a {size}-device mesh on a machine with {count} CUDA "
                    f"device(s): pass its devices explicitly")
            devices = tuple(torch.device("cuda", i) for i in range(size))
        if devices and len(devices) != size:
            raise ValueError(f"{len(devices)} devices for a mesh of "
                             f"{size} positions {dict(self.shape)}")
        object.__setattr__(self, "devices", devices)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())


def make_mesh(shape: Sequence[int], names: Sequence[str],
              devices: Optional[Sequence] = None) -> Mesh:
    """A :class:`Mesh` of axes ``names`` with sizes ``shape``, as
    ``jax.make_mesh(shape, names)`` builds one; ``devices`` (any
    ``torch.device`` arguments, in row-major order, repeats allowed)
    defaults to the machine's cards."""
    if len(shape) != len(names):
        raise ValueError(f"mesh shape {tuple(shape)} for axes {tuple(names)}")
    return Mesh(dict(zip(names, (int(n) for n in shape))),
                tuple(devices or ()))


@dataclasses.dataclass(frozen=True)
class MeshRules:
    """A mesh plus the active logical-axis -> mesh-axes rules."""
    mesh: Mesh
    rules: Mapping[str, tuple[str, ...]]

    def axes_for(self, name: Optional[str]) -> tuple[str, ...]:
        if name is None:
            return ()
        return self.rules.get(name, ())


_ACTIVE: contextvars.ContextVar[Optional[MeshRules]] = contextvars.ContextVar(
    "repro_torch_dist_mesh_rules", default=None)


def _normalize(overrides: Optional[Mapping]) -> dict[str, tuple[str, ...]]:
    out: dict[str, tuple[str, ...]] = {}
    for name, axes in (overrides or {}).items():
        if axes is None:
            axes = ()
        elif isinstance(axes, str):
            axes = (axes,)
        out[name] = tuple(axes)
    return out


@contextlib.contextmanager
def with_rules(mesh: Mesh, overrides: Optional[Mapping] = None
               ) -> Iterator[MeshRules]:
    """Install ``mesh`` + (DEFAULT_RULES | overrides) as the ambient context."""
    mr = MeshRules(mesh=mesh, rules={**DEFAULT_RULES, **_normalize(overrides)})
    token = _ACTIVE.set(mr)
    try:
        yield mr
    finally:
        _ACTIVE.reset(token)


def current_rules() -> Optional[MeshRules]:
    """The ambient MeshRules, or None outside any ``with_rules`` block."""
    return _ACTIVE.get()


def _resolve(shape: Sequence[int], names: Sequence[Optional[str]],
             mr: MeshRules) -> tuple:
    """Logical names -> per-dimension mesh axes under ``mr``, degraded.

    Per dimension, candidate mesh axes are tried in rule order; an axis is
    assigned only if it exists in the mesh, is not already claimed by an
    earlier dimension, and evenly divides what remains of the dimension.
    Each entry is a tuple of the axes picked (empty = replicated).
    """
    axis_sizes = dict(mr.mesh.shape)
    used: set[str] = set()
    entries: list = []
    for dim, name in zip(shape, names):
        picked: list[str] = []
        remaining = int(dim)
        for ax in mr.axes_for(name):
            size = axis_sizes.get(ax)
            if size is None or ax in used or remaining % size != 0:
                continue
            picked.append(ax)
            used.add(ax)
            remaining //= size
        entries.append(tuple(picked))
    return tuple(entries)
