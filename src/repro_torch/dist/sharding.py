"""Logical-axis rules for the stripe axis: single-device in this slice.

The reference resolves logical axis names ("stripes", "batch", ...) onto
the axes of a device mesh, with divisibility degradation: an axis is
assigned only if it exists in the mesh, is not already claimed by an
earlier dimension, and evenly divides what remains. The port keeps that
resolution and the ambient-context API (``with_rules``/``current_rules``)
so the store, engine and scheduler read the same spans as the reference.

Splitting a launch over several cards comes in a later slice (ROADMAP
queue 1, multi-device dist): a :class:`MeshRules` over a mesh of more than one device
raises ``NotImplementedError`` when it is built.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Iterator, Mapping, Optional, Sequence

# Logical-axis -> candidate mesh axes, tried left to right: the
# reference's entry for the one logical axis the stripe system shards.
DEFAULT_RULES: dict[str, tuple[str, ...]] = {
    "stripes": ("data", "pod"),
}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named mesh axes and their sizes, e.g. ``Mesh({"data": 1})``."""
    shape: Mapping[str, int]

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())


@dataclasses.dataclass(frozen=True)
class MeshRules:
    """A mesh plus the active logical-axis -> mesh-axes rules."""
    mesh: Mesh
    rules: Mapping[str, tuple[str, ...]]

    def __post_init__(self):
        if self.mesh.size > 1:
            raise NotImplementedError(
                f"a {self.mesh.size}-device mesh: multi-device stripe "
                f"sharding comes in a later slice (ROADMAP)")

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
