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
so the store, engine and scheduler read the same spans as the reference,
and the train step derives the same parameter, moment and batch specs.

A spec is a tuple with one entry per dimension, each entry the tuple of
mesh axes that dimension takes (``()``: replicated), where the reference
has a ``PartitionSpec``. The port has no GSPMD: :func:`shard_activation`
resolves an activation's spec and leaves the tensor as it is.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Iterator, Mapping, Optional, Sequence

import torch

# Logical-axis -> candidate mesh axes, tried left to right. Absent, claimed
# or indivisible axes are skipped (degradation); an empty tuple is an inert
# axis that only shards when a rule override maps it somewhere.
DEFAULT_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("data", "pod"),
    "stripes": ("data", "pod"),
    "seq": (),
    "kv_seq": (),
    "heads": ("model",),
    "kv_heads": ("model",),
    "ff": ("model",),
    "experts": ("model",),
    "expert_ff": ("model",),
    "inner": ("model",),
    "vocab": ("model",),
}

# Data-parallel axes used by the ZeRO/FSDP extension (opt_state_sharding).
DATA_AXES = ("data", "pod")


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


def shard_activation(x: torch.Tensor, *names: Optional[str]) -> torch.Tensor:
    """The reference's activation constraint: ``names`` resolve under the
    ambient rules (none outside ``with_rules``), and ``x`` comes back as it
    is, since the port places no tensor by a spec."""
    mr = _ACTIVE.get()
    if mr is not None:
        _resolve(x.shape, names, mr)
    return x


def opt_state_sharding(spec: Sequence[tuple], shape: Sequence[int],
                       mr: MeshRules) -> tuple:
    """ZeRO/FSDP extension: spread free data-parallel axes over ``spec``.

    Optimizer moments (and FSDP'd parameters) replicate along whatever the
    parameter spec leaves unsharded; this assigns the mesh's unclaimed
    data axes (:data:`DATA_AXES`) to the largest still-replicated divisible
    dimension, largest dimension first. Returns a spec in this module's
    form, one tuple of axes per dimension of ``shape``.
    """
    axis_sizes = dict(mr.mesh.shape)
    entries = [tuple(e) for e in spec] + [()] * (len(shape) - len(spec))
    entries = entries[:len(shape)]
    used = {ax for e in entries for ax in e}
    free = [ax for ax in DATA_AXES if ax in axis_sizes and ax not in used]
    for i in sorted((i for i, e in enumerate(entries) if not e),
                    key=lambda i: -int(shape[i])):
        if not free:
            break
        picked, remaining = [], int(shape[i])
        for ax in list(free):
            if remaining % axis_sizes[ax] != 0:
                continue
            picked.append(ax)
            free.remove(ax)
            remaining //= axis_sizes[ax]
        if picked:
            entries[i] = tuple(picked)
    return tuple(entries)
