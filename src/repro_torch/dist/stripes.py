"""Stripe-axis sharding: scale the batched codec engine across devices.

Stripes are independent — no codec operation has a cross-stripe term — so
the stripe axis ``S`` of an ``(S, k, B)`` batch is embarrassingly parallel:
this module resolves it onto the mesh's data-parallel axes (the "stripes"
logical axis, ``("data", "pod")`` by default), cuts the batch into the
contiguous slices that resolution implies and launches the kernel once per
slice, on that slice's device.

Degradation mirrors ``repro_torch.dist.sharding._resolve``: an ``S`` that
the data axis does not divide falls back to a single-device launch
(bit-identical either way — GF(2^8) arithmetic is exact, so partitioning
never changes results, only wall-clock).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence

import torch

from repro_torch.device import as_u8

from .sharding import Mesh, MeshRules, _resolve


def stripe_spec(shape, mr: MeshRules) -> tuple:
    """Per-dimension mesh axes sharding axis 0 (stripes) of an ``(S, ...)``
    batch, as ``_resolve`` gives them: ``(("data",), (), ...)``, or an
    empty first entry when the stripe axis degrades (indivisible S / no
    candidate axes). Trailing dims always replicate."""
    names = ("stripes",) + (None,) * (len(shape) - 1)
    return _resolve(shape, names, mr)


@dataclasses.dataclass(frozen=True)
class StripeSharding:
    """:func:`stripe_spec` bound to a mesh: the layout both the sharded
    launch and the per-shard gather geometry derive from."""
    mesh: Mesh
    spec: tuple

    def devices_indices_map(self, shape) -> list[tuple]:
        """``(device, index)`` of every mesh position, in row-major mesh
        order (a list, since devices may repeat): ``index`` is the tuple
        of slices of ``shape`` the position holds, as JAX's
        ``addressable_devices_indices_map`` gives it. ``device`` is None
        on a one-position mesh built without devices."""
        names = list(self.mesh.shape)
        sizes = [int(self.mesh.shape[n]) for n in names]
        devices = self.mesh.devices or (None,) * self.mesh.size
        out = []
        for pos, dev in enumerate(devices):
            coord, rest = {}, pos
            for name, size in zip(reversed(names), reversed(sizes)):
                coord[name], rest = rest % size, rest // size
            index = []
            for dim, axes in zip(shape, self.spec):
                if not axes:
                    index.append(slice(None))
                    continue
                part, count = 0, 1
                for ax in axes:
                    part = part * self.mesh.shape[ax] + coord[ax]
                    count *= self.mesh.shape[ax]
                chunk = int(dim) // count
                index.append(slice(part * chunk, (part + 1) * chunk))
            out.append((dev, tuple(index)))
        return out


def stripe_sharding(shape, mr: MeshRules) -> StripeSharding:
    """:func:`stripe_spec` bound to ``mr``'s mesh."""
    return StripeSharding(mr.mesh, stripe_spec(shape, mr))


def stripe_axis_span(mr: Optional[MeshRules]) -> int:
    """Device count the "stripes" logical axis *can* claim on ``mr``'s mesh
    (the product of its candidate axes present in the mesh), independent of
    any particular batch size. 1 with no rules or no candidate axes."""
    if mr is None:
        return 1
    sizes = dict(mr.mesh.shape)
    span = 1
    for ax in dict.fromkeys(mr.axes_for("stripes")):
        span *= sizes.get(ax, 1)
    return span


def align_stripe_window(window: int, mr: Optional[MeshRules]) -> int:
    """Largest window' <= ``window`` divisible by the stripe-axis device
    span, so windowed launches keep their full device parallelism. Windows
    smaller than the span are returned unchanged."""
    span = stripe_axis_span(mr)
    if span <= 1 or window < span:
        return window
    return (window // span) * span


def stripe_span(shape, mr: Optional[MeshRules]) -> int:
    """How many devices an ``(S, ...)`` batch spreads over (1 = degraded):
    unlike :func:`stripe_axis_span`, an S the stripe axis does not divide
    resolves to 1. The scheduler and the gather layout both key off this
    value, so "will this launch shard?" has one answer everywhere."""
    if mr is None or not len(shape):
        return 1
    sizes = dict(mr.mesh.shape)
    return math.prod(sizes[ax] for ax in stripe_spec(shape, mr)[0])


@dataclasses.dataclass(frozen=True)
class ShardSlice:
    """One device shard's contiguous stripe range of an ``(S, ...)`` batch.

    ``devices`` has more than one entry when other mesh axes replicate the
    batch (e.g. a 4x2 mesh shards stripes over "data" and replicates over
    "model").
    """
    index: int
    lo: int
    hi: int
    devices: tuple

    @property
    def size(self) -> int:
        return self.hi - self.lo


def shard_layout(shape: Sequence[int], mr: Optional[MeshRules]
                 ) -> Optional[list[ShardSlice]]:
    """Per-device stripe slices for an ``(S, ...)`` batch, global order.

    ``None`` when the batch degrades to a single device (no rules, trivial
    mesh, or an ``S`` the stripe axis does not divide). Otherwise ``span``
    equal contiguous :class:`ShardSlice` ranges in stripe order
    (``slices[d]`` covers ``[d*S/span, (d+1)*S/span)``); the stripe
    scheduler (``repro_torch.dist.schedule``) relies on this list-position
    -> slice mapping to assign stripes to shards by permutation.
    """
    shape = tuple(shape)
    if mr is None or stripe_span(shape, mr) <= 1:
        return None
    groups: dict[tuple[int, int], list] = {}
    for dev, idx in stripe_sharding(shape, mr).devices_indices_map(shape):
        groups.setdefault((idx[0].start, idx[0].stop), []).append(dev)
    return [ShardSlice(i, lo, hi, tuple(held))
            for i, ((lo, hi), held) in enumerate(sorted(groups.items()))]


@dataclasses.dataclass(frozen=True)
class ShardedBatch:
    """An ``(S, ...)`` batch held as one tensor per :class:`ShardSlice`,
    each on its slice's first device (``repro_torch.dist.placement.
    assemble_shards`` builds one); :func:`sharded_launch` consumes it
    without another copy."""
    shape: tuple
    layout: tuple
    shards: tuple

    @property
    def ndim(self) -> int:
        return len(self.shape)


def sharded_launch(fn: Callable, coeffs, batch, mr: Optional[MeshRules],
                   device=None, **kwargs) -> torch.Tensor:
    """Run ``fn(coeffs, batch, **kwargs)`` split over the stripe axis.

    With no rules, or when the stripe axis degrades (indivisible ``S`` or
    a trivial mesh), one call on ``device`` (where a tensor ``batch`` lies
    when None). Otherwise one call of ``fn`` per :func:`shard_layout`
    slice, on that slice's first device, and the ``(S, m, B)`` result
    concatenated in stripe order on ``device`` (the first slice's when
    None). ``batch`` may arrive as:

    * a :class:`ShardedBatch` laid out as this mesh resolves — each shard
      is consumed where it lies, with no second host->device copy (one
      laid out otherwise raises ``ValueError``);
    * a host numpy array or a tensor — scattered slice by slice.

    A slice that other mesh axes replicate (a 4x2 mesh) launches once,
    not once per replica: the reference's ``shard_map`` computes every
    replica, but the replicas' outputs are the same bytes.
    """
    layout = shard_layout(batch.shape, mr)
    if isinstance(batch, ShardedBatch) and (
            layout is None or tuple(layout) != batch.layout):
        raise ValueError("a ShardedBatch launches only under the mesh "
                         "rules it was assembled with")
    if layout is None:
        data = as_u8(batch, device)
        return fn(as_u8(coeffs, data.device), data, **kwargs)
    if isinstance(batch, ShardedBatch):
        shards = batch.shards
    else:
        shards = [as_u8(batch[sl.lo:sl.hi], sl.devices[0]) for sl in layout]
    outs = [fn(as_u8(coeffs, s.device), s, **kwargs) for s in shards]
    dev = outs[0].device if device is None else torch.device(device)
    return torch.cat([o.to(dev) for o in outs])
