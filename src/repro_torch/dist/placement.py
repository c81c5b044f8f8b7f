"""Placement layer: (stripe, block) -> (node, shard) + locality cost model.

The paper's repair gains are *bandwidth* gains — CP-LRC repair reads fewer
blocks — and this module makes the fleet layer move those blocks along the
shortest path. A :class:`PlacementMap` names, for every block, the node that
holds it and the *shard* (host / failure domain) that node belongs to, plus
a locality cost model: reads a shard serves from its own nodes are local,
reads that cross shards pay a configurable ``remote_multiplier`` on the
simulated link time (the same accounting XORing Elephants does for
cross-rack repair traffic).

The second half of the module is the sharded-gather geometry shared by the
stripe store and the repair pipeline: :func:`plan_gather` turns an
``(S, ...)`` batch shape plus :class:`~repro_torch.dist.sharding.MeshRules`
into one host buffer per device slice of the mesh's stripe axis
(:func:`~repro_torch.dist.stripes.shard_layout`), and
:func:`assemble_shards` moves each buffer straight onto its slice's device
— no single-host ``(S, |reads|, B)`` stack and no device-0 bounce exist on
the path. Window alignment (``dist.stripes.align_stripe_window``) and this
layout agree by construction: an aligned window always yields ``span``
equal slices of ``S / span`` stripes in global stripe order.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.device import as_u8

from .sharding import MeshRules
from .stripes import ShardedBatch, ShardSlice, shard_layout


@dataclasses.dataclass(frozen=True)
class PlacementMap:
    """(stripe, block) -> (node, shard), with a local/remote cost model.

    ``shard_of_node[i]`` is the shard (host) node ``i`` lives in. ``node_of``
    resolves a ``(sid, block)`` pair to its node id (the stripe store's
    block placement); it may be ``None`` for maps that only answer
    node-level questions. ``remote_multiplier`` scales the simulated link
    time of a read whose source node lives outside the reading shard
    (1.0 = locality-blind, matching the pre-placement model).
    """
    shard_of_node: tuple[int, ...]
    remote_multiplier: float = 1.0
    node_of: Optional[Callable[[int, int], int]] = None

    @property
    def num_shards(self) -> int:
        return max(self.shard_of_node) + 1 if self.shard_of_node else 1

    def locate(self, sid: int, block: int) -> tuple[int, int]:
        """The (node, shard) holding ``(sid, block)``."""
        if self.node_of is None:
            raise ValueError("this PlacementMap has no (sid, block) resolver")
        node = self.node_of(sid, block)
        return node, self.shard_of_node[node]

    def shard_of(self, node: int) -> int:
        return self.shard_of_node[node]

    def is_local(self, node: int, reader_shard: Optional[int]) -> bool:
        """Is a read of ``node`` by ``reader_shard`` shard-local?

        ``reader_shard=None`` means the read is not attributed to any shard
        (client/degraded reads) and is charged as local.
        """
        if reader_shard is None:
            return True
        return self.shard_of_node[node] == reader_shard

    def read_multiplier(self, node: int, reader_shard: Optional[int]) -> float:
        """Link-time multiplier for one read (1.0 local, else remote cost)."""
        return 1.0 if self.is_local(node, reader_shard) \
            else self.remote_multiplier

    def reader_shard(self, device_shard: int, span: int) -> int:
        """Host shard serving device shard ``device_shard`` of ``span``.

        Contiguous, order-preserving — the same stripe->device mapping
        ``shard_layout`` / ``align_stripe_window`` use — so device shard d
        of a span-wide launch reads through host ``d * num_shards // span``
        (identity when the mesh span equals the host count).
        """
        if span <= 0:
            return 0
        return min(self.num_shards - 1, device_shard * self.num_shards // span)

    @classmethod
    def from_store(cls, store, num_shards: int = 1,
                   remote_multiplier: Optional[float] = None
                   ) -> "PlacementMap":
        """Default node->shard map for a stripe store: ``num_shards``
        contiguous node ranges (node ``i`` -> shard ``i*num_shards//N``),
        resolving blocks through the store's stripe placement. The
        multiplier defaults to ``store.cfg.remote_read_multiplier``."""
        n = store.num_nodes
        num_shards = max(1, min(int(num_shards), n))
        shard = tuple(i * num_shards // n for i in range(n))
        if remote_multiplier is None:
            remote_multiplier = getattr(store.cfg, "remote_read_multiplier",
                                        1.0)
        return cls(shard_of_node=shard,
                   remote_multiplier=float(remote_multiplier),
                   node_of=lambda sid, b: store.stripes[sid].node_of_block[b])


def block_loads(placements, num_nodes: int) -> dict[int, int]:
    """Resident-block count per node over per-stripe block->node lists.

    Args:
        placements: iterable of ``node_of_block`` lists (one per stripe) —
            e.g. ``(s.node_of_block for s in store.stripes.values())``.
        num_nodes: fleet size; every node gets an entry (0 when empty), so
            least-loaded selection sees idle nodes too.

    Returns:
        ``{node: blocks resident}`` — the load model behind
        rebuild-destination selection
        (``repro_torch.dist.topology.pick_destinations``) and the rebalancer
        (``repro_torch.ftx.rebalance``).
    """
    loads = {n: 0 for n in range(num_nodes)}
    for nodes in placements:
        for n in nodes:
            loads[n] = loads.get(n, 0) + 1
    return loads


@dataclasses.dataclass
class GatherShard:
    """One shard's gather work item: fill ``buf`` with stripes
    ``[lo, hi)`` of the group, attributing every read to ``shard``."""
    lo: int
    hi: int
    shard: int                             # reader (host) shard for accounting
    buf: np.ndarray                        # (hi - lo, ...) preallocated
    slice_: Optional[ShardSlice] = None    # None on the single-device path


def plan_gather(shape: Sequence[int], mr: Optional[MeshRules], placement,
                out: Optional[np.ndarray] = None
                ) -> tuple[Optional[list[ShardSlice]], list[GatherShard]]:
    """Shared gather geometry for the stripe store and the repair pipeline.

    Args:
        shape: the batched ``(S, |reads|, B)`` gather shape.
        mr: active mesh + rules, or ``None``.
        placement: the active :class:`PlacementMap` (attributes each
            shard's reads), or ``None`` to attribute device shard *i* to
            host shard *i* directly.
        out: a flat ``uint8`` buffer of at least the batch's bytes to back
            the buffers (a reused staging buffer), or ``None`` to allocate
            them. Each buffer is then the view of its stripe range
            ``[lo, hi)`` of the batch laid out in stripe order.

    Returns:
        ``(layout, parts)``: the :func:`shard_layout` result plus one
        :class:`GatherShard` per buffer — preallocated ``uint8`` host
        buffers with their stripe ranges and reader-shard attribution. A
        degraded batch (``layout is None``) gets one full-shape buffer
        attributed to shard 0 — the single-host gather, charged
        consistently on both the synchronous and pipelined paths. Sharded
        batches map device shard *i* onto the placement's host shards
        contiguously (``PlacementMap.reader_shard``), the same
        stripe->device order the layout itself uses.
    """
    shape = tuple(shape)
    row = math.prod(shape[1:])

    def buffer(lo: int, hi: int) -> np.ndarray:
        rows = (hi - lo,) + shape[1:]
        if out is None:
            return np.empty(rows, np.uint8)
        return out[lo * row:hi * row].reshape(rows)

    layout = shard_layout(shape, mr)
    if layout is None:
        return None, [GatherShard(0, shape[0], 0, buffer(0, shape[0]))]
    span = len(layout)
    parts = [GatherShard(
        sl.lo, sl.hi,
        placement.reader_shard(sl.index, span) if placement is not None
        else sl.index,
        buffer(sl.lo, sl.hi), sl) for sl in layout]
    return layout, parts


def assemble_shards(shape: Sequence[int], mr: MeshRules,
                    layout: Sequence[ShardSlice],
                    bufs: Sequence[np.ndarray]) -> ShardedBatch:
    """Per-shard host buffers -> one sharded batch, no host stack.

    Args:
        shape: the global ``(S, ...)`` shape being assembled.
        mr: active mesh + rules (must be the ones ``layout`` derives from).
        layout: the :func:`shard_layout` slices, in slice order.
        bufs: one host ``(slice.size, ...)`` buffer per slice, same order.

    Returns:
        A :class:`~repro_torch.dist.stripes.ShardedBatch` whose shards lie
        on their slices' first devices, each copied there on its own;
        ``sharded_launch`` consumes it with no second copy. A slice that
        other mesh axes replicate is copied once: the launch computes it
        once.
    """
    return ShardedBatch(tuple(shape), tuple(layout), tuple(
        as_u8(buf, sl.devices[0]) for sl, buf in zip(layout, bufs)))
