"""Placement layer: (stripe, block) -> (node, shard) + locality cost model.

The paper's repair gains are *bandwidth* gains — CP-LRC repair reads fewer
blocks — and this module makes the fleet layer move those blocks along the
shortest path. A :class:`PlacementMap` names, for every block, the node that
holds it and the *shard* (host / failure domain) that node belongs to, plus
a locality cost model: reads a shard serves from its own nodes are local,
reads that cross shards pay a configurable ``remote_multiplier`` on the
simulated link time (the same accounting XORing Elephants does for
cross-rack repair traffic).

The second half of the module is the gather geometry shared by the stripe
store and the repair pipeline: :func:`shard_layout` and :func:`plan_gather`
turn an ``(S, ...)`` batch shape into the host buffers the gather fills.
This slice runs on one card, so every batch gathers into one buffer
attributed to shard 0; assembling per-device shards is in ROADMAP queue
1 (multi-device dist).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np

from .sharding import MeshRules
from .stripes import stripe_span


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


@dataclasses.dataclass(frozen=True)
class ShardSlice:
    """One device shard's contiguous stripe range of an ``(S, ...)`` batch."""
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

    ``None`` when the batch stays on a single device — always, in this
    slice; a batch that would spread over several devices raises
    ``NotImplementedError``.
    """
    if mr is None or stripe_span(tuple(shape), mr) <= 1:
        return None
    raise NotImplementedError("multi-device gathers come in a later slice "
                              "(ROADMAP)")


@dataclasses.dataclass
class GatherShard:
    """One shard's gather work item: fill ``buf`` with stripes
    ``[lo, hi)`` of the group, attributing every read to ``shard``."""
    lo: int
    hi: int
    shard: int                             # reader (host) shard for accounting
    buf: np.ndarray                        # (hi - lo, ...) preallocated
    slice_: Optional[ShardSlice] = None    # None on the single-device path


def plan_gather(shape: Sequence[int], mr: Optional[MeshRules], placement
                ) -> tuple[Optional[list[ShardSlice]], list[GatherShard]]:
    """Shared gather geometry for the stripe store and the repair pipeline.

    Returns ``(layout, parts)``: the :func:`shard_layout` result (None on
    one device) and one :class:`GatherShard` per buffer. A single-device
    batch gets one full-shape ``uint8`` buffer attributed to shard 0 — the
    single-host gather, charged the same way on the synchronous and
    pipelined paths. ``placement`` attributes reads of a multi-device
    layout, which this slice does not build.
    """
    shape = tuple(shape)
    layout = shard_layout(shape, mr)
    return layout, [GatherShard(0, shape[0], 0, np.empty(shape, np.uint8))]
