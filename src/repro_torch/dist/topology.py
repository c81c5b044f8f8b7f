"""Topology layer: nodes, failure domains, and block-placement policies.

The paper's repair-time wins assume repair reads come from *nearby*
survivors; whether they do is decided by **placement policy**, not code
structure — the lesson of the copyset/failure-domain analysis in *XORing
Elephants* (Sathiamoorthy et al.) and the locality framing of *Locally
Repairable Codes* (Papailiopoulos & Dimakis). This module makes that policy
pluggable:

* :class:`Topology` describes the physical fleet: ``num_nodes`` storage
  nodes grouped into ``num_domains`` failure domains (racks / hosts).
  Domains are contiguous equal node ranges — the same node->shard geometry
  :meth:`~repro_torch.dist.placement.PlacementMap.from_store` derives — so a
  domain doubles as the *gather shard* that serves a device slice during
  sharded repair.
* :func:`place_stripe` maps a stripe's ``n`` blocks onto nodes under one of
  three policies (:data:`POLICIES`):

  - ``"contiguous"`` — a rotated arc of ``n`` consecutive nodes (the stripe
    store's seed behavior, stride 7). Every stripe of a pattern group lands
    on the *same* arc, so repair locality is whatever the arc's overlap
    with the reading domain happens to be.
  - ``"round_robin"`` — blocks round-robin across failure domains (classic
    "one replica per rack"): maximal failure-domain dispersion, which also
    means every repair read set spreads over ~all domains and no scheduler
    can make it local.
  - ``"spread"`` — copyset-style: each stripe picks a small seeded-random
    set of domains (``spread_width``) and scatters its blocks over their
    nodes. Bounds the number of distinct copysets (the XORing-Elephants
    correlated-failure argument) *and* concentrates each stripe's repair
    reads in few domains — the skewed scenario where locality-aware stripe
    scheduling (``repro_torch.dist.schedule``) pays.

* :func:`placement_from_topology` turns a topology + a live stripe store
  into the :class:`~repro_torch.dist.placement.PlacementMap` the repair read
  stack consumes (node->shard from the domains, block->node from the
  store's stripe index, remote cost from the store config).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .placement import PlacementMap

# Recognized block-placement policies, in increasing dispersion order of a
# single stripe's blocks across failure domains: arc < copyset < per-block.
POLICIES = ("contiguous", "spread", "round_robin")

# The seed stripe store's arc stride: coprime to typical node counts, so
# consecutive stripes rotate their arcs and parities spread across nodes.
_ARC_STRIDE = 7


@dataclasses.dataclass(frozen=True)
class Topology:
    """A fleet of storage nodes grouped into failure domains.

    Args:
        num_nodes: total storage nodes (the stripe store's virtual nodes).
        num_domains: failure domains (racks / hosts). Nodes are assigned to
            domains in contiguous equal ranges: node ``i`` lives in domain
            ``i * num_domains // num_nodes`` — the same contiguous geometry
            the placement layer's default node->shard map uses, so a domain
            is also the gather shard serving a device slice.
        spread_width: how many domains the ``"spread"`` policy lets one
            stripe touch (widened automatically when the chosen domains
            hold fewer than ``n`` nodes).
        seed: seeds the ``"spread"`` policy's per-stripe domain choice.
    """
    num_nodes: int
    num_domains: int = 1
    spread_width: int = 2
    seed: int = 0

    def __post_init__(self):
        if self.num_nodes < 1:
            raise ValueError("topology needs at least one node")
        if not 1 <= self.num_domains <= self.num_nodes:
            raise ValueError(
                f"num_domains must be in [1, {self.num_nodes}], "
                f"got {self.num_domains}")
        if self.spread_width < 1:
            raise ValueError("spread_width must be >= 1")

    def domain_of(self, node: int) -> int:
        """Failure domain of ``node`` (contiguous equal ranges)."""
        return node * self.num_domains // self.num_nodes

    # Rack vocabulary: the reliability simulator (``repro_torch.sim``) models a
    # disk/node/rack unit hierarchy; its racks ARE this topology's failure
    # domains (one correlated-failure blast radius per domain), so the same
    # Topology object drives placement, gather sharding, and fleet
    # simulation without a parallel geometry.
    @property
    def num_racks(self) -> int:
        """Racks for the unit hierarchy — identical to ``num_domains``."""
        return self.num_domains

    def rack_of(self, node: int) -> int:
        """Rack of ``node`` — identical to :meth:`domain_of`."""
        return self.domain_of(node)

    def nodes_by_rack(self) -> list[list[int]]:
        """Node ids grouped by rack (= failure domain), ascending."""
        return [self.nodes_in(d) for d in range(self.num_domains)]

    def nodes_in(self, domain: int) -> list[int]:
        """All node ids in ``domain``, ascending."""
        n, d = self.num_nodes, self.num_domains
        lo = -(-domain * n // d)            # ceil(domain * n / d)
        hi = -(-(domain + 1) * n // d)
        return list(range(lo, hi))

    def shard_of_node(self) -> tuple[int, ...]:
        """node id -> domain id, as the tuple ``PlacementMap`` consumes."""
        return tuple(self.domain_of(i) for i in range(self.num_nodes))


def place_stripe(policy: str, topo: Topology, sid: int, n: int) -> list[int]:
    """Place stripe ``sid``'s ``n`` blocks onto nodes under ``policy``.

    Args:
        policy: one of :data:`POLICIES`.
        topo: the fleet topology.
        sid: stripe id (drives rotation / the seeded domain choice).
        n: blocks per stripe (``k + p + r``).

    Returns:
        ``n`` distinct node ids, indexed by block. Deterministic in
        ``(policy, topo, sid, n)`` — re-running a placement is a pure
        function, so manifests and twin stores reproduce exactly.

    Raises:
        ValueError: unknown policy, or ``n`` exceeds the available nodes.
    """
    if n > topo.num_nodes:
        raise ValueError(f"cannot place {n} blocks on {topo.num_nodes} nodes")
    if policy == "contiguous":
        base = (sid * _ARC_STRIDE) % topo.num_nodes
        return [(base + i) % topo.num_nodes for i in range(n)]
    if policy == "round_robin":
        return _place_round_robin(topo, sid, n)
    if policy == "spread":
        return _place_spread(topo, sid, n)
    raise ValueError(f"unknown placement policy {policy!r} "
                     f"(choose from {', '.join(POLICIES)})")


def _place_round_robin(topo: Topology, sid: int, n: int) -> list[int]:
    """One block per domain, cycling: block ``b`` -> domain
    ``(sid + b) % D`` (rotated per stripe), node rotated within the domain.
    Skips full domains so uneven domain sizes still place ``n`` distinct
    nodes."""
    d_count = topo.num_domains
    pools = [topo.nodes_in(d) for d in range(d_count)]
    used = [0] * d_count
    out: list[int] = []
    for b in range(n):
        d = (sid + b) % d_count
        for off in range(d_count):          # first domain with spare nodes
            dd = (d + off) % d_count
            if used[dd] < len(pools[dd]):
                d = dd
                break
        nodes = pools[d]
        out.append(nodes[(sid + used[d]) % len(nodes)])
        used[d] += 1
    # used[d] consecutive ring offsets per domain => distinct within the
    # domain; domains partition nodes => distinct overall.
    return out


def _place_spread(topo: Topology, sid: int, n: int) -> list[int]:
    """Copyset-style: a seeded per-stripe choice of ``spread_width`` domains
    (widened until they hold ``n`` nodes), blocks sampled without
    replacement from their pooled nodes."""
    rng = np.random.default_rng([topo.seed, sid])
    order = rng.permutation(topo.num_domains)
    pool: list[int] = []
    taken = 0
    for d in order:
        pool.extend(topo.nodes_in(int(d)))
        taken += 1
        if taken >= topo.spread_width and len(pool) >= n:
            break
    sel = rng.choice(len(pool), size=n, replace=False)
    return [pool[int(i)] for i in sel]


def placement_ok(policy: str, topo: Topology, nodes: list[int], *,
                 width: Optional[int] = None) -> bool:
    """Does a stripe's block->node list satisfy ``policy``'s invariants?

    The shared legality check behind rebuild-destination selection
    (:func:`pick_destinations`), the rebalancer's move filter
    (``repro_torch.ftx.rebalance``), and the post-repair property tests:

    * every policy: the ``n`` nodes are distinct;
    * ``"round_robin"``: no failure domain holds more than
      ``ceil(n / num_domains)`` of the stripe's blocks (the one-block-
      per-domain dispersion bound, generalized to ``n > num_domains``);
    * ``"spread"``: the stripe touches at most ``width`` distinct domains
      (the copyset width bound; defaults to the larger of
      ``topo.spread_width`` and the fewest domains whose pooled nodes can
      hold ``n`` blocks — the same widening ``_place_spread`` applies);
    * ``"contiguous"``: no constraint beyond distinctness (arcs are a
      write-time layout, not a durability invariant).
    """
    if len(set(nodes)) != len(nodes):
        return False
    if policy == "round_robin":
        per: dict[int, int] = {}
        for n in nodes:
            d = topo.domain_of(n)
            per[d] = per.get(d, 0) + 1
        return max(per.values()) <= -(-len(nodes) // topo.num_domains)
    if policy == "spread":
        if width is None:
            sizes = sorted((len(topo.nodes_in(d))
                            for d in range(topo.num_domains)), reverse=True)
            need, pooled = 0, 0
            while pooled < len(nodes) and need < len(sizes):
                pooled += sizes[need]
                need += 1
            width = max(topo.spread_width, need)
        return len({topo.domain_of(n) for n in nodes}) <= width
    return True


def pick_destinations(topo: Topology, policy: str,
                      placements: dict[int, list[int]],
                      lost, alive,
                      loads: Optional[dict[int, int]] = None
                      ) -> dict[tuple[int, int], int]:
    """Choose a surviving home for every lost block, least-loaded first.

    The rebuild-destination policy (DESIGN.md §14): instead of writing a
    rebuilt block back to its dead node's address, place it on an *alive*
    node of the least-loaded surviving failure domain — ranked so the
    placement policy's invariants are preserved, not just node
    distinctness:

    * ``"spread"`` prefers domains the stripe already occupies (by
      surviving blocks or already-chosen destinations), so the copyset
      width does not grow while any occupied domain still has capacity;
    * ``"round_robin"`` prefers the domains holding the *fewest* of the
      stripe's blocks, so the per-domain dispersion bound is maintained;
    * ``"contiguous"`` ranks purely by domain load.

    Within the chosen domain the least-loaded alive node not already used
    by the stripe wins; ties break on the lower id, so the result is
    deterministic in ``(topo, policy, placements, lost, alive, loads)``.
    Domain load is the mean resident-block count per *alive* member node.
    A block with no legal destination (every alive node already used by
    its stripe) is omitted — the caller writes it back in place.

    Args:
        topo: the fleet topology.
        policy: the store's placement policy (one of :data:`POLICIES`).
        placements: ``sid -> node_of_block`` pre-repair snapshot for every
            affected stripe.
        lost: ``(sid, block)`` pairs needing a new home.
        alive: ids of UP nodes (destination candidates).
        loads: resident-block count per node
            (``repro_torch.dist.placement.block_loads``); defaults to loads over
            ``placements`` only. Not mutated; assignment updates are
            tracked on a copy so later picks see earlier ones.

    Returns:
        ``{(sid, block): node}`` for every block that found a legal
        surviving destination.
    """
    from .placement import block_loads

    alive = set(alive)
    lost = sorted(set(lost))
    if loads is None:
        loads = block_loads(placements.values(), topo.num_nodes)
    loads = dict(loads)
    lost_by_sid: dict[int, set[int]] = {}
    for sid, b in lost:
        lost_by_sid.setdefault(sid, set()).add(b)
    members = {d: [n for n in topo.nodes_in(d) if n in alive]
               for d in range(topo.num_domains)}

    out: dict[tuple[int, int], int] = {}
    for sid, block in lost:
        nodes = placements[sid]
        # Nodes this stripe occupies: survivors of non-lost blocks plus
        # destinations already chosen for sibling lost blocks.
        used = {n for i, n in enumerate(nodes)
                if i not in lost_by_sid[sid]}
        used |= {out[(sid, b)] for b in lost_by_sid[sid]
                 if (sid, b) in out}
        occupancy: dict[int, int] = {}
        for n in used:
            d = topo.domain_of(n)
            occupancy[d] = occupancy.get(d, 0) + 1

        def usable(d: int) -> list[int]:
            return [n for n in members[d] if n not in used]

        def load_of(d: int) -> float:
            pool = members[d]
            return (sum(loads.get(n, 0) for n in pool) / len(pool)
                    if pool else float("inf"))

        cands = [d for d in range(topo.num_domains) if usable(d)]
        if not cands:
            continue                        # no legal home: stay in place
        def key(d: int) -> tuple:
            if policy == "round_robin":
                return (occupancy.get(d, 0), load_of(d), d)
            if policy == "spread":
                return (occupancy.get(d, 0) == 0, load_of(d), d)
            return (load_of(d), d)

        dom = min(cands, key=key)
        node = min(usable(dom), key=lambda n: (loads.get(n, 0), n))
        out[(sid, block)] = node
        loads[node] = loads.get(node, 0) + 1
        old = nodes[block]
        loads[old] = max(0, loads.get(old, 0) - 1)
    return out


def placement_from_topology(store, topo: Topology,
                            remote_multiplier: Optional[float] = None
                            ) -> PlacementMap:
    """The :class:`~repro_torch.dist.placement.PlacementMap` of ``store`` under
    ``topo``: node->shard from the topology's failure domains, block->node
    from the store's live stripe index.

    Args:
        store: a ``repro_torch.ftx.StripeStore`` whose ``num_nodes`` matches the
            topology.
        topo: the fleet topology (domains become gather shards).
        remote_multiplier: simulated link-time cost of a cross-domain read;
            defaults to ``store.cfg.remote_read_multiplier``.

    Returns:
        A ``PlacementMap`` resolving ``(sid, block)`` through the store —
        it tracks placement changes (e.g. spare remapping) live.
    """
    if topo.num_nodes != store.num_nodes:
        raise ValueError(f"topology has {topo.num_nodes} nodes, "
                         f"store has {store.num_nodes}")
    if remote_multiplier is None:
        remote_multiplier = getattr(store.cfg, "remote_read_multiplier", 1.0)
    return PlacementMap(
        shard_of_node=topo.shard_of_node(),
        remote_multiplier=float(remote_multiplier),
        node_of=lambda sid, b: store.stripes[sid].node_of_block[b])
