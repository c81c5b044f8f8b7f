"""Locality-aware stripe scheduling: which device shard repairs which stripe.

The placement layer (``repro_torch.dist.placement``) gave every repair read a
local/remote cost, but the stripe store still assigned a pattern group's
stripes to device shards *contiguously* — stripe ``i`` of a chunk lands on
device slice ``i * span // S`` regardless of where its surviving blocks
live, so the realized local-read fraction is whatever the default layout
happens to give. This module closes that gap: given a chunk of stripes
sharing one failure pattern, a :class:`~repro_torch.dist.placement.PlacementMap`,
and the mesh's stripe-axis span, :func:`schedule_chunk` **permutes the
chunk** so each stripe lands on the device slice whose serving host shard
owns the most of its surviving blocks.

Why a permutation is all it takes
---------------------------------

``shard_layout`` partitions an ``(S, ...)`` batch into ``span`` equal
contiguous stripe slices in *list order*: positions ``[d*S/span,
(d+1)*S/span)`` of the chunk's sid list go to device slice ``d``, which is
gathered by host shard ``reader_shard(d, span)``. Reordering the sid list
is therefore exactly an assignment of stripes to reading shards — applied
*before* ``shard_layout`` so the gather, the launch sharding, and the
window alignment all see the scheduled order. The inverse permutation on
write-back is carried by the sid list itself: every downstream consumer
(``_gather_group``, ``_finish_repair``, telemetry) indexes rows through the
same permuted list, and rebuilt row ``i`` is persisted to ``sids[i]``'s own
block paths — so outputs are bit-identical under *any* permutation (GF(2^8)
decoding is exact and stripes share no terms; only which shard reads which
bytes changes).

Two assignment modes build on that, forming a dominance chain
(``tests/test_orchestration.py`` property-tests it):

* ``"locality"`` (PR 5) — per-chunk greedy cost-model argmax: stripes claim
  their highest-affinity slice (affinity = surviving blocks the slice's
  host shard owns) best-pair-first under per-slice capacity ``S/span``; if
  the greedy total does not beat the contiguous assignment's total, the
  identity order is kept — the scheduler **never yields a lower predicted
  local-read fraction than the contiguous baseline** (property-tested in
  ``tests/test_schedule.py``).
* ``"global"`` (PR 10, the default) — an exact min-cost assignment across
  **all windows of a pattern group at once** (:func:`schedule_group`). The
  key structural fact: ``reader_shard(d, span)`` does not depend on the
  window index, so the per-window slice slots are interchangeable per slice
  index and the cross-window problem is a *transportation problem* — S
  stripes onto ``span`` columns whose aggregate capacity is the sum of the
  per-window caps. It is solved exactly by starting from the greedy
  per-window assignment (feasible by construction) and canceling
  positive-gain cycles in the column residual graph
  (:func:`optimize_assignment`) until none remain — the classic optimality
  condition for min-cost circulations, equivalent to Hungarian on the
  slot-expanded matrix but warm-started so **global >= greedy >= contiguous
  holds structurally**, not just empirically. Stripes may migrate between
  windows; per-window slice capacities are restored when the optimal
  column assignment is dealt back into windows in input order.

Degradation mirrors the gather geometry: a chunk the span does not divide
would fall back to the single-buffer gather (shard 0), so it is left in
identity order and its reads are predicted against shard 0 — predicted and
realized locality agree on every path. Such ragged chunks keep their
per-chunk schedule under ``"global"`` too (they launch degraded, so there
is no cross-window slot to trade).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from .placement import PlacementMap
from .sharding import MeshRules
from .stripes import stripe_span


@dataclasses.dataclass(frozen=True)
class ChunkSchedule:
    """One chunk's stripe -> device-slice assignment, as a permutation.

    Attributes:
        sids: the chunk's stripe ids in scheduled (launch) order — feed
            this, not the input order, to the gather/launch path.
        order: ``order[i]`` is the input-list index of the stripe now at
            position ``i`` (``sids[i] == input[order[i]]``); the identity
            tuple when scheduling found no improvement or was inapplicable.
        span: device slices the launch will spread over (1 = degraded).
        scheduled_local: predicted shard-local reads under ``sids`` order.
        contiguous_local: predicted shard-local reads under input order.
        total_reads: reads the chunk's gather will issue
            (``len(sids) * |plan reads|``); 0 when the placement cannot
            resolve block locations (no prediction possible).
    """
    sids: tuple[int, ...]
    order: tuple[int, ...]
    span: int
    scheduled_local: int
    contiguous_local: int
    total_reads: int

    @property
    def is_identity(self) -> bool:
        return all(i == o for i, o in enumerate(self.order))

    @property
    def scheduled_local_fraction(self) -> float:
        """Predicted local-read fraction in scheduled order (1.0 when no
        prediction exists — matching ``local_read_fraction``'s convention)."""
        return self.scheduled_local / self.total_reads if self.total_reads \
            else 1.0

    @property
    def contiguous_local_fraction(self) -> float:
        """Predicted local-read fraction in input (contiguous) order."""
        return self.contiguous_local / self.total_reads if self.total_reads \
            else 1.0


def chunk_affinity(sids: Sequence[int], reads: Sequence[int],
                   placement: PlacementMap, span: int) -> np.ndarray:
    """Affinity matrix ``A[i, d]``: how many of stripe ``sids[i]``'s read
    blocks live on nodes of the host shard serving device slice ``d``.

    Args:
        sids: the chunk's stripe ids.
        reads: the compiled plan's read blocks (shared by every stripe of a
            pattern group).
        placement: resolves ``(sid, block) -> node -> shard``; must have a
            ``node_of`` resolver.
        span: device slices of the launch; slice ``d`` is served by host
            shard ``placement.reader_shard(d, span)``.

    Returns:
        ``(len(sids), span)`` int array. Row sums are ``<= len(reads)``
        (equal when the placement's shards cover every read's node, which
        contiguous-domain topologies always do).
    """
    shard_of = placement.shard_of_node
    hosts = [placement.reader_shard(d, span) for d in range(span)]
    a = np.zeros((len(sids), span), dtype=np.int64)
    for i, sid in enumerate(sids):
        per_shard: dict[int, int] = {}
        for b in reads:
            s = shard_of[placement.node_of(sid, b)]
            per_shard[s] = per_shard.get(s, 0) + 1
        for d, h in enumerate(hosts):
            a[i, d] = per_shard.get(h, 0)
    return a


def _identity(sids: Sequence[int], span: int, local: int, total: int
              ) -> ChunkSchedule:
    return ChunkSchedule(sids=tuple(sids), order=tuple(range(len(sids))),
                         span=span, scheduled_local=local,
                         contiguous_local=local, total_reads=total)


def greedy_assign(a: np.ndarray, cap: int) -> list[int]:
    """PR-5 greedy argmax: assign each stripe (row of ``a``) to a device
    slice (column), best ``(stripe, slice)`` pairs first, at most ``cap``
    stripes per slice. Ties break on (stripe, slice) index for determinism.

    Returns ``assigned[i] = column of stripe i``; every stripe is placed
    (``a`` must have ``rows <= cap * columns``).
    """
    n, span = a.shape
    pairs = sorted(((int(-a[i, d]), i, d) for i in range(n)
                    for d in range(span)))
    assigned = [-1] * n
    counts = [0] * span
    placed = 0
    for neg, i, d in pairs:
        if assigned[i] >= 0 or counts[d] >= cap:
            continue
        assigned[i] = d
        counts[d] += 1
        placed += 1
        if placed == n:
            break
    return assigned


def _positive_cycle(gain: np.ndarray) -> Optional[list[int]]:
    """A simple column cycle with strictly positive total gain, or None.

    Bellman–Ford negative-cycle detection on cost ``-gain`` over the
    ``m``-node column graph: relax ``m`` rounds; a node still relaxing in
    the last round reaches a negative cycle, and walking predecessors ``m``
    steps lands on it. Entries equal to the int64 minimum mark absent edges
    (empty source columns).
    """
    m = gain.shape[0]
    absent = np.iinfo(np.int64).min
    edges = [(d, d2, -int(gain[d, d2])) for d in range(m) for d2 in range(m)
             if d != d2 and gain[d, d2] != absent]
    dist = [0] * m
    pred = [-1] * m
    last = -1
    for _ in range(m):
        last = -1
        for u, v, w in edges:
            if dist[u] + w < dist[v]:
                dist[v] = dist[u] + w
                pred[v] = u
                last = v
        if last == -1:
            return None
    for _ in range(m):                      # walk onto the cycle itself
        last = pred[last]
    cycle = [last]
    v = pred[last]
    while v != last:
        cycle.append(v)
        v = pred[v]
    cycle.reverse()                         # consecutive pairs are edges
    return cycle


def optimize_assignment(a: np.ndarray, assign: Sequence[int]) -> np.ndarray:
    """Cancel positive-gain cycles until ``assign`` is an optimal
    transportation solution for affinity ``a`` under the (equality) column
    capacities the starting assignment implies.

    Each round builds the column residual graph — edge ``d -> d2`` carries
    the best single-stripe reassignment gain ``max_{i in d} a[i, d2] -
    a[i, d]`` — and applies one positive cycle (distinct source columns, so
    the simultaneous moves keep every column's count exact). The total is a
    bounded integer that strictly increases, so termination is guaranteed;
    absence of a positive cycle is the standard optimality condition for
    min-cost circulations. The result is therefore never worse than the
    starting assignment — feed it the greedy solution and the dominance
    chain ``global >= greedy`` holds by construction.
    """
    a = np.asarray(a, dtype=np.int64)
    out = np.asarray(list(assign), dtype=np.int64)
    n, m = a.shape
    if n == 0 or m <= 1:
        return out
    absent = np.iinfo(np.int64).min
    cols = np.arange(m)
    # Strictly-improving integer objective bounded by n * max affinity.
    for _ in range(int(n) * int(max(1, a.max())) + 1):
        gain = np.full((m, m), absent, dtype=np.int64)
        arg = np.full((m, m), -1, dtype=np.int64)
        for d in range(m):
            idx = np.nonzero(out == d)[0]
            if idx.size == 0:
                continue
            diffs = a[idx] - a[idx, d][:, None]
            j = np.argmax(diffs, axis=0)
            gain[d] = diffs[j, cols]
            arg[d] = idx[j]
        cycle = _positive_cycle(gain)
        if cycle is None:
            return out
        moves = [(int(arg[d, d2]), d2)
                 for d, d2 in zip(cycle, cycle[1:] + cycle[:1])]
        if sum(int(gain[d, d2]) for d, d2
               in zip(cycle, cycle[1:] + cycle[:1])) <= 0:
            return out                      # defensive: never regress
        for i, d2 in moves:
            out[i] = d2
    return out


def schedule_chunk(sids: Sequence[int], reads: Sequence[int],
                   placement: Optional[PlacementMap],
                   mr: Optional[MeshRules],
                   mode: str = "locality") -> ChunkSchedule:
    """Schedule one launch chunk's stripes onto the mesh's device slices.

    Args:
        sids: stripe ids sharing one failure pattern (one launch chunk /
            pipeline window).
        reads: the pattern's compiled read blocks.
        placement: the active ``PlacementMap``; ``None`` (or one without a
            ``node_of`` resolver) disables prediction and scheduling.
        mr: the active ``MeshRules``; ``None`` or a trivial/indivisible
            stripe span leaves the chunk in identity order, predicted
            against gather shard 0 (the degraded single-buffer path).
        mode: ``"locality"`` runs the greedy assignment; ``"none"`` skips
            it and returns the identity order with the contiguous
            prediction (so both modes account through one code path, and
            the disabled scheduler pays only the single counting pass).

    Returns:
        A :class:`ChunkSchedule` whose ``sids`` is the order to launch and
        whose ``scheduled_local`` is the prediction *for that order* —
        **never** below ``contiguous_local``: the greedy assignment is
        kept only when it strictly beats the contiguous one, else the
        identity order (and its score) is returned.
    """
    n_stripes = len(sids)
    if placement is None or placement.node_of is None or not n_stripes \
            or not len(reads):
        return _identity(sids, 1, 0, 0)
    total = n_stripes * len(reads)
    span = stripe_span((n_stripes, max(1, len(reads)), 1), mr)
    if span <= 1 or n_stripes % span:
        # Degraded launch: plan_gather attributes every read to shard 0.
        shard_of = placement.shard_of_node
        local = sum(1 for sid in sids for b in reads
                    if shard_of[placement.node_of(sid, b)] == 0)
        return _identity(sids, 1, local, total)
    a = chunk_affinity(sids, reads, placement, span)
    cap = n_stripes // span
    contiguous = int(sum(a[i, i // cap] for i in range(n_stripes)))
    if mode == "none":
        return _identity(sids, span, contiguous, total)
    # Greedy argmax: best (stripe, slice) pairs first, per-slice capacity
    # cap. Ties break on (stripe, slice) index for determinism.
    assigned = greedy_assign(a, cap)
    buckets: list[list[int]] = [[] for _ in range(span)]
    for i in range(n_stripes):
        buckets[assigned[i]].append(i)
    greedy = int(sum(a[i, assigned[i]] for i in range(n_stripes)))
    if greedy <= contiguous:
        return _identity(sids, span, contiguous, total)
    for b in buckets:                       # stable within a slice
        b.sort()
    order = tuple(i for b in buckets for i in b)
    return ChunkSchedule(sids=tuple(sids[i] for i in order), order=order,
                         span=span, scheduled_local=greedy,
                         contiguous_local=contiguous, total_reads=total)


def schedule_group(sids: Sequence[int], reads: Sequence[int],
                   placement: Optional[PlacementMap],
                   mr: Optional[MeshRules], *, step: int,
                   mode: str = "global") -> list[ChunkSchedule]:
    """Schedule a whole pattern group's stripes across all its windows.

    Splits ``sids`` into launch chunks of ``step`` stripes (exactly as the
    synchronous repair loop and the pipeline's window builder chunk) and
    returns one :class:`ChunkSchedule` per chunk, in chunk order:

    * ``mode="none"`` / ``"locality"`` — the PR-5 behavior: each chunk is
      scheduled independently by :func:`schedule_chunk`.
    * ``mode="global"`` — one exact min-cost assignment over **every
      shardable chunk of the group at once**. Because the host shard
      serving device slice ``d`` (``placement.reader_shard(d, span)``) does
      not depend on the window index, slice-``d`` slots of different
      windows are interchangeable: the cross-window problem is a
      transportation problem onto ``span`` columns with aggregate capacity
      ``sum_w cap_w``. It is solved exactly by warm-starting from the
      greedy per-chunk assignment and canceling positive-gain column
      cycles (:func:`optimize_assignment`); the optimal column assignment
      is then dealt back into windows — column ``d``'s stripes, in input
      order, fill slice ``d`` of each window in turn — restoring every
      per-window per-slice capacity. Stripes therefore **migrate between
      windows** when that buys locality; write-back is keyed by sid, so
      the result stays bit-identical (only which shard reads which bytes
      changes).

    The dominance chain is structural: the greedy start is feasible, cycle
    canceling only ever improves it, and when the optimum does not
    strictly beat the greedy total the per-chunk greedy schedules are
    returned unchanged — so ``global >= greedy >= contiguous`` on
    predicted shard-local reads, always. Chunks the span does not divide
    (and whole groups with no usable placement/mesh) launch degraded and
    keep their per-chunk schedule under every mode.

    For windows produced by the global mode, ``ChunkSchedule.order``
    indexes into the *group's* input ``sids`` (stripes may have crossed
    windows); ``contiguous_local`` remains the original chunk's
    contiguous-order prediction, so aggregating either field over the
    returned list compares like for like.
    """
    step = max(1, int(step))
    chunks = [list(sids[lo:lo + step]) for lo in range(0, len(sids), step)]
    if mode != "global":
        return [schedule_chunk(c, reads, placement, mr, mode)
                for c in chunks]
    greedy = [schedule_chunk(c, reads, placement, mr, "locality")
              for c in chunks]
    # Pool every chunk that actually shards at the full-window span; the
    # rest (degraded tails, unpredictable placements) keep their per-chunk
    # result.
    span = stripe_span((step, max(1, len(reads)), 1), mr) if chunks else 1
    pooled = [w for w, cs in enumerate(greedy)
              if cs.span == span > 1 and cs.total_reads]
    if not pooled:
        return greedy
    base = {w: sum(len(chunks[v]) for v in pooled[:j])
            for j, w in enumerate(pooled)}
    rows: list[tuple[int, int]] = [(w, i) for w in pooled
                                   for i in range(len(chunks[w]))]
    pooled_sids = [chunks[w][i] for w, i in rows]
    a = chunk_affinity(pooled_sids, reads, placement, span)
    caps = {w: len(chunks[w]) // span for w in pooled}
    start = np.empty(len(rows), dtype=np.int64)
    for w in pooled:
        # greedy[w].order[i] = chunk-input index of the stripe launched at
        # position i; position i of a chunk belongs to slice i // cap.
        for i, oi in enumerate(greedy[w].order):
            start[base[w] + oi] = i // caps[w]
    before = int(a[np.arange(len(rows)), start].sum())
    assign = optimize_assignment(a, start)
    after = int(a[np.arange(len(rows)), assign].sum())
    if after <= before:                     # hard floor: keep greedy
        return greedy
    # Deal columns back into windows: slice d of window w takes the next
    # cap_w stripes of column d, in pooled input order (deterministic).
    queues = [np.nonzero(assign == d)[0].tolist() for d in range(span)]
    heads = [0] * span
    group_ix = {}                           # pooled row -> group input index
    pos = 0
    for w, chunk in enumerate(chunks):
        for i in range(len(chunk)):
            if w in caps:
                group_ix[(w, i)] = pos + i
        pos += len(chunk)
    out = list(greedy)
    for w in pooled:
        cap = caps[w]
        taken: list[int] = []
        for d in range(span):
            taken.extend(queues[d][heads[d]:heads[d] + cap])
            heads[d] += cap
        order = tuple(group_ix[rows[j]] for j in taken)
        sched = int(sum(a[j, int(assign[j])] for j in taken))
        out[w] = ChunkSchedule(
            sids=tuple(pooled_sids[j] for j in taken), order=order,
            span=span, scheduled_local=sched,
            contiguous_local=greedy[w].contiguous_local,
            total_reads=greedy[w].total_reads)
    return out
