"""Background rebalancer: windowed block migration after fleet changes.

Repair restores *durability*; it does not restore *balance*. After a
failure-domain loss, ``pick_destinations`` (repro_torch.dist.topology) piles the
rebuilt blocks onto the least-loaded survivors — correct, but the survivors
now carry more than their share, and after a fleet *expansion* the new
nodes carry nothing at all. This module closes the loop:

* :func:`plan_moves` computes a deterministic list of single-block
  :class:`Move`\\ s that smooths the resident-block load across UP nodes —
  greedy max-to-min transfers, each filtered through
  :func:`~repro_torch.dist.topology.placement_ok` so a move never violates the
  placement policy's durability invariants (copyset width for ``spread``,
  per-domain dispersion for ``round_robin``).
* :class:`Rebalancer` executes the plan through the same double-buffer
  loop the repair and checkpoint pipelines use
  (:func:`~repro_torch.ftx.pipeline.run_double_buffered`): window *i+1*'s source
  blocks prefetch on a reader pool while window *i* commits on the writer
  thread — migration is pure data movement, so the "compute" stage is
  empty and the overlap is read-vs-write.

A move commits atomically from the store's point of view: the block's
bytes land at the destination path, the stripe's ``node_of_block`` entry
flips, and only then is the source replica unlinked — a crash between
write and unlink leaves a harmless orphan file, never a missing block.
"""
from __future__ import annotations

import dataclasses
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Optional

import numpy as np

from repro_torch.dist.placement import block_loads
from repro_torch.dist.topology import placement_ok

from .pipeline import PipelineHook, run_double_buffered


@dataclasses.dataclass(frozen=True)
class Move:
    """One planned migration: stripe ``sid``'s ``block`` from node ``src``
    to node ``dst``."""
    sid: int
    block: int
    src: int
    dst: int


@dataclasses.dataclass
class RebalanceReport:
    """What a rebalance pass planned, moved, and won."""
    planned: int = 0                   # moves the planner emitted
    moved: int = 0                     # moves actually committed
    windows: int = 0
    bytes_moved: int = 0
    imbalance_before: int = 0          # max - min resident blocks (UP nodes)
    imbalance_after: int = 0
    read_seconds: float = 0.0
    write_seconds: float = 0.0
    wall_seconds: float = 0.0

    @property
    def overlap_seconds(self) -> float:
        """Stage time the double buffer hid (0 for a serial pass)."""
        return max(0.0, self.read_seconds + self.write_seconds
                   - self.wall_seconds)


def _imbalance(loads: dict[int, int], alive) -> int:
    vals = [loads.get(n, 0) for n in alive]
    return (max(vals) - min(vals)) if vals else 0


def _no_worse(policy: str, topo, trial: list[int],
              current: list[int]) -> bool:
    """Move legality: the trial placement satisfies the policy invariant,
    or is at least no worse than the current one.

    After a saturated-copyset relocation a stripe can already exceed the
    policy's width/dispersion bound; rejecting every move would then
    freeze exactly the stripes most in need of rebalancing. Distinctness
    is always mandatory; beyond it a move may keep the violation level,
    never raise it."""
    if placement_ok(policy, topo, trial):
        return True
    if len(set(trial)) != len(trial):
        return False
    if policy == "spread":
        def width(nodes):
            return len({topo.domain_of(n) for n in nodes})
        return width(trial) <= width(current)
    if policy == "round_robin":
        def worst(nodes):
            per: dict[int, int] = {}
            for n in nodes:
                d = topo.domain_of(n)
                per[d] = per.get(d, 0) + 1
            return max(per.values())
        return worst(trial) <= worst(current)
    return False


def plan_moves(store, *, max_moves: Optional[int] = None) -> list[Move]:
    """Plan load-smoothing single-block moves for ``store``.

    Greedy max-to-min: repeatedly take the most-loaded UP node and move one
    of its blocks to the least-loaded UP node that (a) holds no block of
    the same stripe and (b) keeps :func:`placement_ok` true for the
    stripe's policy — so rebalancing never widens a ``spread`` copyset
    beyond the policy bound and never breaks ``round_robin`` dispersion.
    Stops when the UP-node spread is <= 1 block (perfectly smooth up to
    integrality) or no legal move reduces it.

    Blocks still resident on DOWN nodes are treated as *must-move*
    (drained first): after an in-place repair of a permanently lost node
    they are unreadable addresses, and draining them is exactly the
    "migrate stripes after domain loss" case.

    Deterministic in the store's stripe index and node states: candidate
    blocks scan in ``(sid, block)`` order, destinations break ties on the
    lower node id.

    Args:
        store: a ``StripeStore``; the plan reads its live placement only.
        max_moves: optional cap on the plan length.

    Returns:
        Moves in commit order. Later moves assume earlier ones applied
        (the planner tracks loads on a scratch copy).
    """
    alive = sorted(n for n, s in store.nodes.items() if s.name == "UP")
    if not alive:
        return []
    topo = store.topology
    policy = store.cfg.placement_policy
    # Scratch placement the plan mutates; skips the open (unsealed) stripe
    # whose blocks have no disk replicas yet.
    placed = {sid: list(st.node_of_block)
              for sid, st in store.stripes.items()
              if sid != store._open_sid}
    loads = block_loads(placed.values(), store.num_nodes)
    blocks_of: dict[int, list[tuple[int, int]]] = {n: [] for n in loads}
    for sid in sorted(placed):
        for b, n in enumerate(placed[sid]):
            blocks_of[n].append((sid, b))
    alive_set = set(alive)

    # Each (sid, block) moves at most once per plan: a re-move would let a
    # later window's prefetch race the earlier window's source unlink.
    moved_keys: set[tuple[int, int]] = set()

    def try_move(src: int) -> Optional[Move]:
        """Cheapest legal move off ``src``, or None."""
        dsts = sorted((n for n in alive if n != src),
                      key=lambda n: (loads.get(n, 0), n))
        for sid, b in blocks_of[src]:
            if (sid, b) in moved_keys:
                continue
            nodes = placed[sid]
            for dst in dsts:
                if loads.get(dst, 0) >= loads.get(src, 0) - 1 \
                        and src in alive_set:
                    break                  # no dst strictly smooths an UP src
                if dst in nodes:
                    continue
                trial = list(nodes)
                trial[b] = dst
                if _no_worse(policy, topo, trial, nodes):
                    return Move(sid=sid, block=b, src=src, dst=dst)
        return None

    out: list[Move] = []

    def commit(m: Move) -> None:
        placed[m.sid][m.block] = m.dst
        blocks_of[m.src].remove((m.sid, m.block))
        blocks_of[m.dst].append((m.sid, m.block))
        loads[m.src] = loads.get(m.src, 0) - 1
        loads[m.dst] = loads.get(m.dst, 0) + 1
        moved_keys.add((m.sid, m.block))
        out.append(m)

    # Phase 1 — drain DOWN nodes that still hold block addresses.
    for src in sorted(n for n in blocks_of
                      if n not in alive_set and blocks_of[n]):
        while blocks_of[src]:
            if max_moves is not None and len(out) >= max_moves:
                return out
            m = try_move(src)
            if m is None:
                break                      # stripe has no legal live home
            commit(m)

    # Phase 2 — smooth the UP-node spread toward <= 1. Donors are scanned
    # in descending load order: the max-loaded node may have no legal move
    # (every candidate violates the policy invariant) while a lighter one
    # still does, so one stuck donor must not end the pass.
    while max_moves is None or len(out) < max_moves:
        if _imbalance(loads, alive) <= 1:
            break
        floor = min(loads.get(n, 0) for n in alive)
        m = None
        for src in sorted(alive, key=lambda n: (-loads.get(n, 0), n)):
            if loads.get(src, 0) - floor <= 1:
                break                      # remaining donors are smooth
            m = try_move(src)
            if m is not None:
                break
        if m is None:
            break                          # no legal smoothing move left
        commit(m)
    return out


class Rebalancer:
    """Executes a move plan through the shared double-buffer loop.

    One instance serves one :meth:`run` call. Windows are fixed-size
    slices of the plan (``window`` moves each, default the store's
    ``pipeline_window`` or ``batch_stripes``); window *i+1*'s source
    blocks prefetch on the reader pool while window *i*'s writes drain on
    the writer thread — the same three-windows-in-flight steady state as
    :class:`~repro_torch.ftx.pipeline.RepairPipeline`, with an empty compute
    stage.

    ``hook(stage, window_index)`` fires at ``"prefetch"`` (reads
    submitted) and ``"commit"`` (window committed), mirroring the repair
    pipeline's hook vocabulary for failure-injection tests.
    """

    def __init__(self, store, *, window: Optional[int] = None,
                 hook: Optional[PipelineHook] = None, readers: int = 4,
                 pipelined: bool = True):
        self.store = store
        cfg = store.cfg
        self.window = int(window or cfg.pipeline_window or cfg.batch_stripes)
        self.hook = hook or (lambda stage, index: None)
        self.readers = max(1, int(readers))
        self.pipelined = pipelined

    # ------------------------------------------------------------- stages
    def _prefetch(self, pool: ThreadPoolExecutor,
                  win: list[Move]) -> list[Future]:
        # Reads go through the serving path: a live source is a direct
        # disk read, a source on a DOWN node (the phase-1 drain case) is
        # rebuilt through the degraded-read decode — moving a block never
        # trusts a dead node's address.
        return [pool.submit(self.store.read, m.sid, m.block)
                for m in win]

    def _commit(self, win: list[Move], blocks: list[np.ndarray],
                rep: RebalanceReport) -> None:
        t0 = time.perf_counter()
        st = self.store
        for m, data in zip(win, blocks):
            stripe = st.stripes[m.sid]
            if stripe.node_of_block[m.block] != m.src:
                continue                   # placement changed under us: skip
            old_path = st._block_path(m.sid, m.block)
            stripe.node_of_block[m.block] = m.dst
            st._write_block(m.sid, m.block, data)
            old_path.unlink(missing_ok=True)
            rep.moved += 1
            rep.bytes_moved += int(data.size)
        rep.write_seconds += time.perf_counter() - t0

    # ---------------------------------------------------------------- run
    def run(self, moves: Optional[list[Move]] = None, *,
            max_moves: Optional[int] = None) -> RebalanceReport:
        """Plan (unless ``moves`` is given) and execute a rebalance pass.

        Returns a :class:`RebalanceReport`; the store's placement and the
        on-disk replicas reflect every committed move on return, and
        ``save_manifest`` persists the new placement like any other.
        """
        st = self.store
        alive = [n for n, s in st.nodes.items() if s.name == "UP"]
        before = block_loads(
            (s.node_of_block for sid, s in st.stripes.items()
             if sid != st._open_sid), st.num_nodes)
        if moves is None:
            moves = plan_moves(st, max_moves=max_moves)
        rep = RebalanceReport(planned=len(moves),
                              imbalance_before=_imbalance(before, alive))
        windows = [(i, moves[lo:lo + self.window]) for i, lo in
                   enumerate(range(0, len(moves), self.window))]
        rep.windows = len(windows)
        t_run = time.perf_counter()
        if windows:
            with ThreadPoolExecutor(self.readers,
                                    thread_name_prefix="rebal-read") as pool, \
                    ThreadPoolExecutor(1, thread_name_prefix="rebal-write") \
                    as writer:

                def produce(win):
                    idx, chunk = win
                    t0 = time.perf_counter()
                    futs = self._prefetch(pool, chunk)
                    self.hook("prefetch", idx)
                    return (futs, t0)

                def consume(win, token):
                    idx, chunk = win
                    futs, t0 = token
                    blocks = [f.result() for f in futs]
                    rep.read_seconds += time.perf_counter() - t0

                    def drain():
                        self._commit(chunk, blocks, rep)
                        self.hook("commit", idx)
                    return drain

                if self.pipelined:
                    run_double_buffered(windows, produce=produce,
                                        consume=consume, writer=writer)
                else:
                    for win in windows:
                        drain = consume(win, produce(win))
                        drain()
        rep.wall_seconds = time.perf_counter() - t_run
        after = block_loads(
            (s.node_of_block for sid, s in st.stripes.items()
             if sid != st._open_sid), st.num_nodes)
        rep.imbalance_after = _imbalance(after, alive)
        return rep


def rebalance(store, *, window: Optional[int] = None,
              max_moves: Optional[int] = None,
              hook: Optional[PipelineHook] = None,
              pipelined: bool = True) -> RebalanceReport:
    """One-call rebalance pass: plan + windowed execution."""
    return Rebalancer(store, window=window, hook=hook,
                      pipelined=pipelined).run(max_moves=max_moves)
