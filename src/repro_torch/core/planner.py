"""Repair planner: compiled, cached GF plans for the batched codec engine.

The GF solves behind every codec operation — reconstruction coefficients,
multi-node cascades, full decode — are pure functions of ``(scheme,
failure-pattern, policy)``; nothing about the payload bytes enters them.
The seed codec recomputed them on every call (one Gaussian elimination per
repaired block per stripe), which is pure waste once a fleet repairs
thousands of stripes sharing a handful of failure patterns.

``RepairPlanner`` computes each plan once and LRU-caches it as a
:class:`CompiledPlan`: a dense ``(targets, reads)`` coefficient matrix ready
to feed the (batched) GF matmul kernels, plus the structural plan metadata.
Multi-node cascades are *flattened* at compile time — since every repaired
block is ultimately a linear combination of the surviving read set, the whole
cascade collapses into one coefficient matrix and therefore one kernel
launch, instead of one launch per repaired block (DESIGN.md §4).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from collections import OrderedDict
from typing import Optional, Sequence

import numpy as np

from .gf import gf_solve_any, matrix_to_bitmatrix
from .repair import (MultiRepairPlan, RepairPlan, multi_repair_plan,
                     single_repair_candidates, single_repair_plan)
from .schemes import LRCScheme

# Serving-path preference order over single-block repair methods: the
# paper's degraded-read argument is local group first (g reads), the
# cascaded group only when the local group is insufficient, and the k-read
# global decode strictly last. "recompute" (a parity from its own group's
# items) is a local-group operation too.
_SERVE_METHOD_RANK = {"group": 0, "recompute": 0, "cascade": 1, "global": 2}

# Bit-matrix expansion accounting. The GF(2) expansion of a plan's byte
# coefficient matrix (DESIGN.md §11) is cached on the CompiledPlan itself,
# so it is computed at most once per plan — i.e. once per failure-pattern
# chunk, amortized over every stripe batch that reuses the plan. The
# counter makes that amortization observable: tests and the benchmark
# regression gate assert expansions == distinct plans, not launches.
_BIT_LOCK = threading.Lock()
_BIT_EXPANSIONS = 0


def bitmatrix_expansions() -> int:
    """Process-wide count of byte->bit coefficient-matrix expansions."""
    with _BIT_LOCK:
        return _BIT_EXPANSIONS


@dataclasses.dataclass(frozen=True)
class CompiledPlan:
    """A fully-solved codec operation: ``out = coeffs @ stack(reads)``.

    ``coeffs[i]`` rebuilds block ``targets[i]`` from the blocks listed in
    ``reads`` (column order). ``meta`` carries the structural plan the
    coefficients were derived from (None for encode/decode plans).
    """
    op: str                              # "encode" | "single" | "multi" | "decode"
    targets: tuple[int, ...]
    reads: tuple[int, ...]
    coeffs: np.ndarray                   # (len(targets), len(reads)) uint8
    meta: RepairPlan | MultiRepairPlan | None = None
    # Lazily-cached GF(2) expansion of ``coeffs`` for the bit-plane backends
    # (crs/mxu). Excluded from init/repr/compare: it is derived state, and
    # ``dataclasses.replace`` (used when re-attaching meta) resets it to
    # None, which only costs one re-expansion on the replaced plan.
    _bit_coeffs: Optional[np.ndarray] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)

    @property
    def cost(self) -> int:
        return len(self.reads)

    def bit_coeffs(self) -> np.ndarray:
        """The packed ``(8*targets, 8*reads)`` GF(2) expansion of ``coeffs``.

        Computed on first use and cached on the plan (plans are LRU-cached
        by the planner, so a whole pattern chunk — every batch launch that
        reuses this plan — pays for exactly one expansion; see
        :func:`bitmatrix_expansions`). Thread-safe: concurrent first calls
        may race to build, but publication through ``object.__setattr__``
        is atomic and the expansion is deterministic, so every caller sees
        the same matrix and the counter counts at most one expansion per
        plan under the lock.
        """
        cached = self._bit_coeffs
        if cached is not None:
            return cached
        global _BIT_EXPANSIONS
        with _BIT_LOCK:
            cached = self._bit_coeffs
            if cached is not None:
                return cached
            bm = matrix_to_bitmatrix(self.coeffs)
            bm.setflags(write=False)
            object.__setattr__(self, "_bit_coeffs", bm)
            _BIT_EXPANSIONS += 1
            return bm


@dataclasses.dataclass
class PlanCacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0

    @property
    def lookups(self) -> int:
        return self.hits + self.misses

    def snapshot(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions}


class RepairPlanner:
    """Per-scheme plan compiler with an LRU cache and hit/miss telemetry.

    Thread-safe: stripe stores may plan from concurrent repair workers. The
    cache key never includes payload data, so a planner can be shared by any
    number of codecs/engines over the same scheme.
    """

    def __init__(self, scheme: LRCScheme, maxsize: int = 512):
        self.scheme = scheme
        self.maxsize = maxsize
        self.stats = PlanCacheStats()
        self._cache: OrderedDict[tuple, CompiledPlan] = OrderedDict()
        self._lock = threading.Lock()

    # ----------------------------------------------------------- cache core
    def _get(self, key: tuple, build, compiling=None) -> CompiledPlan:
        """The cached plan of ``key``, built on a miss; ``compiling`` (a
        zero-argument callable giving a context manager) wraps the build."""
        with self._lock:
            plan = self._cache.get(key)
            if plan is not None:
                self.stats.hits += 1
                self._cache.move_to_end(key)
                return plan
            self.stats.misses += 1
        # Solve outside the lock; duplicate work is harmless.
        with compiling() if compiling else contextlib.nullcontext():
            plan = build()
        with self._lock:
            self._cache[key] = plan
            self._cache.move_to_end(key)
            if len(self._cache) > self.maxsize:
                self._cache.popitem(last=False)
                self.stats.evictions += 1
        return plan

    def cache_clear(self) -> None:
        with self._lock:
            self._cache.clear()
            self.stats = PlanCacheStats()

    def __len__(self) -> int:
        return len(self._cache)

    # ------------------------------------------------------------ raw solves
    def coeffs_for(self, target: int, reads: Sequence[int]
                   ) -> Optional[np.ndarray]:
        """Cached reconstruction coefficients: gen[reads].T @ x = gen[target]."""
        reads = tuple(reads)
        key = ("coeffs", target, reads)
        try:
            return self._get(
                key, lambda: self._solve_many("single", (target,), reads)
            ).coeffs[0]
        except _Unsolvable:
            return None

    def _solve_many(self, op: str, targets: Sequence[int],
                    reads: Sequence[int], meta=None) -> CompiledPlan:
        gen = self.scheme.gen
        reads = tuple(reads)
        a = gen[list(reads)].T.astype(np.uint8)
        rows = []
        for t in targets:
            x = gf_solve_any(a, gen[t])
            if x is None:
                raise _Unsolvable(t, reads)
            rows.append(x)
        return CompiledPlan(op, tuple(targets), reads,
                            np.stack(rows, axis=0).astype(np.uint8), meta)

    # -------------------------------------------------------- compiled plans
    def encode_plan(self) -> CompiledPlan:
        """Parity rows over the data blocks (the generator's parity slice)."""
        s = self.scheme
        return self._get(("encode",), lambda: CompiledPlan(
            "encode", tuple(range(s.k, s.n)), tuple(range(s.k)),
            s.parity_matrix().astype(np.uint8)))

    def single_plan(self, failed: int, policy: str = "paper") -> CompiledPlan:
        """Compiled single-block repair (the paper's typed repair rule)."""
        def build() -> CompiledPlan:
            plan = single_repair_plan(self.scheme, failed, policy)
            reads = tuple(sorted(plan.reads))
            try:
                return dataclasses.replace(
                    self._solve_many("single", (failed,), reads), meta=plan)
            except _Unsolvable:
                raise RuntimeError(
                    f"inconsistent repair plan for block {failed}") from None
        return self._get(("single", failed, policy), build)

    def multi_plan(self, failed, *, compiling=None) -> CompiledPlan:
        """Compiled multi-node repair, cascade flattened to one matrix.

        Every block the structural planner repairs — including cascade steps
        that nominally read earlier repairs — is a linear combination of the
        plan's surviving read set, so the whole schedule compiles to a single
        ``(|failed|, |reads|)`` matrix and executes as one kernel launch.
        ``compiling``, a zero-argument callable that gives a context
        manager, wraps the compile when the plan is not cached (a caller's
        span; ``StripeStore.repair_all`` times and counts its misses so).
        """
        failed = frozenset(failed)
        def build() -> CompiledPlan:
            plan = multi_repair_plan(self.scheme, failed)
            if not plan.feasible:
                raise RuntimeError(f"pattern {sorted(failed)} is not decodable")
            targets = tuple(b for b, _ in plan.steps)
            reads = tuple(sorted(plan.reads))
            try:
                return self._solve_many("multi", targets, reads, meta=plan)
            except _Unsolvable as e:
                raise RuntimeError(
                    f"cannot reconstruct block {e.target} from {sorted(reads)}"
                ) from None
        return self._get(("multi", failed), build, compiling)

    def serving_plan(self, block: int, down) -> CompiledPlan:
        """Cheapest feasible plan to serve one lost block under a down-set.

        The degraded-read planner: among the structural single-block repair
        candidates whose sources are all alive, pick the local-group option
        first, the cascaded-group option next, a global recompute last
        (``_SERVE_METHOD_RANK``), cheapest within each tier. When no
        single-block candidate survives the down-set, fall back to the
        flattened multi-node plan for the whole pattern — its targets
        include ``block`` (and every other lost block, which serving caches
        for free). Cached under ``("serve", block, down)`` so a fleet of
        concurrent readers of one hot lost block compiles the GF solve
        exactly once.

        Raises ``RuntimeError`` when the pattern is not decodable.
        """
        down = frozenset(down)
        if block not in down:
            raise ValueError(f"block {block} is not in the down-set "
                             f"{sorted(down)}")

        def build() -> CompiledPlan:
            cands = [c for c in single_repair_candidates(self.scheme, block)
                     if not (c.reads & down)]
            for cand in sorted(cands, key=lambda c: (
                    _SERVE_METHOD_RANK[c.method], c.cost)):
                reads = tuple(sorted(cand.reads))
                try:
                    return dataclasses.replace(
                        self._solve_many("single", (block,), reads),
                        meta=cand)
                except _Unsolvable:
                    continue
            # No single-block candidate survives this down-set: the whole
            # pattern decodes (or fails) through the multi-node plan, which
            # has its own cache entry — the serve key just aliases it.
            return self.multi_plan(down)

        return self._get(("serve", block, down), build)

    def decode_plan(self, available) -> CompiledPlan:
        """Compiled full decode: the k data blocks from any rank-k read set."""
        ids = tuple(sorted(available))
        def build() -> CompiledPlan:
            try:
                return self._solve_many("decode", tuple(range(self.scheme.k)), ids)
            except _Unsolvable:
                raise RuntimeError(
                    "available blocks do not span the data") from None
        return self._get(("decode", ids), build)


class _Unsolvable(Exception):
    def __init__(self, target: int, reads: tuple[int, ...]):
        super().__init__(f"block {target} not in span of {reads}")
        self.target = target
        self.reads = reads
