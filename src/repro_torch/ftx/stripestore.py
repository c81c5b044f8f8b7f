"""Erasure-coded stripe store over virtual nodes.

Mirrors the paper's prototype (§V): a coordinator (this class) holds stripe/
block/object/node indexes; "data nodes" are directories (one per virtual
node) holding block files. Encode/decode/repair byte-crunching runs through
the port's CUDA GF(2^8) kernel; repair *planning* uses the paper's local-first
algorithms, and every operation is bandwidth-accounted (blocks and bytes
read) so the cloud experiments (Figs 6-9) can be reproduced as simulations
with a configurable link-speed model.

Also implements the paper's file-level optimization (§V-C): objects packed
into stripes with byte-offsets, degraded reads fetch only the needed byte
ranges of surviving blocks; plus straggler-hedged reads (read k+h candidate
sources, use the first k by simulated node latency).
"""
from __future__ import annotations

import dataclasses
import enum
import json
import threading
import time
from collections import OrderedDict
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch.core.codec import StripeCodec
from repro_torch.core.engine import BatchedCodecEngine
from repro_torch.core.repair import (MultiRepairPlan, multi_repair_plan,
                                     single_repair_candidates,
                                     single_repair_plan)
from repro_torch.core.schemes import make_scheme
from repro_torch.device import resolve_device
from repro_torch.dist.placement import PlacementMap, block_loads, plan_gather
from repro_torch.dist.schedule import schedule_group
from repro_torch.dist.sharding import current_rules
from repro_torch.dist.stripes import stripe_axis_span
from repro_torch.dist.topology import (POLICIES, Topology, pick_destinations,
                                       place_stripe, placement_from_topology)
from repro_torch.kernels.ops import default_backend as _default_backend
from repro_torch.kernels.ops import effective_backend as _eff
from repro_torch.serve.telemetry import LatencyRecorder

from .options import RepairOptions, ServeOptions

# Shared all-defaults ServeOptions: every read without explicit options
# resolves its knobs through this one frozen instance.
_DEFAULT_SERVE = ServeOptions()


class NodeState(enum.Enum):
    UP = "up"
    DOWN = "down"


# Cap on the gathered (S, |reads|, B) host stack per batched repair launch;
# chunking shrinks S below cfg.batch_stripes when reads x block_size is wide.
_BATCH_BYTE_BUDGET = 256 << 20


def launch_step(cfg: "StoreConfig", num_reads: int,
                window: Optional[int] = None,
                byte_budget: int = _BATCH_BYTE_BUDGET) -> int:
    """Stripes per batched launch: the requested ``window`` (default
    ``cfg.batch_stripes``) capped by ``batch_stripes`` and the gathered-
    stack byte budget. Shared by the synchronous chunk loop and the async
    pipeline so both paths always chunk identically."""
    per_stripe = num_reads * cfg.block_size
    return max(1, min(window or cfg.batch_stripes, cfg.batch_stripes,
                      byte_budget // max(1, per_stripe)))


@dataclasses.dataclass(frozen=True)
class StoreConfig:
    scheme: str = "cp-azure"
    k: int = 24
    r: int = 2
    p: int = 2
    block_size: int = 1 << 20          # bytes per block
    # Kernel backend (kernels.ops.BACKENDS; gf, crs and mxu each run their
    # own CUDA kernel on a card): REPRO_BACKEND when set, else
    # "gf" — the GF(2^8) CUDA kernel — when this machine has CUDA,
    # else "ref". The one deliberate difference from the reference, whose
    # default is "ref" everywhere: on a card the default path must run the
    # kernel, never the plain version. The factory cannot see the store's
    # ``device``, so it keys on the machine; a CPU-only host therefore gets
    # the reference's default (and the same manifest), and a "gf" store
    # the caller puts on the CPU runs the plain version and reports
    # effective_backend "ref", as the reference does off the TPU.
    backend: str = dataclasses.field(
        default_factory=lambda: _default_backend(
            "gf" if torch.cuda.is_available() else "ref"))
    bandwidth_gbps: float = 1.0        # per-link model for simulated time
    hedge: int = 0                     # extra sources for hedged reads
    seed: int = 0
    batch_stripes: int = 64            # max stripes per batched repair launch
    pipeline_window: int = 32          # stripes per async-repair window (0 = sync)
    prefetch_threads: int = 8          # reader pool width, per gather shard
    io_stall_scale: float = 0.0        # fraction of each read's *simulated*
    #                                    time actually slept (wall-clock),
    #                                    making the per-node latency model
    #                                    real for overlap experiments
    remote_read_multiplier: float = 1.0  # simulated link-time cost of a read
    #                                    whose source node lives outside the
    #                                    reading shard (PlacementMap); 1.0
    #                                    keeps the locality-blind model
    placement_policy: str = "contiguous"  # block-placement policy at stripe
    #                                    open (repro_torch.dist.topology.POLICIES):
    #                                    contiguous arcs (seed behavior),
    #                                    round_robin across domains, or
    #                                    copyset-style spread
    stripe_schedule: str = "global"    # stripe->device-shard assignment for
    #                                    sharded repair launches
    #                                    (repro_torch.dist.schedule): "global"
    #                                    solves one exact min-cost
    #                                    assignment across all windows of a
    #                                    pattern group (never worse than
    #                                    "locality"); "locality" permutes
    #                                    each chunk greedily onto the shards
    #                                    owning most of its surviving blocks
    #                                    (never predicted worse than
    #                                    contiguous); "none" keeps the
    #                                    contiguous default
    rebuild_destinations: str = "in_place"  # where repair_all persists
    #                                    rebuilt blocks: "in_place" writes
    #                                    back to the failed block's original
    #                                    node address (seed behavior);
    #                                    "topology" re-homes each rebuilt
    #                                    block on the least-loaded surviving
    #                                    domain while preserving the
    #                                    placement policy's invariants
    #                                    (repro_torch.dist.topology.
    #                                    pick_destinations)
    read_cache_blocks: int = 64        # hot-block reconstruction cache: max
    #                                    reconstructed blocks kept for the
    #                                    degraded serving path (LRU;
    #                                    0 disables caching entirely)
    coalesce_reads: bool = True        # merge concurrent degraded reads of
    #                                    one lost block into a single decode
    #                                    launch (per-block in-flight future);
    #                                    False = naive per-request decode
    #                                    (the benchmark baseline)
    read_latency_samples: int = 8192   # bounded reservoir behind the read
    #                                    path's p50/p99 latency telemetry


@dataclasses.dataclass
class Stripe:
    sid: int
    node_of_block: list[int]           # block index -> node id


@dataclasses.dataclass
class ObjectMeta:
    key: str
    size: int
    sid: int
    block: int                         # first data block index within stripe
    offset: int                        # byte offset within that block


@dataclasses.dataclass
class Telemetry:
    blocks_read: int = 0
    bytes_read: int = 0
    repairs_local: int = 0
    repairs_global: int = 0
    sim_seconds: float = 0.0
    # Wall-clock stage spans of repair work (read gather / device compute /
    # write-back). Under the pipeline these overlap, so their sum exceeding
    # the repair's wall time is the overlap being won.
    read_seconds: float = 0.0
    compute_seconds: float = 0.0
    write_seconds: float = 0.0
    # Locality accounting (PlacementMap): reads served from the reading
    # shard's own nodes vs. cross-shard fetches, and how many gather bytes
    # each shard pulled from disk during repair gathers.
    local_reads: int = 0
    remote_reads: int = 0
    gather_bytes_per_shard: dict = dataclasses.field(default_factory=dict)
    # Rebuild-destination accounting: blocks whose repair write-back landed
    # on a topology-chosen surviving node instead of the failed block's
    # original address (repro_torch.dist.topology.pick_destinations).
    blocks_relocated: int = 0
    # Degraded-read serving path (read/read_range): requests served straight
    # from live blocks vs. reconstructed inline; how many of the degraded
    # ones piggybacked on another request's in-flight decode (coalescing) or
    # on the hot-block cache; how many decode launches actually reached the
    # engine and whether their plans were local (group/cascade) or global.
    direct_reads: int = 0
    degraded_reads: int = 0
    coalesced_reads: int = 0
    serve_decode_launches: int = 0
    serve_local_decodes: int = 0
    serve_global_decodes: int = 0
    serve_replans: int = 0            # decodes re-planned after a source died
    cache_hits: int = 0
    cache_misses: int = 0
    cache_invalidations: int = 0      # entries dropped by repair/write-back
    served_bytes: int = 0             # payload bytes returned to read clients

    def copy(self) -> "Telemetry":
        snap = dataclasses.replace(self)
        snap.gather_bytes_per_shard = dict(self.gather_bytes_per_shard)
        return snap

    def reset(self) -> "Telemetry":
        snap = self.copy()
        self.blocks_read = self.bytes_read = 0
        self.repairs_local = self.repairs_global = 0
        self.sim_seconds = 0.0
        self.read_seconds = self.compute_seconds = self.write_seconds = 0.0
        self.local_reads = self.remote_reads = 0
        self.gather_bytes_per_shard = {}
        self.blocks_relocated = 0
        self.direct_reads = self.degraded_reads = self.coalesced_reads = 0
        self.serve_decode_launches = 0
        self.serve_local_decodes = self.serve_global_decodes = 0
        self.serve_replans = 0
        self.cache_hits = self.cache_misses = self.cache_invalidations = 0
        self.served_bytes = 0
        return snap


class _InflightDecode:
    """One lost block's in-flight reconstruction: the request coalescing
    unit. The first degraded reader of a (stripe, block) becomes the leader
    and decodes; every concurrent reader of the same block parks on the
    event and is served from ``result`` — N requests, one decode launch."""
    __slots__ = ("event", "result", "error", "waiters")

    def __init__(self):
        self.event = threading.Event()
        self.result: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None
        self.waiters = 0


class StripeStore:
    def __init__(self, root: str | Path, cfg: StoreConfig,
                 num_nodes: Optional[int] = None, placement=None,
                 topology=None, *, device: str | torch.device = "cuda"):
        self.cfg = cfg
        # Where encode/repair/decode launches run: the card unless the
        # caller asks for the CPU. A constructor argument, not a config
        # field, so the manifest stays the reference's byte for byte.
        self.device = resolve_device(device)
        if cfg.placement_policy not in POLICIES:
            raise ValueError(f"unknown placement_policy "
                             f"{cfg.placement_policy!r} "
                             f"(choose from {', '.join(POLICIES)})")
        if cfg.stripe_schedule not in ("none", "locality", "global"):
            raise ValueError(f"unknown stripe_schedule "
                             f"{cfg.stripe_schedule!r} "
                             f"(choose from none, locality, global)")
        if cfg.rebuild_destinations not in ("in_place", "topology"):
            raise ValueError(f"unknown rebuild_destinations "
                             f"{cfg.rebuild_destinations!r} "
                             f"(choose from in_place, topology)")
        self.scheme = make_scheme(cfg.scheme, cfg.k, cfg.r, cfg.p)
        self.codec = StripeCodec(self.scheme, backend=cfg.backend,
                                 device=self.device)
        # Batched executor sharing the codec's plan cache: fleet repair
        # issues one launch per (failure pattern, <=batch_stripes chunk).
        self.engine = BatchedCodecEngine(self.scheme, backend=cfg.backend,
                                         planner=self.codec.planner,
                                         device=self.device)
        self.root = Path(root)
        self.n = self.scheme.n
        self.num_nodes = num_nodes or self.n
        if self.num_nodes < self.n:
            raise ValueError("need at least n nodes for one stripe")
        # Fleet topology (repro_torch.dist.topology): failure domains plus the
        # block-placement policy _open() consults. The single-domain
        # default with the "contiguous" policy reproduces the seed store's
        # stride-7 arcs exactly.
        self.topology = topology if topology is not None \
            else Topology(num_nodes=self.num_nodes)
        # Whether a topology was supplied (vs the inert single-domain
        # default): decides placement derivation and manifest persistence,
        # so a reloaded store keeps placing stripes under the original
        # domains instead of silently reverting to the default.
        self._topology_explicit = topology is not None
        if self.topology.num_nodes != self.num_nodes:
            raise ValueError(f"topology has {self.topology.num_nodes} "
                             f"nodes, store has {self.num_nodes}")
        # Default PlacementMap for repairs (repro_torch.dist.placement): an
        # explicit map wins; a topology derives one (domains = gather
        # shards); None derives one per repair from the node->shard
        # default and the active mesh's stripe-axis span.
        if placement is None and topology is not None:
            placement = placement_from_topology(self, self.topology)
        self.placement = placement
        self.nodes = {i: NodeState.UP for i in range(self.num_nodes)}
        self.latency_ms = {
            i: float(l) for i, l in enumerate(
                np.random.default_rng(cfg.seed).gamma(2.0, 5.0, self.num_nodes))}
        # Pipeline prefetch threads and the write-back thread mutate
        # telemetry concurrently with the coordinator; counters stay exact
        # under this lock.
        self._tele_lock = threading.Lock()
        self.stripes: dict[int, Stripe] = {}
        self.objects: dict[str, ObjectMeta] = {}
        self.telemetry = Telemetry()
        # Degraded-read serving state (read/read_range): the per-block
        # in-flight futures behind request coalescing, the bounded LRU
        # hot-block reconstruction cache, and the latency reservoir for
        # p50/p99 read telemetry. One lock serializes cache/in-flight
        # bookkeeping; decodes themselves run outside it.
        self._serve_lock = threading.Lock()
        self._inflight: dict[tuple[int, int], _InflightDecode] = {}
        self._hot_cache: OrderedDict[tuple[int, int], np.ndarray] = \
            OrderedDict()
        self.read_latency = LatencyRecorder(cfg.read_latency_samples)
        # Diagnostic callback ``(stage, sid, block)`` with stages "plan",
        # "gather", "decode" — the serving-path analogue of pipeline_hook,
        # used by the coalescing and mid-read failure-injection tests.
        self.read_hook = None
        self._next_sid = 0
        self._open_sid: Optional[int] = None
        self._open_fill = 0
        for i in range(self.num_nodes):
            (self.root / f"node{i}").mkdir(parents=True, exist_ok=True)

    # ------------------------------------------------------------- helpers
    def _block_path(self, sid: int, block: int) -> Path:
        node = self.stripes[sid].node_of_block[block]
        return self.root / f"node{node}" / f"s{sid}_b{block}.blk"

    def _read_block(self, sid: int, block: int,
                    rng: Optional[tuple[int, int]] = None, *,
                    shard: Optional[int] = None,
                    placement=None) -> np.ndarray:
        """Read one block (or byte range), charging the simulated link model.

        ``shard``/``placement`` attribute the read to a gather shard: a read
        whose source node lives outside ``shard`` is *remote* and pays the
        placement's ``remote_multiplier`` on its link time. Reads with no
        shard (client/degraded paths) are charged as local.
        """
        node = self.stripes[sid].node_of_block[block]
        if self.nodes[node] is NodeState.DOWN:
            raise IOError(f"node {node} is down")
        data = np.fromfile(self._block_path(sid, block), dtype=np.uint8)
        lo, hi = rng if rng else (0, len(data))
        local = placement is None or placement.is_local(node, shard)
        dt = ((hi - lo) * 8 / (self.cfg.bandwidth_gbps * 1e9)
              + self.latency_ms[node] / 1e3)
        if not local:
            dt *= placement.remote_multiplier
        if self.cfg.io_stall_scale > 0.0:
            # Make the simulated link model wall-real (scaled): serial
            # readers pay it in full, the pipeline's prefetch pool overlaps
            # it with compute — exactly the effect under measurement.
            time.sleep(self.cfg.io_stall_scale * dt)
        with self._tele_lock:
            self.telemetry.blocks_read += 1
            self.telemetry.bytes_read += hi - lo
            self.telemetry.sim_seconds += dt
            if local:
                self.telemetry.local_reads += 1
            else:
                self.telemetry.remote_reads += 1
            if shard is not None:
                gbs = self.telemetry.gather_bytes_per_shard
                gbs[shard] = gbs.get(shard, 0) + (hi - lo)
        return data[lo:hi]

    def _write_block(self, sid: int, block: int, data: np.ndarray) -> None:
        path = self._block_path(sid, block)
        np.asarray(data, np.uint8).tofile(path)
        # Cache-invalidation-on-write-back: the disk copy is now the truth,
        # so a cached reconstruction of this block must never be served
        # again (it is byte-identical today, but a future overwrite path
        # must not inherit a stale entry — DESIGN.md §10).
        self._cache_invalidate(sid, block)

    # ------------------------------------------------- hot-block cache
    def _cache_invalidate(self, sid: int, block: int) -> None:
        with self._serve_lock:
            dropped = self._hot_cache.pop((sid, block), None)
        if dropped is not None:
            with self._tele_lock:
                self.telemetry.cache_invalidations += 1

    def _cache_put(self, sid: int, block: int, data: np.ndarray) -> None:
        cap = self.cfg.read_cache_blocks
        if cap <= 0:
            return
        with self._serve_lock:
            self._hot_cache[(sid, block)] = data
            self._hot_cache.move_to_end((sid, block))
            while len(self._hot_cache) > cap:
                self._hot_cache.popitem(last=False)

    def _cache_get(self, sid: int, block: int) -> Optional[np.ndarray]:
        with self._serve_lock:
            data = self._hot_cache.get((sid, block))
            if data is not None:
                self._hot_cache.move_to_end((sid, block))
        return data

    # ------------------------------------------------------------- writes
    def put(self, key: str, payload: bytes | np.ndarray) -> ObjectMeta:
        """Pack an object into the open stripe (padding + sealing as needed).

        Objects larger than one block span blocks; larger than a stripe's
        data extent span stripes (key#1, key#2 continuation objects).
        """
        payload = np.frombuffer(payload, np.uint8) if isinstance(payload, bytes) \
            else np.asarray(payload, np.uint8).reshape(-1)
        extent = self.cfg.k * self.cfg.block_size
        if self._open_sid is None:
            self._open()
        # Iterative chunking: fill the open stripe, seal, continue into fresh
        # stripes with #cont objects (get() follows the chain).
        first_meta = None
        cur_key = key
        pos = 0
        while True:
            if self._open_sid is None:
                self._open()
            room = extent - self._open_fill
            if room == 0:
                self.seal()
                continue
            take = min(room, len(payload) - pos)
            meta = self._append(cur_key, payload[pos:pos + take])
            if first_meta is None:
                first_meta = meta
            pos += take
            if pos >= len(payload):
                return first_meta
            cur_key = cur_key + "#cont"

    def _alloc_stripe(self) -> int:
        sid = self._next_sid
        self._next_sid += 1
        # Block placement is policy-driven (repro_torch.dist.topology): the
        # default "contiguous" policy is the seed behavior — a stride-7
        # rotated arc, so parities spread across nodes.
        placement = place_stripe(self.cfg.placement_policy, self.topology,
                                 sid, self.n)
        self.stripes[sid] = Stripe(sid=sid, node_of_block=placement)
        return sid

    def _open(self) -> None:
        self._open_sid = self._alloc_stripe()
        self._open_fill = 0
        self._open_buf = np.zeros(self.cfg.k * self.cfg.block_size, np.uint8)

    def _append(self, key: str, payload: np.ndarray) -> ObjectMeta:
        sid = self._open_sid
        start = self._open_fill
        self._open_buf[start:start + len(payload)] = payload
        self._open_fill = start + len(payload)
        meta = ObjectMeta(key=key, size=len(payload), sid=sid,
                          block=start // self.cfg.block_size,
                          offset=start % self.cfg.block_size)
        self.objects[key] = meta
        return meta

    def seal(self) -> None:
        """Encode the open stripe and persist all n blocks."""
        if self._open_sid is None:
            return
        sid = self._open_sid
        data = self._open_buf.reshape(self.cfg.k, self.cfg.block_size)
        stripe = self.codec.encode(data).cpu().numpy()
        for b in range(self.n):
            self._write_block(sid, b, stripe[b])
        self._open_sid = None
        self._open_fill = 0

    def stream_writer(self, key: str, total_bytes: int) -> "StripeStreamWriter":
        """Open the streaming put path: pre-allocate every stripe for a
        ``total_bytes``-sized object so fully *encoded* windows can be
        persisted — in any order, from a writer thread — while upstream
        windows are still encoding (the checkpoint pipeline's drain stage).
        ``close()`` registers exactly the object chain ``put`` + ``seal``
        would have produced (head key plus ``#cont`` continuations, one per
        stripe, zero-padded tail), so ``get``/``read_range`` serve streamed
        bytes identically to packed ones."""
        if self._open_sid is not None:
            raise RuntimeError("seal() the open stripe before stream_writer")
        return StripeStreamWriter(self, key, int(total_bytes))

    # ------------------------------------------------------------- reads
    def get(self, key: str) -> np.ndarray:
        """Read an object; degraded reads repair through the planner and,
        per §V-C, touch only the byte ranges the object needs. Follows
        #cont continuation chains iteratively (objects can span stripes)."""
        parts = []
        cur = key
        while cur in self.objects:
            meta = self.objects[cur]
            out = np.zeros(meta.size, np.uint8)
            pos = 0
            block = meta.block
            offset = meta.offset
            while pos < meta.size:
                take = min(self.cfg.block_size - offset, meta.size - pos)
                out[pos:pos + take] = self._get_range(meta.sid, block,
                                                      offset, offset + take)
                pos += take
                block += 1
                offset = 0
            parts.append(out)
            cur = cur + "#cont"
        if not parts:
            raise KeyError(key)
        return parts[0] if len(parts) == 1 else np.concatenate(parts)

    def _down_blocks(self, sid: int) -> frozenset[int]:
        st = self.stripes[sid]
        return frozenset(b for b, node in enumerate(st.node_of_block)
                         if self.nodes[node] is NodeState.DOWN)

    def _get_range(self, sid: int, block: int, lo: int, hi: int) -> np.ndarray:
        down = self._down_blocks(sid)
        if block not in down:
            return self._read_block(sid, block, (lo, hi))
        # A hot reconstruction from the serving path covers this range for
        # free (no disk reads at all beats §V-C's minimal byte ranges).
        cached = self._cache_get(sid, block)
        if cached is not None:
            with self._tele_lock:
                self.telemetry.cache_hits += 1
            return cached[lo:hi].copy()
        # degraded read: plan repair for just this block, fetch only [lo, hi)
        plan = self._pick_single_plan(sid, block, down)
        if plan is None:                      # plan sources dead -> multi plan
            mplan = multi_repair_plan(self.scheme, down)
            if not mplan.feasible:
                raise IOError(f"stripe {sid}: unrecoverable ({sorted(down)})")
            rebuilt, _ = self._execute_multi(sid, mplan, down, (lo, hi))
            return rebuilt[block]
        reads = sorted(plan.reads)
        coeffs = self.codec.reconstruction_coeffs(block, reads)
        chunks = [self._read_block(sid, b, (lo, hi)) for b in reads]
        piece = self.codec.combine(coeffs, chunks)
        return piece.cpu().numpy()

    def _pick_single_plan(self, sid: int, block: int, down: frozenset[int]):
        """Pick a single-block repair plan whose sources are all alive.

        With hedging on (straggler mitigation), all structural candidates
        compete on *simulated completion time* — the critical-path node
        latency plus the transfer — instead of block count alone; the paper's
        cascaded group gives CP-LRCs more alternatives to hedge across.
        """
        cands = [c for c in single_repair_candidates(self.scheme, block)
                 if not (c.reads & down)]
        if not cands:
            return None
        if not self.cfg.hedge:
            paper = single_repair_plan(self.scheme, block)
            if not (paper.reads & down):
                return paper
            return min(cands, key=lambda c: c.cost)
        node_of = self.stripes[sid].node_of_block

        def sim_time(c):
            lat = max(self.latency_ms[node_of[b]] for b in c.reads)
            return lat / 1e3 + c.cost * self.cfg.block_size * 8 / (
                self.cfg.bandwidth_gbps * 1e9)

        pool = sorted(cands, key=sim_time)[:1 + self.cfg.hedge]
        return pool[0]

    # ------------------------------------------------------------- serving
    def read(self, sid: int, block: int, *,
             options: Optional["ServeOptions"] = None) -> np.ndarray:
        """Serve one block of one stripe, reconstructing inline if lost.

        The degraded-read serving path (DESIGN.md §10): live blocks are
        read straight from their node; a block on a DOWN node is rebuilt
        through the planner's cheapest feasible plan (local group first,
        cascaded group as fallback, global decode last —
        ``RepairPlanner.serving_plan``) in a single
        :class:`BatchedCodecEngine` launch. Concurrent reads of one lost
        block coalesce onto a single in-flight decode
        (``cfg.coalesce_reads``), reconstructions are kept in a bounded
        hot-block LRU (``cfg.read_cache_blocks``, invalidated whenever the
        block is written back), and every request's wall latency lands in
        ``read_latency`` (p50/p99 telemetry).

        ``options`` (:class:`repro_torch.ftx.options.ServeOptions`) carries
        per-request overrides of the serving knobs — coalescing and
        hot-cache participation; ``None`` keeps the store defaults.

        Raises ``KeyError``/``IndexError`` for unknown stripes/blocks and
        ``IOError`` when the stripe's failure pattern is unrecoverable.
        """
        return self.read_range(sid, block, 0, self.cfg.block_size,
                               options=options)

    def read_range(self, sid: int, block: int, lo: int = 0,
                   hi: Optional[int] = None, *,
                   options: Optional["ServeOptions"] = None) -> np.ndarray:
        """``read`` restricted to the byte range ``[lo, hi)`` of the block.

        Live blocks read only the range from disk (the §V-C byte-range
        optimization); lost blocks are reconstructed whole — the unit of
        coalescing and caching — and sliced, so N range reads of one hot
        lost block still cost one decode launch.
        """
        t0 = time.perf_counter()
        if sid not in self.stripes:
            raise KeyError(f"unknown stripe {sid}")
        if not 0 <= block < self.n:
            raise IndexError(f"block {block} out of range for n={self.n}")
        hi = self.cfg.block_size if hi is None else hi
        if not 0 <= lo <= hi <= self.cfg.block_size:
            raise ValueError(f"bad byte range [{lo}, {hi}) for block size "
                             f"{self.cfg.block_size}")
        if block not in self._down_blocks(sid):
            try:
                data = self._read_block(sid, block, (lo, hi))
            except IOError:
                # The node died between the down-set check and the read:
                # take the degraded path with a fresh down-set.
                data = self._read_degraded(sid, block, options)[lo:hi].copy()
                self._account_read(t0, lo, hi, degraded=True)
                return data
            self._account_read(t0, lo, hi, degraded=False)
            return data
        data = self._read_degraded(sid, block, options)[lo:hi].copy()
        self._account_read(t0, lo, hi, degraded=True)
        return data

    def _account_read(self, t0: float, lo: int, hi: int, *,
                      degraded: bool) -> None:
        with self._tele_lock:
            if degraded:
                self.telemetry.degraded_reads += 1
            else:
                self.telemetry.direct_reads += 1
            self.telemetry.served_bytes += hi - lo
        self.read_latency.record(time.perf_counter() - t0, hi - lo)

    def _read_degraded(self, sid: int, block: int,
                       options: Optional["ServeOptions"] = None) -> np.ndarray:
        """Serve a lost block: cache, then coalesce, then lead a decode.

        The cache probe and the in-flight registration happen under one
        lock acquisition, so there is no window in which a block is neither
        cached nor in flight while a decode for it is running: the leader
        inserts the reconstruction into the cache *before* retiring its
        in-flight entry. ``options`` opts this one request out of
        coalescing and/or cache participation.
        """
        o = options if options is not None else _DEFAULT_SERVE
        key = (sid, block)
        coalesce = o.coalesce_for(self.cfg)
        use_cache = o.cache_for(self.cfg)
        leader = False
        entry: Optional[_InflightDecode] = None
        with self._serve_lock:
            cached = self._hot_cache.get(key) if use_cache else None
            if cached is not None:
                self._hot_cache.move_to_end(key)
            elif coalesce:
                entry = self._inflight.get(key)
                if entry is None:
                    entry = _InflightDecode()
                    self._inflight[key] = entry
                    leader = True
                else:
                    entry.waiters += 1
        if cached is not None:
            with self._tele_lock:
                self.telemetry.cache_hits += 1
            return cached
        with self._tele_lock:
            self.telemetry.cache_misses += 1
        if entry is not None and not leader:
            entry.event.wait()
            with self._tele_lock:
                self.telemetry.coalesced_reads += 1
            if entry.error is not None:
                raise entry.error
            return entry.result
        try:
            data = self._decode_block(sid, block, cache_self=use_cache)
            if leader:
                entry.result = data
            return data
        except BaseException as e:
            if leader:
                entry.error = e
            raise
        finally:
            if leader:
                # Retire the future only after the cache holds the result
                # (or the error is recorded): late readers either hit the
                # cache or start a fresh decode — never a stale future.
                with self._serve_lock:
                    self._inflight.pop(key, None)
                entry.event.set()

    def _decode_block(self, sid: int, block: int, *,
                      cache_self: bool = True) -> np.ndarray:
        """One serving-path reconstruction: plan, gather, single launch.

        A source node dying between plan selection and gather surfaces as
        an IOError on the read; the loop re-plans against the fresh
        down-set (``serve_replans`` counts these) until a feasible plan's
        sources all survive the gather, or the pattern goes unrecoverable.
        """
        attempts = 0
        while True:
            down = self._down_blocks(sid)
            if self.read_hook:
                self.read_hook("plan", sid, block)
            try:
                plan = self.engine.planner.serving_plan(block, down)
            except RuntimeError:
                raise IOError(f"stripe {sid}: block {block} unrecoverable "
                              f"({sorted(down)})") from None
            if self.read_hook:
                self.read_hook("gather", sid, block)
            try:
                stacked = np.stack(
                    [self._read_block(sid, b) for b in plan.reads])[None]
            except IOError:
                attempts += 1
                with self._tele_lock:
                    self.telemetry.serve_replans += 1
                if attempts > self.n:
                    raise
                continue
            if self.read_hook:
                self.read_hook("decode", sid, block)
            out = self.engine.execute(plan, stacked).cpu().numpy()
            meta = plan.meta
            local = (meta.all_local if isinstance(meta, MultiRepairPlan)
                     else meta is not None and meta.method != "global")
            with self._tele_lock:
                self.telemetry.serve_decode_launches += 1
                if local:
                    self.telemetry.serve_local_decodes += 1
                else:
                    self.telemetry.serve_global_decodes += 1
            # The multi-plan fallback rebuilds the stripe's whole failure
            # pattern in the same launch; cache every target so sibling
            # lost blocks serve for free.
            result = None
            for t, b in enumerate(plan.targets):
                rebuilt = out[0, t, :]
                if cache_self or b != block:
                    self._cache_put(sid, b, rebuilt)
                if b == block:
                    result = rebuilt
            assert result is not None, "plan targets must include the block"
            return result

    # ------------------------------------------------------------- repair
    def fail_node(self, node: int) -> None:
        self.nodes[node] = NodeState.DOWN

    def revive_node(self, node: int) -> None:
        self.nodes[node] = NodeState.UP

    def expand(self, topology) -> list[int]:
        """Grow the fleet to ``topology`` (same or more nodes) in place.

        The fleet-expansion half of the rebalancing story (DESIGN.md §14):
        new nodes join UP and empty, existing node ids keep their state,
        placement, and simulated latency (the latency model re-draws from
        the same seed, so the original prefix is bit-identical), and the
        new topology drives all future placement, gather sharding, and
        destination selection. Existing stripes are *not* moved: the
        rebalancer that smooths load onto the new capacity
        (``ftx/rebalance.py``) comes with a later slice.

        Returns the newly added node ids (empty when only the domain
        geometry changed).
        """
        if topology.num_nodes < self.num_nodes:
            raise ValueError(f"cannot shrink: store has {self.num_nodes} "
                             f"nodes, topology has {topology.num_nodes}")
        added = list(range(self.num_nodes, topology.num_nodes))
        self.num_nodes = topology.num_nodes
        self.topology = topology
        self._topology_explicit = True
        lat = np.random.default_rng(self.cfg.seed).gamma(
            2.0, 5.0, self.num_nodes)
        for i in added:
            self.nodes[i] = NodeState.UP
            self.latency_ms[i] = float(lat[i])
            (self.root / f"node{i}").mkdir(parents=True, exist_ok=True)
        self.placement = placement_from_topology(self, topology)
        return added

    def repair_all(self, spare_of: Optional[dict[int, int]] = None, *,
                   options: Optional["RepairOptions"] = None) -> dict:
        """Rebuild every block resident on DOWN nodes onto spares (or back in
        place) using the multi-node planner. Returns telemetry for the repair
        (the paper's repair-time experiments).

        Execution knobs arrive in one ``options``
        (:class:`repro_torch.ftx.options.RepairOptions`); the pre-PR-8 loose
        keyword spellings were removed after their one deprecation cycle.

        ``options.batched=True`` (default) groups affected stripes by failure
        pattern and repairs each group through the batched engine — one
        compiled plan and one kernel launch per ``(pattern, chunk)`` of up to
        ``cfg.batch_stripes`` stripes — instead of one solve + one launch per
        stripe. ``batched=False`` keeps the seed per-stripe loop (benchmark
        baseline). Results are bit-identical between the two paths.

        ``pipeline`` routes the batched path through the double-buffered
        async pipeline (``repro_torch.ftx.pipeline``): pattern chunks split into
        ``cfg.pipeline_window``-stripe windows (``window`` overrides) whose
        disk reads, device launches and write-backs overlap. ``None``
        defaults to pipelining whenever ``cfg.pipeline_window > 0``;
        ``False`` is the synchronous fallback. Bit-identical either way.
        ``pipeline_hook`` is a diagnostic callback ``(stage, window_index)``
        (see ``repro_torch.ftx.pipeline.PipelineHook``) used by the failure-
        injection tests.

        ``mesh_rules`` (or an ambient ``with_rules`` context) names the
        mesh the stripe axis resolves onto; this slice runs single-device
        meshes only, so every launch spans one device. Telemetry reports
        ``devices`` (widest device span seen) and ``device_launches`` (total
        per-device kernel executions across all launches).
        ``read/compute/write_seconds``
        report per-stage wall spans; ``overlap_seconds`` is the stage time
        the pipeline hid (0 on the synchronous paths).

        ``placement`` (a ``repro_torch.dist.placement.PlacementMap``; defaults to
        the store's, else one derived from the node->shard default for the
        mesh's stripe-axis span) attributes the gather: every read of the
        batched ``(S, |reads|, B)`` input is charged local or remote
        against the placement's locality cost model
        (``local_reads``/``remote_reads``/``gather_bytes_per_shard``).

        ``schedule`` (default ``cfg.stripe_schedule``) picks the stripe ->
        device-shard assignment of each batched chunk
        (``repro_torch.dist.schedule``): ``"global"`` solves one exact min-cost
        assignment across *all* windows of each pattern group (stripes may
        migrate between windows; never predicted worse than the greedy
        per-chunk result); ``"locality"`` permutes each chunk so every
        stripe lands on the device slice whose serving host shard owns the
        most of its surviving blocks (greedy cost-model argmax, kept only
        when it beats the contiguous assignment — the predicted local-read
        fraction never drops); ``"none"`` keeps the contiguous default.
        Bit-identical every way: write-back is keyed by stripe id, so a
        permutation changes which shard reads which bytes, never the
        bytes. The telemetry reports both predictions
        (``scheduled_local_read_fraction`` vs
        ``contiguous_local_read_fraction``) so the scheduler's uplift is
        observable in every repair.

        ``destinations`` (default ``cfg.rebuild_destinations``) picks
        where rebuilt blocks are persisted: ``"in_place"`` writes each
        block back to its original (failed) node address — the seed
        behavior, which leaves the rebuilt copy on a DOWN node until that
        node revives; ``"topology"`` re-homes every lost block onto the
        least-loaded *surviving* failure domain via
        ``repro_torch.dist.topology.pick_destinations``, preserving the
        placement policy's invariants (copyset width for ``spread``,
        per-domain dispersion for ``round_robin``) so follow-up repairs
        stay local. ``spare_of`` (node-level spares) takes precedence for
        blocks whose node it maps. The telemetry reports
        ``blocks_relocated`` and ``destination_copyset_fraction`` (how
        many re-homed blocks landed in a domain the stripe already
        occupied).
        """
        o = options if options is not None else RepairOptions()
        batched, mesh_rules = o.batched, o.mesh_rules
        pipeline, window = o.pipeline, o.window
        pipeline_hook, placement, schedule = (o.pipeline_hook, o.placement,
                                              o.schedule)
        destinations = o.destinations
        mr = mesh_rules if mesh_rules is not None else current_rules()
        if placement is None:
            placement = self.placement
        if placement is None:
            placement = PlacementMap.from_store(
                self, num_shards=max(1, stripe_axis_span(mr)))
        if schedule is None:
            schedule = self.cfg.stripe_schedule
        if schedule not in ("none", "locality", "global"):
            raise ValueError(f"unknown stripe schedule {schedule!r} "
                             f"(choose from none, locality, global)")
        if destinations is None:
            destinations = self.cfg.rebuild_destinations
        if destinations not in ("in_place", "topology"):
            raise ValueError(f"unknown rebuild destinations "
                             f"{destinations!r} "
                             f"(choose from in_place, topology)")
        use_pipeline = batched and (pipeline if pipeline is not None
                                    else self.cfg.pipeline_window > 0)
        before = self.telemetry.copy()
        t0 = time.perf_counter()
        affected: dict[frozenset[int], list[int]] = {}
        for sid in self.stripes:
            down = self._down_blocks(sid)
            if down:
                affected.setdefault(down, []).append(sid)
        # Topology-aware rebuild destinations: decide, up front and from the
        # pre-repair placement snapshot, a surviving home for every lost
        # block (repro_torch.dist.topology.pick_destinations). Applied at
        # write-back; deterministic in (topology, placements, alive set).
        dest_of: Optional[dict[tuple[int, int], int]] = None
        dest_copyset = dest_total = 0
        if destinations == "topology" and affected:
            alive = {n for n, s in self.nodes.items() if s is NodeState.UP}
            lost = [(sid, b) for down, g_sids in affected.items()
                    for sid in g_sids for b in down]
            placements = {sid: list(self.stripes[sid].node_of_block)
                          for _, g_sids in affected.items() for sid in g_sids}
            loads = block_loads((s.node_of_block
                                 for s in self.stripes.values()),
                                self.num_nodes)
            dest_of = pick_destinations(
                self.topology, self.cfg.placement_policy, placements,
                lost, alive, loads=loads)
            dest_total = len(dest_of)
            for (sid, b), node in dest_of.items():
                live = {self.topology.domain_of(n)
                        for i, n in enumerate(placements[sid])
                        if (sid, i) not in dest_of}
                if self.topology.domain_of(node) in live:
                    dest_copyset += 1
        launches = 0
        devices = 1
        device_launches = 0
        windows = 0
        replans = 0
        # Stripe-scheduler prediction accumulators: local reads the chosen
        # order will serve shard-locally vs. what the contiguous order
        # would have, over the same total (repro_torch.dist.schedule).
        sched_local = contig_local = sched_total = 0
        # Planning stops at the first unrecoverable pattern, but groups
        # sorted before it still repair (matching the seed's loop order):
        # a mixed-failure fleet rebuilds everything it can before raising.
        unrecoverable: Optional[IOError] = None
        work: list[tuple[list[int], frozenset[int], object]] = []
        for down, sids in sorted(affected.items(), key=lambda kv: kv[1][0]):
            if not batched:
                for sid in sids:
                    plan = multi_repair_plan(self.scheme, down)
                    if not plan.feasible:
                        raise IOError(f"stripe {sid} unrecoverable: {sorted(down)}")
                    rebuilt, _ = self._execute_multi(sid, plan, down, None)
                    self._finish_repair([sid], down, plan,
                                        {b: v[None] for b, v in rebuilt.items()},
                                        spare_of, dest_of)
                    launches += 1
                    device_launches += 1
                continue
            try:
                compiled = self.engine.planner.multi_plan(down)
            except RuntimeError:
                unrecoverable = IOError(
                    f"stripes {sids} unrecoverable: {sorted(down)}")
                break
            work.append((sids, down, compiled))
        if use_pipeline and work:
            from .pipeline import RepairPipeline

            res = RepairPipeline(
                self, spare_of=spare_of, dest_of=dest_of,
                byte_budget=_BATCH_BYTE_BUDGET,
                options=RepairOptions(
                    mesh_rules=mr, window=window,
                    pipeline_hook=pipeline_hook, placement=placement,
                    schedule=schedule),
            ).run(work)
            launches += res.launches
            devices = max(devices, res.devices)
            device_launches += res.device_launches
            windows = res.windows
            replans = res.replans
            sched_local += res.scheduled_local
            contig_local += res.contiguous_local
            sched_total += res.schedule_total
            with self._tele_lock:
                self.telemetry.read_seconds += res.read_seconds
                self.telemetry.compute_seconds += res.compute_seconds
                self.telemetry.write_seconds += res.write_seconds
        else:
            for sids, down, compiled in work:
                # Chunk by stripe count AND gathered-stack bytes, so wide
                # read sets at large block sizes stay within a bounded
                # host-memory transient. schedule_group assigns the whole
                # pattern group's stripes to windows x device slices at
                # once ("global" solves the cross-window transportation
                # problem; "locality"/"none" reduce to per-chunk).
                step = launch_step(self.cfg, len(compiled.reads), window)
                for cs in schedule_group(sids, compiled.reads, placement,
                                         mr, step=step, mode=schedule):
                    sched_local += cs.scheduled_local
                    contig_local += cs.contiguous_local
                    sched_total += cs.total_reads
                    span = self._repair_group(list(cs.sids), down,
                                              compiled, spare_of, mr,
                                              placement, dest_of)
                    launches += 1
                    devices = max(devices, span)
                    device_launches += span
        if unrecoverable is not None:
            raise unrecoverable
        t = self.telemetry.copy()
        wall = time.perf_counter() - t0
        gather_shards = {
            s: t.gather_bytes_per_shard.get(s, 0)
            - before.gather_bytes_per_shard.get(s, 0)
            for s in t.gather_bytes_per_shard}
        gather_shards = {s: v for s, v in gather_shards.items() if v}
        stage_sum = ((t.read_seconds - before.read_seconds)
                     + (t.compute_seconds - before.compute_seconds)
                     + (t.write_seconds - before.write_seconds))
        return {
            "stripes_repaired": sum(len(sids) for sids in affected.values()),
            "patterns": len(affected),
            # The formulation the repair launches actually ran (see
            # kernels.ops.effective_backend). Batched launches take the
            # engine's per-launch record; with zero launches (or the
            # per-stripe path, which never substitutes) this is the
            # configured backend's static resolution.
            "effective_backend": ((self.engine.effective_backend
                                   or _eff(self.cfg.backend, self.device))
                                  if batched else self.cfg.backend),
            "launches": launches,
            "devices": devices,
            "device_launches": device_launches,
            "batched": batched,
            "pipelined": bool(use_pipeline and work),
            "windows": windows,
            "replans": replans,
            "blocks_read": t.blocks_read - before.blocks_read,
            "bytes_read": t.bytes_read - before.bytes_read,
            "sim_seconds": t.sim_seconds - before.sim_seconds,
            "wall_seconds": wall,
            "read_seconds": t.read_seconds - before.read_seconds,
            "compute_seconds": t.compute_seconds - before.compute_seconds,
            "write_seconds": t.write_seconds - before.write_seconds,
            "overlap_seconds": max(0.0, stage_sum - wall),
            "repairs_local": t.repairs_local - before.repairs_local,
            "repairs_global": t.repairs_global - before.repairs_global,
            "local_reads": t.local_reads - before.local_reads,
            "remote_reads": t.remote_reads - before.remote_reads,
            "gather_bytes_per_shard": gather_shards,
            "schedule": schedule if batched else "none",
            "destinations": destinations,
            "blocks_relocated": t.blocks_relocated - before.blocks_relocated,
            "destination_copyset_fraction":
                dest_copyset / dest_total if dest_total else 1.0,
            "scheduled_local_reads": sched_local,
            "contiguous_local_reads": contig_local,
            "schedule_total_reads": sched_total,
            "scheduled_local_read_fraction":
                sched_local / sched_total if sched_total else 1.0,
            "contiguous_local_read_fraction":
                contig_local / sched_total if sched_total else 1.0,
        }

    def _gather_group(self, sids: list[int], reads: tuple[int, ...],
                      mesh_rules, placement):
        """Gather surviving blocks for a stripe group into one host
        ``(S, |reads|, B)`` buffer (attributed to gather shard 0; the
        per-device split is a later slice). Every read is charged
        local/remote against ``placement``.
        """
        shape = (len(sids), len(reads), self.cfg.block_size)
        _, parts = plan_gather(shape, mesh_rules, placement)
        for part in parts:
            for i, sid in enumerate(sids[part.lo:part.hi]):
                for j, b in enumerate(reads):
                    part.buf[i, j] = self._read_block(
                        sid, b, shard=part.shard, placement=placement)
        return parts[0].buf

    def _repair_group(self, sids: list[int], down: frozenset[int],
                      compiled, spare_of: Optional[dict[int, int]],
                      mesh_rules=None, placement=None,
                      dest_of: Optional[dict[tuple[int, int], int]] = None
                      ) -> int:
        """Batched repair of stripes sharing one failure pattern: gather
        the (S, |reads|, B) input on the host, move it to the card and run
        a single launch (no per-block intermediate copies). Stages run
        strictly serial here — the span accounting makes that visible next
        to the pipelined path. Returns the device span of the launch."""
        t0 = time.perf_counter()
        stacked = self._gather_group(sids, compiled.reads, mesh_rules,
                                     placement)
        t1 = time.perf_counter()
        out = self.engine.execute(compiled, stacked, mesh_rules).cpu().numpy()
        rebuilt = {b: out[:, t, :] for t, b in enumerate(compiled.targets)}
        t2 = time.perf_counter()
        self._finish_repair(sids, down, compiled.meta, rebuilt, spare_of,
                            dest_of)
        t3 = time.perf_counter()
        with self._tele_lock:
            self.telemetry.read_seconds += t1 - t0
            self.telemetry.compute_seconds += t2 - t1
            self.telemetry.write_seconds += t3 - t2
        return self.engine.last_span

    def _finish_repair(self, sids: list[int], down: frozenset[int], plan,
                       rebuilt: dict[int, np.ndarray],
                       spare_of: Optional[dict[int, int]],
                       dest_of: Optional[dict[tuple[int, int], int]] = None
                       ) -> None:
        """Account telemetry and persist rebuilt (S, B) blocks per stripe.

        ``spare_of`` (node-level spares) takes precedence over ``dest_of``
        (per-block topology destinations); blocks neither maps write back
        in place. Thread-safe against concurrent prefetch reads: the
        pipeline calls this from its writer thread while reader threads
        bump the read counters."""
        relocated = 0
        for i, sid in enumerate(sids):
            st = self.stripes[sid]
            for b, data in rebuilt.items():
                target_node = st.node_of_block[b]
                if spare_of and target_node in spare_of:
                    st.node_of_block[b] = spare_of[target_node]
                elif dest_of and (sid, b) in dest_of:
                    st.node_of_block[b] = dest_of[(sid, b)]
                    relocated += 1
                self._write_block(sid, b, data[i])
        with self._tele_lock:
            if plan.all_local:
                self.telemetry.repairs_local += len(sids)
            else:
                self.telemetry.repairs_global += len(sids)
            self.telemetry.blocks_relocated += relocated

    def _execute_multi(self, sid: int, plan, down: frozenset[int],
                       rng: Optional[tuple[int, int]]):
        avail = {b: self._read_block(sid, b, rng) for b in plan.reads}
        rebuilt, _ = self.codec.repair_multi(down, avail)
        return {b: v.cpu().numpy() for b, v in rebuilt.items()}, plan

    # ---------------------------------------------------------- persistence
    def save_manifest(self) -> None:
        manifest = {
            "cfg": dataclasses.asdict(self.cfg),
            # An explicit topology round-trips (its policies place future
            # stripes); the inert default is omitted so plain stores keep
            # the seed manifest shape and load-time placement derivation.
            "topology": dataclasses.asdict(self.topology)
            if self._topology_explicit else None,
            "stripes": {str(s.sid): s.node_of_block
                        for s in self.stripes.values()},
            "objects": {k: dataclasses.asdict(m)
                        for k, m in self.objects.items()},
        }
        (self.root / "manifest.json").write_text(json.dumps(manifest))

    @classmethod
    def load(cls, root: str | Path, *,
             device: str | torch.device = "cuda") -> "StripeStore":
        root = Path(root)
        manifest = json.loads((root / "manifest.json").read_text())
        return cls.from_manifest(root, manifest, device=device)

    @classmethod
    def from_manifest(cls, root: str | Path, manifest: dict, *,
                      device: str | torch.device = "cuda") -> "StripeStore":
        """A store over the block files under ``root`` described by a
        manifest dict (the document :meth:`save_manifest` writes)."""
        cfg = StoreConfig(**manifest["cfg"])
        topo_doc = manifest.get("topology")
        topology = Topology(**topo_doc) if topo_doc else None
        store = cls(root, cfg, num_nodes=topology.num_nodes if topology
                    else max(max(v) for v in manifest["stripes"].values()) + 1
                    if manifest["stripes"] else None,
                    topology=topology, device=device)
        for sid, placement in manifest["stripes"].items():
            store.stripes[int(sid)] = Stripe(sid=int(sid),
                                             node_of_block=list(placement))
        store._next_sid = 1 + max((int(s) for s in manifest["stripes"]), default=-1)
        for k, m in manifest["objects"].items():
            store.objects[k] = ObjectMeta(**m)
        return store


class StripeStreamWriter:
    """Streaming put path: persist pre-encoded stripes for one object.

    ``put`` buffers plaintext on the coordinator and ``seal`` encodes one
    stripe at a time; the checkpoint encode pipeline instead produces whole
    ``(S, n, B)`` *encoded* windows off the batched engine and drains them
    from a writer thread while later windows are still encoding. This
    writer pre-allocates all stripes (ids + policy-driven placement) for a
    known object size up front — cheap host bookkeeping, no buffers — then
    accepts encoded windows in any order from any thread. ``close``
    registers the exact object chain ``put`` + ``seal`` would have written
    (head key plus ``#cont`` continuations, one stripe-extent object per
    stripe, zero-padded tail), so the streamed object reads back
    byte-identically through ``get``/``read_range``.
    """

    def __init__(self, store: StripeStore, key: str, total_bytes: int):
        if total_bytes < 0:
            raise ValueError("total_bytes must be >= 0")
        if key in store.objects:
            raise ValueError(f"object {key!r} already exists")
        self.store = store
        self.key = key
        self.total_bytes = total_bytes
        extent = store.cfg.k * store.cfg.block_size
        # A zero-byte object still occupies one (all-zeros) stripe, same as
        # put() opening a stripe for it.
        self.num_stripes = max(1, -(-total_bytes // extent))
        self.sids = [store._alloc_stripe() for _ in range(self.num_stripes)]
        self._written: set[int] = set()
        self._lock = threading.Lock()
        self._closed = False

    def write_window(self, first: int, encoded: np.ndarray) -> None:
        """Persist ``encoded`` — shape ``(S, n, block_size)``, already
        through the codec — as stream stripes ``first .. first+S-1``.
        Thread-safe; windows may land in any order."""
        enc = np.asarray(encoded, np.uint8)
        n, B = self.store.n, self.store.cfg.block_size
        if enc.ndim != 3 or enc.shape[1:] != (n, B):
            raise ValueError(f"window shape {enc.shape} != (S, {n}, {B})")
        if first < 0 or first + enc.shape[0] > self.num_stripes:
            raise ValueError(f"window [{first}, {first + enc.shape[0]}) "
                             f"outside {self.num_stripes}-stripe stream")
        for i in range(enc.shape[0]):
            sid = self.sids[first + i]
            for b in range(n):
                self.store._write_block(sid, b, enc[i, b])
        with self._lock:
            if self._closed:
                raise RuntimeError("stream writer already closed")
            self._written.update(range(first, first + enc.shape[0]))

    def close(self) -> None:
        """Register the object chain. Every stripe must have been written —
        a partial stream must ``abort()`` instead."""
        with self._lock:
            if self._closed:
                return
            missing = self.num_stripes - len(self._written)
            if missing:
                raise RuntimeError(f"cannot close stream: {missing} of "
                                   f"{self.num_stripes} stripes unwritten")
            self._closed = True
        extent = self.store.cfg.k * self.store.cfg.block_size
        remaining = self.total_bytes
        cur = self.key
        for sid in self.sids:
            take = min(extent, remaining)
            self.store.objects[cur] = ObjectMeta(key=cur, size=take, sid=sid,
                                                 block=0, offset=0)
            remaining -= take
            cur = cur + "#cont"

    def abort(self) -> None:
        """Drop the allocated stripes (and any block files already written)
        so a failed encode leaves no phantom stripes behind."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        for sid in self.sids:
            st = self.store.stripes.pop(sid, None)
            if st is None:
                continue
            for b, node in enumerate(st.node_of_block):
                path = self.store.root / f"node{node}" / f"s{sid}_b{b}.blk"
                path.unlink(missing_ok=True)
