"""Double-buffered async repair pipeline (DESIGN.md §7).

The batched engine made repair compute-efficient — one compiled plan and one
kernel launch per failure-pattern chunk — but ``StripeStore.repair_all``
remained *serial*: gather every surviving block for a chunk on the host,
then launch, then write back, leaving the device idle during I/O and the
disks idle during compute. The paper's repair wins are bandwidth-bound
(§VI; XORing Elephants makes the same point for HDFS), so the read path is
the wall-clock floor and the compute should hide behind it.

This module overlaps the three stages with a classic double buffer over
*stripe windows*:

* each failure-pattern group is split into windows of
  ``StoreConfig.pipeline_window`` stripes (capped by ``batch_stripes`` and
  the gathered-stack byte budget, and rounded to the mesh's stripe-axis
  device span so sharded launches keep their full parallelism);
* window *i+1*'s surviving blocks prefetch through a
  ``prefetch_threads``-wide reader pool into one host buffer. Every read
  still goes through ``StripeStore._read_block`` — node liveness and the
  simulated per-node latency/bandwidth model apply unchanged, with the
  ``PlacementMap`` charging cross-shard reads at the configured remote
  multiplier — while window *i* moves to the card and runs through
  ``BatchedCodecEngine.execute`` (per-shard pools and buffers for a
  multi-device mesh are a later slice);
* write-back of window *i*'s rebuilt blocks happens on a dedicated writer
  thread, overlapped with the launch of window *i+1*.

Window creation runs the locality-aware stripe scheduler
(``repro_torch.dist.schedule``, ``schedule="locality"``): each window's sid list
is permuted so every stripe lands on the device slice whose serving host
shard owns the most of its surviving blocks — the per-shard reader pools
then fetch mostly shard-local blocks with no further changes, since the
pools follow the window's sid order by construction. Bit-identical (write-
back is keyed by sid) and never predicted worse than the contiguous order.

Failure injection mid-pipeline is first-class: a node that dies between
prefetch and launch surfaces as ``IOError`` on the affected read futures,
and the window *re-plans* — fresh ``_down_blocks`` per stripe, fresh
compiled plans for the (now larger) patterns — until it drains or the
pattern is genuinely unrecoverable. Results are bit-identical to the
synchronous path by construction: GF(2^8) decoding is exact, so windowing,
thread scheduling and re-planning change wall-clock only, never bytes.

:class:`EncodePipeline` runs the same double buffer in reverse for the
streaming put path (erasure-coded checkpoints): a packer thread slices
window *i+1*'s ``(S, k, B)`` plaintext off a frozen host snapshot, window
*i* goes to the card for one ``BatchedCodecEngine.encode`` launch and
comes back in one copy, and the writer thread drains window *i-1*'s
encoded stripes through ``StripeStreamWriter.write_window``.

Every stage records wall spans; :class:`PipelineResult` aggregates them so
overlap is *observable*: ``read+compute+write > wall`` is the pipeline
working, and ``overlap_seconds`` quantifies it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor, wait
from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.dist.placement import plan_gather
from repro_torch.dist.schedule import schedule_group
from repro_torch.dist.stripes import align_stripe_window, stripe_axis_span

# A hook receives (stage, window_index) at: "prefetch" (reads submitted),
# "launch" (about to execute), "writeback" (write submitted), "replan"
# (window re-planning after mid-pipeline failures). Tests use it to inject
# node failures at precise pipeline points.
PipelineHook = Callable[[str, int], None]


def run_double_buffered(windows: Sequence, *, produce, consume,
                        writer: ThreadPoolExecutor) -> None:
    """The double-buffer loop shared by every windowed pipeline.

    Repair runs it forward (read → decode → write-back) and checkpoint
    encode runs it "in reverse" (pack → encode → persist); the loop itself
    is direction-agnostic:

    * ``produce(win)`` submits asynchronous production of ``win``'s input
      (reader-pool prefetch, host packing, ...) and returns a token;
    * ``consume(win, token)`` waits the token out, runs the window's
      device work, and returns either ``None`` (the window was handled
      entirely inline — e.g. a repair re-plan) or a zero-argument drain
      callable;
    * the drain callable runs on the dedicated ``writer`` thread,
      overlapped with the next window's consume.

    Window *i+1*'s production is always submitted before window *i* is
    consumed, so at steady state three consecutive windows are in flight:
    one producing, one computing, one draining. Drain errors surface after
    the last window (every future's result is collected).
    """
    drains: list[Future] = []
    pending = produce(windows[0]) if windows else None
    for i, win in enumerate(windows):
        nxt = produce(windows[i + 1]) if i + 1 < len(windows) else None
        drain = consume(win, pending)
        if drain is not None:
            drains.append(writer.submit(drain))
        pending = nxt
    wait(drains)
    for f in drains:
        f.result()                       # surface writer-thread errors


def _record_span(lock: threading.Lock, res: "PipelineResult", stage: str,
                 index: int, t0: float, t1: float) -> None:
    """Append a stage span and bump its aggregate, under the result lock
    (stages land from the coordinator, packer and writer threads)."""
    with lock:
        res.spans.append((stage, index, t0, t1))
        setattr(res, f"{stage}_seconds",
                getattr(res, f"{stage}_seconds") + (t1 - t0))


@dataclasses.dataclass(frozen=True)
class RepairWindow:
    """One pipeline unit: a slice of stripes sharing a failure pattern."""
    index: int
    sids: tuple[int, ...]
    down: frozenset[int]
    compiled: object                       # CompiledPlan


@dataclasses.dataclass
class _Fetch:
    """An in-flight window prefetch: futures filling per-shard buffers.

    ``layout`` is the window's device-shard geometry (None = degraded /
    single device, one buffer). With a layout, ``bufs[i]`` is shard *i*'s
    slice of the ``(S, |reads|, B)`` batch, filled only by that shard's
    reader pool.
    """
    window: RepairWindow
    shape: tuple[int, int, int]
    layout: Optional[list]                 # list[ShardSlice] | None
    bufs: list[np.ndarray]
    futures: list[Future]
    t_submit: float


@dataclasses.dataclass
class PipelineResult:
    """Aggregate spans + launch accounting for one pipeline run."""
    windows: int = 0
    launches: int = 0
    devices: int = 1
    device_launches: int = 0
    replans: int = 0
    read_seconds: float = 0.0              # sum of per-window prefetch spans
    compute_seconds: float = 0.0           # sum of launch (+ host copy) spans
    write_seconds: float = 0.0             # sum of write-back spans
    wall_seconds: float = 0.0
    spans: list = dataclasses.field(default_factory=list)  # (stage, win, t0, t1)
    # Stripe-scheduler predictions (repro_torch.dist.schedule): shard-local reads
    # under the order the windows actually used vs. the contiguous order,
    # over schedule_total gather reads. Re-planned sub-windows are excluded
    # (the slow path repairs in regroup order).
    scheduled_local: int = 0
    contiguous_local: int = 0
    schedule_total: int = 0

    @property
    def busy_seconds(self) -> float:
        return self.read_seconds + self.compute_seconds + self.write_seconds

    @property
    def overlap_seconds(self) -> float:
        """Stage time hidden by pipelining (0 for a fully serial run)."""
        return max(0.0, self.busy_seconds - self.wall_seconds)


class RepairPipeline:
    """Drives windowed, double-buffered repair against one ``StripeStore``.

    One instance serves one ``repair_all`` call; the reader pool and writer
    thread live only for the duration of :meth:`run`.
    """

    def __init__(self, store, *, spare_of: Optional[dict[int, int]] = None,
                 dest_of: Optional[dict[tuple[int, int], int]] = None,
                 threads: Optional[int] = None,
                 byte_budget: Optional[int] = None,
                 options=None):
        from .options import RepairOptions

        o = options if options is not None else RepairOptions()
        self.store = store
        self.spare_of = spare_of
        # Per-block rebuild destinations ((sid, block) -> surviving node),
        # pre-computed by repair_all from the pre-repair placement snapshot;
        # applied at write-back (re-planned sub-windows included).
        self.dest_of = dest_of
        self.mesh_rules = o.mesh_rules
        self.placement = o.placement
        # Stripe->device-shard assignment per window ("locality" permutes
        # each window onto the shards owning its surviving blocks;
        # repro_torch.dist.schedule). Applied at window creation, before any
        # prefetch is submitted, so the per-shard reader pools follow the
        # scheduled order automatically.
        self.schedule = o.schedule or "none"
        cfg = store.cfg
        self.window = int(o.window or cfg.pipeline_window or cfg.batch_stripes)
        # Reader width is per gather shard: each simulated host prefetches
        # its own shard's blocks through its own pool (its own disks/NIC),
        # so sharded gathers scale I/O with the shard count instead of
        # funnelling every read through one host-wide pool.
        self.threads = max(1, int(threads or cfg.prefetch_threads))
        self.byte_budget = byte_budget
        self.hook = o.pipeline_hook or (lambda stage, index: None)
        self._span_lock = threading.Lock()

    # ------------------------------------------------------------- windows
    def _windows(self, work: Sequence[tuple[list[int], frozenset[int], object]],
                 res: PipelineResult) -> list[RepairWindow]:
        from .stripestore import launch_step

        cfg = self.store.cfg
        out: list[RepairWindow] = []
        for sids, down, compiled in work:
            step = launch_step(cfg, len(compiled.reads), self.window,
                               **({} if self.byte_budget is None
                                  else {"byte_budget": self.byte_budget}))
            step = align_stripe_window(step, self.mesh_rules)
            # "global" assigns the whole pattern group's stripes across all
            # its windows in one exact solve (stripes may migrate between
            # windows); "locality"/"none" reduce to the per-chunk schedule.
            for cs in schedule_group(sids, compiled.reads, self.placement,
                                     self.mesh_rules, step=step,
                                     mode=self.schedule):
                res.scheduled_local += cs.scheduled_local
                res.contiguous_local += cs.contiguous_local
                res.schedule_total += cs.total_reads
                out.append(RepairWindow(len(out), cs.sids, down, compiled))
        return out

    # ------------------------------------------------------------- stages
    def _fill(self, buf: np.ndarray, i: int, j: int, sid: int, b: int,
              shard: int) -> None:
        buf[i, j] = self.store._read_block(sid, b, shard=shard,
                                           placement=self.placement)

    def _prefetch(self, pools: list[ThreadPoolExecutor], win: RepairWindow
                  ) -> _Fetch:
        """Submit a window's reads, partitioned per gather shard.

        Sharded windows fill one buffer per device shard through that
        shard's own reader pool; degraded windows (no mesh, or a ragged
        tail the span does not divide) fall back to one buffer on pool 0,
        attributed to gather shard 0 — matching the synchronous path
        bit-for-bit and count-for-count.
        """
        reads = win.compiled.reads
        shape = (len(win.sids), len(reads), self.store.cfg.block_size)
        layout, parts = plan_gather(shape, self.mesh_rules, self.placement)
        t0 = time.perf_counter()
        futures: list[Future] = []
        for part in parts:
            pool = pools[part.slice_.index % len(pools)] if layout \
                else pools[0]
            futures += [pool.submit(self._fill, part.buf, i, j, sid, b,
                                    part.shard)
                        for i, sid in enumerate(win.sids[part.lo:part.hi])
                        for j, b in enumerate(reads)]
        return _Fetch(win, shape, layout, [p.buf for p in parts],
                      futures, t0)

    def _collect(self, fetch: _Fetch, res: PipelineResult):
        """Wait out a prefetch. Returns the batch — the window's host
        stack — or None when node deaths invalidated it (the window must
        re-plan). Non-I/O errors raise."""
        wait(fetch.futures)
        t1 = time.perf_counter()
        self._span(res, "read", fetch.window.index, fetch.t_submit, t1)
        io_failed = False
        for f in fetch.futures:
            err = f.exception()
            if err is None:
                continue
            if isinstance(err, IOError):
                io_failed = True
            else:
                raise err
        if io_failed:
            return None
        return fetch.bufs[0]

    def _launch(self, win: RepairWindow, stacked,
                res: PipelineResult) -> dict[int, np.ndarray]:
        engine = self.store.engine
        t0 = time.perf_counter()
        out = engine.execute(win.compiled, stacked,
                             self.mesh_rules).cpu().numpy()
        t1 = time.perf_counter()
        self._span(res, "compute", win.index, t0, t1)
        res.launches += 1
        res.devices = max(res.devices, engine.last_span)
        res.device_launches += engine.last_span
        return {b: out[:, t, :] for t, b in enumerate(win.compiled.targets)}

    def _writeback(self, win: RepairWindow, rebuilt: dict[int, np.ndarray],
                   res: PipelineResult) -> None:
        t0 = time.perf_counter()
        self.store._finish_repair(list(win.sids), win.down, win.compiled.meta,
                                  rebuilt, self.spare_of, self.dest_of)
        t1 = time.perf_counter()
        self._span(res, "write", win.index, t0, t1)

    def _span(self, res: PipelineResult, stage: str, index: int,
              t0: float, t1: float) -> None:
        _record_span(self._span_lock, res, stage, index, t0, t1)

    # ------------------------------------------------------------- replan
    def _replan(self, pools: list[ThreadPoolExecutor], win: RepairWindow,
                res: PipelineResult) -> None:
        """Slow path: nodes died under this window's prefetch. Regroup its
        stripes by their *current* down sets, compile fresh plans, and
        repair synchronously (reads still fan out over the shard pools).
        Loops while further failures land; every retry consumes a new
        failure, so the node count bounds the iterations."""
        store = self.store
        pending = list(win.sids)
        for _ in range(1 + len(store.nodes)):
            if not pending:
                return
            res.replans += 1
            self.hook("replan", win.index)
            retry: list[int] = []
            groups: dict[frozenset[int], list[int]] = {}
            for sid in pending:
                groups.setdefault(store._down_blocks(sid), []).append(sid)
            for down, sids in sorted(groups.items(), key=lambda kv: kv[1][0]):
                try:
                    compiled = store.engine.planner.multi_plan(down)
                except RuntimeError:
                    raise IOError(f"stripes {sids} unrecoverable: "
                                  f"{sorted(down)}") from None
                sub = RepairWindow(win.index, tuple(sids), down, compiled)
                stacked = self._collect(self._prefetch(pools, sub), res)
                if stacked is None:          # yet another failure; go again
                    retry.extend(sids)
                    continue
                self._writeback(sub, self._launch(sub, stacked, res), res)
            pending = retry
        raise IOError(f"stripes {pending}: nodes kept failing during re-plan")

    # ---------------------------------------------------------------- run
    def run(self, work: Sequence[tuple[list[int], frozenset[int], object]]
            ) -> PipelineResult:
        """Repair ``[(sids, down, compiled), ...]`` pattern groups.

        The double buffer: wait on window *i*'s prefetch, immediately
        submit window *i+1*'s, then launch *i* and hand its write-back to
        the writer thread — so at steady state reads, compute and writes
        for three consecutive windows run concurrently.
        """
        res = PipelineResult()
        windows = self._windows(work, res)
        res.windows = len(windows)
        if not windows:
            return res
        t_run = time.perf_counter()
        # One reader pool per gather shard (each simulated host's own
        # disks); a single pool when the mesh degrades to one device.
        num_pools = max(1, stripe_axis_span(self.mesh_rules))
        with contextlib.ExitStack() as stack:
            readers = [stack.enter_context(ThreadPoolExecutor(
                self.threads, thread_name_prefix=f"repair-read-s{s}"))
                for s in range(num_pools)]
            writer = stack.enter_context(ThreadPoolExecutor(
                1, thread_name_prefix="repair-write"))

            def produce(win: RepairWindow) -> _Fetch:
                fetch = self._prefetch(readers, win)
                self.hook("prefetch", win.index)
                return fetch

            def consume(win: RepairWindow, fetch: _Fetch):
                stacked = self._collect(fetch, res)
                self.hook("launch", win.index)
                if stacked is None:
                    self._replan(readers, win, res)
                    return None
                rebuilt = self._launch(win, stacked, res)
                self.hook("writeback", win.index)
                return lambda: self._writeback(win, rebuilt, res)

            run_double_buffered(windows, produce=produce, consume=consume,
                                writer=writer)
        res.wall_seconds = time.perf_counter() - t_run
        return res


@dataclasses.dataclass(frozen=True)
class EncodeWindow:
    """One encode-pipeline unit: a run of consecutive stream stripes and
    the byte range of the snapshot buffer that fills them."""
    index: int
    first: int                             # first stream stripe
    count: int                             # stripes in this window
    lo: int                                # snapshot byte range [lo, hi)
    hi: int


class EncodePipeline:
    """The repair pipeline run in reverse: stream a frozen host buffer
    through batched encode into a store's streaming put path.

    The stage machinery is :func:`run_double_buffered` with the data flow
    mirrored — instead of reader pools filling a batch from disk for the
    decoder, a packer thread slices window *i+1*'s ``(S, k, B)`` plaintext
    batch out of the snapshot buffer (zero-padding the tail stripe exactly
    like ``seal``), window *i* moves to the card and encodes through
    ``BatchedCodecEngine.encode`` (one launch of the backend's batched
    kernel) and comes back to the host in one copy, and window *i-1*'s
    encoded stripes drain to disk on the writer thread via
    :meth:`StripeStreamWriter.write_window`. Chunking reuses
    ``launch_step`` (byte-budget-capped, mesh-span-aligned), so encode
    launches are cut exactly like repair launches.

    Spans land in the same :class:`PipelineResult` vocabulary as repair:
    ``read_seconds`` is host packing, ``compute_seconds`` the copy to the
    card, the encode and the copy back, ``write_seconds`` the drain, and
    ``overlap_seconds`` the stall the double buffer hides — a checkpoint's
    encode-overlap fraction is ``overlap / busy``.

    ``pipelined=False`` runs the identical stages strictly in sequence
    (the serial baseline); bytes are identical either way.
    ``drain_stall`` sleeps that many wall seconds per drained window —
    the write-side analogue of ``StoreConfig.io_stall_scale``, making a
    slow persistence medium wall-real for overlap experiments.

    ``hook(stage, window_index)`` fires at "pack" (slice submitted),
    "encode" (window encoded), "drain" (window persisted) — tests use it
    to crash saves at precise pipeline points.
    """

    def __init__(self, store, *, window: Optional[int] = None,
                 mesh_rules=None, hook: Optional[PipelineHook] = None,
                 pipelined: bool = True, drain_stall: float = 0.0):
        self.store = store
        cfg = store.cfg
        self.mesh_rules = mesh_rules
        self.window = int(window or cfg.pipeline_window or cfg.batch_stripes)
        self.hook = hook or (lambda stage, index: None)
        self.pipelined = pipelined
        self.drain_stall = float(drain_stall)
        self._span_lock = threading.Lock()

    # ------------------------------------------------------------- windows
    def _windows(self, total_stripes: int) -> list[EncodeWindow]:
        from .stripestore import launch_step

        cfg = self.store.cfg
        # The "reads" of an encode window are the n blocks it will hold on
        # the host at once (k plaintext in, n encoded out).
        step = align_stripe_window(
            launch_step(cfg, self.store.n, self.window), self.mesh_rules)
        extent = cfg.k * cfg.block_size
        out: list[EncodeWindow] = []
        for first in range(0, total_stripes, step):
            count = min(step, total_stripes - first)
            out.append(EncodeWindow(len(out), first, count,
                                    first * extent, (first + count) * extent))
        return out

    # ------------------------------------------------------------- stages
    def _pack(self, flat: np.ndarray, win: EncodeWindow) -> np.ndarray:
        """Slice + zero-pad one window's plaintext batch off the snapshot."""
        cfg = self.store.cfg
        batch = np.zeros(win.count * cfg.k * cfg.block_size, np.uint8)
        src = flat[win.lo:min(win.hi, len(flat))]
        batch[:len(src)] = src
        return batch.reshape(win.count, cfg.k, cfg.block_size)

    def _encode(self, win: EncodeWindow, batch: np.ndarray,
                res: PipelineResult) -> np.ndarray:
        engine = self.store.engine
        t0 = time.perf_counter()
        out = engine.encode(batch, self.mesh_rules).cpu().numpy()
        t1 = time.perf_counter()
        _record_span(self._span_lock, res, "compute", win.index, t0, t1)
        res.launches += 1
        res.devices = max(res.devices, engine.last_span)
        res.device_launches += engine.last_span
        return out

    def _drain(self, stream, win: EncodeWindow, encoded: np.ndarray,
               res: PipelineResult) -> None:
        t0 = time.perf_counter()
        stream.write_window(win.first, encoded)
        if self.drain_stall > 0.0:
            time.sleep(self.drain_stall)
        t1 = time.perf_counter()
        _record_span(self._span_lock, res, "write", win.index, t0, t1)
        self.hook("drain", win.index)

    # ---------------------------------------------------------------- run
    def run(self, stream, flat: np.ndarray) -> PipelineResult:
        """Encode ``flat`` (the frozen snapshot bytes) into ``stream`` (a
        :class:`StripeStreamWriter` sized for it). The caller closes or
        aborts the stream — on error this raises with windows possibly
        half-drained, and the stream refuses to ``close``."""
        flat = np.asarray(flat, np.uint8).reshape(-1)
        res = PipelineResult()
        windows = self._windows(stream.num_stripes)
        res.windows = len(windows)
        if not windows:
            return res
        t_run = time.perf_counter()
        with contextlib.ExitStack() as stack:
            packer = stack.enter_context(ThreadPoolExecutor(
                1, thread_name_prefix="ckpt-pack"))
            writer = stack.enter_context(ThreadPoolExecutor(
                1, thread_name_prefix="ckpt-write"))

            def produce(win: EncodeWindow):
                t0 = time.perf_counter()
                fut = packer.submit(self._pack, flat, win)
                self.hook("pack", win.index)
                return (fut, t0)

            def consume(win: EncodeWindow, token):
                fut, t0 = token
                batch = fut.result()
                _record_span(self._span_lock, res, "read", win.index,
                             t0, time.perf_counter())
                encoded = self._encode(win, batch, res)
                self.hook("encode", win.index)
                return lambda: self._drain(stream, win, encoded, res)

            if self.pipelined:
                run_double_buffered(windows, produce=produce,
                                    consume=consume, writer=writer)
            else:
                for win in windows:        # serial baseline: no overlap
                    consume(win, produce(win))()
        res.wall_seconds = time.perf_counter() - t_run
        return res
