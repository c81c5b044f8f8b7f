"""Erasure-coded checkpointing: async sharded save, parallel degraded restore.

Training state (params + optimizer moments + step) is flattened to a byte
stream and striped through the CP-LRC StripeStore. Losing up to ``r``
arbitrary hosts — or more when failures spread across local repair groups —
costs only a local-group repair instead of a cold re-read of the full
checkpoint: the paper's repair-bandwidth win applied to elastic training
restart.

**Save** is asynchronous and pipelined (DESIGN.md §13). ``save_async``
snapshots the train state on the caller's thread — one device→host copy
per tensor, straight into one frozen host byte buffer, so the next training
step can mutate its tensors immediately — and hands the buffer to a
background :class:`repro_torch.ftx.pipeline.EncodePipeline`: the repair
pipeline's reader/writer thread machinery run in reverse, packing stripe
windows off the snapshot while the previous window encodes on the card
through ``BatchedCodecEngine.encode`` (one launch of the backend's batched
kernel) and the one before that drains to disk through the store's
streaming put path. The whole store is built under ``step<N>.tmp`` and
atomically renamed on seal, so a crash mid-save can never corrupt — or even
make visible — a partial checkpoint; orphaned ``.tmp``/meta-less
directories are swept on manager init.

**Restore** gathers all k data shards in parallel through per-host reader
pools (``read_range``), and after host failures reconstructs the lost
blocks via the serving planner (local group first, cascade next, global
last) *concurrently* with the live-shard reads — decode launches consume
live data sources straight from the already-gathered restore buffer and
touch disk only for the plan's extra (parity) sources, so a degraded
restore reads barely more than a healthy one and strictly fewer blocks
than a replication system's full re-read plus re-replication.

The state is a nest of dicts, ordered dicts, lists, tuples and named
tuples over leaves that are torch tensors (on any device), numpy arrays or
Python scalars; ``None`` holds no leaf. Leaves are laid out in the order
the JAX package's checkpoints use (``repro_torch.tree``: a plain dict's
keys sorted, an ordered dict's in insertion order, sequences in order) and
recorded under numpy's dtype names (``"bfloat16"`` for ``torch.bfloat16``),
so a checkpoint written by either package restores in the other byte for
byte.
``restore`` rebuilds the template's nesting with CPU tensors of the
recorded dtypes and shapes.
"""
from __future__ import annotations

import dataclasses
import json
import re
import shutil
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor, wait
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.dist.sharding import current_rules
from repro_torch.tree import tree_leaves, tree_unflatten

from .pipeline import EncodePipeline, PipelineHook
from .stripestore import StoreConfig, StripeStore, launch_step

PyTree = Any

_STEP_DIR = re.compile(r"^step(\d+)$")

# The head key of the checkpoint byte stream inside each step's store
# (continuations follow the standard #cont chain, one per stripe).
_STATE_KEY = "state"

# numpy's dtype names (what the checkpoint metadata records) for the torch
# dtypes a leaf may have; each name is also the torch attribute.
_DTYPE_NAMES = ("bool", "uint8", "int8", "int16", "int32", "int64",
                "uint16", "uint32", "uint64", "float16", "bfloat16",
                "float32", "float64", "complex64", "complex128")
_TORCH_DTYPES = {name: getattr(torch, name) for name in _DTYPE_NAMES
                 if hasattr(torch, name)}
_DTYPE_NAME = {dt: name for name, dt in _TORCH_DTYPES.items()}


@dataclasses.dataclass(frozen=True)
class CheckpointConfig:
    store: StoreConfig = dataclasses.field(
        default_factory=lambda: StoreConfig(k=8, r=2, p=2,
                                            block_size=1 << 18))
    keep: int = 3
    encode_window: Optional[int] = None   # stripes per encode window (None =
    #                                       the store's pipeline_window)
    restore_threads: int = 2              # reader-pool width per host on the
    #                                       parallel restore path
    decode_threads: int = 2               # concurrent degraded-decode tasks
    #                                       during restore


# ------------------------------------------------------------ state trees
def _leaf_meta(leaf) -> dict:
    if isinstance(leaf, torch.Tensor):
        name = _DTYPE_NAME.get(leaf.dtype)
        shape, nbytes = list(leaf.shape), leaf.numel() * leaf.element_size()
    else:
        arr = np.asarray(leaf)
        name, shape, nbytes = str(arr.dtype), list(arr.shape), arr.nbytes
    if name not in _TORCH_DTYPES:
        raise TypeError(f"cannot checkpoint a leaf of dtype "
                        f"{getattr(leaf, 'dtype', type(leaf).__name__)}")
    return {"dtype": name, "shape": shape, "nbytes": int(nbytes)}


def _flatten_bytes(tree: PyTree) -> tuple[np.ndarray, list]:
    """Flatten a state tree to one contiguous host byte buffer + leaf
    metadata.

    Always copies: each tensor's bytes go into the buffer in one copy (a
    device→host copy for a tensor on the card), so the result is the
    checkpoint *snapshot*, guaranteed to not alias any tensor or array the
    training loop may mutate after this returns.
    """
    leaves = tree_leaves(tree)
    meta = [_leaf_meta(leaf) for leaf in leaves]
    flat = np.empty(sum(m["nbytes"] for m in meta), np.uint8)
    pos = 0
    for leaf, m in zip(leaves, meta):
        dst = flat[pos:pos + m["nbytes"]]
        if isinstance(leaf, torch.Tensor):
            torch.from_numpy(dst).copy_(
                leaf.detach().reshape(-1).view(torch.uint8))
        else:
            dst[:] = np.ascontiguousarray(leaf).reshape(-1).view(np.uint8)
        pos += m["nbytes"]
    return flat, meta


def _unflatten_bytes(template: PyTree, flat: np.ndarray, meta: list) -> PyTree:
    """CPU tensors of the recorded dtypes and shapes, each with a buffer of
    its own, nested as ``template``."""
    leaves = []
    pos = 0
    for m in meta:
        n, dtype = m["nbytes"], _TORCH_DTYPES[m["dtype"]]
        if n == 0:                       # an empty uint8 tensor cannot view
            leaves.append(torch.empty(m["shape"], dtype=dtype))
            continue
        raw = torch.from_numpy(flat[pos:pos + n].copy())
        leaves.append(raw.view(dtype).reshape(m["shape"]))
        pos += n
    return tree_unflatten(template, iter(leaves))


class CheckpointFuture:
    """Handle to an in-flight asynchronous save.

    The snapshot has already been taken when ``save_async`` returns this;
    ``result()`` joins the background encode and returns the save info
    dict (or raises the encode's error). ``snapshot_seconds`` is the only
    time the training loop was stalled.
    """

    def __init__(self, step: int, future: Future, snapshot_seconds: float):
        self.step = step
        self.snapshot_seconds = snapshot_seconds
        self._future = future

    def done(self) -> bool:
        return self._future.done()

    def exception(self, timeout: Optional[float] = None):
        return self._future.exception(timeout)

    def result(self, timeout: Optional[float] = None) -> dict:
        return self._future.result(timeout)


class CheckpointManager:
    """Saves and restores numbered checkpoints under ``root``, one stripe
    store per step. Every store it builds or loads encodes and decodes on
    ``device`` (the card unless the caller asks for the CPU)."""

    def __init__(self, root: str | Path, cfg: Optional[CheckpointConfig] = None,
                 *, device: str | torch.device = "cuda"):
        self.root = Path(root)
        self.cfg = cfg or CheckpointConfig()
        self.device = resolve_device(device)
        self.root.mkdir(parents=True, exist_ok=True)
        self._stores: dict[int, StripeStore] = {}
        self._meta: dict[int, dict] = {}
        # One background worker serializes saves: retention and the
        # atomic renames never race each other.
        self._encoder = ThreadPoolExecutor(1, thread_name_prefix="ckpt-encode")
        self._lock = threading.Lock()
        self._clean_orphans()

    def _clean_orphans(self) -> None:
        """Sweep the debris of crashed saves: ``step<N>.tmp`` staging dirs
        and ``step<N>`` dirs missing their ``ckpt_meta.json``.
        ``available()`` already refuses to list them; here they are
        reclaimed instead of leaking forever."""
        for p in self.root.glob("step*"):
            if not p.is_dir():
                continue
            complete = (_STEP_DIR.match(p.name)
                        and (p / "ckpt_meta.json").exists())
            if not complete:
                shutil.rmtree(p, ignore_errors=True)

    # -------------------------------------------------------------- save
    def save(self, step: int, state: PyTree, *, mesh_rules=None) -> dict:
        """Encode + persist one checkpoint synchronously; returns telemetry.

        Exactly ``save_async(...).result()`` — the bytes on disk are
        identical, the caller just waits out the encode."""
        return self.save_async(step, state, mesh_rules=mesh_rules).result()

    def save_async(self, step: int, state: PyTree, *, mesh_rules=None,
                   pipelined: bool = True, drain_stall: float = 0.0,
                   hook: Optional[PipelineHook] = None) -> CheckpointFuture:
        """Snapshot ``state`` and encode it to disk in the background.

        The snapshot (flatten + host copy) happens here, on the caller's
        thread — when this returns, the training loop may freely mutate
        every tensor in ``state``. Everything else (windowed encode, drain,
        manifest, atomic rename, retention) runs on the manager's
        background thread; the returned :class:`CheckpointFuture` joins it.

        ``mesh_rules`` names the mesh the encode launches' stripe axis
        resolves onto (default: the ambient ``with_rules`` context *of the
        caller* — captured now, since the background thread has no ambient
        context). ``pipelined=False`` runs the encode stages serially (the
        serial baseline); ``drain_stall``/``hook`` are forwarded to the
        :class:`EncodePipeline`.
        """
        if mesh_rules is None:
            mesh_rules = current_rules()
        t0 = time.perf_counter()
        flat, leaves = _flatten_bytes(state)
        snapshot_seconds = time.perf_counter() - t0
        fut = self._encoder.submit(self._encode_and_seal, step, flat, leaves,
                                   mesh_rules, snapshot_seconds, pipelined,
                                   drain_stall, hook)
        return CheckpointFuture(step, fut, snapshot_seconds)

    def _encode_and_seal(self, step: int, flat: np.ndarray, leaves: list,
                         mesh_rules, snapshot_seconds: float,
                         pipelined: bool, drain_stall: float,
                         hook: Optional[PipelineHook]) -> dict:
        """Background half of a save: stream-encode into ``step<N>.tmp``,
        then atomically rename. Any failure tears the staging dir down and
        re-raises — the previous checkpoint is never touched."""
        tmp = self.root / f"step{step}.tmp"
        final = self.root / f"step{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        t0 = time.perf_counter()
        try:
            store = StripeStore(tmp, self.cfg.store, device=self.device)
            stream = store.stream_writer(_STATE_KEY, len(flat))
            pipe = EncodePipeline(store, window=self.cfg.encode_window,
                                  mesh_rules=mesh_rules, hook=hook,
                                  pipelined=pipelined,
                                  drain_stall=drain_stall)
            res = pipe.run(stream, flat)
            stream.close()
            store.save_manifest()
            info = {"step": step, "bytes": int(len(flat)),
                    "stripes": stream.num_stripes,
                    "snapshot_seconds": snapshot_seconds,
                    "encode_seconds": time.perf_counter() - t0,
                    "encode": {
                        "pipelined": pipelined,
                        "windows": res.windows,
                        "launches": res.launches,
                        "pack_seconds": res.read_seconds,
                        "compute_seconds": res.compute_seconds,
                        "write_seconds": res.write_seconds,
                        "wall_seconds": res.wall_seconds,
                        "overlap_seconds": res.overlap_seconds,
                        "overlap_fraction": (res.overlap_seconds
                                             / res.busy_seconds
                                             if res.busy_seconds else 0.0)},
                    "leaves": leaves}
            (tmp / "ckpt_meta.json").write_text(json.dumps(info))
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        # The atomic commit point: a complete checkpoint appears under its
        # final name in one rename, or not at all.
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)
        store.root = final
        with self._lock:
            self._stores[step] = store
            self._meta[step] = info
        self._retain()
        return info

    def _retain(self) -> None:
        steps = sorted(self.available())
        for old in steps[:-self.cfg.keep]:
            shutil.rmtree(self.root / f"step{old}", ignore_errors=True)
            with self._lock:
                self._stores.pop(old, None)
                self._meta.pop(old, None)

    def available(self) -> list[int]:
        out = []
        for p in self.root.glob("step*"):
            m = _STEP_DIR.match(p.name)
            if m and (p / "ckpt_meta.json").exists():
                out.append(int(m.group(1)))
        return sorted(out)

    # ------------------------------------------------------------ restore
    def store_for(self, step: int) -> StripeStore:
        with self._lock:
            if step not in self._stores:
                self._stores[step] = StripeStore.load(
                    self.root / f"step{step}", device=self.device)
            return self._stores[step]

    def restore(self, step: int, template: PyTree, *, parallel: bool = True,
                mesh_rules=None) -> tuple[PyTree, dict]:
        """Rebuild state at ``step``; degraded reads repair automatically.

        ``parallel=True`` (the default) gathers shards through per-host
        reader pools and decodes lost blocks concurrently with the live
        reads; ``parallel=False`` is the serial object-read fallback (the
        serial baseline). Both return bit-identical state: CPU tensors
        nested as ``template``.
        """
        if mesh_rules is None:
            mesh_rules = current_rules()
        t0 = time.perf_counter()
        store = self.store_for(step)
        info = json.loads(
            (self.root / f"step{step}" / "ckpt_meta.json").read_text())
        before = store.telemetry.copy()
        if parallel:
            flat, extra = self._gather_parallel(store, info["bytes"],
                                                mesh_rules)
        else:
            flat, extra = store.get(_STATE_KEY)[:info["bytes"]], {}
        state = _unflatten_bytes(template, flat, info["leaves"])
        t = store.telemetry
        tele = {"restore_seconds": time.perf_counter() - t0,
                "blocks_read": t.blocks_read - before.blocks_read,
                "bytes_read": t.bytes_read - before.bytes_read,
                "sim_seconds": t.sim_seconds - before.sim_seconds,
                "parallel": parallel, **extra}
        return state, tele

    def _gather_parallel(self, store: StripeStore, num_bytes: int,
                         mesh_rules) -> tuple[np.ndarray, dict]:
        """The parallel (and degraded-capable) restore read path.

        Live data blocks fan out over one reader pool per host — every
        host's disks stream their shard of the checkpoint concurrently.
        Stripes with lost data blocks are grouped by failure pattern and
        decoded in batched ``serving_plan`` launches on the store's device
        that run *while* the live gather is still in flight: each decode
        waits only on the read futures of its own live data sources (served
        from the restore buffer — already paid for) and reads just the
        plan's extra parity sources from disk. The buffer is
        zero-initialized, so the stream-writer's zero padding never needs
        reading or reconstructing.
        """
        cfg = store.cfg
        k, B = cfg.k, cfg.block_size
        extent = k * B
        # The checkpoint object chain: one stripe per link, in stream order.
        metas = []
        cur = _STATE_KEY
        while cur in store.objects:
            metas.append(store.objects[cur])
            cur += "#cont"
        if not metas:
            raise KeyError(_STATE_KEY)
        flat = np.zeros(len(metas) * extent, np.uint8)

        read_futs: dict[tuple[int, int], Future] = {}
        stats = {"degraded_blocks": 0, "restore_decode_launches": 0,
                 "extra_source_reads": 0}
        slock = threading.Lock()
        patterns: dict[frozenset[int], list[tuple[int, int]]] = {}

        def read_live(sid: int, b: int, dst: int, hi: int) -> None:
            flat[dst:dst + hi] = store.read_range(sid, b, 0, hi)

        def decode_group(down: frozenset[int], group: list[tuple[int, int]]
                         ) -> None:
            lost = [b for b in sorted(down) if b < k]
            covered: set[int] = set()
            for b in lost:
                if b in covered:
                    continue
                plan = store.engine.planner.serving_plan(b, down)
                covered.update(t for t in plan.targets if t < k)
                step = launch_step(cfg, len(plan.reads),
                                   cfg.pipeline_window or None)
                for lo in range(0, len(group), step):
                    chunk = group[lo:lo + step]
                    stacked = np.empty((len(chunk), len(plan.reads), B),
                                       np.uint8)
                    for i, (sid, off) in enumerate(chunk):
                        for j, r in enumerate(plan.reads):
                            if r < k and r not in down:
                                f = read_futs.get((sid, r))
                                if f is not None:
                                    f.result()
                                stacked[i, j] = flat[off + r * B:
                                                     off + (r + 1) * B]
                            else:
                                stacked[i, j] = store._read_block(sid, r)
                                with slock:
                                    stats["extra_source_reads"] += 1
                    out = store.engine.execute(plan, stacked,
                                               mesh_rules).cpu().numpy()
                    with slock:
                        stats["restore_decode_launches"] += 1
                    for t, tb in enumerate(plan.targets):
                        if tb >= k:
                            continue
                        for i, (sid, off) in enumerate(chunk):
                            flat[off + tb * B:off + (tb + 1) * B] = out[i, t]

        with ThreadPoolExecutor(self.cfg.decode_threads,
                                thread_name_prefix="restore-decode") as dpool:
            pools: dict[int, ThreadPoolExecutor] = {}
            try:
                for i, meta in enumerate(metas):
                    sid, off = meta.sid, i * extent
                    down = store._down_blocks(sid)
                    stripe = store.stripes[sid]
                    for b in range(k):
                        hi = min(meta.size - b * B, B)
                        if hi <= 0:
                            break            # zero padding: nothing to read
                        if b in down:
                            stats["degraded_blocks"] += 1
                            continue
                        node = stripe.node_of_block[b]
                        pool = pools.get(node)
                        if pool is None:
                            pool = pools[node] = ThreadPoolExecutor(
                                self.cfg.restore_threads,
                                thread_name_prefix=f"restore-h{node}")
                        read_futs[(sid, b)] = pool.submit(read_live, sid, b,
                                                          off + b * B, hi)
                    # Only patterns that lose a *needed* data block decode;
                    # blocks entirely inside the zero padding reconstruct
                    # to zeros the buffer already holds.
                    needed = min(k, -(-meta.size // B))
                    if down & set(range(needed)):
                        patterns.setdefault(down, []).append((sid, off))
                decode_futs = [dpool.submit(decode_group, down, group)
                               for down, group in patterns.items()]
                wait(list(read_futs.values()))
                wait(decode_futs)
                for f in [*read_futs.values(), *decode_futs]:
                    f.result()               # surface read/decode errors
            finally:
                for pool in pools.values():
                    pool.shutdown(wait=True)
        return flat[:num_bytes], stats

    def fail_hosts(self, step: int, hosts: list[int]) -> None:
        store = self.store_for(step)
        for h in hosts:
            store.fail_node(h)

    def repair(self, step: int) -> dict:
        return self.store_for(step).repair_all()
