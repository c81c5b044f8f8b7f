"""Continuous-batching serve engine.

The port of ``src/repro/serve/engine.py``. A fixed pool of ``max_batch``
slots over one shared, preallocated KV cache on the engine's device:

* ``submit`` queues requests;
* each ``step()`` admits queued requests into free slots (prefill computes
  the prompt's cache row-block and writes it into the slot) and then runs
  ONE decode step for all live slots (per-slot position indices);
* finished requests (EOS, ``max_new`` tokens, or the cache's last
  position) free their slots immediately — the classic continuous-batching
  schedule.

Greedy decoding: each token is the argmax of the last logits. The model
runs eagerly on ``device`` (the card by default); the engine never moves
parameters between devices. It keeps the milliseconds of each prefill and
decode step (CUDA events on the card, the host clock on the host;
``call_ms``).
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from collections import deque
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import blocks
from repro_torch.models.registry import ModelApi
from repro_torch.tree import tree_leaves, tree_map

from .telemetry import LatencyRecorder


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray          # (prompt_len,) int32
    max_new: int = 16
    eos_id: Optional[int] = None
    out_tokens: list = dataclasses.field(default_factory=list)
    done: bool = False
    submitted_at: float = 0.0   # perf_counter at submit; feeds latency p50/p99


class ServeEngine:
    def __init__(self, api: ModelApi, max_batch: int = 4, max_len: int = 512,
                 device: str | torch.device = "cuda"):
        if api.cfg.family == "encdec":
            raise NotImplementedError("engine demo targets decoder-only archs")
        self.api = api
        self.cfg = api.cfg
        self.max_batch = max_batch
        self.max_len = max_len
        self.device = resolve_device(device)
        self.params = None
        self.caches = None
        self.queue: deque[Request] = deque()
        self.slots: list[Optional[Request]] = [None] * max_batch
        self.lengths = np.zeros(max_batch, np.int32)
        self._rid = itertools.count()
        # The most recent calls' times per kind, as LatencyRecorder keeps
        # its most recent latencies.
        self._times = {"prefill": deque(maxlen=8192),
                       "decode": deque(maxlen=8192)}
        # Submit-to-completion wall latency per request — the same recorder
        # (and so the same p50/p99 meaning) as the degraded block-read
        # serving path (repro_torch.serve.telemetry).
        self.latency = LatencyRecorder()

    def load(self, params) -> None:
        """Serve ``params``, which must already lie on the engine's device,
        and allocate the slots' caches there."""
        away = {str(t.device) for t in tree_leaves(params)
                if t.device != self.device}
        if away:
            raise ValueError(f"parameters on {sorted(away)}, the engine runs "
                             f"on {self.device}: move them there first")
        self.params = params
        self.caches = self.api.init_caches(self.cfg, self.max_batch,
                                           self.max_len, device=self.device)

    def submit(self, prompt: np.ndarray, max_new: int = 16,
               eos_id: Optional[int] = None) -> Request:
        req = Request(rid=next(self._rid), prompt=np.asarray(prompt, np.int32),
                      max_new=max_new, eos_id=eos_id,
                      submitted_at=time.perf_counter())
        self.queue.append(req)
        return req

    # ------------------------------------------------------------------
    def _call(self, kind: str, fn: Callable, *args):
        """``fn(*args)``, its time kept under ``kind``."""
        if self.device.type != "cuda":
            t0 = time.perf_counter()
            out = fn(*args)
            self._times[kind].append((time.perf_counter() - t0) * 1e3)
            return out
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args)
        end.record()
        self._times[kind].append((start, end))
        return out

    def call_ms(self) -> dict:
        """``{"prefill": [...], "decode": [...]}``: the milliseconds of each
        recent call, oldest first (waits for the card's last call)."""
        return {kind: [_elapsed_ms(t) for t in times]
                for kind, times in self._times.items()}

    def _admit(self) -> None:
        for slot in range(self.max_batch):
            if self.slots[slot] is not None or not self.queue:
                continue
            req = self.queue.popleft()
            batch = {"tokens": torch.as_tensor(
                req.prompt[None, :], dtype=torch.int64, device=self.device)}
            if self.cfg.frontend != "none":
                batch["prefix_embeds"] = torch.zeros(
                    (1, self.cfg.frontend_tokens, self.cfg.d_model),
                    dtype=torch.bfloat16, device=self.device)
            logits, row_caches = self._call("prefill", self.api.prefill,
                                            self.params, batch)
            row_caches = blocks.pad_caches(row_caches, self.cfg, self.max_len)
            _write_slot(self.caches, row_caches, slot)
            self.slots[slot] = req
            off = (self.cfg.frontend_tokens
                   if self.cfg.frontend != "none" else 0)
            self.lengths[slot] = len(req.prompt) + off
            req.out_tokens.append(int(torch.argmax(logits[0, -1])))

    def step(self) -> int:
        """Admit + one decode step for all live slots; returns #live."""
        self._admit()
        live = [i for i, r in enumerate(self.slots) if r is not None]
        if not live:
            return 0
        tokens = np.zeros((self.max_batch, 1), np.int64)
        for i in live:
            tokens[i, 0] = self.slots[i].out_tokens[-1]
        logits, self.caches = self._call(
            "decode", self.api.decode_step, self.params, self.caches,
            torch.from_numpy(tokens).to(self.device),
            torch.from_numpy(self.lengths.astype(np.int64)).to(self.device))
        nxt = torch.argmax(logits[:, 0, :], dim=-1).cpu().numpy()
        for i in live:
            req = self.slots[i]
            self.lengths[i] += 1
            req.out_tokens.append(int(nxt[i]))
            if (len(req.out_tokens) >= req.max_new
                    or (req.eos_id is not None and nxt[i] == req.eos_id)
                    or self.lengths[i] >= self.max_len - 1):
                req.done = True
                self.slots[i] = None
                self.latency.record(time.perf_counter() - req.submitted_at,
                                    len(req.out_tokens))
        return len(live)

    def latency_stats(self) -> dict:
        """p50/p99/mean submit-to-completion latency over finished requests."""
        return self.latency.snapshot()

    def run(self, max_steps: int = 10_000) -> None:
        for _ in range(max_steps):
            if not self.queue and all(s is None for s in self.slots):
                return
            self.step()


def _elapsed_ms(t) -> float:
    """A call's milliseconds: the host's reading, or the time
    between its two CUDA events once the second has completed."""
    if isinstance(t, float):
        return t
    start, end = t
    end.synchronize()
    return start.elapsed_time(end)


def _write_slot(caches, row_caches, slot: int) -> None:
    """Copy a prefilled single-row cache into batch slot ``slot`` of the
    engine's caches, in place (the engine owns them). Every leaf is
    (R, B, ...): the row's (R, 1, ...) must match the slot's shape, which
    ``pad_caches`` ensures."""

    def write(dst, src):
        if src.shape[2:] != dst.shape[2:] or src.shape[0] != dst.shape[0]:
            raise ValueError(f"a cache row of shape {tuple(src.shape)} does "
                             f"not fit a slot of {tuple(dst.shape)}")
        dst[:, slot] = src[:, 0].to(dst.dtype)

    tree_map(write, caches, row_caches)
