"""Deterministic, restart-safe data pipeline.

The port's own copy of ``src/repro/data/pipeline.py`` (numpy only): a
batch is the same bytes in both packages. ``batch_at`` returns numpy
arrays; the train step moves them to the device.

Production concerns baked in:
* **Determinism / restartability**: batches are a pure function of
  (seed, step) — after a failure + checkpoint restore, the pipeline resumes
  at the right step with zero state to persist beyond the step counter.
  This is what makes the CP-LRC checkpoint-repair path sufficient for full
  job recovery.
* **Host sharding**: each host materializes only its slice of the global
  batch (``process_index``/``process_count``), matching the batch's
  ("pod", "data") sharding.
* Two sources: synthetic LM tokens (zipf-ish unigram mix so losses move)
  and a packed-documents mode over an on-disk token file.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    kind: str = "synthetic"       # "synthetic" | "file"
    path: Optional[str] = None    # token file (uint16/uint32 raw) for "file"
    frontend: str = "none"        # mirror of the model's stub frontend
    frontend_tokens: int = 0
    d_model: int = 0


class SyntheticLM:
    """Zipf-mixture synthetic token stream; batch = f(seed, step, host)."""

    def __init__(self, cfg: DataConfig, process_index: int = 0,
                 process_count: int = 1):
        self.cfg = cfg
        if cfg.global_batch % process_count:
            raise ValueError("global batch must divide process count")
        self.local_batch = cfg.global_batch // process_count
        self.process_index = process_index

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, self.process_index]))
        # zipf-ish unigram distribution makes the LM loss learnable
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        probs = 1.0 / ranks
        probs /= probs.sum()
        shape = (self.local_batch, cfg.seq_len + 1)
        toks = rng.choice(cfg.vocab_size, size=shape, p=probs).astype(np.int32)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if cfg.frontend == "frames":
            out["frames"] = rng.standard_normal(
                (self.local_batch, cfg.seq_len, cfg.d_model)).astype(np.float32)
        elif cfg.frontend == "patches":
            out["prefix_embeds"] = rng.standard_normal(
                (self.local_batch, cfg.frontend_tokens, cfg.d_model)
            ).astype(np.float32)
        return out

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class FileLM(SyntheticLM):
    """Packed-document reader: strided windows over a raw token file."""

    def __init__(self, cfg: DataConfig, process_index: int = 0,
                 process_count: int = 1):
        super().__init__(cfg, process_index, process_count)
        if not cfg.path:
            raise ValueError("file pipeline needs cfg.path")
        self.tokens = np.memmap(cfg.path, dtype=np.uint32, mode="r")

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        n = len(self.tokens) - cfg.seq_len - 1
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, self.process_index]))
        starts = rng.integers(0, n, size=self.local_batch)
        rows = np.stack([self.tokens[s:s + cfg.seq_len + 1] for s in starts])
        rows = (rows % cfg.vocab_size).astype(np.int32)
        return {"tokens": rows[:, :-1], "labels": rows[:, 1:]}


def make_pipeline(cfg: DataConfig, process_index: int = 0,
                  process_count: int = 1) -> SyntheticLM:
    if cfg.kind == "file":
        return FileLM(cfg, process_index, process_count)
    return SyntheticLM(cfg, process_index, process_count)
