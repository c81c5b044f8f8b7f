"""Model API: a uniform facade over the model assemblies, used by the
server and the smoke runs.

The port of ``src/repro/models/registry.py``. Parameters are drawn from a
``torch.Generator`` (``init_params(gen)``) on the generator's device; the
abstract forms build on the ``meta`` device, so counting the parameters of
a 300B+ configuration allocates nothing. ``build`` takes the
decoder-only families (``lm``) and the encoder-decoder one (``encdec``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import torch

from repro_torch.tree import tree_leaves

from . import encdec, lm
from .common import ModelConfig

PyTree = Any


@dataclasses.dataclass(frozen=True)
class ModelApi:
    cfg: ModelConfig
    init_params: Callable[[Optional[torch.Generator]], PyTree]
    param_logical: Callable[[], PyTree]
    train_loss: Callable[[PyTree, dict], torch.Tensor]
    prefill: Callable[[PyTree, dict], tuple]
    decode_step: Callable[[PyTree, PyTree, torch.Tensor, Any], tuple]
    init_caches: Callable[..., PyTree]
    sample_batch: Callable[..., dict]

    def abstract_params(self) -> PyTree:
        """The parameters as ``meta`` tensors: shapes and dtypes, no
        allocation."""
        return self.init_params(None)

    def abstract_caches(self, batch: int, max_len: int) -> PyTree:
        if self.cfg.family == "encdec":
            return self.init_caches(self.cfg, batch, max_len, max_len,
                                    device="meta")
        return self.init_caches(self.cfg, batch, max_len, device="meta")

    def param_count(self) -> int:
        return sum(math.prod(x.shape) for x in tree_leaves(
            self.abstract_params()))

    def active_param_count(self) -> int:
        """MoE: expert weights count as top-k / E of their size (active set)."""
        cfg = self.cfg
        if not cfg.num_experts:
            return self.param_count()
        total = 0
        for leaf in tree_leaves(self.abstract_params()):
            n = math.prod(leaf.shape)
            # Expert tensors: (E, d, ff) or layer-stacked (R, E, d, ff).
            if (leaf.ndim >= 3 and cfg.num_experts > 1
                    and (leaf.shape[0] == cfg.num_experts
                         or (leaf.ndim >= 4
                             and leaf.shape[1] == cfg.num_experts))):
                n = n * cfg.experts_per_tok // cfg.num_experts
            total += n
        return total


def build(cfg: ModelConfig) -> ModelApi:
    mod = encdec if cfg.family == "encdec" else lm
    return ModelApi(
        cfg=cfg,
        init_params=lambda gen: mod.init_params(gen, cfg),
        param_logical=lambda: mod.param_logical(cfg),
        train_loss=lambda params, batch: mod.train_loss(params, batch, cfg),
        prefill=lambda params, batch: mod.prefill(params, batch, cfg),
        decode_step=lambda params, caches, tokens, index: mod.decode_step(
            params, caches, tokens, index, cfg),
        init_caches=mod.init_caches,
        sample_batch=lambda batch, seq, gen, **kw: mod.sample_batch(
            cfg, batch, seq, gen, **kw),
    )
