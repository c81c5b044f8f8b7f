"""Decoder-only language model assembly (covers dense / MoE / hybrid / SSM /
VLM-backbone / frontend-stub families).

The port of ``src/repro/models/lm.py``. Params nest:
  {"embed": (V, d), "stack": [per-position stacked LayerParams],
   "final_norm": (d,), "frontend_proj": optional (d, d)}

Batch dict (see ``repro_torch.configs.input_specs``):
  tokens  (B, S) integer
  labels  (B, S) integer        (train only)
  prefix_embeds (B, F, d) bf16  (vlm/audio stubs only)

The reference's activation-sharding annotations do nothing outside a mesh
and are left out.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from . import blocks
from .common import (ModelConfig, cross_entropy, dense_init, embed_tokens,
                     full, lm_logits, rms_norm, stacked_logical)

PyTree = Any


def init_params(gen: Optional[torch.Generator], cfg: ModelConfig) -> PyTree:
    """Every parameter, drawn from ``gen`` on its device (on ``meta``,
    without allocating, for ``gen=None``)."""
    params = {
        "embed": dense_init(gen, (cfg.vocab_size, cfg.d_model),
                            cfg.param_dtype, scale=0.02),
        "stack": blocks.init_stack(gen, cfg),
        "final_norm": full(gen, (cfg.d_model,), 1.0, cfg.param_dtype),
    }
    if cfg.frontend != "none":
        params["frontend_proj"] = dense_init(gen, (cfg.d_model, cfg.d_model),
                                             cfg.param_dtype)
    return params


def param_logical(cfg: ModelConfig) -> PyTree:
    """Logical axis names, mirroring init_params structure. Stacked layer
    leaves get a leading None (the repeat axis)."""
    stack_logical = [stacked_logical(blocks.layer_param_logical(spec, cfg))
                     for spec in blocks.build_period(cfg)]
    out = {
        "embed": ("vocab", None),
        "stack": stack_logical,
        "final_norm": (None,),
    }
    if cfg.frontend != "none":
        out["frontend_proj"] = (None, None)
    return out


def _embed_inputs(params, batch, cfg: ModelConfig):
    x = embed_tokens(params["embed"], batch["tokens"])
    mask = None
    if cfg.frontend != "none":
        prefix = batch["prefix_embeds"].to(cfg.param_dtype)
        prefix = torch.einsum("bfd,de->bfe", prefix, params["frontend_proj"])
        x = torch.cat([prefix, x], dim=1)
        # loss only on token positions
        b, s = batch["tokens"].shape
        f = prefix.shape[1]
        mask = torch.cat([torch.zeros((b, f), dtype=torch.bool,
                                      device=x.device),
                          torch.ones((b, s), dtype=torch.bool,
                                     device=x.device)], dim=1)
    return x, mask


def forward(params, batch, cfg: ModelConfig,
            remat: bool = True) -> torch.Tensor:
    """Token-level logits (B, S_total, V)."""
    x, _ = _embed_inputs(params, batch, cfg)
    x = blocks.forward_stack(params["stack"], x, cfg, remat=remat)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return lm_logits(x, params["embed"], None)


def train_loss(params, batch, cfg: ModelConfig) -> torch.Tensor:
    """Mean token cross-entropy; every period rematerialised in the
    backward."""
    x, mask = _embed_inputs(params, batch, cfg)
    x = blocks.forward_stack(params["stack"], x, cfg, remat=True)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if mask is not None:
        f = x.shape[1] - batch["labels"].shape[1]
        x = x[:, f:, :]
    logits = lm_logits(x, params["embed"], None)
    return cross_entropy(logits, batch["labels"])


def prefill(params, batch, cfg: ModelConfig):
    """Prefill: returns (last-position logits, decode caches)."""
    x, _ = _embed_inputs(params, batch, cfg)
    x, caches = blocks.prefill_stack(params["stack"], x, cfg)
    x = rms_norm(x[:, -1:, :], params["final_norm"], cfg.norm_eps)
    logits = lm_logits(x, params["embed"], None)
    return logits, caches


def decode_step(params, caches, tokens, index, cfg: ModelConfig):
    """One decode step: tokens (B, 1), index = current absolute position
    (a scalar, or one per row)."""
    x = embed_tokens(params["embed"], tokens)
    x, caches = blocks.decode_stack(params["stack"], caches, x, index, cfg)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = lm_logits(x, params["embed"], None)
    return logits, caches


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                device="cuda"):
    return blocks.init_caches(cfg, batch, max_len, device=device)


def sample_batch(cfg: ModelConfig, batch: int, seq: int,
                 gen: torch.Generator, with_labels: bool = True) -> dict:
    """Concrete random batch on ``gen``'s device, for smoke runs."""
    dev = gen.device

    def tokens():
        return torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                             device=dev)

    out = {"tokens": tokens()}
    if with_labels:
        out["labels"] = tokens()
    if cfg.frontend != "none":
        out["prefix_embeds"] = torch.randn(
            (batch, cfg.frontend_tokens, cfg.d_model), generator=gen,
            device=dev).to(torch.bfloat16)
    return out
