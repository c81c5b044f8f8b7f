"""Layer assembly: period-structured stacks.

The port of ``src/repro/models/blocks.py``. A model is a *period* of layer
positions repeated R times (num_layers = R * period). Uniform models have
period 1; gemma3 uses a 6-layer period (5 sliding-window + 1 global
attention); jamba an 8-layer period (7 Mamba + 1 attention, MoE on odd
positions). Parameters and KV/SSM caches stack along a leading R axis per
position, as the reference's do, and the depth runs as a Python loop over
the R repeats where the reference scans. Each stacked leaf is split into
its repeats with one ``torch.unbind`` per pass, so a backward stacks each
leaf's gradients once (indexing ``a[r]`` would give every repeat a
backward that zero-fills the whole stacked shape). With ``remat`` (the
reference's ``jax.checkpoint`` of each period) every period runs under
``torch.utils.checkpoint``, which keeps only the period's input and
recomputes the rest in the backward; it takes effect only while autograd
records.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.tree import (stack_trees, tree_leaves, tree_map,
                              tree_unflatten)

from . import attention as attn_lib
from . import mlp as mlp_lib
from . import ssm as ssm_lib
from .common import ModelConfig, cache_device, full, rms_norm

PyTree = Any


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str  # "attn" | "attn_local" | "ssm"
    ffn: str    # "mlp" | "moe" | "none"


def build_period(cfg: ModelConfig) -> list[LayerSpec]:
    """Derive the layer period from the config's structural knobs."""
    period_len = 1
    if cfg.local_global_period:
        period_len = cfg.local_global_period
    if cfg.attn_period:
        period_len = max(period_len, cfg.attn_period)
    if cfg.num_experts and cfg.moe_every > 1:
        period_len = max(period_len, cfg.moe_every)
    if cfg.num_layers % period_len:
        raise ValueError(f"{cfg.name}: {cfg.num_layers} layers not divisible "
                         f"by period {period_len}")
    specs = []
    for i in range(period_len):
        if not cfg.is_attn_layer(i):
            mixer = "ssm"
        elif cfg.is_global_attn_layer(i) or not cfg.sliding_window:
            mixer = "attn"
        else:
            mixer = "attn_local"
        if cfg.d_ff == 0 and not cfg.num_experts:
            ffn = "none"
        elif cfg.is_moe_layer(i):
            ffn = "moe"
        else:
            ffn = "mlp"
        specs.append(LayerSpec(mixer=mixer, ffn=ffn))
    return specs


class LayerParams(NamedTuple):
    norm1: torch.Tensor
    mixer: PyTree                   # AttnParams | SSMParams
    norm2: Optional[torch.Tensor]
    ffn: Optional[PyTree]           # MLPParams | MoEParams | None


def init_layer(gen, spec: LayerSpec, cfg: ModelConfig) -> LayerParams:
    if spec.mixer == "ssm":
        mixer = ssm_lib.init_ssm(gen, cfg)
    else:
        mixer = attn_lib.init_attn(gen, cfg)
    if spec.ffn == "moe":
        ffn = mlp_lib.init_moe(gen, cfg)
    elif spec.ffn == "mlp":
        ffn = mlp_lib.init_mlp(gen, cfg)
    else:
        ffn = None
    g = full(gen, (cfg.d_model,), 1.0, cfg.param_dtype)
    return LayerParams(norm1=g, mixer=mixer,
                       norm2=g if ffn is not None else None, ffn=ffn)


def layer_param_logical(spec: LayerSpec, cfg: ModelConfig) -> LayerParams:
    mixer = (ssm_lib.ssm_param_logical() if spec.mixer == "ssm"
             else attn_lib.attn_param_logical(cfg))
    if spec.ffn == "moe":
        ffn = mlp_lib.moe_param_logical(cfg)
    elif spec.ffn == "mlp":
        ffn = mlp_lib.mlp_param_logical()
    else:
        ffn = None
    return LayerParams(norm1=(None,), mixer=mixer,
                       norm2=(None,) if ffn is not None else None, ffn=ffn)


def _window(spec: LayerSpec, cfg: ModelConfig) -> int:
    """The attention window of a position's mixer (0: global)."""
    return cfg.sliding_window if spec.mixer == "attn_local" else 0


def _ffn(spec: LayerSpec, p: LayerParams, x: torch.Tensor,
         cfg: ModelConfig) -> torch.Tensor:
    if p.ffn is not None:
        h = rms_norm(x, p.norm2, cfg.norm_eps)
        if spec.ffn == "moe":
            x = x + mlp_lib.moe(p.ffn, h, cfg)
        else:
            x = x + mlp_lib.mlp(p.ffn, h, cfg)
    return x


def apply_layer(spec: LayerSpec, p: LayerParams, x: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    h = rms_norm(x, p.norm1, cfg.norm_eps)
    if spec.mixer == "ssm":
        x = x + ssm_lib.ssm_forward(p.mixer, h, cfg)
    else:
        x = x + attn_lib.attention(p.mixer, h, cfg, window=_window(spec, cfg))
    return _ffn(spec, p, x, cfg)


# --------------------------------------------------------------------------
# stacked periods
# --------------------------------------------------------------------------
def unstack(tree: PyTree) -> list[PyTree]:
    """A stacked nest as one nest per repeat (views), with one
    ``torch.unbind`` per leaf."""
    parts = [leaf.unbind(0) for leaf in tree_leaves(tree)]
    repeats = len(parts[0]) if parts else 0
    return [tree_unflatten(tree, (p[r] for p in parts))
            for r in range(repeats)]


def remat_call(fn, remat: bool, *args):
    """``fn(*args)``, rematerialised in the backward when ``remat`` and
    autograd records (the reference's ``jax.checkpoint``)."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def init_stack(gen, cfg: ModelConfig) -> list[PyTree]:
    """Per-position stacked params: list over period positions; each element
    has leaves with leading axis R = num_layers / period."""
    specs = build_period(cfg)
    repeats = cfg.num_layers // len(specs)
    return [stack_trees([init_layer(gen, spec, cfg) for _ in range(repeats)])
            for spec in specs]


def forward_stack(stack: list[PyTree], x: torch.Tensor, cfg: ModelConfig,
                  remat: bool = True) -> torch.Tensor:
    specs = build_period(cfg)

    def period(h, layers):
        for spec, p in zip(specs, layers):
            h = apply_layer(spec, p, h, cfg)
        return h

    for layers in zip(*map(unstack, stack)):
        x = remat_call(period, remat, x, layers)
    return x


def prefill_stack(stack: list[PyTree], x: torch.Tensor, cfg: ModelConfig,
                  remat: bool = True) -> tuple[torch.Tensor, list[PyTree]]:
    """Forward pass that also emits decode caches for every layer."""
    specs = build_period(cfg)

    def period(h, layers):
        caches = []
        for spec, p in zip(specs, layers):
            hn = rms_norm(h, p.norm1, cfg.norm_eps)
            if spec.mixer == "ssm":
                out, c = ssm_lib.ssm_forward_with_cache(p.mixer, hn, cfg)
            else:
                out, c = attn_lib.prefill_attention(
                    p.mixer, hn, cfg, window=_window(spec, cfg))
            h = _ffn(spec, p, h + out, cfg)
            caches.append(c)
        return h, caches

    per_period = []
    for layers in zip(*map(unstack, stack)):
        x, caches = remat_call(period, remat, x, layers)
        per_period.append(caches)
    return x, [stack_trees(cs) for cs in zip(*per_period)]


# --------------------------------------------------------------------------
# decode with caches
# --------------------------------------------------------------------------
def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                device="cuda") -> list[PyTree]:
    """Per-position stacked caches (leading R axis), matching init_stack,
    on ``device`` (the card by default; ``meta`` allocates nothing). Every
    leaf is a tensor of its own (zeros), so writing one slot of one layer
    touches nothing else."""
    device = cache_device(device)
    specs = build_period(cfg)
    repeats = cfg.num_layers // len(specs)
    caches = []
    for spec in specs:
        if spec.mixer == "ssm":
            c = ssm_lib.init_ssm_cache(cfg, batch, device=device)
        else:
            length = (min(cfg.sliding_window, max_len)
                      if spec.mixer == "attn_local" else max_len)
            c = attn_lib.init_cache(cfg, batch, length, device=device)
        caches.append(tree_map(
            lambda a: a[None].expand((repeats,) + a.shape).contiguous(), c))
    return caches


def pad_caches(caches: list[PyTree], cfg: ModelConfig,
               new_len: int) -> list[PyTree]:
    """Grow KV caches (axis: length) with zeros so decode can append:
    global caches to ``new_len``, and sliding-window (ring) caches shorter
    than ``min(window, new_len)`` — a prompt shorter than the window — to
    that length, the ring's size in ``init_caches``. The zero slots stay
    masked by ``decode_attention`` until written. SSM caches are
    length-invariant.

    The reference grows only global caches (``src/repro/models/blocks.py``
    ``pad_caches``), so its engine cannot take a prompt shorter than the
    window; this one can."""
    specs = build_period(cfg)
    out = []
    for spec, c in zip(specs, caches):
        if spec.mixer != "ssm" and isinstance(c, attn_lib.KVCache):
            want = (new_len if spec.mixer == "attn"
                    else min(cfg.sliding_window, new_len))
            cur = c.k.shape[2]  # (R, B, L, KV, hd)
            if cur < want:
                widths = (0, 0, 0, 0, 0, want - cur)
                c = attn_lib.KVCache(k=F.pad(c.k, widths),
                                     v=F.pad(c.v, widths))
        out.append(c)
    return out


def decode_stack(stack: list[PyTree], caches: list[PyTree], x: torch.Tensor,
                 index, cfg: ModelConfig) -> tuple[torch.Tensor, list[PyTree]]:
    """One-token step through the whole depth; returns (x, new caches)."""
    specs = build_period(cfg)
    per_pos = [[] for _ in specs]
    for layers, layer_caches in zip(zip(*map(unstack, stack)),
                                    zip(*map(unstack, caches))):
        for pos, spec in enumerate(specs):
            p, c = layers[pos], layer_caches[pos]
            hn = rms_norm(x, p.norm1, cfg.norm_eps)
            if spec.mixer == "ssm":
                out, c = ssm_lib.ssm_decode_step(p.mixer, hn, c, cfg)
            else:
                out, c = attn_lib.decode_attention(
                    p.mixer, hn, c, index, cfg, window=_window(spec, cfg))
            x = _ffn(spec, p, x + out, cfg)
            per_pos[pos].append(c)
    return x, [stack_trees(cs) for cs in per_pos]
