"""Layer assembly: period-structured stacks.

The port of ``src/repro/models/blocks.py``. A model is a *period* of layer
positions repeated R times (num_layers = R * period). Uniform models have
period 1; gemma3 uses a 6-layer period (5 sliding-window + 1 global
attention); jamba an 8-layer period (7 Mamba + 1 attention, MoE on odd
positions). Parameters and KV/SSM caches stack along a leading R axis per
position, as the reference's do, and the depth runs as a Python loop over
the R repeats where the reference scans. Nothing here takes a gradient, so
there is no rematerialisation.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.tree import stack_trees, tree_map

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
def _repeat(tree: PyTree, r: int) -> PyTree:
    """Repeat ``r`` of a stacked nest (a view of every leaf)."""
    return tree_map(lambda a: a[r], tree)


def init_stack(gen, cfg: ModelConfig) -> list[PyTree]:
    """Per-position stacked params: list over period positions; each element
    has leaves with leading axis R = num_layers / period."""
    specs = build_period(cfg)
    repeats = cfg.num_layers // len(specs)
    return [stack_trees([init_layer(gen, spec, cfg) for _ in range(repeats)])
            for spec in specs]


def forward_stack(stack: list[PyTree], x: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    specs = build_period(cfg)
    for r in range(stack[0].norm1.shape[0]):
        for pos, spec in enumerate(specs):
            x = apply_layer(spec, _repeat(stack[pos], r), x, cfg)
    return x


def prefill_stack(stack: list[PyTree], x: torch.Tensor, cfg: ModelConfig
                  ) -> tuple[torch.Tensor, list[PyTree]]:
    """Forward pass that also emits decode caches for every layer."""
    specs = build_period(cfg)
    per_pos = [[] for _ in specs]
    for r in range(stack[0].norm1.shape[0]):
        for pos, spec in enumerate(specs):
            p = _repeat(stack[pos], r)
            hn = rms_norm(x, p.norm1, cfg.norm_eps)
            if spec.mixer == "ssm":
                out, c = ssm_lib.ssm_forward_with_cache(p.mixer, hn, cfg)
            else:
                out, c = attn_lib.prefill_attention(
                    p.mixer, hn, cfg, window=_window(spec, cfg))
            x = _ffn(spec, p, x + out, cfg)
            per_pos[pos].append(c)
    return x, [stack_trees(cs) for cs in per_pos]


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
    for r in range(stack[0].norm1.shape[0]):
        for pos, spec in enumerate(specs):
            p = _repeat(stack[pos], r)
            c = _repeat(caches[pos], r)
            hn = rms_norm(x, p.norm1, cfg.norm_eps)
            if spec.mixer == "ssm":
                out, c = ssm_lib.ssm_decode_step(p.mixer, hn, c, cfg)
            else:
                out, c = attn_lib.decode_attention(
                    p.mixer, hn, c, index, cfg, window=_window(spec, cfg))
            x = _ffn(spec, p, x + out, cfg)
            per_pos[pos].append(c)
    return x, [stack_trees(cs) for cs in per_pos]
