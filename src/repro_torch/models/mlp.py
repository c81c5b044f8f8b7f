"""Feed-forward layers: SwiGLU/GeLU MLP and capacity-based top-k MoE.

The port of ``src/repro/models/mlp.py``. MoE uses the grouped one-hot
dispatch formulation (T5X/Mixtral-style): tokens are processed in groups of
at most ``moe_group_size`` (the largest divisor of the token count); within
a group, top-k routing (softmax over the k chosen logits) builds a
(tokens, experts, capacity) dispatch tensor and two einsums move tokens to
experts and back. A token's choice past its expert's capacity is dropped.
The router, the dispatch and the combine run in f32; the expert FFNs in the
parameters' dtype.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from .common import ModelConfig, dense_init


class MLPParams(NamedTuple):
    w_in: torch.Tensor    # (d, ff) gate/up fused for swiglu: (d, 2*ff)
    w_out: torch.Tensor   # (ff, d)


class MoEParams(NamedTuple):
    router: torch.Tensor          # (d, E) f32
    w_in: torch.Tensor            # (E, d, 2*ff or ff)
    w_out: torch.Tensor           # (E, ff, d)
    dense: Optional[MLPParams]    # arctic's parallel dense residual


def init_mlp(gen, cfg: ModelConfig, d_ff: Optional[int] = None) -> MLPParams:
    d_ff = d_ff or cfg.d_ff
    width = 2 * d_ff if cfg.act == "swiglu" else d_ff
    return MLPParams(
        w_in=dense_init(gen, (cfg.d_model, width), cfg.param_dtype),
        w_out=dense_init(gen, (d_ff, cfg.d_model), cfg.param_dtype),
    )


def mlp_param_logical() -> MLPParams:
    return MLPParams(w_in=(None, "ff"), w_out=("ff", None))


def init_moe(gen, cfg: ModelConfig) -> MoEParams:
    e = cfg.num_experts
    ff = cfg.moe_d_ff or cfg.d_ff
    width = 2 * ff if cfg.act == "swiglu" else ff
    return MoEParams(
        router=dense_init(gen, (cfg.d_model, e), torch.float32),
        w_in=dense_init(gen, (e, cfg.d_model, width), cfg.param_dtype),
        w_out=dense_init(gen, (e, ff, cfg.d_model), cfg.param_dtype),
        dense=init_mlp(gen, cfg) if cfg.dense_residual else None,
    )


def moe_param_logical(cfg: ModelConfig) -> MoEParams:
    return MoEParams(
        router=(None, None),
        w_in=("experts", None, "expert_ff"),
        w_out=("experts", "expert_ff", None),
        dense=mlp_param_logical() if cfg.dense_residual else None,
    )


def _act(h: torch.Tensor, act: str, d_ff: int) -> torch.Tensor:
    if act == "swiglu":
        gate, up = h[..., :d_ff], h[..., d_ff:]
        return F.silu(gate) * up
    return F.gelu(h, approximate="tanh")     # jax.nn.gelu's default


def mlp(p: MLPParams, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    d_ff = p.w_out.shape[0]
    h = torch.einsum("bsd,df->bsf", x, p.w_in)
    h = _act(h, cfg.act, d_ff)
    return torch.einsum("bsf,fd->bsd", h, p.w_out)


def moe(p: MoEParams, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Top-k MoE over x (B, S, d)."""
    b, s, d = x.shape
    e = cfg.num_experts
    topk = cfg.experts_per_tok
    ff = cfg.moe_d_ff or cfg.d_ff
    t = b * s
    g = max(1, min(cfg.moe_group_size, t))
    while t % g:  # largest divisor of T <= moe_group_size
        g -= 1
    ng = t // g
    xg = x.reshape(ng, g, d)

    logits = torch.einsum("ngd,de->nge", xg.float(), p.router)
    weights, experts = torch.topk(logits, topk, dim=-1)     # (ng, g, topk)
    weights = torch.softmax(weights, dim=-1)

    cap = int(g * topk / e * cfg.capacity_factor)
    cap = max(cap, topk)
    onehot = F.one_hot(experts, e).float()                   # (ng, g, topk, e)
    # position of each (token, choice) in its expert's buffer
    pos = torch.cumsum(onehot.reshape(ng, g * topk, e), dim=1).reshape(
        ng, g, topk, e) * onehot - 1.0
    keep = (pos < cap) & (onehot > 0)
    pos = torch.where(keep, pos, 0.0).long()
    # (ng, g, topk, e, cap): 1 where (token, choice) lands in (expert, slot);
    # masked by keep (capacity overflow drops the token's choice).
    poshot = F.one_hot(pos, cap).float() * keep[..., None]
    dispatch = poshot.sum(dim=2)                             # (ng, g, e, cap)
    combine = (weights[..., None, None] * poshot).sum(dim=2)

    xe = torch.einsum("ngec,ngd->necd", dispatch, xg.float()).to(x.dtype)
    h = torch.einsum("necd,edf->necf", xe, p.w_in)
    h = _act(h, cfg.act, ff)
    ye = torch.einsum("necf,efd->necd", h, p.w_out)
    y = torch.einsum("ngec,necd->ngd", combine, ye.float())
    y = y.to(x.dtype).reshape(b, s, d)
    if p.dense is not None:
        y = y + mlp(p.dense, x, cfg)
    return y
