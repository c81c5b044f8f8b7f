"""Encoder-decoder assembly (seamless-m4t backbone).

The port of ``src/repro/models/encdec.py``. Encoder: bidirectional
attention over stub frame embeddings (the audio frontend provides
(B, T, d) directly). Decoder: causal self-attention, cross-attention to
the encoder's memory, and an MLP. Layers stack along a leading axis, as
the reference's do, and run as a Python loop over it; in the encoder and
in the decoder stack of ``train_loss`` every layer is rematerialised in
the backward, as the reference's ``jax.checkpoint`` does.

Params:
  {"embed": (V, d), "enc_stack": stacked EncLayer, "dec_stack": stacked
   DecLayer, "enc_norm": (d,), "final_norm": (d,), "frontend_proj": (d, d)}
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.tree import stack_trees

from . import attention as attn_lib
from . import mlp as mlp_lib
from .blocks import remat_call, unstack
from .common import (ModelConfig, cache_device, cross_entropy, dense_init,
                     embed_tokens, full, lm_logits, rms_norm, stacked_logical)

PyTree = Any


class EncLayer(NamedTuple):
    norm1: torch.Tensor
    attn: attn_lib.AttnParams
    norm2: torch.Tensor
    ffn: mlp_lib.MLPParams


class DecLayer(NamedTuple):
    norm1: torch.Tensor
    self_attn: attn_lib.AttnParams
    norm_x: torch.Tensor
    cross_attn: attn_lib.AttnParams
    norm2: torch.Tensor
    ffn: mlp_lib.MLPParams


def _init_enc_layer(gen, cfg: ModelConfig) -> EncLayer:
    g = full(gen, (cfg.d_model,), 1.0, cfg.param_dtype)
    return EncLayer(norm1=g, attn=attn_lib.init_attn(gen, cfg), norm2=g,
                    ffn=mlp_lib.init_mlp(gen, cfg))


def _init_dec_layer(gen, cfg: ModelConfig) -> DecLayer:
    g = full(gen, (cfg.d_model,), 1.0, cfg.param_dtype)
    return DecLayer(norm1=g, self_attn=attn_lib.init_attn(gen, cfg), norm_x=g,
                    cross_attn=attn_lib.init_attn(gen, cfg), norm2=g,
                    ffn=mlp_lib.init_mlp(gen, cfg))


def init_params(gen: Optional[torch.Generator], cfg: ModelConfig) -> PyTree:
    """Every parameter, drawn from ``gen`` on its device (on ``meta``,
    without allocating, for ``gen=None``)."""
    enc_layers = cfg.encoder_layers or cfg.num_layers
    return {
        "embed": dense_init(gen, (cfg.vocab_size, cfg.d_model),
                            cfg.param_dtype, scale=0.02),
        "frontend_proj": dense_init(gen, (cfg.d_model, cfg.d_model),
                                    cfg.param_dtype),
        "enc_stack": stack_trees([_init_enc_layer(gen, cfg)
                                  for _ in range(enc_layers)]),
        "dec_stack": stack_trees([_init_dec_layer(gen, cfg)
                                  for _ in range(cfg.num_layers)]),
        "enc_norm": full(gen, (cfg.d_model,), 1.0, cfg.param_dtype),
        "final_norm": full(gen, (cfg.d_model,), 1.0, cfg.param_dtype),
    }


def param_logical(cfg: ModelConfig) -> PyTree:
    a = attn_lib.attn_param_logical(cfg)
    m = mlp_lib.mlp_param_logical()
    enc = stacked_logical(EncLayer(norm1=(None,), attn=a, norm2=(None,),
                                   ffn=m))
    dec = stacked_logical(DecLayer(norm1=(None,), self_attn=a,
                                   norm_x=(None,), cross_attn=a,
                                   norm2=(None,), ffn=m))
    return {"embed": ("vocab", None), "frontend_proj": (None, None),
            "enc_stack": enc, "dec_stack": dec,
            "enc_norm": (None,), "final_norm": (None,)}


def _encode(params, frames: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = torch.einsum("btd,de->bte", frames.to(cfg.param_dtype),
                     params["frontend_proj"])

    def layer(h, p: EncLayer):
        hn = rms_norm(h, p.norm1, cfg.norm_eps)
        h = h + _bidir_attention(p.attn, hn, cfg)
        hn = rms_norm(h, p.norm2, cfg.norm_eps)
        return h + mlp_lib.mlp(p.ffn, hn, cfg)

    for p in unstack(params["enc_stack"]):
        x = remat_call(layer, True, x, p)
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _bidir_attention(p: attn_lib.AttnParams, x: torch.Tensor,
                     cfg: ModelConfig) -> torch.Tensor:
    """Encoder self-attention: full (non-causal) mask."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    q, k, v = attn_lib._project_qkv(p, x, positions, cfg)
    probs = torch.softmax(attn_lib._gqa_scores(q, k, cfg), dim=-1)
    return attn_lib._gqa_out(probs, v, p.wo)


def _cross(p: DecLayer, h: torch.Tensor, mem_k, mem_v,
           cfg: ModelConfig) -> torch.Tensor:
    """A decoder layer's cross-attention and MLP halves, residuals added."""
    hn = rms_norm(h, p.norm_x, cfg.norm_eps)
    h = h + attn_lib.cross_attention(p.cross_attn, hn, mem_k, mem_v, cfg)
    hn = rms_norm(h, p.norm2, cfg.norm_eps)
    return h + mlp_lib.mlp(p.ffn, hn, cfg)


def _decode_stack(params, x: torch.Tensor, memory: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    def layer(h, p: DecLayer):
        hn = rms_norm(h, p.norm1, cfg.norm_eps)
        h = h + attn_lib.attention(p.self_attn, hn, cfg)
        mk, mv = attn_lib.project_memory_kv(p.cross_attn, memory)
        return _cross(p, h, mk, mv, cfg)

    for p in unstack(params["dec_stack"]):
        x = remat_call(layer, True, x, p)
    return x


def train_loss(params, batch, cfg: ModelConfig) -> torch.Tensor:
    memory = _encode(params, batch["frames"], cfg)
    x = embed_tokens(params["embed"], batch["tokens"])
    x = _decode_stack(params, x, memory, cfg)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = lm_logits(x, params["embed"], None)
    return cross_entropy(logits, batch["labels"])


def prefill(params, batch, cfg: ModelConfig):
    """Encode + decoder prefill. Caches: (self KV per layer, memory KV per
    layer in bf16); ``decode_step`` reuses both."""
    memory = _encode(params, batch["frames"], cfg)
    x = embed_tokens(params["embed"], batch["tokens"])
    per_layer = []
    for p in unstack(params["dec_stack"]):
        hn = rms_norm(x, p.norm1, cfg.norm_eps)
        out, kv = attn_lib.prefill_attention(p.self_attn, hn, cfg)
        mk, mv = attn_lib.project_memory_kv(p.cross_attn, memory)
        x = _cross(p, x + out, mk, mv, cfg)
        per_layer.append((kv, (mk.to(torch.bfloat16), mv.to(torch.bfloat16))))
    x = rms_norm(x[:, -1:, :], params["final_norm"], cfg.norm_eps)
    return lm_logits(x, params["embed"], None), stack_trees(per_layer)


def decode_step(params, caches, tokens, index, cfg: ModelConfig):
    """One decode step: tokens (B, 1), index = current absolute position
    (a scalar, or one per row)."""
    x = embed_tokens(params["embed"], tokens)
    self_kv, mem_kv = caches
    new_kv = []
    for p, kv, mem in zip(unstack(params["dec_stack"]), unstack(self_kv),
                          unstack(mem_kv)):
        hn = rms_norm(x, p.norm1, cfg.norm_eps)
        out, kv = attn_lib.decode_attention(p.self_attn, hn, kv, index, cfg)
        x = _cross(p, x + out, mem[0], mem[1], cfg)
        new_kv.append(kv)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return lm_logits(x, params["embed"], None), (stack_trees(new_kv), mem_kv)


def init_caches(cfg: ModelConfig, batch: int, max_len: int, mem_len: int,
                device="cuda"):
    """(self KV, memory KV) zeros for every decoder layer in bf16, on
    ``device`` (the card by default; ``meta`` allocates nothing)."""
    device = cache_device(device)
    hd = cfg.resolved_head_dim

    def zeros(length):
        return torch.zeros((cfg.num_layers, batch, length, cfg.num_kv_heads,
                            hd), dtype=torch.bfloat16, device=device)

    return (attn_lib.KVCache(k=zeros(max_len), v=zeros(max_len)),
            (zeros(mem_len), zeros(mem_len)))


def sample_batch(cfg: ModelConfig, batch: int, seq: int,
                 gen: torch.Generator, with_labels: bool = True) -> dict:
    """Concrete random batch on ``gen``'s device, for smoke runs."""
    dev = gen.device

    def tokens():
        return torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                             device=dev)

    out = {"tokens": tokens(),
           "frames": torch.randn((batch, seq, cfg.d_model), generator=gen,
                                 device=dev).to(torch.bfloat16)}
    if with_labels:
        out["labels"] = tokens()
    return out
