"""Grouped-query attention: training/prefill (full + sliding window) and
cached single-token decode. GQA never materializes repeated KV heads — score
einsums keep a (kv_heads, q_per_kv) split so memory matches the cache.

The port of ``src/repro/models/attention.py``: scores and softmax in f32,
the context cast back to the output projection's dtype, KV caches in bf16,
sliding-window caches as ring buffers. Cache updates are functional, as the
reference's ``.at[...].set``: ``decode_attention`` returns new cache tensors
and leaves the ones it was given untouched.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from .common import ModelConfig, cache_device, dense_init, full, rope

NEG_INF = -1e30


class AttnParams(NamedTuple):
    wq: torch.Tensor            # (d, H, hd)
    wk: torch.Tensor            # (d, KV, hd)
    wv: torch.Tensor            # (d, KV, hd)
    wo: torch.Tensor            # (H, hd, d)
    bq: Optional[torch.Tensor]  # (H, hd) or None
    bk: Optional[torch.Tensor]
    bv: Optional[torch.Tensor]


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, S_max, KV, hd)
    v: torch.Tensor


def init_attn(gen, cfg: ModelConfig) -> AttnParams:
    hd = cfg.resolved_head_dim
    d = cfg.d_model
    dt = cfg.param_dtype

    def bias(shape):
        return full(gen, shape, 0.0, dt) if cfg.qkv_bias else None

    return AttnParams(
        wq=dense_init(gen, (d, cfg.num_heads, hd), dt),
        wk=dense_init(gen, (d, cfg.num_kv_heads, hd), dt),
        wv=dense_init(gen, (d, cfg.num_kv_heads, hd), dt),
        wo=dense_init(gen, (cfg.num_heads, hd, d), dt),
        bq=bias((cfg.num_heads, hd)),
        bk=bias((cfg.num_kv_heads, hd)),
        bv=bias((cfg.num_kv_heads, hd)),
    )


def attn_param_logical(cfg: ModelConfig) -> AttnParams:
    """Logical axis names per parameter (layer-stacked callers prepend None).
    Bias entries are None when the config has no QKV bias, matching the
    params nesting exactly."""
    b = cfg.qkv_bias
    return AttnParams(
        wq=(None, "heads", None), wk=(None, "kv_heads", None),
        wv=(None, "kv_heads", None), wo=("heads", None, None),
        bq=("heads", None) if b else None,
        bk=("kv_heads", None) if b else None,
        bv=("kv_heads", None) if b else None,
    )


def _project_qkv(p: AttnParams, x: torch.Tensor, positions, cfg: ModelConfig):
    q = torch.einsum("bsd,dhk->bshk", x, p.wq)
    k = torch.einsum("bsd,dgk->bsgk", x, p.wk)
    v = torch.einsum("bsd,dgk->bsgk", x, p.wv)
    if p.bq is not None:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _gqa_scores(q: torch.Tensor, k: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """q (B,S,H,hd) x k (B,T,KV,hd) -> (B, KV, qpk, S, T) in f32 (the
    products of bf16 inputs are exact in f32, as the reference's
    ``preferred_element_type``)."""
    b, s, h, hd = q.shape
    qg = q.reshape(b, s, cfg.num_kv_heads, cfg.q_per_kv, hd)
    scores = torch.einsum("bsgqk,btgk->bgqst", qg.float(), k.float())
    return scores / torch.sqrt(torch.tensor(float(hd), dtype=torch.float32))


def _gqa_out(probs: torch.Tensor, v: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """probs (B,KV,qpk,S,T) f32 x v (B,T,KV,hd) -> (B,S,d)."""
    ctx = torch.einsum("bgqst,btgk->bsgqk", probs, v.to(probs.dtype))
    b, s, g, qpk, hd = ctx.shape
    ctx = ctx.reshape(b, s, g * qpk, hd).to(wo.dtype)
    return torch.einsum("bshk,hkd->bsd", ctx, wo)


def attention(p: AttnParams, x: torch.Tensor, cfg: ModelConfig,
              window: int = 0) -> torch.Tensor:
    """Causal self-attention over x (B,S,d); window>0 = sliding window."""
    out, _ = _attention_impl(p, x, cfg, window, want_cache=False)
    return out


def prefill_attention(p: AttnParams, x: torch.Tensor, cfg: ModelConfig,
                      window: int = 0) -> tuple[torch.Tensor, KVCache]:
    """Causal attention that also emits the KV cache for decode.

    Global layers cache all S positions. Sliding-window layers cache the last
    ``window`` positions laid out in ring-buffer order (position t at slot
    t %% window) so ``decode_attention`` continues seamlessly at index S; a
    prompt shorter than the window caches its S positions at slots 0..S-1.
    """
    return _attention_impl(p, x, cfg, window, want_cache=True)


def _attention_impl(p: AttnParams, x: torch.Tensor, cfg: ModelConfig,
                    window: int, want_cache: bool):
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    q, k, v = _project_qkv(p, x, positions, cfg)
    if cfg.attn_chunk and s > cfg.attn_chunk:
        out = _chunked_causal_attention(q, k, v, p.wo, cfg, window)
    else:
        scores = _gqa_scores(q, k, cfg)
        i = torch.arange(s, device=x.device)[:, None]
        j = torch.arange(s, device=x.device)[None, :]
        mask = j <= i
        if window:
            mask &= (i - j) < window
        scores = torch.where(mask, scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        out = _gqa_out(probs, v, p.wo)
    cache = None
    if want_cache:
        if window and s >= window:
            offset = (s - window) % window
            kc = torch.roll(k[:, s - window:], offset, dims=1)
            vc = torch.roll(v[:, s - window:], offset, dims=1)
        else:
            kc, vc = k, v
        cache = KVCache(k=kc.to(torch.bfloat16), v=vc.to(torch.bfloat16))
    return out, cache


def _chunked_causal_attention(q, k, v, wo, cfg: ModelConfig,
                              window: int) -> torch.Tensor:
    """Flash-style tiled attention: an outer loop over query chunks and an
    inner loop over KV chunks with the online-softmax recurrence, so the
    (S, T) score matrix never materializes: peak extra memory is one
    (B, KV, qpk, Qc, Tc) tile. Enabled via ``cfg.attn_chunk``."""
    b, s, h, hd = q.shape
    kv = cfg.num_kv_heads
    qpk = cfg.q_per_kv
    qc = min(cfg.attn_chunk, s)
    tc = min(cfg.attn_chunk, s)
    if s % qc or s % tc:
        raise ValueError(f"sequence {s} is not a multiple of attn_chunk "
                         f"{cfg.attn_chunk}")
    nq, nt = s // qc, s // tc
    scale = 1.0 / math.sqrt(hd)
    dev = q.device

    qg = q.reshape(b, nq, qc, kv, qpk, hd)
    kg = k.reshape(b, nt, tc, kv, hd)
    vg = v.reshape(b, nt, tc, kv, hd)

    tiles = []
    for qi in range(nq):
        q_tile = qg[:, qi]                               # (B, Qc, KV, qpk, hd)
        m = torch.full((b, kv, qpk, qc), -math.inf, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, kv, qpk, qc), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, kv, qpk, qc, hd), dtype=torch.float32,
                          device=dev)
        for tj in range(nt):
            kj, vj = kg[:, tj], vg[:, tj]                # (B, Tc, KV, hd)
            sc = torch.einsum("bqgph,btgh->bgpqt", q_tile.float(),
                              kj.float()) * scale
            qpos = qi * qc + torch.arange(qc, device=dev)[:, None]
            kpos = tj * tc + torch.arange(tc, device=dev)[None, :]
            mask = kpos <= qpos
            if window:
                mask &= (qpos - kpos) < window
            sc = torch.where(mask, sc, NEG_INF)
            m_new = torch.maximum(m, sc.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            pr = torch.exp(sc - m_new[..., None])
            l = l * alpha + pr.sum(dim=-1)
            pv = torch.einsum("bgpqt,btgh->bgpqh", pr.to(vj.dtype), vj)
            acc = acc * alpha[..., None] + pv.float()
            m = m_new
        out = acc / torch.clamp(l[..., None], min=1e-30)  # (B,KV,qpk,Qc,hd)
        tiles.append(torch.movedim(out, 3, 1))             # (B,Qc,KV,qpk,hd)
    ctx = torch.cat(tiles, dim=1) if nq > 1 else tiles[0]
    ctx = ctx.reshape(b, s, h, hd).to(wo.dtype)
    return torch.einsum("bshk,hkd->bsd", ctx, wo)


def cross_attention(p: AttnParams, x: torch.Tensor, mem_k: torch.Tensor,
                    mem_v: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Decoder cross-attention against precomputed encoder K/V (B,T,KV,hd);
    no RoPE and no mask."""
    q = torch.einsum("bsd,dhk->bshk", x, p.wq)
    if p.bq is not None:
        q = q + p.bq
    probs = torch.softmax(_gqa_scores(q, mem_k, cfg), dim=-1)
    return _gqa_out(probs, mem_v, p.wo)


def project_memory_kv(p: AttnParams, mem: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The encoder memory (B,T,d) projected to cross-attention K and V."""
    k = torch.einsum("btd,dgk->btgk", mem, p.wk)
    v = torch.einsum("btd,dgk->btgk", mem, p.wv)
    if p.bk is not None:
        k, v = k + p.bk, v + p.bv
    return k, v


# --------------------------------------------------------------------------
# cached decode
# --------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> KVCache:
    shape = (batch, max_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    device = cache_device(device)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def decode_attention(p: AttnParams, x: torch.Tensor, cache: KVCache,
                     index, cfg: ModelConfig,
                     window: int = 0) -> tuple[torch.Tensor, KVCache]:
    """One-token step. x: (B,1,d); index: current position — a scalar
    (lockstep batch) or a per-row (B,) tensor (continuous batching in the
    serve engine). Every row's slot must lie inside the cache.

    For sliding-window layers the cache is a ring buffer of the cache's
    length; for global layers it holds the full context.
    """
    b = x.shape[0]
    index = torch.as_tensor(index, device=x.device)
    idx_rows = (index if index.ndim == 1 else index.expand(b)).long()
    q, k_new, v_new = _project_qkv(p, x, idx_rows[:, None], cfg)
    max_len = cache.k.shape[1]
    slots = idx_rows % max_len if window else idx_rows
    rows = torch.arange(b, device=x.device)
    k = cache.k.index_put((rows, slots), k_new[:, 0].to(cache.k.dtype))
    v = cache.v.index_put((rows, slots), v_new[:, 0].to(cache.v.dtype))
    scores = _gqa_scores(q, k, cfg)                   # (B,KV,qpk,1,S_max)
    t = torch.arange(max_len, device=x.device)[None, :]
    if window:
        # ring: every slot is live once the context has wrapped
        valid = (t <= slots[:, None]) | (idx_rows[:, None] >= max_len)
    else:
        valid = t <= idx_rows[:, None]
    scores = torch.where(valid[:, None, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = _gqa_out(probs, v, p.wo)
    return out, KVCache(k=k, v=v)
