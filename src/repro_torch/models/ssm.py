"""Mamba2 (SSD — state-space duality) mixer: chunked dual-form prefill and
O(1) recurrent decode.

The port of ``src/repro/models/ssm.py``. The chunked algorithm follows
arXiv:2405.21060: within chunks of length Q the dual "attention-like" form
runs as masked matmuls; across chunks a loop carries the (H, P, N) SSM
state. Decode is the pure recurrence. All state math is in f32, and every
decay exponent of the chunked form is clipped to [-60, 0] as the
reference's is.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .common import ModelConfig, cache_device, dense_init, full


class SSMParams(NamedTuple):
    in_proj: torch.Tensor    # (d, 2*d_inner + 2*N + H)
    conv_w: torch.Tensor     # (4, d_inner + 2*N) depthwise causal conv
    dt_bias: torch.Tensor    # (H,) f32
    a_log: torch.Tensor      # (H,) f32
    d_skip: torch.Tensor     # (H,) f32
    norm_g: torch.Tensor     # (d_inner,)
    out_proj: torch.Tensor   # (d_inner, d)


class SSMCache(NamedTuple):
    conv: torch.Tensor       # (B, 3, d_inner + 2*N) last inputs
    state: torch.Tensor      # (B, H, P, N) f32


def _dims(cfg: ModelConfig):
    d_inner = cfg.ssm_expand * cfg.d_model
    heads = d_inner // cfg.ssm_head_dim
    return d_inner, heads, cfg.ssm_state, cfg.ssm_head_dim


def init_ssm(gen, cfg: ModelConfig) -> SSMParams:
    d_inner, heads, n, _ = _dims(cfg)
    dt = cfg.param_dtype
    return SSMParams(
        in_proj=dense_init(gen, (cfg.d_model, 2 * d_inner + 2 * n + heads), dt),
        conv_w=dense_init(gen, (4, d_inner + 2 * n), dt, scale=0.5),
        dt_bias=full(gen, (heads,), 0.0, torch.float32),
        a_log=full(gen, (heads,), 0.0, torch.float32),
        d_skip=full(gen, (heads,), 1.0, torch.float32),
        norm_g=full(gen, (d_inner,), 1.0, dt),
        out_proj=dense_init(gen, (d_inner, cfg.d_model), dt),
    )


def ssm_param_logical() -> SSMParams:
    return SSMParams(in_proj=(None, "inner"), conv_w=(None, "inner"),
                     dt_bias=(None,), a_log=(None,), d_skip=(None,),
                     norm_g=("inner",), out_proj=("inner", None))


def _split_proj(p: SSMParams, x: torch.Tensor, cfg: ModelConfig):
    d_inner, heads, n, _ = _dims(cfg)
    zxbcdt = torch.einsum("bld,de->ble", x, p.in_proj)
    z = zxbcdt[..., :d_inner]
    xbc = zxbcdt[..., d_inner:2 * d_inner + 2 * n]
    dt = zxbcdt[..., 2 * d_inner + 2 * n:].float()
    return z, xbc, dt


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, kernel 4, over (B, L, C)."""
    pad = F.pad(xbc, (0, 0, 3, 0))
    out = sum(pad[:, i:i + xbc.shape[1], :] * w[i][None, None, :]
              for i in range(4))
    return F.silu(out)


def _rmsnorm_gated(y: torch.Tensor, z: torch.Tensor, g: torch.Tensor,
                   eps: float) -> torch.Tensor:
    y = y * F.silu(z.float())
    scale = torch.rsqrt(torch.mean(y * y, dim=-1, keepdim=True) + eps)
    return (y * scale).to(g.dtype) * g


def _decay(x: torch.Tensor) -> torch.Tensor:
    return torch.exp(torch.clamp(x, -60.0, 0.0))


def ssm_forward(p: SSMParams, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    out, _ = ssm_forward_with_cache(p, x, cfg, want_cache=False)
    return out


def ssm_forward_with_cache(p: SSMParams, x: torch.Tensor, cfg: ModelConfig,
                           want_cache: bool = True):
    """Chunked SSD over x (B, L, d). Ragged tails are zero-padded to the
    chunk size (zero inputs contribute nothing to the state; padded outputs
    are sliced off)."""
    d_inner, heads, n, hp = _dims(cfg)
    b, l_orig, _ = x.shape
    x_orig = x
    q = min(cfg.ssm_chunk, l_orig)
    pad = (-l_orig) % q
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
    l = l_orig + pad
    nchunks = l // q

    z, xbc, dt = _split_proj(p, x, cfg)
    xbc = _causal_conv(xbc, p.conv_w)
    xin = xbc[..., :d_inner]
    bmat = xbc[..., d_inner:d_inner + n].float()                  # (B,L,N)
    cmat = xbc[..., d_inner + n:].float()                         # (B,L,N)
    dt = F.softplus(dt + p.dt_bias)                               # (B,L,H)
    if pad:
        # Padded steps must neither decay the state (a = dt*A -> 0) nor
        # contribute to it (contribution is dt-scaled) — zero their dt.
        live = (torch.arange(l, device=x.device) < l_orig).to(dt.dtype)
        dt = dt * live[None, :, None]
    a = -torch.exp(p.a_log)                                       # (H,)
    xh = xin.reshape(b, l, heads, hp).float()                     # (B,L,H,P)

    # chunked layout
    dtc = dt.reshape(b, nchunks, q, heads)
    ac = dtc * a[None, None, None, :]                             # log-decay/step
    cum = torch.cumsum(ac, dim=2)                                 # (B,NC,Q,H)
    total = cum[:, :, -1:, :]                                     # (B,NC,1,H)
    bc = bmat.reshape(b, nchunks, q, n)
    cc = cmat.reshape(b, nchunks, q, n)
    xc = xh.reshape(b, nchunks, q, heads, hp)

    # intra-chunk (dual/attention form)
    scores = torch.einsum("bcin,bcjn->bcij", cc, bc)              # (B,NC,Q,Q)
    ii = torch.arange(q, device=x.device)[:, None]
    jj = torch.arange(q, device=x.device)[None, :]
    causal = (jj <= ii)[None, None, :, :, None]                   # (1,1,Q,Q,1)
    decay = _decay(cum[:, :, :, None, :] - cum[:, :, None, :, :])  # (B,NC,Q,Q,H)
    gate = torch.where(causal, scores[..., None] * decay, 0.0)
    gate = gate * dtc[:, :, None, :, :]                           # weight dt_j
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", gate, xc)

    # inter-chunk state recurrence
    in_decay = _decay(total - cum)                                # (B,NC,Q,H)
    state_in = torch.einsum("bcjh,bcjn,bcjhp->bchpn",
                            in_decay * dtc, bc, xc)               # per-chunk contrib
    chunk_decay = _decay(total[:, :, 0, :])                       # (B,NC,H)
    state = torch.zeros((b, heads, hp, n), dtype=torch.float32,
                        device=x.device)
    entering = []                 # the state *entering* each chunk
    for c in range(nchunks):
        entering.append(state)
        state = state * chunk_decay[:, c, :, None, None] + state_in[:, c]
    states = torch.stack(entering, dim=1)                         # (B,NC,H,P,N)

    out_decay = _decay(cum)                                       # (B,NC,Q,H)
    y_inter = torch.einsum("bcin,bchpn,bcih->bcihp", cc, states, out_decay)

    y = (y_intra + y_inter).reshape(b, l, heads, hp)
    y = y + p.d_skip[None, None, :, None] * xh
    y = y.reshape(b, l, d_inner)[:, :l_orig]
    y = _rmsnorm_gated(y, z[:, :l_orig], p.norm_g, cfg.norm_eps)
    out = torch.einsum("bld,de->ble", y.to(p.out_proj.dtype), p.out_proj)
    cache = None
    if want_cache:
        # conv state: last 3 *pre-conv* projected inputs (of the real, unpadded
        # sequence); ssm state: final carry. The carry includes padded
        # positions' contributions, which are zero by construction.
        _, xbc_raw, _ = _split_proj(p, x_orig[:, -3:, :], cfg)
        cache = SSMCache(conv=xbc_raw.to(p.conv_w.dtype), state=state)
    return out, cache


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------
def init_ssm_cache(cfg: ModelConfig, batch: int,
                   device="cuda") -> SSMCache:
    d_inner, heads, n, hp = _dims(cfg)
    device = cache_device(device)
    return SSMCache(
        conv=torch.zeros((batch, 3, d_inner + 2 * n), dtype=cfg.param_dtype,
                         device=device),
        state=torch.zeros((batch, heads, hp, n), dtype=torch.float32,
                          device=device),
    )


def ssm_decode_step(p: SSMParams, x: torch.Tensor, cache: SSMCache,
                    cfg: ModelConfig) -> tuple[torch.Tensor, SSMCache]:
    """One token: x (B, 1, d) -> (B, 1, d) with recurrent state update."""
    d_inner, heads, n, hp = _dims(cfg)
    b = x.shape[0]
    z, xbc, dt = _split_proj(p, x, cfg)                           # seq len 1
    hist = torch.cat([cache.conv, xbc], dim=1)                    # (B,4,C)
    conv = sum(hist[:, i, :] * p.conv_w[i][None, :] for i in range(4))
    conv = F.silu(conv)                                           # (B,C)
    xin = conv[:, :d_inner]
    bvec = conv[:, d_inner:d_inner + n].float()
    cvec = conv[:, d_inner + n:].float()
    dtv = F.softplus(dt[:, 0] + p.dt_bias)                        # (B,H)
    a = -torch.exp(p.a_log)
    alpha = torch.exp(dtv * a[None, :])                           # (B,H)
    xhead = xin.reshape(b, heads, hp).float()
    state = (cache.state * alpha[:, :, None, None]
             + torch.einsum("bh,bn,bhp->bhpn", dtv, bvec, xhead))
    y = torch.einsum("bn,bhpn->bhp", cvec, state)
    y = y + p.d_skip[None, :, None] * xhead
    y = y.reshape(b, 1, d_inner)
    y = _rmsnorm_gated(y, z, p.norm_g, cfg.norm_eps)
    out = torch.einsum("bld,de->ble", y.to(p.out_proj.dtype), p.out_proj)
    return out, SSMCache(conv=hist[:, 1:, :], state=state)
