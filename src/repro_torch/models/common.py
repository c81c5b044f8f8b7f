"""Shared model substrate of the port: config, parameters as nests of
tensors, norms, RoPE, embeddings.

Models are nests of tensors plus plain functions, in the reference's
layout (``src/repro/models``): ``init_params(gen, cfg)`` draws the
parameters from a ``torch.Generator`` on the device they live on, or,
given no generator, describes them on the ``meta`` device without
allocating; forward functions are pure functions of tensors. Layers stack
along a leading axis per period position, as the reference's do, and run
as a Python loop over that axis in place of its ``lax.scan``.

Casts follow the reference exactly: bf16 products stay bf16, and the
places it computes in f32 (norms, RoPE, attention scores, logits) do so
here too.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device

PyTree = Any


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 => d_model // num_heads
    # attention
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    sliding_window: int = 0          # 0 = full attention
    local_global_period: int = 0     # gemma3: period length; last layer global
    attn_chunk: int = 0              # >0: flash-style tiled attention
    # moe
    num_experts: int = 0
    experts_per_tok: int = 0
    moe_d_ff: int = 0                # expert hidden dim (defaults to d_ff)
    moe_every: int = 1               # MoE on layers where (i % moe_every)==moe_offset
    moe_offset: int = 0
    dense_residual: bool = False     # arctic: dense FFN in parallel with MoE
    moe_group_size: int = 4096
    capacity_factor: float = 1.25
    # ssm / hybrid
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    attn_period: int = 0             # jamba: 1 attention layer per this many
    attn_offset: int = 0             # position of the attention layer in period
    # encoder-decoder
    encoder_layers: int = 0
    # frontends (stubbed modalities)
    frontend: str = "none"           # none | patches | frames
    frontend_tokens: int = 0         # prefix positions fed by the stub frontend
    # misc
    norm_eps: float = 1e-5
    act: str = "swiglu"              # swiglu | gelu
    tie_embeddings: bool = False
    param_dtype: Any = torch.bfloat16
    fsdp_params: bool = False        # giant models: extra data-axis sharding
    # Carried as data: the reference unrolls its layer scan for XLA's cost
    # analysis; the port's layer loop is a Python loop either way.
    scan_unroll: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    def is_moe_layer(self, i: int) -> bool:
        return (self.num_experts > 0
                and i % self.moe_every == self.moe_offset % self.moe_every)

    def is_attn_layer(self, i: int) -> bool:
        """hybrid: which layers use attention (vs Mamba); dense: all."""
        if self.family == "ssm":
            return False
        if self.attn_period:
            return i % self.attn_period == self.attn_offset
        return True

    def is_global_attn_layer(self, i: int) -> bool:
        """gemma3-style local:global interleave; others: all global unless
        sliding_window set without a period (then all local)."""
        if not self.local_global_period:
            return self.sliding_window == 0
        return (i + 1) % self.local_global_period == 0


def make_generator(seed: int = 0,
                   device: str | torch.device = "cuda") -> torch.Generator:
    """A ``torch.Generator`` seeded with ``seed`` on ``device`` (the card
    by default, through ``resolve_device``): ``init_params`` draws every
    parameter there."""
    return torch.Generator(device=resolve_device(device)).manual_seed(seed)


# --------------------------------------------------------------------------
# init helpers
# --------------------------------------------------------------------------
def cache_device(device: str | torch.device = "cuda") -> torch.device:
    """Where a cache is allocated: ``meta`` as it is (shapes and dtypes,
    nothing allocated), anything else through ``resolve_device`` (the card
    by default; raises on a host without CUDA)."""
    dev = torch.device(device)
    return dev if dev.type == "meta" else resolve_device(dev)


def init_device(gen: Optional[torch.Generator]) -> torch.device:
    """Where parameters drawn from ``gen`` live: its device, or ``meta``
    (shapes and dtypes only, nothing allocated) without a generator."""
    return torch.device("meta") if gen is None else gen.device


def dense_init(gen: Optional[torch.Generator], shape, dtype,
               scale: Optional[float] = None) -> torch.Tensor:
    """Normal(0, scale) of ``shape`` drawn in f32 from ``gen`` and cast to
    ``dtype``; scale defaults to 1/sqrt(fan_in), fan_in = shape[0]."""
    fan_in = shape[0] if len(shape) > 1 else 1
    scale = scale if scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    dev = init_device(gen)
    if dev.type == "meta":
        return torch.empty(shape, dtype=dtype, device=dev)
    w = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
    return (w * scale).to(dtype)


def full(gen: Optional[torch.Generator], shape, value: float,
         dtype) -> torch.Tensor:
    """A constant parameter (norm gains, biases) beside ``gen``'s draws."""
    return torch.full(shape, value, dtype=dtype, device=init_device(gen))


def stacked_logical(names):
    """Logical names of a stacked nest (names tuples, named tuples of them,
    ``None``): a leading None for the stacking axis on every leaf."""
    if names is None:
        return None
    if hasattr(names, "_fields"):
        return type(names)(*(stacked_logical(n) for n in names))
    return (None,) + tuple(names)


# --------------------------------------------------------------------------
# primitives
# --------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    scale = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * scale).to(dt) * gamma


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding. x: (..., seq, heads, head_dim); positions: (..., seq)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = positions[..., :, None].float() * freqs        # (..., seq, half)
    cos = torch.cos(ang)[..., :, None, :]                # (..., seq, 1, half)
    sin = torch.sin(ang)[..., :, None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


def embed_tokens(embedding: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return F.embedding(tokens.long(), embedding)


def lm_logits(x: torch.Tensor, embedding: torch.Tensor,
              head: Optional[torch.Tensor]) -> torch.Tensor:
    """Final projection; f32 logits. The weight is cast to f32 whole, as
    the reference does (a (V, d) f32 temporary on every call)."""
    w = embedding.T if head is None else head
    return torch.matmul(x.float(), w.float())


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token cross-entropy in f32; mask selects contributing positions."""
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, labels[..., None].long())[..., 0]
    if mask is None:
        return -torch.mean(ll)
    mask = mask.float()
    return -torch.sum(ll * mask) / torch.clamp(torch.sum(mask), min=1.0)
