"""Assigned architectures (exact public configs) + shape grid + input specs.

The port's copy of ``src/repro/configs``. Each ``<arch>.py`` module defines
``CONFIG`` (the full published config) and ``SMOKE`` (a reduced same-family
config for CPU smoke runs), with ``param_dtype`` a torch dtype. The shape
grid is the assignment's four cells; ``long_500k`` is only valid for
sub-quadratic archs (``LONG_OK``).
"""
from __future__ import annotations

import dataclasses
import importlib

import torch

from repro_torch.models.common import ModelConfig
from repro_torch.models.registry import ModelApi, build

ARCHS = (
    "internlm2_20b",
    "qwen25_3b",
    "phi3_mini_38b",
    "gemma3_12b",
    "seamless_m4t_medium",
    "internvl2_1b",
    "grok1_314b",
    "arctic_480b",
    "jamba_52b",
    "mamba2_27b",
)

# public ids (with dashes/dots) -> module names
ALIASES = {
    "internlm2-20b": "internlm2_20b",
    "qwen2.5-3b": "qwen25_3b",
    "phi3-mini-3.8b": "phi3_mini_38b",
    "gemma3-12b": "gemma3_12b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "internvl2-1b": "internvl2_1b",
    "grok-1-314b": "grok1_314b",
    "arctic-480b": "arctic_480b",
    "jamba-v0.1-52b": "jamba_52b",
    "mamba2-2.7b": "mamba2_27b",
}


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}

# archs allowed to run long_500k (sub-quadratic / bounded-KV attention)
LONG_OK = {"gemma3_12b", "jamba_52b", "mamba2_27b"}


def resolve(arch: str) -> str:
    mod = ALIASES.get(arch, arch).replace("-", "_").replace(".", "_")
    if mod not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; have {sorted(ALIASES)}")
    return mod


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    module = importlib.import_module(f"{__name__}.{resolve(arch)}")
    return module.SMOKE if smoke else module.CONFIG


def get_model(arch: str, smoke: bool = False) -> ModelApi:
    return build(get_config(arch, smoke))


def cell_valid(arch: str, shape: str) -> tuple[bool, str]:
    """Is (arch x shape) a runnable cell? Returns (ok, reason-if-skip)."""
    mod = resolve(arch)
    if shape == "long_500k" and mod not in LONG_OK:
        return False, ("full-attention arch: 512k decode KV is quadratic-cost "
                       "prefill territory; skipped per assignment spec")
    return True, ""


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(arch: str, shape: str, smoke: bool = False) -> dict:
    """``meta`` tensors standing for every input of the step function.

    train:   {"batch": {tokens, labels, [frames|prefix_embeds]}}
    prefill: {"batch": {tokens, [frames|prefix_embeds]}}
    decode:  {"caches": ..., "tokens": (B,1), "index": scalar}
    """
    cfg = get_config(arch, smoke)
    spec = SHAPES[shape]
    b, s = spec.global_batch, spec.seq_len
    if smoke:
        b, s = max(2, b // 128), min(s, 256)
    i32 = torch.int32
    out: dict = {}
    if spec.kind in ("train", "prefill"):
        batch = {"tokens": _spec((b, s), i32)}
        if spec.kind == "train":
            batch["labels"] = _spec((b, s), i32)
        if cfg.family == "encdec":
            batch["frames"] = _spec((b, s, cfg.d_model), torch.bfloat16)
        elif cfg.frontend != "none":
            batch["prefix_embeds"] = _spec(
                (b, cfg.frontend_tokens, cfg.d_model), torch.bfloat16)
        out["batch"] = batch
    else:
        api = get_model(arch, smoke)
        out["caches"] = api.abstract_caches(b, s)
        out["tokens"] = _spec((b, 1), i32)
        out["index"] = _spec((), i32)
    return out
