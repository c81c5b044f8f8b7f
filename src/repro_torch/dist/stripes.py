"""Stripe-axis spans and the launch layer of the batched codec engine.

Stripes are independent — no codec operation has a cross-stripe term — so
the reference splits a batch's stripe axis ``S`` over the mesh's
data-parallel axes, one launch per device. This slice runs on one card:
the span helpers keep the reference's answers (which all come out 1 on a
single-device mesh) and :func:`sharded_launch` calls the kernel body
directly. The per-device split is in ROADMAP queue 1 (multi-device
dist).
"""
from __future__ import annotations

from typing import Callable, Optional

from .sharding import MeshRules, _resolve


def stripe_axis_span(mr: Optional[MeshRules]) -> int:
    """Device count the "stripes" logical axis *can* claim on ``mr``'s mesh
    (the product of its candidate axes present in the mesh), independent of
    any particular batch size. 1 with no rules or no candidate axes."""
    if mr is None:
        return 1
    sizes = dict(mr.mesh.shape)
    span = 1
    for ax in dict.fromkeys(mr.axes_for("stripes")):
        span *= sizes.get(ax, 1)
    return span


def align_stripe_window(window: int, mr: Optional[MeshRules]) -> int:
    """Largest window' <= ``window`` divisible by the stripe-axis device
    span, so windowed launches keep their full device parallelism. Windows
    smaller than the span are returned unchanged."""
    span = stripe_axis_span(mr)
    if span <= 1 or window < span:
        return window
    return (window // span) * span


def stripe_span(shape, mr: Optional[MeshRules]) -> int:
    """How many devices an ``(S, ...)`` batch spreads over (1 = degraded):
    unlike :func:`stripe_axis_span`, an S the stripe axis does not divide
    resolves to 1."""
    if mr is None or not len(shape):
        return 1
    names = ("stripes",) + (None,) * (len(shape) - 1)
    sizes = dict(mr.mesh.shape)
    span = 1
    for ax in _resolve(shape, names, mr)[0]:
        span *= sizes[ax]
    return span


def sharded_launch(fn: Callable, coeffs, batch, mr: Optional[MeshRules],
                   **kwargs):
    """Run ``fn(coeffs, batch, **kwargs)`` as one launch on ``batch``'s
    device. A batch that would spread over several devices raises
    ``NotImplementedError`` (multi-device launches are a later slice)."""
    if stripe_span(batch.shape, mr) > 1:
        raise NotImplementedError("multi-device stripe launches come in a "
                                  "later slice (ROADMAP)")
    return fn(coeffs, batch, **kwargs)
