"""Carry the reference's numpy-level state into the port's objects.

The GF(2^8) codes have no weights: the state that crosses between the two
packages is a scheme (its generator matrix and group structure), a
compiled repair plan (coefficients, reads, targets and the structural
plan behind them) and a stripe store's manifest. :func:`from_reference`
turns any of them, as the reference holds them, into the port's object, so
both packages can run the same plans over the same stores. A plan's GF(2)
bitmatrix (the crs/mxu backends' operand) does not cross: both sides
derive it from the coefficients (``CompiledPlan.bit_coeffs``).
"""
from __future__ import annotations

import dataclasses
from collections.abc import Mapping
from pathlib import Path

import numpy as np
import torch

from repro_torch.core.planner import CompiledPlan
from repro_torch.core.repair import MultiRepairPlan, RepairPlan
from repro_torch.core.schemes import Cascade, Group, LRCScheme
from repro_torch.ftx.stripestore import StripeStore

_PLAN_META = {"RepairPlan": RepairPlan, "MultiRepairPlan": MultiRepairPlan}


def _fields(obj, cls):
    """``cls`` built from the same-named fields of dataclass ``obj``."""
    return cls(**{f.name: getattr(obj, f.name)
                  for f in dataclasses.fields(cls) if f.init})


def from_reference(state, *, root: str | Path | None = None,
                   device: str | torch.device = "cuda"):
    """The port's counterpart of a piece of reference state.

    * an ``LRCScheme`` -> the port's ``LRCScheme`` (same generator matrix,
      groups, cascade and tolerance);
    * a ``CompiledPlan`` -> the port's ``CompiledPlan`` (same op, targets,
      reads, coefficients and structural meta);
    * a manifest dict (``save_manifest``'s document) -> a port
      ``StripeStore`` over the block files under ``root``, on ``device``.
    """
    if isinstance(state, Mapping):
        if root is None:
            raise ValueError("a manifest needs the store's root directory")
        return StripeStore.from_manifest(root, dict(state), device=device)
    if hasattr(state, "gen") and hasattr(state, "groups"):
        return LRCScheme(
            name=state.name, k=state.k, r=state.r, p=state.p,
            gen=np.array(state.gen, np.uint8),
            groups=tuple(_fields(g, Group) for g in state.groups),
            cascade=None if state.cascade is None
            else _fields(state.cascade, Cascade),
            tolerance=state.tolerance)
    if hasattr(state, "coeffs") and hasattr(state, "reads"):
        meta = state.meta
        if meta is not None:
            meta = _fields(meta, _PLAN_META[type(meta).__name__])
        return CompiledPlan(state.op, tuple(state.targets), tuple(state.reads),
                            np.array(state.coeffs, np.uint8), meta)
    raise TypeError(f"no port counterpart for {type(state).__name__}")
