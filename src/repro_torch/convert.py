"""Carry the reference's numpy-level state into the port's objects.

The GF(2^8) codes have no weights: the state that crosses between the two
packages is a scheme (its generator matrix and group structure), a
compiled repair plan (coefficients, reads, targets and the structural
plan behind them) and a stripe store's manifest. :func:`from_reference`
turns any of them, as the reference holds them, into the port's object, so
both packages can run the same plans over the same stores. A plan's GF(2)
bitmatrix (the crs/mxu backends' operand) does not cross: both sides
derive it from the coefficients (``CompiledPlan.bit_coeffs``).

Checkpoints do carry tensors: :func:`state_from_reference` turns the
reference's state tree of numpy arrays into the same nesting of torch
tensors, so both packages can checkpoint one state.
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
from repro_torch.device import resolve_device
from repro_torch.ftx.checkpoint import _tree_leaves, _tree_unflatten
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


def _tensor_of(leaf, device: torch.device) -> torch.Tensor:
    arr = np.array(leaf, order="C")
    if arr.dtype.name == "bfloat16":
        # numpy has no bfloat16 of its own (the reference's comes from
        # ml_dtypes): carry the bits across as int16.
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def state_from_reference(tree, *, device: str | torch.device = "cuda"):
    """The reference's checkpoint state as the port holds it: ``tree``'s
    nesting (dicts, ordered dicts, lists, tuples, named tuples, ``None``)
    with every leaf — a numpy array (ml_dtypes bfloat16 included), numpy
    scalar or Python scalar — as a torch tensor of the same dtype, shape and
    bytes on ``device``. A Python scalar becomes the 0-d tensor of the
    dtype numpy gives it, so checkpoint metadata stays the reference's."""
    dev = resolve_device(device)
    return _tree_unflatten(tree, iter([_tensor_of(leaf, dev)
                                       for leaf in _tree_leaves(tree)]))
