"""The train step and the derivation of its specs.

The port of ``src/repro/train/train_step.py``. ``train_shardings`` turns
a model's logical parameter names into specs for the parameters, the
optimizer state and the batch under a mesh (the FSDP extension for giant
configs and the ZeRO-style moment specs included), in
``repro_torch.dist.sharding``'s form: one tuple of mesh axes per
dimension. ``make_train_step`` builds the (params, opt_state, batch) ->
(params, opt_state, metrics) function: gradients from
``torch.autograd.grad`` over the parameter leaves, summed in f32 over a
loop of microbatches when ``microbatches > 1`` (the reference's
``lax.scan``), then AdamW.

``make_train_step(api, tc, donate=True)`` is the reference's
``jax.jit(step, donate_argnums=(0, 1))``: it writes the new parameters and
moments into the tensors it was given and returns them. Without donation
(the default) it returns new tensors and leaves its inputs alone.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.dist.sharding import MeshRules, _resolve, opt_state_sharding
from repro_torch.models.registry import ModelApi
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

from .optimizer import AdamWConfig, adamw_update

PyTree = Any


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: AdamWConfig = AdamWConfig()
    microbatches: int = 1


def _is_logical(v) -> bool:
    """A leaf of a logical-names nest: a plain tuple of names (or None)."""
    return (isinstance(v, tuple) and not hasattr(v, "_fields")
            and all(x is None or isinstance(x, str) for x in v))


def _is_spec(v) -> bool:
    """A leaf of a specs nest: a plain tuple of per-dimension axis tuples."""
    return (isinstance(v, tuple) and not hasattr(v, "_fields")
            and all(isinstance(e, tuple) for e in v))


def param_shardings(api: ModelApi, mr: MeshRules) -> PyTree:
    """A spec for every parameter from the model's logical names."""
    logical = api.param_logical()
    shapes = api.abstract_params()

    def one(names, shape):
        spec = _resolve(shape.shape, names, mr)
        if api.cfg.fsdp_params:
            # extend with data/pod axes on the largest replicated dim
            return opt_state_sharding(spec, shape.shape, mr)
        return spec

    return tree_map(one, logical, shapes, is_leaf=_is_logical)


def opt_shardings(api: ModelApi, mr: MeshRules, p_shardings: PyTree) -> PyTree:
    shapes = api.abstract_params()
    moments = tree_map(lambda sh, shape: opt_state_sharding(sh, shape.shape,
                                                            mr),
                       p_shardings, shapes, is_leaf=_is_spec)
    return {"m": moments, "v": moments, "step": ()}


def batch_shardings(batch_specs: dict, mr: MeshRules) -> dict:
    out = {}
    for k, v in batch_specs.items():
        names = ("batch",) + (None,) * (len(v.shape) - 1)
        out[k] = _resolve(v.shape, names, mr)
    return out


def train_shardings(api: ModelApi, mr: MeshRules, batch_specs: dict) -> dict:
    ps = param_shardings(api, mr)
    return {
        "params": ps,
        "opt_state": opt_shardings(api, mr, ps),
        "batch": batch_shardings(batch_specs, mr),
    }


def snapshot_for_checkpoint(state: PyTree) -> PyTree:
    """Device→host snapshot of train state for asynchronous checkpointing.

    Every leaf is copied into a fresh CPU tensor, so the returned nest
    aliases no tensor of the training loop: the next ``train_step`` may
    overwrite its inputs (``donate=True``) while the checkpoint manager's
    background encode still reads the snapshot.
    ``CheckpointManager.save_async`` makes an equivalent copy while it
    flattens, so this is needed only when the snapshot must be taken
    earlier than the save call."""
    def copy(x):
        if isinstance(x, torch.Tensor):
            return x.detach().to("cpu", copy=True)
        return torch.from_numpy(np.array(x))

    return tree_map(copy, state)


def make_train_step(api: ModelApi, tc: Optional[TrainConfig] = None, *,
                    donate: bool = False):
    """The step function. A batch's arrays (numpy or tensors) move to the
    parameters' device inside the step."""
    tc = tc or TrainConfig()

    def loss_and_grads(leaves: list, template: PyTree, batch: dict):
        with torch.enable_grad():
            params = tree_unflatten(template, iter(leaves))
            loss = api.train_loss(params, batch)
            grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), list(grads)

    def train_step(params, opt_state, batch):
        flat = tree_leaves(params)
        dev = flat[0].device
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        leaves = [p.detach().requires_grad_() for p in flat]
        n = tc.microbatches
        if n > 1:
            gsum, lsum = None, 0.0
            for i in range(n):
                mb = {k: v.reshape((n, v.shape[0] // n) + tuple(v.shape[1:]))[i]
                      for k, v in batch.items()}
                loss, grads = loss_and_grads(leaves, params, mb)
                if gsum is None:
                    gsum = [g.to(torch.float32) for g in grads]
                else:
                    for a, g in zip(gsum, grads):
                        a.add_(g)
                lsum = lsum + loss
            grads = [g.mul_(1.0 / n) for g in gsum]
            loss = lsum * (1.0 / n)
        else:
            loss, grads = loss_and_grads(leaves, params, batch)
        del leaves
        params, opt_state, metrics = adamw_update(
            params, tree_unflatten(params, iter(grads)), opt_state, tc.opt,
            inplace=donate)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step
