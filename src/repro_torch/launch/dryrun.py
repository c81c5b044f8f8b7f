"""Dry run over every (architecture x input-shape) cell, on ``meta``.

The port of ``src/repro/launch/dryrun.py``. For each cell it builds the
parameters, the AdamW state and the inputs as ``meta`` tensors (shapes and
dtypes, nothing allocated), runs the step function on them under one
dispatch mode (:class:`CostMode`) and records:

* ``memory``: per-device argument and output bytes, each leaf's bytes
  divided by the mesh axes of its resolved spec (the train step's
  parameter, moment and batch specs; :func:`cache_shardings` for decode
  caches). ``temp_size_in_bytes`` is ``null``: a ``meta`` run cannot know
  the step's temporaries (``repro_torch.launch.perf_iter`` measures them
  on the card);
* ``cost``: the whole step's matmul-class FLOPs by
  ``torch.utils.flop_counter``'s registry, also split by operand dtype
  (``flops_by_dtype``), and ``bytes accessed``: every non-view operator's
  input and output bytes, XLA's definition (the eager operators'
  traffic, an upper bound that a step's own extra passes raise);
  ``"flops_scope": "global"``, so the roofline splits both over the mesh;
* ``collectives``: the reference's five kinds, all zero. The port has no
  SPMD partitioner, so a step runs no collective and there is no HLO to
  parse.

The step is the one the card runs: train is ``make_train_step`` (the
loss, ``torch.autograd.grad`` with each period rematerialised, and AdamW),
prefill ``api.prefill``, decode ``api.decode_step``. An eager step visits
every layer, so the reference's ``--unroll`` has no counterpart: every
count is what its unrolled lowering gives. ``compile_s`` is the seconds
the counted ``meta`` step took.

Results cache to ``RESULTS_DIR/dryrun_<mesh>.json`` (the roofline's
directory), keyed by cell, so re-runs count only missing cells.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh single --arch all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh multi \\
      --arch grok-1-314b --shape train_4k
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
import traceback
from collections import Counter
from pathlib import Path
from typing import Any, Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import ALIASES, SHAPES, cell_valid, get_model, input_specs
from repro_torch.dist.sharding import Mesh, MeshRules, _resolve, with_rules
from repro_torch.launch import roofline
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.serve_shardings import cache_shardings
from repro_torch.models.registry import ModelApi
from repro_torch.train.optimizer import adamw_init
from repro_torch.train.train_step import (TrainConfig, batch_shardings,
                                          make_train_step, param_shardings,
                                          train_shardings)
from repro_torch.tree import tree_map

PyTree = Any

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")
# Operators that only allocate or relabel: they move no bytes.
_FREE = frozenset(("empty", "empty_like", "empty_strided", "new_empty",
                   "new_empty_strided", "_unsafe_view"))
MESH_NAMES = ("single", "multi")


class CostMode(TorchDispatchMode):
    """Counts what the operators dispatched under it compute and move:
    ``flops_by_dtype`` (matmul-class FLOPs by the dtype name of the first
    tensor operand) and ``bytes`` (every non-view, non-allocating
    operator's tensor inputs and outputs)."""

    def __init__(self):
        super().__init__()
        self.flops_by_dtype: Counter = Counter()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        tensors = [t for t in tree_flatten((args, kwargs))[0]
                   if isinstance(t, torch.Tensor)]
        if packet in flop_registry:
            dtype = str(tensors[0].dtype).removeprefix("torch.")
            self.flops_by_dtype[dtype] += flop_registry[packet](
                *args, **kwargs, out_val=out)
        if not func.is_view and packet.__name__ not in _FREE:
            outs = [t for t in tree_flatten(out)[0]
                    if isinstance(t, torch.Tensor)]
            self.bytes += sum(t.numel() * t.element_size()
                              for t in tensors + outs)
        return out

    @property
    def flops(self) -> int:
        return sum(self.flops_by_dtype.values())


@dataclasses.dataclass
class Count:
    """One cell's counted step: its cost, and its arguments and outputs
    (``meta`` nests) beside their specs' logical derivation."""
    kind: str
    cost: dict
    seconds: float
    args: tuple
    outs: tuple
    api: ModelApi
    specs: dict


def count_step(api: ModelApi, kind: str, specs: dict, *,
               tc: Optional[TrainConfig] = None,
               donate: bool = True) -> Count:
    """Run ``kind``'s step function of ``api`` on the ``meta`` inputs
    ``specs`` (``configs.input_specs``'s form) under :class:`CostMode`."""
    mode = CostMode()
    t0 = time.perf_counter()
    if kind == "train":
        params = api.abstract_params()
        opt = adamw_init(params)
        args = (params, opt, specs["batch"])
        step = make_train_step(api, tc, donate=donate)
        with mode:
            outs = step(*args)
    elif kind == "prefill":
        args = (api.abstract_params(), specs["batch"])
        with mode, torch.no_grad():
            outs = api.prefill(*args)
    else:
        args = (api.abstract_params(), specs["caches"], specs["tokens"],
                specs["index"])
        with mode, torch.no_grad():
            outs = api.decode_step(*args)
    cost = {"flops": float(mode.flops), "bytes accessed": float(mode.bytes),
            "flops_by_dtype": {k: float(v) for k, v in
                               sorted(mode.flops_by_dtype.items())}}
    return Count(kind, cost, time.perf_counter() - t0, args, outs, api, specs)


def _specs(count: Count, mr: MeshRules) -> tuple[tuple, tuple]:
    """The arguments' and outputs' specs under ``mr``: the train step's
    parameter, moment and batch specs, cache specs for caches, batch on
    the first dimension of logits and tokens, scalars replicated."""
    api, specs = count.api, count.specs
    psh = param_shardings(api, mr)
    if count.kind == "train":
        sh = train_shardings(api, mr, specs["batch"])
        metrics = {k: () for k in count.outs[2]}
        return ((sh["params"], sh["opt_state"], sh["batch"]),
                (sh["params"], sh["opt_state"], metrics))
    logits = _resolve(count.outs[0].shape, ("batch",) + (None,) * (
        count.outs[0].ndim - 1), mr)
    csh = cache_shardings(count.outs[1], mr)
    if count.kind == "prefill":
        return (psh, batch_shardings(specs["batch"], mr)), (logits, csh)
    tokens = _resolve(specs["tokens"].shape, ("batch", None), mr)
    return ((psh, cache_shardings(specs["caches"], mr), tokens, ()),
            (logits, csh))


def per_device_bytes(values: PyTree, specs: PyTree, mesh: Mesh) -> int:
    """Each leaf's bytes over the product of the mesh axes in its spec."""
    sizes = dict(mesh.shape)
    total = [0]

    def one(t, spec):
        ways = math.prod(sizes[ax] for entry in spec for ax in entry)
        total[0] += t.numel() * t.element_size() // ways

    tree_map(one, values, specs)
    return total[0]


def cell_record(arch: str, shape: str, count: Count, mesh: Mesh,
                extra_rules: Optional[dict] = None) -> dict:
    """The reference's record schema for one counted cell on ``mesh``."""
    with with_rules(mesh, extra_rules) as mr:
        arg_specs, out_specs = _specs(count, mr)
    return {
        "arch": arch, "shape": shape, "kind": count.kind,
        "mesh": dict(mesh.shape), "compile_s": round(count.seconds, 1),
        "memory": {
            "argument_size_in_bytes": per_device_bytes(count.args, arg_specs,
                                                       mesh),
            "output_size_in_bytes": per_device_bytes(count.outs, out_specs,
                                                     mesh),
            "temp_size_in_bytes": None},
        "cost": count.cost, "flops_scope": "global",
        "collectives": {k: {"in": 0, "out": 0, "count": 0}
                        for k in _COLLECTIVES},
    }


def count_cell(arch: str, shape: str, *, smoke: bool = False,
               tc: Optional[TrainConfig] = None,
               donate: bool = True) -> Count:
    spec = SHAPES[shape]
    return count_step(get_model(arch, smoke=smoke), spec.kind,
                      input_specs(arch, shape, smoke=smoke), tc=tc,
                      donate=donate)


def lower_cell(arch: str, shape: str, mesh: Mesh, *, smoke: bool = False,
               tc: Optional[TrainConfig] = None, donate: bool = True,
               extra_rules: Optional[dict] = None) -> dict:
    """Count one cell on ``meta`` and return its record on ``mesh``."""
    count = count_cell(arch, shape, smoke=smoke, tc=tc, donate=donate)
    return cell_record(arch, shape, count, mesh, extra_rules)


def production_mesh(meshname: str) -> Mesh:
    """The 16x16 or 2x16x16 mesh over ``meta`` positions."""
    n = 512 if meshname == "multi" else 256
    return make_production_mesh(multi_pod=(meshname == "multi"),
                                devices=("meta",) * n)


def kv_rules(shape: str) -> Optional[dict]:
    """batch=1 long context: split the KV length over the idle "data"
    axis instead of replicating a 512k cache."""
    return {"kv_seq": ("data",)} if SHAPES[shape].global_batch < 16 else None


def run(meshnames: str | Sequence[str], archs: list[str], shapes: list[str],
        force: bool = False, results_dir: Optional[Path] = None) -> dict:
    """Count every cell once and write its record for each mesh of
    ``meshnames`` ("single", "multi" or both): the records of two meshes
    differ only in their spec divisions. Returns ``{mesh: results}``
    (a bare name returns that mesh's results)."""
    names = (meshnames,) if isinstance(meshnames, str) else tuple(meshnames)
    base = Path(results_dir or roofline.RESULTS_DIR)
    base.mkdir(parents=True, exist_ok=True)
    paths = {m: base / f"dryrun_{m}.json" for m in names}
    meshes = {m: production_mesh(m) for m in names}
    results = {m: json.loads(p.read_text()) if p.exists() else {}
               for m, p in paths.items()}
    for arch in archs:
        for shape in shapes:
            key = f"{arch}|{shape}"
            ok, reason = cell_valid(arch, shape)
            if not ok:
                for m in names:
                    results[m][key] = {"arch": arch, "shape": shape,
                                       "skip": reason}
                continue
            todo = [m for m in names if force or key not in results[m]
                    or "error" in results[m][key]]
            if not todo:
                print(f"[cached] {key}")
                continue
            print(f"[lower ] {key} ...", flush=True)
            try:
                count = count_cell(arch, shape)
                for m in todo:
                    results[m][key] = cell_record(arch, shape, count,
                                                  meshes[m], kv_rules(shape))
                print(f"[ok    ] {key} count={count.seconds:.1f}s "
                      f"flops={count.cost['flops']:.4e}", flush=True)
            except Exception as e:
                for m in todo:
                    results[m][key] = {"arch": arch, "shape": shape,
                                       "error": f"{type(e).__name__}: {e}"}
                print(f"[FAIL  ] {key}: {e}\n{traceback.format_exc()}",
                      flush=True)
            for m in todo:
                paths[m].write_text(json.dumps(results[m], indent=1,
                                               sort_keys=True))
    for m in names:
        paths[m].write_text(json.dumps(results[m], indent=1, sort_keys=True))
    return results[meshnames] if isinstance(meshnames, str) else results


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", choices=MESH_NAMES, default="single")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--results-dir", default=None)
    args = ap.parse_args(argv)
    archs = list(ALIASES) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    results = run(args.mesh, archs, shapes, force=args.force,
                  results_dir=args.results_dir)
    bad = [k for k, v in results.items() if "error" in v]
    print(f"\n{len(results) - len(bad)}/{len(results)} cells ok; "
          f"failures: {bad or 'none'}")


if __name__ == "__main__":
    main()
