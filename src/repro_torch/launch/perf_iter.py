"""Perf hill-climbing harness: one cell under named variants.

The port of ``src/repro/launch/perf_iter.py``. For each variant (config
and train overrides) it counts the cell's step on ``meta`` as the dry
run does and prints the roofline terms per device of the production
mesh (an even split of the whole step's count; no collectives). Its
``memory_s`` is the eager operators' traffic over the HBM rate: every
operator's inputs and outputs, an upper bound that a variant's own extra
passes raise, not a roofline term. The reference compiles each variant
and reads ``memory_analysis``; the torch counterpart is to run the step:
with ``--device cuda`` (the default) a train cell's variants also run on
the card at a batch one card holds (``--batch``, default 1) and the
shape's sequence length, one warm-up step and then ``--steps`` timed
ones, and the row gains ``step_ms`` (CUDA events, median), ``peak_gb``
(``max_memory_allocated`` over the variant's steps), ``temp_gb`` (that
peak less what was allocated when the step started), the losses and
gradient norms, and the step's counted FLOPs at the card's batch beside
its bound: ``bound_ms`` is the larger of the compute term and the bytes
the step must move (its arguments read once, its outputs written once)
over the HBM rate, so a variant that adds passes cannot raise it. GB
here are 2^30 bytes, the reference's unit. Prefill and decode cells take
``--device meta``.

The reference's variants that only override sharding rules or
``fsdp_params`` (``seqshard``, ``nofsdp`` and their ``flash2048``
pairs) are not in the table: the port has no partitioner, so they would
run the step of ``baseline`` or ``flash2048`` unchanged.

The parameters and AdamW moments are built once per call, and each
variant swaps only the config: every variant starts from the same
parameters (a copy on the card resets them), zero moments and the same
batch, so their first losses agree. ``--device meta`` counts only.
Without a card it raises: it never falls back to the CPU. The
reference's ``--unroll`` has no counterpart: an eager step visits every
layer.

  PYTHONPATH=src python -m repro_torch.launch.perf_iter --arch qwen2.5-3b \\
      --shape train_4k --variants baseline,flash2048 [--device meta]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
from pathlib import Path
from typing import Optional

import torch

from repro_torch.configs import SHAPES, get_config, input_specs
from repro_torch.device import resolve_device
from repro_torch.launch import roofline
from repro_torch.launch.dryrun import count_step, production_mesh
from repro_torch.models.common import make_generator
from repro_torch.models.registry import ModelApi, build
from repro_torch.train.optimizer import adamw_init
from repro_torch.train.train_step import TrainConfig, make_train_step
from repro_torch.tree import tree_leaves, tree_map

GB = 2 ** 30
SEED = 0

# variant name -> (config overrides, train overrides)
VARIANTS = {
    "baseline": ({}, {}),
    "flash1024": ({"attn_chunk": 1024}, {}),
    "flash2048": ({"attn_chunk": 2048}, {}),
    "flash4096": ({"attn_chunk": 4096}, {}),
    "micro2": ({}, {"microbatches": 2}),
    "micro4": ({}, {"microbatches": 4}),
    "flash2048+micro4": ({"attn_chunk": 2048}, {"microbatches": 4}),
    "moegroup512": ({"moe_group_size": 512}, {}),
    "flash2048+moegroup512": ({"attn_chunk": 2048, "moe_group_size": 512},
                              {}),
}


def variant(arch: str, name: str, smoke: bool = False
            ) -> tuple[ModelApi, Optional[TrainConfig]]:
    """The variant's model and train config."""
    cfg_over, train_over = VARIANTS[name]
    api = build(dataclasses.replace(get_config(arch, smoke), **cfg_over))
    return api, TrainConfig(**train_over) if train_over else None


@dataclasses.dataclass
class CardState:
    """A train cell's state on the card, built once per call: the
    parameters, a copy that resets them before each variant, the AdamW
    moments and one batch."""
    params: object
    snapshot: list
    opt: dict
    batch: dict

    @classmethod
    def build(cls, arch: str, shape: str, device, batch: int) -> "CardState":
        if torch.device(device).type != "cuda" or not torch.cuda.is_available():
            raise RuntimeError(f"perf_iter measures on a CUDA card ({device} "
                               f"asked, CUDA available: "
                               f"{torch.cuda.is_available()}); pass "
                               f"--device meta to count only")
        spec = SHAPES[shape]
        if spec.kind != "train":
            raise ValueError(f"perf_iter times train cells on the card; "
                             f"count {shape} with --device meta")
        dev = resolve_device(device)
        api = build(get_config(arch))
        params = api.init_params(make_generator(SEED, dev))
        return cls(params, [t.clone() for t in tree_leaves(params)],
                   adamw_init(params),
                   api.sample_batch(batch, spec.seq_len,
                                    make_generator(SEED + 1, dev)))

    def reset(self) -> None:
        for t, s in zip(tree_leaves(self.params), self.snapshot):
            t.copy_(s)
        for t in tree_leaves(self.opt):
            t.zero_()


def run_on_card(api: ModelApi, tc: Optional[TrainConfig], state: CardState,
                steps: int) -> dict:
    """One warm-up step and ``steps`` timed ones from the reset state."""
    state.reset()
    step = make_train_step(api, tc, donate=True)

    def one() -> dict:
        metrics = step(state.params, state.opt, state.batch)[2]
        return {k: float(metrics[k]) for k in ("loss", "grad_norm")}

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    metrics = [one()]
    ms = []
    for _ in range(steps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        metrics.append(one())
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
    peak = torch.cuda.max_memory_allocated()
    return {"step_ms": statistics.median(ms), "step_ms_all": ms,
            "losses": [m["loss"] for m in metrics],
            "grad_norms": [m["grad_norm"] for m in metrics],
            "peak_gb": peak / GB,
            "resident_gb": resident / GB, "temp_gb": (peak - resident) / GB}


def measure(arch: str, shape: str, name: str, *, multi_pod: bool = False,
            smoke: bool = False, state: Optional[CardState] = None,
            steps: int = 3) -> dict:
    """The variant's roofline row on the production mesh (an even split of
    the step's ``meta`` count) and, given a ``state`` on the card, its
    measured step beside the bound of the step's count at that batch."""
    api, tc = variant(arch, name, smoke)
    kind = SHAPES[shape].kind
    count = count_step(api, kind, input_specs(arch, shape, smoke=smoke),
                       tc=tc)
    chips = production_mesh("multi" if multi_pod else "single").size
    per_dev = {dt: f / chips for dt, f in count.cost["flops_by_dtype"].items()}
    hbytes = count.cost["bytes accessed"] / chips
    row = {
        "variant": name, "compile_s": round(count.seconds, 1),
        "temp_gb": None,
        "flops_per_dev": count.cost["flops"] / chips,
        "flops_by_dtype_per_dev": per_dev,
        "bytes_per_dev": hbytes, "wire_bytes_per_dev": 0.0,
        "compute_s": roofline.compute_seconds(per_dev),
        "memory_s": hbytes / roofline.HBM_BW, "collective_s": 0.0,
        "collectives": {},
    }
    if state is None:
        return row
    meta = tree_map(lambda t: torch.empty_like(t, device="meta"), state.batch)
    card = count_step(api, kind, {"batch": meta}, tc=tc)
    compute_ms = roofline.compute_seconds(card.cost["flops_by_dtype"]) * 1e3
    io_bytes = nbytes(card.args) + nbytes(card.outs)
    io_ms = io_bytes / roofline.HBM_BW * 1e3
    row.update(run_on_card(api, tc, state, steps))
    row.update({
        "device": torch.cuda.get_device_name(), "card_flops": card.cost["flops"],
        "card_flops_by_dtype": card.cost["flops_by_dtype"],
        "card_compute_ms": compute_ms, "card_io_bytes": io_bytes,
        "card_io_ms": io_ms, "bound_ms": max(compute_ms, io_ms),
        "bound_by": "operations" if compute_ms >= io_ms else "bytes",
        "bound_share": max(compute_ms, io_ms) / row["step_ms"],
        "card_eager_bytes": card.cost["bytes accessed"],
        "card_eager_ms": card.cost["bytes accessed"] / roofline.HBM_BW * 1e3,
        "achieved_tflops": card.cost["flops"] / row["step_ms"] / 1e9})
    return row


def nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variants", default="baseline,flash2048")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--device", choices=("cuda", "meta"), default="cuda")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    state = None
    if args.device == "cuda":
        state = CardState.build(args.arch, args.shape, "cuda", args.batch)
    rows = []
    for v in args.variants.split(","):
        print(f"[perf] {args.arch}|{args.shape} variant={v} ...", flush=True)
        try:
            r = measure(args.arch, args.shape, v, multi_pod=args.multi_pod,
                        state=state, steps=args.steps)
        except Exception as e:
            r = {"variant": v, "error": f"{type(e).__name__}: {e}"}
        rows.append(r)
        print(json.dumps(r, indent=1, default=str), flush=True)
    print("\nvariant            temp_gb  compute_s  memory_s  coll_s  step_ms"
          "  peak_gb  (memory_s: the eager operators' traffic)")
    for r in rows:
        if "error" in r:
            print(f"{r['variant']:18s} ERROR {r['error'][:60]}")
            continue
        card = (f" {r['step_ms']:8.2f} {r['peak_gb']:8.2f}"
                if "step_ms" in r else "        -        -")
        temp = "-" if r["temp_gb"] is None else f"{r['temp_gb']:.1f}"
        print(f"{r['variant']:18s} {temp:>8s} {r['compute_s']:9.4f} "
              f"{r['memory_s']:9.4f} {r['collective_s']:7.4f}{card}")
    if args.out:
        Path(args.out).write_text(json.dumps(rows, indent=1, default=str))
    return rows


if __name__ == "__main__":
    main()
