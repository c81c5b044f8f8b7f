#!/usr/bin/env python3
"""The control: the reference put in the program's place, one step of
precision down, which the check has to find wrong.

    PYTHONPATH=src python3 portbench/control.py --workload <name> \
        --seeds 1,2,3 --seconds 10

A configuration states exact GF(2^8) arithmetic. The control rebuilds
lost blocks with the reference's decode computed in GF(2) instead: every
coefficient taken as 1, so each lost block is the XOR of the sources its
decode uses (what a plain-XOR parity scheme would compute,
the cheaper arithmetic a later change might be tempted by). Everything
else of the run is as the benchmark runs it: the same set-up, window,
traffic and check. It prints, per seed, each number the check compares
beside its limit; the benchmark's own runs never run it.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
for path in (ROOT, ROOT / "src"):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import harness  # noqa: E402
from portbench.reference import lrc  # noqa: E402


def _block_path(store, sid: int, block: int) -> Path:
    node = store.stripes[sid].node_of_block[block]
    return store.root / f"node{node}" / f"s{sid}_b{block}.blk"


def _read(path: Path) -> np.ndarray:
    return np.fromfile(path, dtype=np.uint8)


class _Decoder:
    """The reference's decode of a stripe's lost blocks from the block
    files of its surviving nodes, on the store's device, in GF(2)."""

    def __init__(self, store):
        cfg = store.cfg
        self.gen = lrc.generator(cfg.scheme, cfg.k, cfg.r, cfg.p)
        self.device = store.device

    def rebuild(self, store, sid: int, lost: list) -> dict:
        survivors = {b: torch.from_numpy(_read(_block_path(store, sid, b)))
                     .to(self.device)[None]
                     for b in range(store.n) if b not in lost}
        out = lrc.decode(self.gen, lost, survivors, xor_only=True)
        return {b: out[0, i].cpu().numpy() for i, b in enumerate(lost)}


class Report:
    """The fields of the program's repair report that the benchmark reads."""

    def __init__(self, **fields):
        self.__dict__.update(fields)


class Repair:
    """``repair_failed_nodes`` with the reference's GF(2) decode."""

    def repair(self, store, nodes):
        t0 = time.perf_counter()
        decoder = _Decoder(store)
        rebuilt = 0
        for sid, stripe in store.stripes.items():
            lost = [b for b, n in enumerate(stripe.node_of_block)
                    if n in nodes]
            for b, data in decoder.rebuild(store, sid, lost).items():
                data.tofile(_block_path(store, sid, b))
                rebuilt += 1
        wall = time.perf_counter() - t0
        return Report(stripes_repaired=len(store.stripes),
                      blocks_read=rebuilt * (store.n - len(nodes)),
                      wall_seconds=wall, read_seconds=0.0,
                      compute_seconds=wall, write_seconds=0.0,
                      overlap_seconds=0.0, overlap_ratio=0.0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    cell = harness.resolve(args.workload)
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        record = harness.run_cell(cell, seed, args.seconds, False,
                                  torch.device("cuda", 0),
                                  harness.process_start(), Repair())
        line = harness.result_line(cell, record, False, {})
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "correct": line["correct"],
                          "attempted": line["attempted"],
                          "checks": line["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
