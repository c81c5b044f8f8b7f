"""Node repair, back to back: fail a node (or a group of nodes), take
its block files away so that only the repair can bring them back, run
the repair, and again, until the window's seconds have passed.

Mix keys: ``nodes_per_repair`` (how many nodes each repair loses) and
``node_gap`` (a repair of node x loses x, x + gap, ...). The order of
the repairs comes from the seed, stratified: nodes whose loss costs the
same work (the same blocks of the same stripes lost) form a stratum, and
each turn takes one node of each stratum, the strata always in the same
order, so every seed's window holds the same sequence of repair shapes
and only the nodes differ.

Every rebuilt file is kept until the check: before a node is failed
again, the files an earlier repair wrote for it are moved aside, not
overwritten.
"""
from __future__ import annotations

import dataclasses
import os
import sys
import time
from collections import defaultdict

import numpy as np

from portbench import fleet as fleet_lib
from portbench.profiling import WINDOW, Tracer


class Program:
    """The code under test."""

    def repair(self, store, nodes):
        from repro_torch.ftx import repair_failed_nodes

        return repair_failed_nodes(store, nodes, device=store.device)


def failure_sets(mix: dict, num_nodes: int) -> list[tuple[int, ...]]:
    per, gap = int(mix["nodes_per_repair"]), int(mix.get("node_gap", 1))
    return [tuple((x + i * gap) % num_nodes for i in range(per))
            for x in range(num_nodes)]


def stratified_order(fl, sets: list, seed: int) -> list:
    """``sets`` in a seeded order that takes one set of each stratum (the
    same lost blocks, stripe by stripe, up to order) in turn. The strata
    come in one fixed order in every turn and for every seed; the seed
    picks which set of each stratum a turn takes."""
    strata = defaultdict(list)
    for nodes in sets:
        lost = sorted(tuple(sorted(fl.block_on(sid, node) for node in nodes))
                      for sid in range(len(fl.nodes_of)))
        strata[tuple(lost)].append(nodes)
    rng = np.random.default_rng([seed, 1])
    groups = [list(g) for g in strata.values()]
    for g in groups:
        rng.shuffle(g)
    order = []
    for turn in range(max(len(g) for g in groups)):
        for g in groups:
            if turn < len(g):
                order.append(g[turn])
    return order


class Files:
    """Where each repair's rebuilt blocks ended up."""

    def __init__(self, fl, archive):
        self.fl = fl
        self.archive = archive
        self.owner: dict = {}          # (sid, block) -> repair at its path
        self.outputs: list = []        # repair -> {(sid, block): path}

    def lost(self, nodes) -> list:
        return [(sid, self.fl.block_on(sid, node))
                for node in nodes for sid in range(len(self.fl.nodes_of))]

    def retire(self, nodes) -> None:
        """Take the nodes' block files away: sealed ones are unlinked
        (their bytes stay under ``sealed/``), rebuilt ones moved aside."""
        for sid, b in self.lost(nodes):
            path = self.fl.path(sid, b)
            j = self.owner.pop((sid, b), None)
            if j is None:
                path.unlink(missing_ok=True)
                continue
            dest = self.archive / f"r{j}"
            dest.mkdir(parents=True, exist_ok=True)
            try:
                os.replace(path, dest / path.name)
                self.outputs[j][(sid, b)] = dest / path.name
            except FileNotFoundError:
                self.outputs[j][(sid, b)] = None

    def repaired(self, nodes) -> list:
        i = len(self.outputs)
        self.outputs.append({})
        blocks = self.lost(nodes)
        for key in blocks:
            self.owner[key] = i
            self.outputs[i][key] = self.fl.path(*key)
        return blocks


# Properties of the program's report that the readers see beside its
# fields.
REPORT_PROPERTIES = ("overlap_ratio", "read_rest_seconds")


def report_fields(rep) -> dict:
    """Every field of the repair's report that holds a number, a flag or a
    name (its dataclass fields; the public attributes of another object),
    and the properties above: a counter the program adds reaches the
    readers with no edit here."""
    if dataclasses.is_dataclass(rep):
        names = [f.name for f in dataclasses.fields(rep)]
        names += [n for n in REPORT_PROPERTIES if hasattr(rep, n)]
    else:
        names = [n for n in dir(rep) if not n.startswith("_")]
    out = {}
    for name in names:
        value = getattr(rep, name)
        if isinstance(value, (int, float, bool, str)):
            out[name] = value
    return out


def run(ctx) -> dict:
    system = ctx.system or Program()
    mix, cfg = ctx.cell.mix, ctx.cell.config
    fl = fleet_lib.build(ctx)
    store = fl.store
    order = stratified_order(fl, failure_sets(mix, cfg["nodes"]), ctx.seed)
    files = Files(fl, ctx.workdir / "archive")
    repairs = []

    def one(nodes, in_window: bool, tracer) -> None:
        with tracer.mark("portbench.retire"):
            files.retire(nodes)
        t0 = time.perf_counter()
        try:
            with tracer.mark("portbench.repair"):
                rep = system.repair(store, nodes)
            fields = report_fields(rep)
        except Exception as err:        # counted as failed, then checked
            print(f"portbench: repair of nodes {list(nodes)} raised "
                  f"{err!r}", file=sys.stderr)
            for node in nodes:
                store.revive_node(node)
            fields = None
        t1 = time.perf_counter()
        blocks = files.repaired(nodes)
        repairs.append({"nodes": list(nodes), "t0": t0, "t1": t1,
                        "blocks": len(blocks),
                        "bytes": len(blocks) * cfg["block_size"],
                        "report": fields, "in_window": in_window})

    off = Tracer(False)
    for i in range(int(mix.get("warmup_repairs", 1))):
        one(order[-1 - i % len(order)], False, off)
    tracer = Tracer(ctx.trace)
    with tracer:
        t_start = time.perf_counter()
        with tracer.mark(WINDOW):
            i = 0
            while time.perf_counter() - t_start < ctx.seconds:
                one(order[i % len(order)], True, tracer)
                i += 1
            t_end = time.perf_counter()
    record = fleet_lib.device_record(ctx, tracer, t_start, t_end)
    placed = fleet_lib.release(fl)

    ref = fleet_lib.Reference(fl, ctx.device)
    checks = fleet_lib.common_checks(fl, ref, placed)
    wrong = failed = attempted = 0
    for rep, outputs in zip(repairs, files.outputs):
        bad = [(sid, b) for (sid, b), path in outputs.items()
               if path is None
               or ref.wrong(sid, b, fleet_lib.read_file(path))]
        wrong += len(bad)
        bad_stripes = {sid for sid, _ in bad}
        if rep["report"] is None:
            bad_stripes = set(range(len(fl.nodes_of)))
        if rep["in_window"]:
            attempted += len(fl.nodes_of)
            failed += len(bad_stripes)
    checks["rebuilt_blocks_wrong"] = (wrong, 0)
    window = [r for r in repairs if r["in_window"]]
    print("portbench: repairs (nodes, seconds, blocks read): " + ", ".join(
        f"{r['nodes']} {r['t1'] - r['t0']:.3f} "
        f"{r['report']['blocks_read'] if r['report'] else '-'}"
        for r in window), file=sys.stderr)
    checks["repairs_raised"] = (sum(r["report"] is None for r in repairs), 0)
    record.update(
        kind="repair", checks=checks, attempted=attempted, failed=failed,
        window_start=t_start, repairs=window,
        block_size=cfg["block_size"])
    return record
