"""The benchmark's generic half: find a cell's files by name, run its
driver, read its metrics, decide and print its result.

A cell of ``BENCHMARK.json`` names a configuration (``configs/<name>.json``)
and a traffic mix (``mixes/<name>.json``), whose ``driver`` key names a
module of ``drivers/``. Each end-to-end metric is read by
``end_to_end/<name>.py`` and each per-layer metric by
``layer_metrics/<name>.py``: a function ``read(record)`` that returns a
number, or ``None`` where the run's record holds nothing for it. No table
of names lives in code, so a new cell, mix or metric is new files and new
entries of ``BENCHMARK.json``.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# Top-level module names that may not be loaded in the process that
# prints a result: the JAX stack and the JAX package the program was
# ported from. Compared whole, so the program's own package, whose name
# begins with the JAX package's, does not match.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    end_to_end: list
    per_layer: list


@dataclasses.dataclass
class Context:
    """What a driver is given: the cell, the run's arguments, the device,
    a scratch directory under ``TMPDIR`` and the process's start on the
    ``time.perf_counter`` clock. ``system`` replaces the code under test
    (the control runs the reference in its place); ``None`` is the
    program."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: Any
    workdir: Path
    t_process: float
    system: Any = None


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def resolve(name: str, bench_path: Path = ROOT / "BENCHMARK.json") -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration, its
    mix and the metrics it reports."""
    bench = load_json(bench_path)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"portbench: no workload {name!r} in "
                         f"{bench_path.name} (have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(ROOT / configs[w["config"]]["file"])
    mix = load_json(HERE / "mixes" / f"{w['traffic']}.json")

    def here(metric):
        return name in metric.get("workloads", [name])

    e2e = [m for m in bench["end_to_end"] if here(m)]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if here(m) and m["moves"] in moved]
    return Cell(name=name, chips=int(w["chips"]), config=config, mix=mix,
                end_to_end=e2e, per_layer=layer)


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` of this folder as a module; names may hold
    dots, so it is loaded from its path."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"portbench: no {kind} file {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def driver(cell: Cell):
    return importlib.import_module(f"portbench.drivers.{cell.mix['driver']}")


def read_metrics(specs: list, record: dict) -> dict:
    """``{name: {"value", "unit"}}`` for each metric whose reader finds
    something in ``record``."""
    out = {}
    for spec in specs:
        # End-to-end metrics carry a bound; per-layer metrics never do.
        value = load_module("end_to_end" if spec.get("bound") is not None
                            else "layer_metrics", spec["name"]).read(record)
        if value is not None and not math.isfinite(value):
            # A time over work that never finished: JSON holds no
            # infinity, so the reading goes to the log only.
            print(f"portbench: {spec['name']} read {value}", file=sys.stderr)
        elif value is not None:
            out[spec["name"]] = {"value": float(value), "unit": spec["unit"]}
    return out


def io_counters() -> dict:
    """This process's I/O counters from ``/proc/self/io`` (Linux)."""
    try:
        with open("/proc/self/io") as f:
            return {k: int(v) for k, v in
                    (line.split(":") for line in f if ":" in line)}
    except OSError:
        return {}


def forbidden_modules() -> list[str]:
    top = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(top.intersection(FORBIDDEN_MODULES))


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() or None


def process_start() -> float:
    """The process's start on the ``time.perf_counter`` clock (to the
    kernel's 10 ms tick), or now where ``/proc`` does not say."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return now
    return now - max(0.0, uptime - started)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_process: float, system=None) -> dict:
    """Run one cell once on ``device`` and return the driver's record:
    metrics' inputs, the checks (``{name: (value, limit)}``), ``attempted``,
    ``failed`` and the device readings."""
    with tempfile.TemporaryDirectory(prefix="portbench-") as tmp:
        ctx = Context(cell=cell, seed=seed, seconds=seconds, trace=trace,
                      device=device, workdir=Path(tmp),
                      t_process=t_process, system=system)
        return driver(cell).run(ctx)


def result_line(cell: Cell, record: dict, trace: bool,
                device_fields: dict) -> dict:
    metrics = read_metrics(cell.per_layer if trace else cell.end_to_end,
                           record)
    checks = record["checks"]
    correct = all(value <= limit for value, limit in checks.values())
    line = {"correct": correct, "attempted": int(record["attempted"]),
            "failed": int(record["failed"]), "metrics": metrics,
            "device": device_fields}
    if trace and record.get("breakdown"):
        line["breakdown"] = record["breakdown"]
    line["checks"] = {name: {"value": value, "limit": limit}
                      for name, (value, limit) in checks.items()}
    return line


def main(argv=None) -> int:
    t_process = process_start()
    args = parse_args(argv)
    cell = resolve(args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA card(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    record = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), t_process)
    fields = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips,
              "memory_peak_bytes": int(record["memory_peak_bytes"])}
    if args.trace:
        fields["busy_s"] = record["busy_s"]
        fields["window_s"] = record["window_s"]
    fields["power"] = power_limit()
    line = result_line(cell, record, bool(args.trace), fields)
    # Last, once every reader has been loaded: nothing that runs before
    # the result is printed may bring in a forbidden module unseen.
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    print(json.dumps({"io": io_counters(), "setup_s": record["setup_s"],
                      "window_s": record["window_s"]}))
    for name, check in line["checks"].items():
        print(f"check {name}: {check['value']} (limit {check['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0
