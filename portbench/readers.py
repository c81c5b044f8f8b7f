"""Arithmetic that several per-layer readers share."""
from __future__ import annotations

from portbench.bounds import gf256_matmul_seconds


def repair_reports(record) -> list:
    """The program's report of each repair that completed in the window."""
    if record.get("kind") != "repair":
        return []
    return [r["report"] for r in record["repairs"] if r["report"]]


def per_repair_ms(record, field: str):
    reps = repair_reports(record)
    if not reps:
        return None
    return 1e3 * sum(r[field] for r in reps) / len(reps)


def roofline_percent(record, kind: str):
    """Least time of the window's GF(2^8) launches, from the program's
    counts of blocks read and rebuilt, over the device time the trace
    gives the program's kernels, in %."""
    trace = record.get("trace")
    if record.get("kind") != kind or not trace:
        return None
    kernel_s = trace["by_kind"]["kernel"] / 1e6
    done = [r for r in record["repairs"] if r["report"]]
    if kernel_s <= 0 or not done:
        return None
    bound = gf256_matmul_seconds(
        sum(r["report"]["blocks_read"] for r in done),
        sum(r["blocks"] for r in done), record["block_size"])
    return 100.0 * bound / kernel_s


def idle_share(record, kind: str):
    trace = record.get("trace")
    if record.get("kind") != kind or not trace or trace["window_us"] <= 0:
        return None
    return 1.0 - trace["busy_us"] / trace["window_us"]
