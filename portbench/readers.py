"""Arithmetic that several per-layer readers share."""
from __future__ import annotations

from portbench.bounds import gf256_matmul_seconds


def repair_reports(record) -> list:
    """The program's report of each repair that completed in the window."""
    if record.get("kind") != "repair":
        return []
    return [r["report"] for r in record["repairs"] if r["report"]]


def reports_with(record, *fields) -> list:
    """The window's reports that carry every one of ``fields``."""
    return [r for r in repair_reports(record)
            if all(f in r for f in fields)]


def per_repair_ms(record, field: str):
    reps = reports_with(record, field)
    if not reps:
        return None
    return 1e3 * sum(r[field] for r in reps) / len(reps)


def per_read_ms(record, field: str):
    """``field`` summed over the window's repairs, in ms, over the blocks
    they read."""
    reps = reports_with(record, field, "blocks_read")
    reads = sum(r["blocks_read"] for r in reps)
    if not reads:
        return None
    return 1e3 * sum(r[field] for r in reps) / reads


def ratio_of_sums(record, part, whole):
    """Sum over the window's repairs of ``part(report)`` over that of
    ``whole(report)``, each a function of one report; ``None`` where the
    reports lack a field either reads or the whole sums to 0."""
    try:
        reps = repair_reports(record)
        den = sum(whole(r) for r in reps)
        num = sum(part(r) for r in reps)
    except KeyError:
        return None
    return num / den if den else None


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
