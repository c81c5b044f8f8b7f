"""Where a repair's time goes, on the CPU (``device="cpu"``): the calling
thread's stage split (plan, read wait, copy in, kernel, copy out, drain
wait), the readers' busy time and the time with no read in flight, the
parts of a block read's own time, the bytes sent to the device, and the
same spans on a ``torch.profiler`` trace when, and only when, a profiler
records the calling thread."""
import collections
import dataclasses
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.ftx import (FleetRepairReport, RepairOptions,  # noqa: E402
                             StoreConfig, StripeStore, repair_failed_nodes)
from repro_torch.ftx.stripestore import SERVE_FIELDS, Telemetry  # noqa: E402

SPLIT = ("plan", "read_wait", "copy_in", "kernel", "copy_out", "drain_wait")
NAMES = {"repair.plan": "plan", "pipeline.read_wait": "read_wait",
         "pipeline.copy_in": "copy_in", "pipeline.kernel": "kernel",
         "pipeline.copy_out": "copy_out",
         "pipeline.drain_wait": "drain_wait"}
STALL = 0.05                       # share of each read's link time slept
# The parts of a block read's own time (Telemetry.read_<part>_seconds).
READ_PARTS = ("open", "copy", "sleep", "overshoot", "lock", "handoff", "cpu")


def _store(tmp_path, *, stripes=8, window=4, threads=4, stall=STALL):
    cfg = StoreConfig(scheme="cp-azure", k=6, r=2, p=2, block_size=4096,
                      batch_stripes=window, pipeline_window=window,
                      prefetch_threads=threads, io_stall_scale=stall)
    store = StripeStore(tmp_path, cfg, device="cpu")
    payload = np.random.default_rng(5).integers(
        0, 256, stripes * cfg.k * cfg.block_size, dtype=np.uint8)
    store.put("blob", payload.tobytes())
    store.seal()
    return store


def _repair(store, pipeline):
    return repair_failed_nodes(store, [0], device="cpu",
                               options=RepairOptions(pipeline=pipeline))


@pytest.mark.parametrize("pipeline", [True, False])
def test_repair_reports_its_split(tmp_path, pipeline):
    """Every part of the split is there, the three parts of compute fit
    inside it, the readers were busy at least the link time they slept
    and at most all of their wall time, and every block read went to the
    device once."""
    store = _store(tmp_path)
    rep = _repair(store, pipeline)
    assert rep.pipelined is pipeline and rep.blocks_read > 0
    waits = ("read_wait", "drain_wait")
    for stage in SPLIT:
        value = getattr(rep, f"{stage}_seconds")
        if pipeline or stage not in waits:
            assert value > 0, stage
        else:
            assert value == 0, stage
    assert (rep.copy_in_seconds + rep.kernel_seconds
            + rep.copy_out_seconds) <= rep.compute_seconds
    assert rep.read_wait_seconds <= rep.read_seconds
    assert rep.reader_busy_seconds >= rep.sim_seconds * STALL
    assert rep.reader_threads == (4 if pipeline else 1)
    assert 0 < rep.reader_occupancy <= 1
    assert rep.h2d_bytes == rep.blocks_read * store.cfg.block_size
    assert 0 < rep.no_read_seconds < rep.wall_seconds
    # The union of the reads lies between their longest share per reader
    # and their sum; on the synchronous path they never overlap.
    assert rep.no_read_seconds <= rep.wall_seconds \
        - rep.reader_busy_seconds / rep.reader_threads + 1e-9
    assert rep.no_read_seconds >= rep.wall_seconds \
        - rep.reader_busy_seconds - 1e-9
    if not pipeline:
        assert rep.no_read_seconds + rep.reader_busy_seconds \
            == pytest.approx(rep.wall_seconds, abs=1e-6)


@pytest.mark.parametrize("pipeline", [True, False])
def test_repair_splits_its_reads_own_time(tmp_path, pipeline):
    """Every part of a read's own time is there and none is negative; the
    parts the read waits out on its own thread fit inside the readers'
    busy time, with the rest (Python between the steps) left over; the
    sleep asked for is the scaled link time; only a reader pool hands
    reads off, and only its threads' CPU time is counted."""
    store = _store(tmp_path)
    rep = _repair(store, pipeline)
    parts = {part: getattr(rep, f"read_{part}_seconds")
             for part in READ_PARTS}
    assert all(v >= 0 for v in parts.values()), parts
    assert parts["open"] > 0 and parts["copy"] > 0 and parts["sleep"] > 0
    assert parts["sleep"] == pytest.approx(STALL * rep.sim_seconds)
    timed = (parts["open"] + parts["copy"] + parts["sleep"]
             + parts["overshoot"] + parts["lock"])
    assert timed <= rep.reader_busy_seconds + 1e-9
    assert rep.read_rest_seconds == pytest.approx(
        rep.reader_busy_seconds - timed)
    assert parts["cpu"] <= rep.reader_busy_seconds + 1e-6
    if pipeline:
        assert parts["handoff"] > 0 and parts["cpu"] > 0
    else:
        assert parts["handoff"] == 0 and parts["cpu"] == 0


def test_no_link_sleep_reads_no_sleep_or_overshoot(tmp_path):
    store = _store(tmp_path, stall=0.0)
    rep = _repair(store, True)
    assert rep.blocks_read > 0 and rep.read_copy_seconds > 0
    assert rep.read_sleep_seconds == 0 and rep.read_overshoot_seconds == 0


def test_a_degraded_read_counts_its_reads_as_copies(tmp_path):
    """A degraded read of a lost block reads its sources' byte ranges
    with ``np.fromfile``: the whole call is copy time, none is open
    time."""
    store = _store(tmp_path, stripes=1)
    sid = next(iter(store.stripes))
    node = store.stripes[sid].node_of_block[0]
    store.fail_node(node)
    before = store.telemetry.copy()
    store.read(sid, 0)
    tele = store.telemetry
    assert tele.degraded_reads == before.degraded_reads + 1
    assert tele.blocks_read > before.blocks_read
    assert tele.read_copy_seconds > before.read_copy_seconds
    assert tele.read_open_seconds == before.read_open_seconds
    assert tele.read_handoff_seconds == before.read_handoff_seconds


def test_store_telemetry_sums_the_split_over_repairs(tmp_path):
    store = _store(tmp_path)
    reps = [_repair(store, True), _repair(store, False)]
    tele = store.telemetry
    reads = [f"read_{part}_seconds" for part in READ_PARTS]
    for field in [f"{s}_seconds" for s in SPLIT] + [
            "reader_busy_seconds", "h2d_bytes"] + reads:
        assert getattr(tele, field) == pytest.approx(
            sum(getattr(r, field) for r in reps)), field
    assert tele.no_read_seconds >= sum(r.no_read_seconds for r in reps)
    snap = tele.reset()
    assert snap.h2d_bytes == sum(r.h2d_bytes for r in reps)
    assert snap.read_sleep_seconds == pytest.approx(
        sum(r.read_sleep_seconds for r in reps))
    assert tele.h2d_bytes == 0 and tele.reader_busy_seconds == 0
    assert all(getattr(tele, f"{s}_seconds") == 0 for s in SPLIT)
    assert all(getattr(tele, field) == 0 for field in reads)
    # A repair's result carries every repair field of the telemetry and
    # every field of the report; a degraded read moves the serving
    # fields; reset() then returns every field to its default.
    store.fail_node(0)
    got = store.repair_all()
    store.revive_node(0)
    fields = [f.name for f in dataclasses.fields(Telemetry)]
    assert {f for f in fields if f not in SERVE_FIELDS} <= set(got)
    assert not set(SERVE_FIELDS) & set(got)
    assert {f.name for f in dataclasses.fields(FleetRepairReport)} \
        - {"failed_nodes", "plan_cache"} <= set(got)
    sid = next(iter(store.stripes))
    store.fail_node(store.stripes[sid].node_of_block[0])
    store.read(sid, 0)
    assert tele.degraded_reads == 1 and tele.served_bytes > 0
    moved = [f for f in fields
             if getattr(tele, f) != getattr(Telemetry(), f)]
    assert len(moved) > len(fields) // 2
    tele.reset()
    for f in dataclasses.fields(Telemetry):
        assert getattr(tele, f.name) == getattr(Telemetry(), f.name), f.name


def _span_sums(prof):
    sums, counts = collections.defaultdict(float), collections.Counter()
    for evt in prof.events():
        if evt.name in NAMES:
            sums[NAMES[evt.name]] += (evt.time_range.end
                                      - evt.time_range.start) / 1e6
            counts[evt.name] += 1
    return sums, counts


@pytest.mark.parametrize("pipeline", [True, False])
def test_spans_show_on_a_profiler_trace(tmp_path, pipeline):
    """Under a CPU profiler the calling thread's spans are events of the
    same names, whose durations sum to the report's split within 1 ms.
    One stripe makes one window, so no reader or writer thread runs
    Python while a span opens or closes. The process can still be
    preempted between a span's clock and its event's (a loaded host does
    that for milliseconds), so each stage is held to the closest of three
    traced repairs: a span that timed other code than its event would
    miss in all three."""
    store = _store(tmp_path, stripes=1)
    _repair(store, pipeline)                       # plans cached
    want = set(NAMES) if pipeline else {
        "repair.plan", "pipeline.copy_in", "pipeline.kernel",
        "pipeline.copy_out"}
    misses = collections.defaultdict(list)
    for _ in range(3):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with torch.profiler.record_function("warm-up"):
                pass
            rep = _repair(store, pipeline)
        sums, counts = _span_sums(prof)
        assert set(counts) == want
        assert counts["pipeline.kernel"] == rep.launches
        for stage in sums:
            misses[stage].append(
                abs(sums[stage] - getattr(rep, f"{stage}_seconds")))
    assert {stage: min(m) for stage, m in misses.items()
            if min(m) > 1e-3} == {}


def test_no_span_is_opened_unless_the_caller_is_profiled(tmp_path,
                                                         monkeypatch):
    """With no profiler, or one that records another thread, the repair
    opens no ``record_function`` at all."""
    store = _store(tmp_path, stripes=2)
    opened = []
    real = torch.profiler.record_function

    def counting(name, *args, **kwargs):
        opened.append(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    _repair(store, True)
    _repair(store, False)
    assert opened == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        worker = threading.Thread(target=_repair, args=(store, True))
        worker.start()
        worker.join()
    assert opened == [] and not _span_sums(prof)[1]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        _repair(store, True)
    assert set(opened) == set(NAMES)


def test_compiled_plans_are_spans_inside_the_planning(tmp_path):
    """Each plan the planning compiles (a cache miss) is one
    ``planner.compile`` span inside ``repair.plan``; their durations sum
    to the report's ``plan_compile_seconds`` within 1 ms. A repair whose
    plans are cached compiles none."""
    store = _store(tmp_path, stripes=2)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("warm-up"):
            pass
        rep = _repair(store, True)
    spans = [e for e in prof.events() if e.name == "planner.compile"]
    plan = [e for e in prof.events() if e.name == "repair.plan"]
    assert len(spans) == rep.plans_compiled == rep.patterns > 0
    assert all(any(p.time_range.start <= e.time_range.start
                   and e.time_range.end <= p.time_range.end for p in plan)
               for e in spans)
    assert sum(e.time_range.end - e.time_range.start
               for e in spans) / 1e6 == pytest.approx(
                   rep.plan_compile_seconds, abs=1e-3)
    assert 0 < rep.plan_compile_seconds <= rep.plan_seconds
    again = _repair(store, False)
    assert (again.plans_compiled, again.plan_compile_seconds) == (0, 0.0)
