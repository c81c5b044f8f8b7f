"""The readers see every field of a repair's report: after a small CPU
repair through the driver every scalar field of ``FleetRepairReport`` is
in the record, each reader of the report's parts reads a number there and
nothing where the fields are missing, and the older readers read what
they read from the fixed list of keys the driver used to keep."""
import dataclasses
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
for _p in (ROOT, ROOT / "src"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from portbench import harness  # noqa: E402
from portbench.drivers import repair  # noqa: E402

SEED = 2 ** 31 + 29
PARTS = ["pipeline.read_open_ms.repair", "pipeline.read_overshoot_ms.repair",
         "pipeline.read_copy_ms.repair", "pipeline.read_wait_ms.repair",
         "pipeline.no_read_ms.repair", "pipeline.reader_occupancy.repair",
         "planner.compile_ms.repair", "planner.cascaded_share.repair",
         "kernels.table_chunks_per_launch.repair"]
OLDER = ["planner.reads_per_block.repair", "pipeline.read_ms.repair",
         "pipeline.write_ms.repair", "pipeline.overlap_ratio.repair",
         "engine.compute_ms.repair", "gf256_matmul_roofline.repair",
         "device.idle_share.repair", "device.h2d_ms.repair",
         "planner.global_share.repair"]
# The keys the driver kept before it took the whole report.
OLD_KEYS = ("stripes_repaired", "patterns", "launches", "windows",
            "blocks_read", "wall_seconds", "read_seconds",
            "compute_seconds", "write_seconds", "overlap_seconds",
            "repairs_local", "repairs_global", "overlap_ratio")


@pytest.fixture(scope="module")
def record():
    cell = harness.resolve("cp-uniform-p5.repair-2node")
    cell.config = dict(cell.config, block_size=1024, stripes=4)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        rec = harness.run_cell(cell, SEED, 0.3, False, torch.device("cpu"),
                               0.0)
    finally:
        torch.set_num_threads(threads)
    assert all(v <= lim for v, lim in rec["checks"].values())
    # A traced run's numbers, so that the device's readers read too.
    rec["trace"] = {"busy_us": 100.0, "window_us": 1e6,
                    "by_kind": {"kernel": 40.0, "h2d": 50.0, "d2h": 10.0,
                                "other": 0.0}}
    return rec


def _read(name, record):
    return harness.load_module("layer_metrics", name).read(record)


def _with_reports(record, keep):
    repairs = [dict(r, report={k: v for k, v in r["report"].items()
                               if keep(k)} if r["report"] else None)
               for r in record["repairs"]]
    return dict(record, repairs=repairs)


def test_every_scalar_field_of_the_report_is_kept(record):
    from repro_torch.ftx.fleet import FleetRepairReport

    reps = [r["report"] for r in record["repairs"] if r["report"]]
    assert reps
    for rep in reps:
        for f in dataclasses.fields(FleetRepairReport):
            if f.name in ("failed_nodes", "plan_cache",
                          "gather_bytes_per_shard"):
                assert f.name not in rep
            else:
                assert f.name in rep, f.name
        assert {"overlap_ratio", "read_rest_seconds"} <= set(rep)
        assert all(isinstance(v, (int, float, bool, str))
                   for v in rep.values())


def test_a_field_the_report_gains_reaches_the_readers():
    @dataclasses.dataclass
    class Report:
        blocks_read: int
        nodes: tuple
        read_wait_seconds: float = 0.5
        later_counter: int = 3

        @property
        def overlap_ratio(self):
            return 0.25

    fields = repair.report_fields(Report(blocks_read=7, nodes=(1, 2)))
    assert fields == {"blocks_read": 7, "read_wait_seconds": 0.5,
                      "later_counter": 3, "overlap_ratio": 0.25}


@pytest.mark.parametrize("name", PARTS)
def test_each_reader_of_the_parts_reads_a_number(name, record):
    value = _read(name, record)
    assert isinstance(value, float) and value >= 0.0
    bare = _with_reports(record, lambda k: k in OLD_KEYS)
    assert _read(name, bare) is None
    assert _read(name, dict(record, kind="read")) is None
    assert _read(name, dict(record, repairs=[])) is None


def test_the_parts_are_the_reports_sums(record):
    reps = [r["report"] for r in record["repairs"] if r["report"]]
    reads = sum(r["blocks_read"] for r in reps)
    for name, field in (("pipeline.read_open_ms.repair", "read_open_seconds"),
                        ("pipeline.read_overshoot_ms.repair",
                         "read_overshoot_seconds"),
                        ("pipeline.read_copy_ms.repair",
                         "read_copy_seconds")):
        assert _read(name, record) == pytest.approx(
            1e3 * sum(r[field] for r in reps) / reads)
    assert _read("pipeline.read_wait_ms.repair", record) == pytest.approx(
        1e3 * sum(r["read_wait_seconds"] for r in reps) / len(reps))
    assert _read("pipeline.reader_occupancy.repair", record) == \
        pytest.approx(sum(r["reader_busy_seconds"] for r in reps)
                      / sum(r["reader_threads"] * r["wall_seconds"]
                            for r in reps))
    cascaded = _read("planner.cascaded_share.repair", record)
    assert cascaded == pytest.approx(
        sum(r["repairs_cascaded"] for r in reps)
        / sum(r["repairs_local"] + r["repairs_global"] for r in reps))
    # K1 does not run on the CPU: no table chunks.
    assert _read("kernels.table_chunks_per_launch.repair", record) == 0.0


@pytest.mark.parametrize("name", OLDER)
def test_the_older_readers_read_what_they_read(name, record):
    old = _with_reports(record, lambda k: k in OLD_KEYS)
    assert _read(name, record) == _read(name, old)
    assert _read(name, record) is not None
