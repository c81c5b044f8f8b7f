"""The paper's Azure-LRC baseline at P5, ``azure-p5.repair-1node``, on the
CPU: the cell as ``BENCHMARK.json`` states it, shrunk as the harness's
tests shrink a cell (1 KiB blocks, 4 stripes, one intra-op thread) and
with no link time, runs with every check 0 and its control is wrong.
With 4 stripes node x holds blocks x, x-7, x-14 and x-21 once each, so a
repair reads 4 x 12 blocks in classes 0 to 4 (data and the two local
parities, each from its group of 12) and 3 x 12 + 24 in classes 5 and 6,
whose G1 or G2 takes a 24-read global decode; the global read share is
what the reports count."""
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
for _p in (ROOT, ROOT / "src"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from portbench import control, harness  # noqa: E402

SEED = 2 ** 31 + 29
CELL = "azure-p5.repair-1node"


@pytest.fixture(scope="module")
def runs():
    """The cell run by the program (a window long enough for a turn of
    the 7 classes) and by the control."""
    cell = harness.resolve(CELL)
    assert cell.config["scheme"] == "azure"
    cell.config = dict(cell.config, block_size=1024, stripes=4,
                       io_stall_scale=0.0)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        sound = harness.run_cell(cell, SEED, 1.0, False,
                                 torch.device("cpu"), 0.0)
        wrong = harness.run_cell(cell, SEED, 0.3, False,
                                 torch.device("cpu"), 0.0, control.Repair())
    finally:
        torch.set_num_threads(threads)
    return cell, sound, wrong


def test_azure_p5_is_cp_azure_p5_but_for_the_code():
    cell, base = harness.resolve(CELL), harness.resolve(
        "cp-azure-p5.repair-1node")
    differ = {key for key in base.config.keys() | cell.config.keys()
              if base.config.get(key) != cell.config.get(key)}
    assert differ == {"name", "source", "scheme", "deployment"}
    assert cell.mix == base.mix and cell.chips == 1
    assert "planner.cascaded_share.repair" not in \
        {m["name"] for m in cell.per_layer}


def test_azure_p5_run_is_correct_and_its_control_is_not(runs):
    cell, sound, wrong = runs
    line = harness.result_line(cell, sound, False, {})
    assert line["correct"], line["checks"]
    assert all(c["value"] == 0 for c in line["checks"].values())
    assert line["attempted"] > 0 and line["failed"] == 0
    line = harness.result_line(cell, wrong, False, {})
    assert not line["correct"]
    assert line["checks"]["rebuilt_blocks_wrong"]["value"] > 0


def test_each_repair_reads_what_its_class_costs(runs):
    _, sound, _ = runs
    classes = set()
    for r in sound["repairs"]:
        (node,) = r["nodes"]
        rep = r["report"]
        glob = node % 7 in (5, 6)
        assert rep["blocks_read"] == (60 if glob else 48), node
        assert rep["reads_global"] == (24 if glob else 0), node
        assert rep["repairs_global"] == int(glob)
        assert rep["repairs_cascaded"] == 0
        classes.add(node % 7)
    assert classes == set(range(7))


def test_global_read_share_sums_over_the_window(runs):
    _, sound, _ = runs
    reps = [r["report"] for r in sound["repairs"]]
    share = harness.load_module(
        "layer_metrics", "planner.global_read_share.repair").read(sound)
    assert share == sum(r["reads_global"] for r in reps) \
        / sum(r["blocks_read"] for r in reps)
    assert 0 < share < 24 / 60


def _repair(reads, glob, report=True):
    return {"t0": 0, "t1": 1, "bytes": 64 << 20, "blocks": 64,
            "report": {"blocks_read": reads, "reads_global": glob}
            if report else None}


def test_global_read_share_reads_nothing_without_the_counter():
    read = harness.load_module("layer_metrics",
                               "planner.global_read_share.repair").read
    record = {"kind": "repair",
              "repairs": [_repair(768, 0), _repair(960, 384),
                          _repair(0, 0, report=False)]}
    assert read(record) == pytest.approx(384 / 1728)
    # A parent's reports, which lack the counter, no repair that
    # completed, or a record of another kind read nothing.
    bare = _repair(768, 0)
    del bare["report"]["reads_global"]
    assert read({"kind": "repair", "repairs": [bare]}) is None
    assert read({"kind": "repair",
                 "repairs": [_repair(0, 0, report=False)]}) is None
    assert read({"kind": "read", "repairs": [_repair(960, 384)]}) is None
