"""A baseline of the paper enters the harness with new files only: the
Azure-LRC P5 deployment, as a configuration file beside cp-azure-p5's
would state it, runs through the harness on the CPU with every check 0,
and its control is found wrong."""
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
for _p in (ROOT, ROOT / "src"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from portbench import control, harness  # noqa: E402

SEED = 2 ** 31 + 23


@pytest.fixture(scope="module")
def runs():
    """The one-node P5 cell with Azure-LRC in its configuration, shrunk as
    the P8 test shrinks its cell (1 KiB blocks, 4 stripes, one intra-op
    thread), run by the program and by the control."""
    cell = harness.resolve("cp-azure-p5.repair-1node")
    cell.config = dict(cell.config, scheme="azure", block_size=1024,
                       stripes=4)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        sound = harness.run_cell(cell, SEED, 0.3, False,
                                 torch.device("cpu"), 0.0)
        wrong = harness.run_cell(cell, SEED, 0.3, False,
                                 torch.device("cpu"), 0.0, control.Repair())
    finally:
        torch.set_num_threads(threads)
    return cell, sound, wrong


def test_azure_lrc_run_is_correct(runs):
    cell, sound, _ = runs
    line = harness.result_line(cell, sound, False, {})
    assert line["correct"], line["checks"]
    assert all(c["value"] == 0 for c in line["checks"].values())
    assert line["attempted"] > 0 and line["failed"] == 0


def test_azure_lrc_takes_no_cascade(runs):
    _, sound, _ = runs
    reps = [r["report"] for r in sound["repairs"]]
    assert all(r["repairs_cascaded"] == 0 for r in reps)
    share = harness.load_module("layer_metrics",
                                "planner.cascaded_share.repair").read(sound)
    assert share == 0.0


def test_azure_lrc_control_is_wrong(runs):
    cell, _, wrong = runs
    line = harness.result_line(cell, wrong, False, {})
    assert not line["correct"]
    assert line["checks"]["rebuilt_blocks_wrong"]["value"] > 0
