"""The widest stripe, P8 (k=96, r=5, p=4, 105 nodes), on the CPU: the
reference's generators and placement equal the port's at P6 to P8, a
shrunk whole run of the P8 cell is correct and its control is not, and the
planner's global share reads what it should."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
for _p in (ROOT, ROOT / "src"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from portbench import control, harness  # noqa: E402
from portbench.reference import lrc  # noqa: E402

SEED = 2 ** 31 + 17
# The paper's P6, P7 and P8; P1 to P5 are pinned with the reference's
# own tests.
WIDE = [(48, 4, 3), (72, 4, 4), (96, 5, 4)]


@pytest.mark.parametrize("scheme", lrc.SCHEMES)
@pytest.mark.parametrize("krp", WIDE, ids=str)
def test_wide_generator_is_the_ports(scheme, krp):
    from repro_torch.core.schemes import make_scheme

    gen = lrc.generator(scheme, *krp)
    assert np.array_equal(gen, make_scheme(scheme, *krp).gen)


def test_placement_is_the_ports_on_105_nodes():
    from repro_torch.dist.topology import Topology, place_stripe

    for sid in range(70):
        assert lrc.placement("contiguous", 105, sid, 105, 7) \
            == place_stripe("contiguous", Topology(num_nodes=105), sid, 105)


def test_p8_run_is_correct_and_its_control_is_not():
    """The widest stripe's cell, shrunk as the harness's tests shrink the
    P5 cells (1 KiB blocks, 4 stripes): a sound run's every check reads 0,
    with global decodes of 96 reads in each repair; the control's rebuilt
    blocks are wrong. One intra-op thread: the tensors are small, and a
    parallel region per op stalls when the host's cores are all busy."""
    cell = harness.resolve("cp-azure-p8.repair-2node")
    cell.config = dict(cell.config, block_size=1024, stripes=4)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        sound = harness.run_cell(cell, SEED, 0.3, False,
                                 torch.device("cpu"), 0.0)
        wrong = harness.run_cell(cell, SEED, 0.3, False,
                                 torch.device("cpu"), 0.0, control.Repair())
    finally:
        torch.set_num_threads(threads)
    line = harness.result_line(cell, sound, False, {})
    assert line["correct"], line["checks"]
    assert all(c["value"] == 0 for c in line["checks"].values())
    assert line["attempted"] > 0 and line["failed"] == 0
    reps = [r["report"] for r in sound["repairs"]]
    assert all(r["repairs_global"] > r["repairs_local"] for r in reps)
    share = harness.load_module("layer_metrics",
                                "planner.global_share.repair").read(sound)
    assert share > 0.5
    line = harness.result_line(cell, wrong, False, {})
    assert not line["correct"]
    assert line["checks"]["rebuilt_blocks_wrong"]["value"] > 0


def _repair(local, glob, report=True):
    return {"t0": 0, "t1": 1, "bytes": 64 << 20, "blocks": 64,
            "report": {"blocks_read": 704, "repairs_local": local,
                       "repairs_global": glob} if report else None}


def test_global_share_counts_stripes_over_the_window():
    read = harness.load_module("layer_metrics",
                               "planner.global_share.repair").read
    record = {"kind": "repair", "window_start": 0.0,
              "repairs": [_repair(2, 28), _repair(4, 26),
                          _repair(0, 0, report=False)]}
    assert read(record) == pytest.approx(54 / 60)
    assert read({"kind": "repair", "repairs": [_repair(60, 0)]}) == 0.0
    # A record without the counters (the control's reports), with no
    # repair that completed, or of another kind reads nothing.
    bare = _repair(0, 0)
    del bare["report"]["repairs_local"], bare["report"]["repairs_global"]
    assert read({"kind": "repair", "repairs": [bare]}) is None
    assert read({"kind": "repair",
                 "repairs": [_repair(0, 0, report=False)]}) is None
    assert read({"kind": "read", "repairs": [_repair(2, 28)]}) is None
    assert read({"kind": "repair", "repairs": [_repair(0, 0)]}) is None
