"""The check that decides ``correct``, driven through whole runs of every
cell at a small size on the CPU: sound runs pass it; the control (the
reference in the program's place, in GF(2)) and each fault that a cell
can have, planted in the program underneath, fail it."""
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
for _p in (ROOT, ROOT / "src"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from portbench import control, harness  # noqa: E402

REPAIRS = ["cp-azure-p5.repair-1node", "cp-uniform-p5.repair-2node"]
SEED = 2 ** 31 + 17


def small(name: str):
    cell = harness.resolve(name)
    cell.config = dict(cell.config, block_size=2048, stripes=6)
    return cell


def run(name: str, system=None) -> dict:
    cell = small(name)
    record = harness.run_cell(cell, SEED, 0.4, False, torch.device("cpu"),
                              0.0, system)
    return harness.result_line(cell, record, False, {})


@pytest.mark.parametrize("name", REPAIRS)
def test_sound_run_is_correct(name):
    line = run(name)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {m["name"]
                                    for m in small(name).end_to_end}


@pytest.mark.parametrize("name", REPAIRS)
def test_control_is_not_correct(name):
    line = run(name, control.Repair())
    assert not line["correct"]
    assert line["checks"]["rebuilt_blocks_wrong"]["value"] > 0


class _Report:
    stripes_repaired = blocks_read = 0
    wall_seconds = read_seconds = compute_seconds = write_seconds = 0.0
    overlap_seconds = overlap_ratio = 0.0


def _unchanged(monkeypatch):
    """A repair that returns with the store as it was."""
    import repro_torch.ftx

    def repair_failed_nodes(store, nodes, **_):
        return _Report()

    monkeypatch.setattr(repro_torch.ftx, "repair_failed_nodes",
                        repair_failed_nodes)


def _half_batch(monkeypatch):
    """Each repair window writes back only the first half of its stripes."""
    from repro_torch.ftx.stripestore import StripeStore

    finish = StripeStore._finish_repair

    def half(self, sids, down, plan, rebuilt, *args):
        keep = max(1, len(sids) // 2)
        return finish(self, sids[:keep], down, plan,
                      {b: v[:keep] for b, v in rebuilt.items()}, *args)

    monkeypatch.setattr(StripeStore, "_finish_repair", half)


def _altered(monkeypatch):
    """One byte of every launch's result flipped where it is produced."""
    from repro_torch.core.engine import BatchedCodecEngine

    execute = BatchedCodecEngine.execute

    def flipped(self, *args, **kwargs):
        out = execute(self, *args, **kwargs).clone()
        out.view(-1)[0] ^= 1
        return out

    monkeypatch.setattr(BatchedCodecEngine, "execute", flipped)


@pytest.mark.parametrize("name", REPAIRS)
@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _altered],
                         ids=["unchanged", "half_batch", "altered"])
def test_repair_faults_are_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    line = run(name)
    assert not line["correct"]
    assert line["checks"]["rebuilt_blocks_wrong"]["value"] > 0
    assert line["failed"] > 0
