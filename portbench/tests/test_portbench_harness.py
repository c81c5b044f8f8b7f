"""The benchmark's harness on the CPU: every cell finds its files, the
metric arithmetic, the generators, and the refusals (no card, no program,
a forbidden module)."""
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
for _p in (ROOT, ROOT / "src"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from portbench import bounds, harness, profiling  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_file_keeps_to_its_format():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"]
    assert BENCH["paths"] == ["portbench"]
    assert (ROOT / BENCH["command"][1]).is_file()
    assert 1 <= BENCH["run_seconds"] <= 51
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        names += [w["name"], w["traffic"]]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "bound" not in m
        assert set(m["workloads"]) <= set(CELLS)
    assert all(NAME.match(n) for n in names)
    assert len(set(m["name"] for m in BENCH["end_to_end"]
                   + BENCH["per_layer"])) \
        == len(BENCH["end_to_end"]) + len(BENCH["per_layer"])


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_resolves_to_its_files(name):
    cell = harness.resolve(name)
    assert {"scheme", "k", "r", "p", "nodes", "block_size", "stripes",
            "placement", "backend", "link_gbps", "io_stall_scale",
            "source", "assumed", "reduced"} <= set(cell.config)
    assert harness.driver(cell).run
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer
    for spec in cell.end_to_end:
        assert callable(harness.load_module("end_to_end", spec["name"]).read)
    for spec in cell.per_layer:
        assert spec["moves"] in reported
        assert callable(harness.load_module("layer_metrics",
                                            spec["name"]).read)


def _repair(t0, t1, mib=64, report=True):
    return {"t0": t0, "t1": t1, "bytes": mib << 20, "blocks": mib,
            "report": {"blocks_read": 11 * mib, "read_seconds": 0.4,
                       "compute_seconds": 0.1, "write_seconds": 0.2,
                       "overlap_seconds": 0.2} if report else None}


def test_repair_rate_is_all_work_over_all_time():
    record = {"kind": "repair", "window_start": 10.0,
              "repairs": [_repair(10.0, 10.5), _repair(10.5, 11.5),
                          _repair(11.5, 12.0, report=False)]}
    read = harness.load_module("end_to_end", "repair_MiB_s").read
    assert read(record) == pytest.approx(128 / 1.5)
    per_block = harness.load_module("layer_metrics",
                                    "planner.reads_per_block.repair").read
    assert per_block(record) == pytest.approx(11.0)
    overlap = harness.load_module("layer_metrics",
                                  "pipeline.overlap_ratio.repair").read
    assert overlap(record) == pytest.approx(0.4 / 1.4)


def test_traced_readers_and_the_device_record():
    device = [("gf256_matmul_kernel<1, true>", 100, 110),
              ("Memcpy HtoD (Pageable -> Device)", 50, 100),
              ("Memcpy DtoH (Device -> Pageable)", 110, 120),
              ("Memcpy HtoD (Pageable -> Device)", 300, 400)]
    host = [("portbench.repair", 0, 1000), ("aten::copy_", 180, 240)]
    summary = profiling.reduce(device, host, (0, 1000))
    assert summary["busy_us"] == 170
    assert summary["by_kind"] == {"kernel": 10, "h2d": 150, "d2h": 10,
                                  "other": 0}
    assert summary["idle_gaps"][0] == ["portbench.repair / host code "
                                       "outside torch", 600 / 1e6]
    assert summary["idle_gaps"][1][0] == "portbench.repair / aten::copy_"
    record = {"kind": "repair", "trace": summary, "block_size": 1 << 20,
              "repairs": [_repair(0, 1), _repair(1, 2, report=False)]}
    # 704 blocks read and 64 rebuilt by the repair that completed, each
    # moved once at the HBM rate.
    bound = bounds.gf256_matmul_seconds(704, 64, 1 << 20)
    assert bound == pytest.approx(768 * 2 ** 20 / 3.35e12)
    roof = harness.load_module("layer_metrics",
                               "gf256_matmul_roofline.repair").read
    assert roof(record) == pytest.approx(100 * bound / 10e-6)
    idle = harness.load_module("layer_metrics", "device.idle_share.repair")
    assert idle.read(record) == pytest.approx(0.83)
    h2d = harness.load_module("layer_metrics", "device.h2d_ms.repair")
    assert h2d.read(record) == pytest.approx(0.075)
    assert roof(dict(record, trace=None)) is None
    assert roof(dict(record, kind="read")) is None


def test_generators_are_deterministic_per_seed():
    from portbench import fleet

    cfg = {"stripes": 3, "k": 4, "block_size": 64}
    cpu = torch.device("cpu")
    assert torch.equal(fleet.make_data(cfg, 2 ** 31 + 9, cpu),
                       fleet.make_data(cfg, 2 ** 31 + 9, cpu))
    assert not torch.equal(fleet.make_data(cfg, 1, cpu),
                           fleet.make_data(cfg, 2, cpu))


def test_repair_order_is_stratified_and_seeded():
    from portbench.drivers import repair
    from portbench.reference import lrc

    class Fl:
        nodes_of = [lrc.placement("contiguous", 28, s, 28, 7)
                    for s in range(64)]

        def block_on(self, sid, node):
            return self.nodes_of[sid].index(node)

    fl = Fl()
    for mix in ({"nodes_per_repair": 1},
                {"nodes_per_repair": 2, "node_gap": 1}):
        sets = repair.failure_sets(mix, 28)
        a = repair.stratified_order(fl, sets, 11)
        b = repair.stratified_order(fl, sets, 12)
        assert a == repair.stratified_order(fl, sets, 11)
        assert a != b
        assert sorted(a) == sorted(sets)
        # Every seed takes the strata in the same sequence.
        assert [x[0] % 7 for x in a] == [x[0] % 7 for x in b]
        # One node of each of the seven strata in each turn of seven.
        classes = [sorted(x[0] % 7 for x in a[t:t + 7])
                   for t in range(0, 28, 7)]
        assert classes == [list(range(7))] * 4


def _run_cli(cwd, env=None, args=("--workload", CELLS[0], "--seed", "1",
                                  "--seconds", "1")):
    return subprocess.run([sys.executable, "portbench/run.py", *args],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=120, env=env)


def test_run_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _run_cli(ROOT, env)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
    assert "CUDA card" in out.stderr


def test_run_fails_with_only_the_benchmark_files():
    with tempfile.TemporaryDirectory() as tmp:
        shutil.copy(ROOT / "BENCHMARK.json", tmp)
        shutil.copytree(ROOT / "portbench", Path(tmp) / "portbench",
                        ignore=shutil.ignore_patterns("__pycache__"))
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        out = _run_cli(tmp, env)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_fake", object())
    assert harness.forbidden_modules() == [] or \
        set(harness.forbidden_modules()) <= {"jax", "jaxlib", "flax",
                                             "repro"}
    before = set(harness.forbidden_modules())
    monkeypatch.setitem(sys.modules, "repro.core.fake", object())
    assert set(harness.forbidden_modules()) == before | {"repro"}


_LATE_READER = '''
import sys, torch
from pathlib import Path
sys.path[:0] = ['.', 'src']
from portbench import harness
harness.HERE = Path(sys.argv[1])
cell = harness.Cell(name='probe', chips=1, config={}, mix={},
                    end_to_end=[{'name': 'probe_s', 'unit': 's',
                                 'bound': 0.25}], per_layer=[])
harness.resolve = lambda name: cell
harness.run_cell = lambda *a, **k: {
    'memory_peak_bytes': 0, 'checks': {'wrong': (0, 0)}, 'attempted': 1,
    'failed': 0, 'setup_s': 1.0, 'window_s': 1.0}
torch.cuda.is_available = lambda: True
torch.cuda.device_count = lambda: 1
torch.cuda.get_device_name = lambda *a: 'card'
sys.exit(harness.main(['--workload', 'probe', '--seed', '1',
                       '--seconds', '1']))
'''


@pytest.mark.parametrize("imports,rc", [("", 0), ("import repro", 3)],
                         ids=["clean", "forbidden"])
def test_a_reader_that_loads_a_forbidden_module_gets_no_result(imports, rc,
                                                                tmp_path):
    # The readers load after the window, while the result is put together:
    # one that brings in the JAX package must still stop the result.
    (tmp_path / "end_to_end").mkdir()
    (tmp_path / "end_to_end" / "probe_s.py").write_text(
        f"{imports}\n\ndef read(record):\n    return record['setup_s']\n")
    out = subprocess.run([sys.executable, "-c", _LATE_READER, str(tmp_path)],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == rc, out.stderr[-2000:]
    assert ('"correct"' in out.stdout) == (rc == 0)
    if rc:
        assert "loaded repro" in out.stderr


def test_a_run_loads_neither_jax_nor_the_reference_package():
    code = (
        "import sys, torch\n"
        "sys.path[:0] = ['.', 'src']\n"
        "from portbench import harness\n"
        "for name in ('cp-azure-p5.repair-1node',"
        " 'cp-uniform-p5.repair-2node'):\n"
        "    cell = harness.resolve(name)\n"
        "    cell.config = dict(cell.config, block_size=1024, stripes=4)\n"
        "    rec = harness.run_cell(cell, 7, 0.3, False,"
        " torch.device('cpu'), 0.0)\n"
        "    assert all(v <= lim for v, lim in rec['checks'].values())\n"
        "    for spec in cell.end_to_end + cell.per_layer:\n"
        "        harness.load_module('end_to_end' if spec.get('bound')"
        " else 'layer_metrics', spec['name'])\n"
        "print('forbidden', harness.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "forbidden []" in out.stdout
