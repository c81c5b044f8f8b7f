"""The port's store examples print the reference examples' lines.

``examples/torch_quickstart.py``, ``torch_repair_demo.py`` and
``torch_placement_demo.py`` run with ``--device cpu`` beside
``examples/quickstart.py``, ``repair_demo.py`` and ``placement_demo.py``,
all six in subprocesses at once; their standard output must be the same
line for line, with one label mapped (the codec's name). The printed
lines are counts (reads, plans, locality fractions) and the
``bit-exact=True`` of a repair. Without ``--device cpu`` on a host with no
card the port's examples raise, and ``chip_smoke.py`` phase 10c holds the
examples on the card to the same lines.

The reference's placement demo runs with ``REPRO_BACKEND=gf``: under its
default ``ref`` backend its seal compiles the GF(2^8) product anew for
every stripe, which makes it more than ten times slower; its lines do
not depend on the backend, and both runs print the same.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ("quickstart", "repair_demo", "placement_demo")
# reference label -> port label
LABELS = {"== bytes-level repair through the JAX/Pallas codec ==":
          "== bytes-level repair through the PyTorch/CUDA codec =="}


def _run(args, **env) -> subprocess.Popen:
    """``args`` in a subprocess on one intra-op thread (nine run at once)."""
    return subprocess.Popen(
        [sys.executable] + list(args), cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 OMP_NUM_THREADS="1", **env),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def printed():
    """{(package, example): (exit code, stdout lines, stderr)}."""
    procs = {}
    for name in EXAMPLES:
        ref_env = {"REPRO_BACKEND": "gf"} if name == "placement_demo" else {}
        procs["repro", name] = _run([f"examples/{name}.py"], **ref_env)
        procs["repro_torch", name] = _run(
            [f"examples/torch_{name}.py", "--device", "cpu"])
        procs["no card", name] = _run([f"examples/torch_{name}.py"],
                                      CUDA_VISIBLE_DEVICES="")
    out = {}
    try:
        for key, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=600)
            out[key] = (proc.returncode, stdout.splitlines(), stderr)
    finally:
        for proc in procs.values():
            proc.kill()
    return out


@pytest.mark.parametrize("name", EXAMPLES)
def test_port_example_prints_the_reference_lines(printed, name):
    rc, want, err = printed["repro", name]
    assert rc == 0, err[-2000:]
    rc, got, err = printed["repro_torch", name]
    assert rc == 0, err[-2000:]
    assert got == [LABELS.get(line, line) for line in want]
    assert any("bit-exact=True" in line for line in got) == \
        (name == "quickstart")


@pytest.mark.parametrize("name", EXAMPLES)
def test_chip_smoke_holds_the_card_to_the_same_lines(printed, monkeypatch,
                                                     name):
    monkeypatch.syspath_prepend(str(ROOT))
    sys.modules.pop("chip_smoke", None)
    import chip_smoke

    assert chip_smoke.EXAMPLE_LINES[f"torch_{name}.py"] == \
        printed["repro_torch", name][1]
    sys.modules.pop("chip_smoke", None)


@pytest.mark.parametrize("name", EXAMPLES)
def test_port_example_needs_a_card_unless_told(printed, name):
    rc, lines, err = printed["no card", name]
    assert rc != 0 and "CUDA is not available" in err, err[-2000:]
