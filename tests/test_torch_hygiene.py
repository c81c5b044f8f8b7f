"""The port stands alone: no module of ``src/repro_torch``, no script of
``tools/`` and no line of ``chip_smoke.py`` imports JAX or the JAX
package, and the smoke script refuses to run (and prints no result) on a
machine without a card."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + sorted((ROOT / "tools").glob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported(path: Path) -> set[str]:
    """Top-level package of every module ``path`` imports, anywhere in it
    (function bodies included)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_neither_jax_nor_the_reference(path):
    bad = _imported(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_hygiene_walk_sees_forbidden_imports(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("def f():\n    import jax.numpy as jnp\n"
                     "from repro.core import gf\n"
                     "import importlib\nimportlib.import_module('jaxlib')\n")
    assert _imported(probe) & set(FORBIDDEN) == {"jax", "jaxlib", "repro"}


def test_chip_smoke_binds_each_top_level_name_once():
    """Phases share ``chip_smoke.py``'s module namespace: a constant or
    function bound twice at top level silently changes an earlier phase."""
    seen, twice = set(), set()
    for node in ast.parse((ROOT / "chip_smoke.py").read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names = [node.name]
        elif isinstance(node, ast.Assign):
            names = [n.id for t in node.targets for n in ast.walk(t)
                     if isinstance(n, ast.Name)]
        else:
            continue
        twice.update(n for n in names if n in seen)
        seen.update(names)
    assert not twice, f"chip_smoke.py binds {sorted(twice)} twice"


def _smoke(cwd: Path, env: dict) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=120)


def test_chip_smoke_fails_without_a_card_or_a_checkout(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    alone = tmp_path / "alone"
    alone.mkdir()
    (alone / "chip_smoke.py").write_bytes((ROOT / "chip_smoke.py").read_bytes())
    for cwd in (alone, ROOT):
        run = _smoke(cwd, env)
        assert run.returncode != 0, run.stdout
        assert '"ok"' not in run.stdout and "FAILED" in run.stderr
