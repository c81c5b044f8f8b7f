"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles with ``nvcc``
alone (no PyTorch headers) into ``_build/lib<name>-<hash>.so``, where the
hash covers the source and the flags: a changed source rebuilds, an
unchanged one loads the library already built. ``build`` starts one
``nvcc`` per missing source, all at once, so a fresh checkout builds in
the time of its slowest source. ``nvcc`` runs with ``-Xptxas -v``; its
output is kept beside the library (``lib<name>-<hash>.log``) and
:func:`ptxas_report` reads each kernel's registers, shared memory and
spills from it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("gf256_matmul", "bitmatrix_encode", "mod2_matmul")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc() -> str:
    """Path of ``nvcc``: under ``$CUDA_HOME``, else ``/usr/local/cuda``,
    else on ``PATH``."""
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (home / "bin" / "nvcc").exists():
        return str(home / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on "
                           "PATH to build the CUDA kernels")
    return found


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lands for this source."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names=SOURCES) -> dict[str, Path]:
    """Compile every library of ``names`` not built yet, in parallel.

    Raises ``RuntimeError`` with the compiler's output if any build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        running.append((name, tmp, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    errors = []
    for name, tmp, out, proc in running:
        log, _ = proc.communicate()
        if proc.returncode:
            errors.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
        else:
            out.with_suffix(".log").write_text(log)
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(errors))
    return {name: library_path(name) for name in names}


_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_PROPS = re.compile(r"Function properties for (\S+)")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers")
_SMEM = re.compile(r"(\d+) bytes smem")


def parse_ptxas(log: str) -> list[dict]:
    """One dict per entry function of a ``-Xptxas -v`` log: ``kernel``
    (mangled name), ``registers``, ``smem`` (static shared memory, bytes),
    ``stack``, ``spill_stores`` and ``spill_loads`` (bytes)."""
    out: list[dict] = []
    props = None                       # whose properties the next lines are
    for line in log.splitlines():
        if m := _ENTRY.search(line):
            out.append({"kernel": m.group(1), "registers": None, "smem": 0,
                        "stack": 0, "spill_stores": 0, "spill_loads": 0})
            props = m.group(1)
        elif m := _PROPS.search(line):
            props = m.group(1)
        elif not out or props != out[-1]["kernel"]:
            continue
        elif m := _FRAME.search(line):
            out[-1].update(stack=int(m.group(1)),
                           spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
        elif m := _USED.search(line):
            out[-1]["registers"] = int(m.group(1))
            if sm := _SMEM.search(line):
                out[-1]["smem"] = int(sm.group(1))
    return out


def ptxas_report(name: str) -> list[dict]:
    """:func:`parse_ptxas` of the log kept when ``csrc/<name>.cu`` was
    built; empty if the library was built without one."""
    log = library_path(name).with_suffix(".log")
    return parse_ptxas(log.read_text()) if log.exists() else []


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build((name,))[name]))
            _LIBS[name] = lib
        return lib
