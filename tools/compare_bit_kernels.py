#!/usr/bin/env python3
"""Time builds of the select-and-XOR kernel side by side on one CUDA card.

    git show <commit>:src/repro_torch/csrc/bitmatrix_encode.cu >_scratch/old.cu
    python3 tools/compare_bit_kernels.py --old _scratch/old.cu \\
        --sub select 'kQuads = kAligned && G == 32;' 'kQuads = false;' \\
        --out _scratch/compare_bit_kernels.json

Variants, each built with the flags of ``repro_torch.kernels._build``
under ``_scratch/compare_bit_kernels/`` (gitignored):

* ``new``: ``src/repro_torch/csrc/bitmatrix_encode.cu`` as it stands;
* one variant for each NAME of ``--sub NAME OLD NEW``: the same source
  with the text OLD replaced by NEW (a NAME given again adds a
  replacement), for example the quad-table path turned off above;
* ``old`` (with ``--old``): the source at that path.

Each variant's ``-Xptxas -v`` lines are printed. At the seal encode, the
five repair windows of ``chip_smoke.py`` and a 32-row window (S=10, R8=32,
K8=192), all at P = 131072, each variant is held byte for byte to the
plain version; then the variants are timed in turns (in order, then in
reverse, ``--rounds`` times) through the port's own wrappers, whose
launcher is pointed at the variant's library, with ``chip_smoke.py``'s two
timers: one call (``cuda_ms``) and device time (``device_ms``: CUDA graph
replay over copies of the inputs that pass twice the L2). The mod-2 kernel
(K4, K6 at the seal) is timed the same way once a round beside them.
Medians go to stdout and, with every sample, to ``--out`` as JSON.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
P = 131072
# (label, S, m, k): R8 = 8m output and K8 = 8k input bit-plane rows; the
# seal is the parity matrix of chip_smoke.py's store over one stripe.
WINDOWS = (("S=6 R8=16 K8=192", 6, 2, 24), ("S=10 R8=16 K8=192", 10, 2, 24),
           ("S=16 R8=8 K8=16", 16, 1, 2), ("S=16 R8=8 K8=96", 16, 1, 12),
           ("S=16 R8=16 K8=104", 16, 2, 13),
           ("S=10 R8=32 K8=192", 10, 4, 24))


def build(variants: dict[str, Path], outdir: Path, nvcc, flags, parse_ptxas,
          kernel_name) -> dict:
    """One ``nvcc`` per variant, all started together; prints each
    kernel's registers and spills and returns each variant's launcher."""
    outdir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in variants.items():
        lib = outdir / f"lib{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [nvcc, *flags, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    launchers = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc exited {proc.returncode}\n{log}")
        for e in parse_ptxas(log):
            print(f"[ptxas] {name} {kernel_name(e['kernel'])}: "
                  f"{e['registers']} registers, {e['spill_stores']} bytes "
                  f"spill stores, {e['spill_loads']} bytes spill loads")
        fn = ctypes.CDLL(str(lib)).bitmatrix_encode_launch
        fn.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        launchers[name] = fn
    return launchers


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", type=Path, help="a source to time beside it")
    ap.add_argument("--sub", nargs=3, action="append", default=[],
                    metavar=("NAME", "OLD", "NEW"),
                    help="a variant of the source with OLD replaced by NEW")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", type=Path, help="JSON file for the samples")
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false: this script "
                         "needs a card")
    import chip_smoke as cs
    from repro_torch.core.gf import matrix_to_bitmatrix
    from repro_torch.core.schemes import make_scheme
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import bitmatrix_encode as bme

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    outdir = ROOT / "_scratch" / "compare_bit_kernels"
    outdir.mkdir(parents=True, exist_ok=True)
    new = _build.CSRC / "bitmatrix_encode.cu"
    variants = {"new": new}
    for name, old, repl in args.sub:
        src = variants.get(name, new)
        text = src.read_text()
        if old not in text:
            raise SystemExit(f"variant {name}: {old!r} not in {src}")
        variants[name] = outdir / f"{name}.cu"
        variants[name].write_text(text.replace(old, repl))
    if args.old:
        variants["old"] = args.old.resolve()
    launchers = build(variants, outdir, _build.nvcc(), _build.NVCC_FLAGS,
                      _build.parse_ptxas, cs.kernel_name)
    names = list(launchers)

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(cs.SEED)
    shapes = []
    for label, s, m, k in WINDOWS:
        bm = matrix_to_bitmatrix(rng.integers(0, 256, (m, k), dtype=np.uint8))
        shapes.append((label, s, bm))
    parity = make_scheme("cp-azure", 24, 2, 2).parity_matrix()
    shapes.append(("seal R8=32 K8=192", 1, matrix_to_bitmatrix(parity)))

    results = {}
    for label, s, bm_np in shapes:
        bm = torch.from_numpy(bm_np).to(dev)
        r8, k8 = bm.shape
        pk = torch.from_numpy(rng.integers(0, 256, (s, k8, P),
                                           dtype=np.uint8)).to(dev)
        if label.startswith("seal"):
            pk = pk[0]
            fn, mod2, plain = (bme.bitmatrix_encode, bme.mod2_matmul_encode,
                               ref.bitmatrix_encode_ref)
        else:
            fn, mod2, plain = (bme.bitmatrix_encode_batched,
                               bme.mod2_matmul_encode_batched,
                               ref.bitmatrix_encode_batched_ref)
        want = plain(bm, pk)
        for name in names:
            bme._LAUNCHERS["bitmatrix_encode"] = launchers[name]
            got = fn(bm, pk)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise SystemExit(f"{name} differs from the plain version at "
                                 f"{label}")
        samples = {n: {"ms": [], "device_ms": []} for n in names + ["mod2"]}

        def sample(name, wrapper):
            samples[name]["ms"].append(
                cs.cuda_ms(torch, lambda: wrapper(bm, pk), 10))
            samples[name]["device_ms"].append(
                cs.device_ms(torch, wrapper, (bm, pk)))

        for _ in range(args.rounds):
            for name in names + names[::-1]:
                bme._LAUNCHERS["bitmatrix_encode"] = launchers[name]
                sample(name, fn)
            sample("mod2", mod2)
        bound, by = cs.bit_bound_ms("bitmatrix_encode", s, bm_np, P)
        med = {n: {t: statistics.median(v) for t, v in d.items()}
               for n, d in samples.items()}
        results[label] = {"bound_ms": bound, "bound_by": by, "median": med,
                          "samples": samples}
        print(f"[time] {label} P={P}: bound {bound:.4f} ms ({by}) | "
              + " ".join(f"{n} {d['ms']:.4f} (device {d['device_ms']:.4f}, "
                         f"{d['device_ms'] / bound:.2f}x)"
                         for n, d in med.items()))
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(results, indent=1))


if __name__ == "__main__":
    main()
