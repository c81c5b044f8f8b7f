#!/usr/bin/env python3
"""Time builds of one of the port's kernels side by side on one CUDA card.

    git show <commit>:src/repro_torch/csrc/bitmatrix_encode.cu >_scratch/old.cu
    python3 tools/compare_bit_kernels.py --old _scratch/old.cu \\
        --sub select 'kQuads = kAligned && G == 32;' 'kQuads = false;' \\
        --out _scratch/compare_bit_kernels.json
    python3 tools/compare_bit_kernels.py --kernel gf256_matmul \\
        --old _scratch/old_gf.cu --out _scratch/compare_gf.json

``--kernel`` picks the family (default ``bitmatrix_encode``, the
select-and-XOR kernel; ``gf256_matmul``, the GF(2^8) kernel). Variants,
each built with the flags of ``repro_torch.kernels._build`` under
``_scratch/compare_bit_kernels/`` (gitignored):

* ``new``: ``src/repro_torch/csrc/<kernel>.cu`` as it stands;
* one variant for each NAME of ``--sub NAME OLD NEW``: the same source
  with the text OLD replaced by NEW (a NAME given again adds a
  replacement), for example the quad-table path turned off above;
* ``old`` (with ``--old``): the source at that path.

Each variant's ``-Xptxas -v`` lines are printed. Shapes: for the
select-and-XOR kernel, the seal encode, the five repair windows of
``chip_smoke.py`` and a 32-row window (S=10, R8=32, K8=192), all at P =
131072 packed bytes; for the GF(2^8) kernel, ``chip_smoke.py``'s nine
windows (``chip_smoke.gf_windows``) and the seal's flat encode, all at
B = 1 MiB. At each shape every variant is held byte for byte to the
plain version; then the variants are timed in turns (in order, then in
reverse, ``--rounds`` times) through the port's own wrappers, whose
launcher is pointed at the variant's library, with ``chip_smoke.py``'s two
timers: one call (``cuda_ms``) and device time (``device_ms``: CUDA graph
replay over copies of the inputs that pass twice the L2). For the
select-and-XOR kernel the mod-2 kernel (K4, K6 at the seal) is timed the
same way once a round beside them. Medians go to stdout and, with every
sample, to ``--out`` as JSON.
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
B = 1 << 20
# (label, S, m, k): R8 = 8m output and K8 = 8k input bit-plane rows; the
# seal is the parity matrix of chip_smoke.py's store over one stripe.
WINDOWS = (("S=6 R8=16 K8=192", 6, 2, 24), ("S=10 R8=16 K8=192", 10, 2, 24),
           ("S=16 R8=8 K8=16", 16, 1, 2), ("S=16 R8=8 K8=96", 16, 1, 12),
           ("S=16 R8=16 K8=104", 16, 2, 13),
           ("S=10 R8=32 K8=192", 10, 4, 24))
# Pointer arguments of each family's C entry point (then the ints and the
# stream).
POINTERS = {"bitmatrix_encode": 3, "gf256_matmul": 4}


def build(variants: dict[str, Path], outdir: Path, nvcc, flags, parse_ptxas,
          kernel_name, kernel: str) -> dict:
    """One ``nvcc`` per variant, all started together; prints each
    kernel's registers and spills and returns each variant's launcher."""
    outdir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in variants.items():
        lib = outdir / f"lib{kernel}-{name}.so"
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
        fn = getattr(ctypes.CDLL(str(lib)), f"{kernel}_launch")
        fn.argtypes = [ctypes.c_void_p] * POINTERS[kernel] + [
            ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        launchers[name] = fn
    return launchers


def bit_shapes(np, torch, rng, dev, cs):
    """(label, wrapper, plain, companion, args, bound) of the select-and-XOR
    kernel's shapes; the companion is the mod-2 kernel."""
    from repro_torch.core.gf import matrix_to_bitmatrix
    from repro_torch.core.schemes import make_scheme
    from repro_torch.kernels import bitmatrix_encode as bme
    from repro_torch.kernels import ref

    shapes = [(label, s, matrix_to_bitmatrix(
        rng.integers(0, 256, (m, k), dtype=np.uint8)))
        for label, s, m, k in WINDOWS]
    parity = make_scheme("cp-azure", 24, 2, 2).parity_matrix()
    shapes.append(("seal R8=32 K8=192", 1, matrix_to_bitmatrix(parity)))
    for label, s, bm_np in shapes:
        bm = torch.from_numpy(bm_np).to(dev)
        r8, k8 = bm.shape
        pk = torch.from_numpy(rng.integers(0, 256, (s, k8, P),
                                           dtype=np.uint8)).to(dev)
        bound = cs.bit_bound_ms("bitmatrix_encode", s, bm_np, P)
        if label.startswith("seal"):
            yield (f"{label} P={P}", bme.bitmatrix_encode,
                   ref.bitmatrix_encode_ref, bme.mod2_matmul_encode,
                   (bm, pk[0]), bound)
        else:
            yield (f"{label} P={P}", bme.bitmatrix_encode_batched,
                   ref.bitmatrix_encode_batched_ref,
                   bme.mod2_matmul_encode_batched, (bm, pk), bound)


def gf_shapes(np, torch, rng, dev, cs):
    """The same for the GF(2^8) kernel, with no companion."""
    from repro_torch.ftx import StoreConfig
    from repro_torch.kernels import gf256_matmul as gm
    from repro_torch.kernels import ref

    cfg = StoreConfig(scheme="cp-azure", k=24, r=2, p=2, block_size=B,
                      backend="gf")

    def u8(shape):
        return torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)
                                ).to(dev)

    for s, m, k in cs.gf_windows(cfg):
        yield (f"S={s} m={m} k={k} B={B}", gm.gf256_matmul_batched,
               ref.gf256_matmul_batched_ref, None, (u8((m, k)), u8((s, k, B))),
               cs.bound_ms(s, m, k, B))
    parity = torch.from_numpy(cs.cfg_parity(cfg)).to(dev)
    yield (f"seal m=4 k=24 B={B}", gm.gf256_matmul, ref.gf256_matmul_ref, None,
           (parity, u8((cfg.k, B))), cs.bound_ms(1, 4, cfg.k, B))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernel", choices=sorted(POINTERS),
                    default="bitmatrix_encode", help="the kernel family")
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
    from repro_torch.kernels import _build
    from repro_torch.kernels import bitmatrix_encode as bme
    from repro_torch.kernels import gf256_matmul as gm

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    outdir = ROOT / "_scratch" / "compare_bit_kernels"
    outdir.mkdir(parents=True, exist_ok=True)
    new = _build.CSRC / f"{args.kernel}.cu"
    variants = {"new": new}
    for name, old, repl in args.sub:
        src = variants.get(name, new)
        text = src.read_text()
        if old not in text:
            raise SystemExit(f"variant {name}: {old!r} not in {src}")
        variants[name] = outdir / f"{args.kernel}-{name}.cu"
        variants[name].write_text(text.replace(old, repl))
    if args.old:
        variants["old"] = args.old.resolve()
    launchers = build(variants, outdir, _build.nvcc(), _build.NVCC_FLAGS,
                      _build.parse_ptxas, cs.kernel_name, args.kernel)
    names = list(launchers)

    def point(name):
        if args.kernel == "gf256_matmul":
            gm._LAUNCH = launchers[name]
        else:
            bme._LAUNCHERS[args.kernel] = launchers[name]

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(cs.SEED)
    shapes = (gf_shapes if args.kernel == "gf256_matmul" else bit_shapes)(
        np, torch, rng, dev, cs)
    results = {}
    for label, fn, plain, companion, xs, (bound, by) in shapes:
        want = plain(*xs)
        for name in names:
            point(name)
            got = fn(*xs)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise SystemExit(f"{name} differs from the plain version at "
                                 f"{label}")
        others = ["mod2"] if companion else []
        samples = {n: {"ms": [], "device_ms": []} for n in names + others}

        def sample(name, wrapper):
            samples[name]["ms"].append(
                cs.cuda_ms(torch, lambda: wrapper(*xs), 10))
            samples[name]["device_ms"].append(
                cs.device_ms(torch, wrapper, xs))

        for _ in range(args.rounds):
            for name in names + names[::-1]:
                point(name)
                sample(name, fn)
            if companion:
                sample("mod2", companion)
        med = {n: {t: statistics.median(v) for t, v in d.items()}
               for n, d in samples.items()}
        results[label] = {"bound_ms": bound, "bound_by": by, "median": med,
                          "samples": samples}
        print(f"[time] {label}: bound {bound:.4f} ms ({by}) | "
              + " ".join(f"{n} {d['ms']:.4f} (device {d['device_ms']:.4f}, "
                         f"{d['device_ms'] / bound:.2f}x)"
                         for n, d in med.items()))
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(results, indent=1))


if __name__ == "__main__":
    main()
