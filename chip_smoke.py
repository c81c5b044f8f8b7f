#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one CUDA card and check it.

    python3 chip_smoke.py            # from the root of a checkout

Phases (any failure raises and the script exits non-zero):

1. Device and build: the card's name and power limit, the seconds it
   takes to build every CUDA source of ``src/repro_torch/csrc`` (one
   ``nvcc`` per source, started together), and each kernel's registers,
   shared memory and spills as ``nvcc -Xptxas -v`` reported them (no
   kernel may spill).
2. Each kernel against its plain PyTorch version on the card, byte for
   byte, over a sweep of shapes (ragged widths, odd and large stripe
   counts, zero and one-hot coefficient rows) and the shapes the main path
   gives it; at the main-path shapes, the time of one call of the kernel
   and of its plain version (CUDA events, median; the kernels line's
   ``ms`` and ``plain_ms``) and the kernel's device time (calls captured
   in a CUDA graph over copies of the inputs that pass twice the L2, so
   no host launch cost and no warm L2; ``device_ms``) beside the least
   time the card could take.
   2 is the GF(2^8) kernel (gf backend), with its edges (k past its
   table chunk, m off and past its tiles, S=1 at a wide B, coefficient
   blocks of one kind, data and out 1 byte off alignment, more stripes
   and m tiles than a grid's rows), 2b the two bit-plane kernels
   (crs: select-and-XOR, mxu: mod-2 tensor-core matmul), the mxu kernel
   also against the crs kernel, the mod-2 kernel's edges (K8 and R8 off
   its tiles, packets and out 1 byte off alignment, more work items than
   one wave of its persistent grid, a bitmatrix too deep for shared
   memory), the select-and-XOR kernel's split-K edges (a K8 smaller than
   its K slices, a bitmatrix with every row zero or three live columns,
   S=1 at a wide P), and the packetize/unpacketize glue.
3. The main path at real size: a ``StripeStore`` with the paper's P5
   (cp-azure, k=24, r=2, p=2), 1 MiB blocks and 28 nodes; seeded random
   objects until 64 stripes are sealed (1.5 GiB of user data); then
   ``repair_failed_nodes`` for one and for two failed nodes, the two-node
   repair once more under ``torch.profiler`` (device time by kind against
   the wall), and a degraded ``read`` and ``get`` with a node down. The
   failed nodes' block files are emptied before each repair and must hash
   as they did when sealed after it, the report's counts must be the
   reference's, and every kernel of the backend must have launched during
   this phase. 3 runs the gf backend; 3b the same path once with crs and
   once with mxu, each in a fresh store whose sealed block files must hash
   as the gf store's did.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Without a CUDA card, or run
outside a checkout, it fails and prints no result.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
STRIPES = 64
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
SCALAR_OPS_PER_S = 67e12       # H100 SXM non-tensor 32-bit rate
INT8_TENSOR_OPS_PER_S = 1979e12  # H100 SXM dense int8 tensor-core rate
# The reference's counts for this store (held by tests/test_torch_store.py
# against the JAX package): failed nodes -> (patterns, blocks_read,
# repairs_local, repairs_global).
EXPECTED = {(3,): (4, 608, 64, 0), (3, 4): (4, 1360, 16, 48)}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def sha(path: Path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()


def cuda_ms(torch, fn, reps: int) -> float:
    """Median milliseconds of ``fn`` on the card, one event pair a run,
    after one warm-up run."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(torch, fn, args, calls: int = 20, replays: int = 5) -> float:
    """Milliseconds of ``fn(*args)`` on the card without the host's launch
    cost and without a warm L2: ``calls`` calls captured in one CUDA graph,
    the graph replayed ``replays`` times between two events, after a
    warm-up call. The calls rotate over copies of ``args``, as many as it
    takes for the bytes the other calls read between two reads of one copy
    to pass twice the card's L2 (the main path reads a new stripe from
    device memory at each launch), and each call writes an output of its
    own. A single call timed by :func:`cuda_ms` also counts the host's time
    to allocate and launch, which hides a short kernel."""
    per_call = sum(a.numel() * a.element_size() for a in args)
    l2 = getattr(torch.cuda.get_device_properties(0), "L2_cache_size",
                 50 << 20)
    n = min(calls, 1 + -(-2 * l2 // per_call))
    copies = [args] + [tuple(a.clone() for a in args) for _ in range(n - 1)]
    fn(*args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [fn(*copies[i % n]) for i in range(calls)]
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    del outs, graph
    return start.elapsed_time(end) / (calls * replays)


def _larger(mem_ms: float, ops_ms: float) -> tuple[float, str]:
    return (mem_ms, "bytes") if mem_ms >= ops_ms else (ops_ms, "operations")


def bound_ms(s: int, m: int, k: int, b: int) -> tuple[float, str]:
    """Least time for (m,k) x (S,k,B): every input byte read once and every
    output byte written once at the HBM rate, against one 32-bit operation
    per GF multiply-accumulate at the card's non-tensor peak."""
    mem = (s * (k + m) * b + m * k) / HBM_BYTES_PER_S * 1e3
    ops = s * m * k * b / SCALAR_OPS_PER_S * 1e3
    return _larger(mem, ops)


def bit_bound_ms(kernel: str, s: int, bm, p: int) -> tuple[float, str]:
    """Least time for bitmatrix (R8, K8) x packets (S, K8, P): the bytes as
    in :func:`bound_ms`, against, for select-and-XOR, one 32-bit XOR per 4
    packed bytes of every selected row (this bitmatrix's ones) at the
    non-tensor peak, and for the mod-2 matmul, 2*S*R8'*K8'*8P int8
    operations (R8', K8' padded to the kernel's tiles) at the tensor-core
    peak."""
    from repro_torch.kernels.bitmatrix_encode import mod2_padded_shape

    r8, k8 = bm.shape
    mem = (s * (k8 + r8) * p + r8 * k8) / HBM_BYTES_PER_S * 1e3
    if kernel == "bitmatrix_encode":
        ones = int((bm != 0).sum())
        ops = s * ones * p / 4 / SCALAR_OPS_PER_S * 1e3
    else:
        r8p, k8p = mod2_padded_shape(r8, k8)
        ops = 2 * s * r8p * k8p * 8 * p / INT8_TENSOR_OPS_PER_S * 1e3
    return _larger(mem, ops)


def main() -> None:
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             f"a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")

    from repro_torch.core.gf import gf_matmul
    from repro_torch.ftx import StoreConfig
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import bitmatrix_encode as bme
    from repro_torch.kernels import gf256_matmul as gm

    # ------------------------------------------------ 1. device and build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    t0 = time.perf_counter()
    _build.build()
    print(f"[build] {len(_build.SOURCES)} CUDA source(s) in "
          f"{time.perf_counter() - t0:.3f} s")
    for name in _build.SOURCES:
        entries = _build.ptxas_report(name)
        check(bool(entries), f"no -Xptxas -v report for {name}")
        for e in entries:
            print(f"[ptxas] {name} {kernel_name(e['kernel'])}: "
                  f"{e['registers']} registers, {e['smem']} bytes static "
                  f"shared memory, {e['stack']} bytes stack, "
                  f"{e['spill_stores']} bytes spill stores, "
                  f"{e['spill_loads']} bytes spill loads")
            check(e["spill_stores"] + e["spill_loads"] == 0,
                  f"{name}: {kernel_name(e['kernel'])} spills registers")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)

    # ---------------------------------------- 2. kernels against plain
    def rand(shape):
        return torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)
                                ).to(dev)

    max_err = {"gf256_matmul_batched": 0, "gf256_matmul": 0}

    def compare(coef, data, label):
        got = gm.gf256_matmul_batched(coef, data)
        want = ref.gf256_matmul_batched_ref(coef, data)
        torch.cuda.synchronize()
        err = int((got.int() - want.int()).abs().max()) if got.numel() else 0
        max_err["gf256_matmul_batched"] = max(max_err["gf256_matmul_batched"],
                                              err)
        check(err == 0 and got.shape == want.shape,
              f"batched kernel differs from the plain version at {label}")
        if data.shape[0] == 1:
            flat = gm.gf256_matmul(coef, data[0])
            torch.cuda.synchronize()
            ferr = int((flat.int() - want[0].int()).abs().max())
            max_err["gf256_matmul"] = max(max_err["gf256_matmul"], ferr)
            check(ferr == 0, f"flat kernel differs at {label}")

    sweep = 0
    for (m, k, b) in [(2, 4, 128), (4, 6, 256), (8, 24, 512), (9, 96, 128),
                      (3, 17, 384)]:
        for s in (1, 7, 64):
            for bb in (b, b + 13):               # ragged byte width
                coef = rand((m, k))
                coef[0] = 0                      # an all-zero row
                if m > 1:
                    coef[1] = 0
                    coef[1, k // 2] = 1          # a one-hot row
                compare(coef, rand((s, k, bb)), (s, m, k, bb))
                sweep += 1
    # The GF(2^8) kernel's edges: k past its 64-row table chunk; m off its
    # 1/2/4/8-row tiles and past 8 (m = k = 24: a full decode); S=1 at the
    # seal's B = 1 MiB (one wave of warps), even and ragged; coefficient
    # blocks of one kind (all 0, all 1, one-hot rows, all 0x8E, the largest
    # log); more (stripe, m tile) pairs than a grid's 65535 rows.
    for (s, m, k, bb, kind) in GF_EDGES:
        coef = gf_edge_coef(rng, m, k, kind).to(dev)
        compare(coef, rand((s, k, bb)), (kind, s, m, k, bb))
        sweep += 1
    # data and out 1 byte off a 16-byte boundary (contiguous views of
    # buffers sliced at 1), through the C interface, since the wrapper
    # allocates an aligned out.
    for (s, m, k, bb) in ((7, 4, 24, 4096), (3, 9, 65, 1000),
                          (1, 4, 24, 1 << 20)):
        coef = rand((m, k))
        data = rand((s * k * bb + 1,))[1:].view(s, k, bb)
        buf = torch.zeros(s * m * bb + 2, dtype=torch.uint8, device=dev)
        out = buf[1:-1].view(s, m, bb)
        check(data.data_ptr() % 16 == 1 and out.data_ptr() % 16 == 1,
              "the views are not 1 byte off alignment")
        err = gm._launcher()(coef.data_ptr(), data.data_ptr(), out.data_ptr(),
                             gm._tables(dev).data_ptr(), m, k, bb, s,
                             torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"gf256_matmul launch failed: CUDA error {err}")
        want = ref.gf256_matmul_batched_ref(coef, data)
        torch.cuda.synchronize()
        diff = int((out.int() - want.int()).abs().max())
        max_err["gf256_matmul_batched"] = max(
            max_err["gf256_matmul_batched"], diff)
        check(diff == 0, f"batched kernel differs off alignment at "
              f"{(s, m, k, bb)}")
        check(int(buf[0]) == 0 and int(buf[-1]) == 0,
              f"gf256_matmul wrote outside out at {(s, m, k, bb)}")
        sweep += 1
    # The flat kernel against the numpy GF algebra, independently of torch.
    c_np = rng.integers(0, 256, (4, 24), dtype=np.uint8)
    d_np = rng.integers(0, 256, (24, 4096), dtype=np.uint8)
    got = gm.gf256_matmul(torch.from_numpy(c_np).to(dev),
                          torch.from_numpy(d_np).to(dev)).cpu().numpy()
    check((got == gf_matmul(c_np, d_np)).all(),
          "flat kernel differs from the numpy GF(2^8) algebra")

    cfg = StoreConfig(scheme="cp-azure", k=24, r=2, p=2)
    check(cfg.backend == "gf", f"store default backend on CUDA is "
          f"{cfg.backend!r}, expected 'gf'")
    B = cfg.block_size
    shapes = gf_windows(cfg)
    timings = {}
    for (s, m, k) in shapes:
        coef = rand((m, k))
        data = rand((s, k, B))
        compare(coef, data, (s, m, k, B))
        kms = cuda_ms(torch, lambda: gm.gf256_matmul_batched(coef, data), 10)
        dms = device_ms(torch, gm.gf256_matmul_batched, (coef, data))
        pms = cuda_ms(torch,
                      lambda: ref.gf256_matmul_batched_ref(coef, data), 3)
        bms, by = bound_ms(s, m, k, B)
        timings[(s, m, k)] = (kms, pms, bms, by, dms)
        print(f"[kernel] gf256_matmul_batched S={s} m={m} k={k} B={B}: "
              f"{kms:.4f} ms (device {dms:.4f} ms), plain {pms:.4f} ms, "
              f"bound {bms:.4f} ms ({by})")
    # The seal-time flat encode: parity rows (4, 24) over one stripe.
    pcoef = torch.from_numpy(cfg_parity(cfg)).to(dev)
    pdata = rand((cfg.k, B))
    compare(pcoef, pdata[None], (1, 4, 24, B))
    flat_ms = cuda_ms(torch, lambda: gm.gf256_matmul(pcoef, pdata), 10)
    flat_dev = device_ms(torch, gm.gf256_matmul, (pcoef, pdata))
    flat_plain = cuda_ms(torch, lambda: ref.gf256_matmul_ref(pcoef, pdata), 3)
    flat_bound, flat_by = bound_ms(1, 4, cfg.k, B)
    print(f"[kernel] gf256_matmul m=4 k=24 B={B}: {flat_ms:.4f} ms (device "
          f"{flat_dev:.4f} ms), plain {flat_plain:.4f} ms, bound "
          f"{flat_bound:.4f} ms ({flat_by})")
    # What one window costs to bring to the card from a pageable host
    # stack, beside the kernel that consumes it.
    big = max(timings, key=lambda t: t[0] * t[2])
    host = rng.integers(0, 256, (big[0], big[2], B), dtype=np.uint8)
    h2d = cuda_ms(torch, lambda: torch.from_numpy(host).to(dev), 5)
    print(f"[copy] host->device of the S={big[0]} k={big[2]} window "
          f"({host.nbytes} bytes, pageable): {h2d:.4f} ms against "
          f"{timings[big][0]:.4f} ms in the kernel")
    print(f"[kernel] {sweep} sweep shapes and {len(shapes) + 1} main-path "
          f"shapes byte-equal to the plain version; no single PyTorch call "
          f"computes a GF(2^8) matmul, so library_ms is null")

    # ------------------------------- 2b. bit-plane kernels against plain
    windows = [(s, m, k) for (s, m, k) in shapes if (m, k) in REPAIR_PLANS]
    bit_rows = bit_kernel_phase(np, torch, rng, dev, windows,
                                cfg_parity(cfg), B // 8)

    # ------------------------------------------ 3. main path at real size
    # Each backend's path runs in a fresh store with its wrappers' counts
    # set to 0 just before and read just after; the crs and mxu stores'
    # sealed block files must hash as the gf store's did.
    wrappers = {"gf": (gm.gf256_matmul_batched, gm.gf256_matmul),
                "crs": (bme.bitmatrix_encode_batched, bme.bitmatrix_encode),
                "mxu": (bme.mod2_matmul_encode_batched,
                        bme.mod2_matmul_encode)}
    launches = {}
    gf_hashes = None
    (ROOT / "_smoke").mkdir(exist_ok=True)
    for backend in ("gf", "crs", "mxu"):
        workdir = Path(tempfile.mkdtemp(prefix=f"store-{backend}-",
                                        dir=ROOT / "_smoke"))
        try:
            for fn in wrappers[backend]:
                fn.launches = 0
            report, hashes = drive_main_path(
                np, torch, dataclasses.replace(cfg, backend=backend),
                workdir, dev, wrappers[backend][0], gf_hashes)
            for fn in wrappers[backend]:
                launches[fn.__name__] = fn.launches
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        gf_hashes = gf_hashes or hashes
        for fn in wrappers[backend]:
            check(launches[fn.__name__] > 0,
                  f"{fn.__name__} was never launched on the {backend} path")
        print(f"[main] {backend}: kernel launches on the main path: "
              + json.dumps({fn.__name__: launches[fn.__name__]
                            for fn in wrappers[backend]})
              + f"; {json.dumps(report)}")

    s, m, k = big
    kms, pms, bms, by, dms = timings[big]
    kernels = [
        {"name": "gf256_matmul_batched", "route": "cuda",
         "source": "src/repro_torch/csrc/gf256_matmul.cu",
         "replaces": "src/repro/kernels/gf256_matmul.py:126",
         "launches": launches["gf256_matmul_batched"],
         "max_abs_err": max_err["gf256_matmul_batched"],
         "ms": kms, "plain_ms": pms, "bound_ms": bms, "bound_by": by,
         "library_ms": None, "device_ms": dms,
         "shape": {"S": s, "m": m, "k": k, "B": B}},
        {"name": "gf256_matmul", "route": "cuda",
         "source": "src/repro_torch/csrc/gf256_matmul.cu",
         "replaces": "src/repro/kernels/gf256_matmul.py:92",
         "launches": launches["gf256_matmul"],
         "max_abs_err": max_err["gf256_matmul"],
         "ms": flat_ms, "plain_ms": flat_plain, "bound_ms": flat_bound,
         "bound_by": flat_by, "library_ms": None, "device_ms": flat_dev,
         "shape": {"S": 1, "m": 4, "k": cfg.k, "B": B}},
    ]
    for row in bit_rows:
        row["launches"] = launches[row["name"]]
        kernels.append(row)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def kernel_name(mangled: str) -> str:
    """``mod2_matmul_kernel<1, true>`` for a kernel's mangled name (as
    ``c++filt`` gives it, without namespace and arguments), or the mangled
    name where there is no ``c++filt``."""
    tool = shutil.which("c++filt")
    if tool is None:
        return mangled
    name = subprocess.run([tool, mangled], capture_output=True, text=True
                          ).stdout.strip() or mangled
    name = name.replace("(anonymous namespace)::", "")
    m = re.match(r"(?:void )?(?:\w+::)*(\w+(?:<[^>]*>)?)\(", name)
    return m.group(1) if m else name


# (S, m, k, B, coefficient kind) of the GF(2^8) kernel's edges; the kinds
# are those of gf_edge_coef.
GF_EDGES = ((3, 4, 65, 4096, "sweep"), (2, 2, 257, 1000, "sweep"),
            (1, 9, 300, 4096 + 13, "sweep"), (7, 3, 24, 4096, "sweep"),
            (7, 9, 24, 4096, "sweep"), (3, 16, 24, 4096, "sweep"),
            (3, 24, 24, 4096 + 13, "sweep"), (1, 4, 24, 1 << 20, "sweep"),
            (1, 4, 24, (1 << 20) + 13, "sweep"), (1, 4, 24, 1 << 20, "zero"),
            (1, 4, 24, 1 << 20, "one"), (1, 4, 24, 1 << 20, "onehot"),
            (1, 4, 24, 1 << 20, "max"), (66000, 1, 3, 32, "sweep"),
            (22000, 24, 2, 16, "sweep"))


def gf_edge_coef(rng, m: int, k: int, kind: str):
    """A (m, k) coefficient block on the CPU: "sweep" is random with row 0
    zero and row 1 one-hot, "zero" all 0, "one" all 1, "onehot" a single 1
    in each row, "max" all 0x8E (log 254, the largest)."""
    import numpy as np
    import torch

    coef = rng.integers(0, 256, (m, k), dtype=np.uint8)
    if kind == "sweep":
        coef[0] = 0
        if m > 1:
            coef[1] = 0
            coef[1, k // 2] = 1
    elif kind == "onehot":
        coef[:] = 0
        coef[np.arange(m), np.arange(m) % k] = 1
    else:
        coef[:] = {"zero": 0, "one": 1, "max": 0x8E}[kind]
    return torch.from_numpy(coef)


# The bit-plane kernels: family -> (stripe-batched wrapper, flat wrapper,
# source, pallas_call line of the TPU kernel each wrapper replaces).
BIT_FAMILIES = {
    "bitmatrix_encode": ("bitmatrix_encode_batched", "bitmatrix_encode",
                         "src/repro_torch/csrc/bitmatrix_encode.cu",
                         "src/repro/kernels/bitmatrix_encode.py:115",
                         "src/repro/kernels/bitmatrix_encode.py:60"),
    "mod2_matmul": ("mod2_matmul_encode_batched", "mod2_matmul_encode",
                    "src/repro_torch/csrc/mod2_matmul.cu",
                    "src/repro/kernels/bitmatrix_encode.py:220",
                    "src/repro/kernels/bitmatrix_encode.py:166"),
}


def bit_kernel_phase(np, torch, rng, dev, windows, parity,
                     p_main: int) -> list[dict]:
    """Phase 2b: each bit-plane kernel against its plain version (and the
    mod-2 kernel against the select-and-XOR one) over a sweep, then at the
    repair windows ``windows`` ((S, m, reads) as the GF matmul sees them;
    R8 = 8m, K8 = 8 reads) and the seal-time encode by ``parity``, timed
    beside its plain version and its bound. Returns one ``kernels`` row
    per wrapper (launches filled in by the caller)."""
    from repro_torch.core.gf import matrix_to_bitmatrix
    from repro_torch.kernels import bitmatrix_encode as bme
    from repro_torch.kernels import ref

    fams = {fam: (getattr(bme, b), getattr(bme, f), getattr(ref, b + "_ref"),
                  getattr(ref, f + "_ref"))
            for fam, (b, f, *_) in BIT_FAMILIES.items()}
    max_err = {getattr(bme, n).__name__: 0
               for b, f, *_ in BIT_FAMILIES.values() for n in (b, f)}

    def u8(shape, high=256):
        return torch.from_numpy(rng.integers(0, high, shape, dtype=np.uint8)
                                ).to(dev)

    def held(got, want, name, label):
        torch.cuda.synchronize()
        err = int((got.int() - want.int()).abs().max()) if got.numel() else 0
        max_err[name] = max(max_err[name], err)
        check(err == 0 and got.shape == want.shape,
              f"{name} differs from its plain version at {label}")

    def compare(bm, pk, label):
        outs = []
        for batched, flat, plain_b, plain_f in fams.values():
            got = batched(bm, pk)
            held(got, plain_b(bm, pk), batched.__name__, label)
            outs.append(got)
            if pk.shape[0] == 1:
                held(flat(bm, pk[0]), plain_f(bm, pk[0]), flat.__name__,
                     label)
        check(torch.equal(outs[0], outs[1]), f"the mod-2 kernel differs "
              f"from the select-and-XOR kernel at {label}")

    def sweep_bm(r8, k8):
        bm = u8((r8, k8), 2)
        bm[0] = 0                                # an all-zero row
        bm[1] = 0
        bm[1, k8 // 2] = 1                       # a one-hot row
        return bm

    # R8 24 and 40 and K8 40 and 104 are off the mod-2 kernel's 16-row
    # groups and 32-deep k steps.
    sweep = 0
    for r8 in (8, 16, 24, 32, 40, 192):
        for k8 in (16, 40, 104, 192, 768):
            bm = sweep_bm(r8, k8)
            for s in (1, 7, 64):
                for p in (512, 517):             # 517: a ragged P
                    compare(bm, u8((s, k8, p)), (s, r8, k8, p))
                    sweep += 1
    # More (stripe, 32-byte tile) work items than one wave of the mod-2
    # kernel's persistent grid, and a bitmatrix whose fragments pass its
    # shared-memory limit.
    for (s, r8, k8, p) in ((64, 16, 192, 16384), (64, 32, 104, 16384),
                           (7, 24, 2056, 517), (3, 40, 2056, 4096)):
        compare(sweep_bm(r8, k8), u8((s, k8, p)), (s, r8, k8, p))
        sweep += 1
    # The select-and-XOR kernel's split-K edges: a K8 smaller than its K
    # slices, a bitmatrix with every row zero (an empty compact list), one
    # with three live columns (slices left empty), and S=1 at a wide P with
    # R8=32 (a split-K reduction in every block).
    for (s, r8, k8, p, kind) in ((1, 32, 3, 4096, "sweep"),
                                 (7, 8, 3, 517, "sweep"),
                                 (1, 32, 192, 131072, "zero"),
                                 (1, 32, 192, 131072, "sparse"),
                                 (1, 16, 104, 131072 + 16, "zero"),
                                 (1, 32, 192, 131072 + 5, "sweep")):
        bm = sweep_bm(r8, k8)
        if kind != "sweep":
            bm.zero_()
        if kind == "sparse":
            bm[:, torch.from_numpy(rng.choice(k8, 3, replace=False))] = 1
        compare(bm, u8((s, k8, p)), (kind, s, r8, k8, p))
        sweep += 1
    # packets and out 1 byte off a 16-byte boundary (contiguous views of
    # buffers sliced at 1), through the C interface, since the wrappers
    # allocate an aligned out.
    for (s, r8, k8, p) in ((7, 16, 192, 4096), (7, 24, 40, 1000),
                           (3, 40, 104, 517), (1, 32, 192, 4096)):
        bm = sweep_bm(r8, k8)
        pk = u8((s * k8 * p + 1,))[1:].view(s, k8, p)
        want = fams["bitmatrix_encode"][2](bm, pk)
        outs = []
        for fam, (batched, *_) in fams.items():
            buf = torch.zeros(s * r8 * p + 2, dtype=torch.uint8, device=dev)
            out = buf[1:-1].view(s, r8, p)
            check(pk.data_ptr() % 16 == 1 and out.data_ptr() % 16 == 1,
                  "the views are not 1 byte off alignment")
            err = bme._launcher(fam)(
                bm.data_ptr(), pk.data_ptr(), out.data_ptr(), r8, k8, p, s,
                torch.cuda.current_stream().cuda_stream)
            check(err == 0, f"{fam} launch failed: CUDA error {err}")
            held(out, want, batched.__name__, ("unaligned", s, r8, k8, p))
            check(int(buf[0]) == 0 and int(buf[-1]) == 0,
                  f"{fam} wrote outside out at ({s}, {r8}, {k8}, {p})")
            outs.append(out)
        check(torch.equal(outs[0], outs[1]), "the mod-2 kernel differs from "
              "the select-and-XOR kernel off alignment")
        sweep += 1

    def timed(fn, plain, bm, pk, kernel, label):
        kms = cuda_ms(torch, lambda: fn(bm, pk), 10)
        dms = device_ms(torch, fn, (bm, pk))
        pms = cuda_ms(torch, lambda: plain(bm, pk), 3)
        s = 1 if pk.ndim == 2 else pk.shape[0]
        bms, by = bit_bound_ms(kernel, s, bm.cpu().numpy(), pk.shape[-1])
        print(f"[kernel] {fn.__name__} {label}: {kms:.4f} ms (device "
              f"{dms:.4f} ms, {dms / bms:.2f} times the bound), plain "
              f"{pms:.4f} ms, bound {bms:.4f} ms ({by})")
        return {"ms": kms, "plain_ms": pms, "bound_ms": bms, "bound_by": by,
                "device_ms": dms}

    rows, big = {}, max(windows, key=lambda w: w[0] * w[2])
    for (s, m, k) in windows:
        bm = torch.from_numpy(matrix_to_bitmatrix(
            rng.integers(0, 256, (m, k), dtype=np.uint8))).to(dev)
        pk = u8((s, 8 * k, p_main))
        label = f"S={s} R8={8 * m} K8={8 * k} P={p_main}"
        compare(bm, pk, label)
        for fam, (batched, _, plain_b, _) in fams.items():
            t = timed(batched, plain_b, bm, pk, fam, label)
            if (s, m, k) == big:
                rows[batched.__name__] = dict(
                    t, shape={"S": s, "R8": 8 * m, "K8": 8 * k, "P": p_main})
    # The seal-time flat encode: the parity rows' bitmatrix over one stripe.
    bm = torch.from_numpy(matrix_to_bitmatrix(parity)).to(dev)
    r8, k8 = bm.shape
    pk = u8((k8, p_main))
    label = f"R8={r8} K8={k8} P={p_main}"
    compare(bm, pk[None], label)
    for fam, (_, flat, _, plain_f) in fams.items():
        rows[flat.__name__] = dict(
            timed(flat, plain_f, bm, pk, fam, label),
            shape={"S": 1, "R8": r8, "K8": k8, "P": p_main})
    # The packetize/unpacketize glue around the largest window's launch.
    s, m, k = big
    blocks = u8((s, k, 8 * p_main))
    check(torch.equal(ref.unpacketize_batched(ref.packetize_batched(blocks)),
                      blocks), "unpacketize(packetize(x)) != x on the card")
    glue = cuda_ms(torch, lambda: ref.unpacketize_batched(
        ref.packetize_batched(blocks)), 5)
    print(f"[glue] packetize + unpacketize of the S={s} k={k} window "
          f"({blocks.numel()} bytes, plain PyTorch on the card): "
          f"{glue:.4f} ms against "
          f"{rows['bitmatrix_encode_batched']['ms']:.4f} ms (crs) and "
          f"{rows['mod2_matmul_encode_batched']['ms']:.4f} ms (mxu) in the "
          f"kernel")
    print(f"[kernel] bit-plane: {sweep} sweep shapes and {len(windows) + 1} "
          f"main-path shapes byte-equal to the plain versions, the mod-2 "
          f"kernel equal to the select-and-XOR kernel at each; no single "
          f"PyTorch call computes a GF(2) bit-plane product with repack, so "
          f"library_ms is null")

    out = []
    for fam, (bname, fname, source, rep_b, rep_f) in BIT_FAMILIES.items():
        for name, replaces in ((bname, rep_b), (fname, rep_f)):
            out.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": None,
                        "max_abs_err": max_err[name], **rows[name],
                        "library_ms": None})
    return out


# (m, reads) of the plans the planner compiles for the main path's repairs
# of one and two failed nodes.
REPAIR_PLANS = ((1, 12), (1, 2), (2, 24), (2, 13))


def gf_windows(cfg) -> list[tuple[int, int, int]]:
    """(S, m, k) of the GF(2^8) kernel's launches at the main path's
    widths: the repair pipeline's windows (4 groups of 16 stripes per
    failure, cut by ``launch_step``) for the plans of ``REPAIR_PLANS``, and
    S=16 or the step, m = 1, 2, 4 at k = 12 and 24 (decodes)."""
    from repro_torch.ftx import launch_step

    shapes = {(min(launch_step(cfg, k, cfg.pipeline_window), 16), m, k)
              for m in (1, 2, 4) for k in (12, 24)}
    for m, k in REPAIR_PLANS:
        step = launch_step(cfg, k, cfg.pipeline_window)
        for s in {min(step, 16), 16 % step or step}:
            shapes.add((s, m, k))
    return sorted(shapes)


def cfg_parity(cfg):
    from repro_torch.core.schemes import make_scheme

    return make_scheme(cfg.scheme, cfg.k, cfg.r, cfg.p).parity_matrix()


def drive_main_path(np, torch, cfg, workdir: Path, device, batched,
                    want_hashes=None) -> tuple[dict, dict]:
    """Seal 64 stripes, repair one and two failed nodes, serve degraded,
    through ``cfg.backend``, whose stripe-batched kernel wrapper is
    ``batched``. The sealed block files must hash as ``want_hashes`` (by
    path under the store's root) when it is given. Returns the report and
    the sealed files' hashes."""
    from repro_torch.ftx import StripeStore, repair_failed_nodes
    from repro_torch.kernels import ref

    backend = cfg.backend
    if device.type == "cuda" or backend in ("crs", "mxu"):
        ran = backend
    else:
        ran = "ref"                      # gf and ref: the CPU's table path

    store = StripeStore(workdir, cfg, device=device)
    extent = cfg.k * cfg.block_size
    rng = np.random.default_rng(SEED)
    objects = {}                                 # key -> (seed, size)
    total = 0
    t0 = time.perf_counter()
    while total < STRIPES * extent:
        size = min(int(rng.integers(1 << 20, 40 << 20)),
                   STRIPES * extent - total)
        key = f"obj{len(objects)}"
        objects[key] = (len(objects), size)
        store.put(key, payload(np, len(objects) - 1, size))
        total += size
    store.seal()
    seal_s = time.perf_counter() - t0
    check(len(store.stripes) == STRIPES,
          f"{len(store.stripes)} stripes sealed, expected {STRIPES}")
    hashes = {p: sha(p) for p in workdir.glob("node*/*.blk")}
    check(len(hashes) == STRIPES * store.n, f"{len(hashes)} block files")
    by_path = {str(p.relative_to(workdir)): h for p, h in hashes.items()}
    check(want_hashes is None or by_path == want_hashes,
          f"{backend}: sealed block files differ from the gf store's")
    print(f"[main] {backend}: sealed {STRIPES} stripes ({total} bytes of "
          f"objects, {len(hashes)} block files) in {seal_s:.3f} s"
          + ("" if want_hashes is None else
             "; every block file hashes as the gf store's"))

    # Seal-time parity against the plain version on the same data blocks.
    st0 = store.stripes[0]
    blocks = np.stack([np.fromfile(workdir / f"node{st0.node_of_block[b]}"
                                   / f"s0_b{b}.blk", np.uint8)
                       for b in range(store.n)])
    want = ref.gf256_matmul_ref(
        torch.from_numpy(store.scheme.parity_matrix()).to(device),
        torch.from_numpy(blocks[:cfg.k]).to(device)).cpu().numpy()
    check((want == blocks[cfg.k:]).all(),
          "sealed parity differs from the plain version")

    fields = ("stripes_repaired", "patterns", "launches", "windows",
              "blocks_read", "wall_seconds", "read_seconds",
              "compute_seconds", "write_seconds")

    def repair(nodes):
        """Empty the failed nodes' block files (only the repair can bring
        their bytes back), repair them, and check what came back."""
        rebuilt = [p for p in hashes if int(p.parent.name[4:]) in nodes]
        for p in rebuilt:
            p.write_bytes(b"")
        before = batched.launches
        rep = repair_failed_nodes(store, nodes, device=device)
        grew = batched.launches - before
        patterns, reads, local, glob = EXPECTED[nodes]
        check(rep.stripes_repaired == STRIPES and rep.patterns == patterns
              and rep.blocks_read == reads and rep.repairs_local == local
              and rep.repairs_global == glob,
              f"repair {nodes}: counts differ from the reference: {rep}")
        check(rep.effective_backend == ran,
              f"repair {nodes} ran {rep.effective_backend!r}, not {ran!r}")
        check(device.type != "cuda" or grew >= rep.launches,
              f"repair {nodes}: the kernel launched {grew} times for "
              f"{rep.launches} reported launches")
        bad = [p.name for p in rebuilt if sha(p) != hashes[p]]
        check(not bad, f"repair {nodes}: rebuilt blocks differ: {bad[:5]}")
        return rep, len(rebuilt), grew

    out = {}
    for nodes in ((3,), (3, 4)):
        rep, rebuilt, grew = repair(nodes)
        out[f"repair_{'_'.join(map(str, nodes))}"] = {
            f: getattr(rep, f) for f in fields}
        print(f"[main] {backend}: repair_failed_nodes{list(nodes)}: "
              + ", ".join(f"{f}={getattr(rep, f)}" for f in fields)
              + f"; {rebuilt} rebuilt files byte-equal; kernel "
              f"launches {grew}")
    if device.type == "cuda":
        out["profile_3_4"] = profile_repair(torch, lambda: repair((3, 4)),
                                            backend)

    # Degraded serving with node 3 down: one lost block, and objects whose
    # bytes lie on it.
    store.fail_node(3)
    sid, block = next((sid, b) for sid, st in sorted(store.stripes.items())
                      for b, n in enumerate(st.node_of_block) if n == 3)
    lost = workdir / "node3" / f"s{sid}_b{block}.blk"
    t0 = time.perf_counter()
    data = store.read(sid, block)
    read_s = time.perf_counter() - t0
    check(hashlib.sha256(data.tobytes()).hexdigest() == hashes[lost],
          f"degraded read of stripe {sid} block {block} differs")
    served = 0
    t0 = time.perf_counter()
    for key, (seed, size) in objects.items():
        meta = store.objects[key]
        first = meta.block
        last = (meta.offset + meta.size - 1) // cfg.block_size + meta.block
        on_lost = any(store.stripes[meta.sid].node_of_block[b] == 3
                      for b in range(first, min(last, cfg.k - 1) + 1))
        if not on_lost:
            continue
        check((store.get(key) == payload(np, seed, size)).all(),
              f"degraded get of {key} differs")
        served += 1
        if served == 3:
            break
    get_s = time.perf_counter() - t0
    check(served > 0, "no object lay on the failed node")
    store.revive_node(3)
    print(f"[main] {backend}: degraded read of stripe {sid} block {block} in "
          f"{read_s:.4f} s and {served} degraded gets in {get_s:.4f} s: "
          f"byte-equal")
    out["seal_seconds"] = seal_s
    return out, by_path


# Substrings of the port's CUDA kernels' names, as the profiler sees them.
KERNEL_NAMES = ("gf256_matmul", "bitmatrix_encode", "mod2_matmul")


def profile_repair(torch, run, backend: str) -> dict:
    """Where the time goes: ``run`` (one repair) under torch.profiler, its
    device time by kind (the port's kernels, host->device and
    device->host copies, the rest) against the repair's wall time. For
    crs and mxu "other" holds the packetize/unpacketize glue, which runs
    as plain PyTorch elementwise kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        rep = run()[0]
        torch.cuda.synchronize()
    device_us = {"kernel": 0.0, "h2d": 0.0, "d2h": 0.0, "other": 0.0}
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        kind = ("kernel" if any(n in evt.name for n in KERNEL_NAMES)
                else "h2d" if "HtoD" in evt.name
                else "d2h" if "DtoH" in evt.name else "other")
        device_us[kind] += evt.time_range.elapsed_us()
    busy_s = sum(device_us.values()) / 1e6
    result = {"wall_seconds": rep.wall_seconds,
              "compute_seconds": rep.compute_seconds,
              "device_ms": {k: v / 1e3 for k, v in device_us.items()},
              "device_busy_share": (busy_s / rep.wall_seconds
                                    if busy_s else None)}
    if busy_s:
        print(f"[profile] {backend}: repair_failed_nodes[3, 4] under "
              f"torch.profiler: "
              f"wall {rep.wall_seconds} s, compute span "
              f"{rep.compute_seconds} s; device ms: "
              + ", ".join(f"{k} {v / 1e3}" for k, v in device_us.items())
              + f"; device busy {result['device_busy_share']} of the wall"
              + ("; other is the packetize/unpacketize glue (plain "
                 "PyTorch elementwise kernels) and any other op"
                 if backend in ("crs", "mxu") else ""))
    else:
        print("[profile] torch.profiler recorded no device time: device "
              "busy share not measured")
    # Host time by operator (self time, summed over the pipeline's
    # threads): where a compute span goes that the device does not show.
    host = sorted(((e.self_cpu_time_total, e.count, e.key)
                   for e in prof.key_averages()), reverse=True)[:6]
    result["host_self_ms"] = {key: us / 1e3 for us, _, key in host}
    print(f"[profile] {backend}: host self ms by operator, top 6: "
          + "; ".join(f"{key} {us / 1e3} ({n} calls)" for us, n, key in host))
    return result


def payload(np, seed: int, size: int):
    """Object ``seed``'s bytes, the same every time they are asked for."""
    return np.frombuffer(np.random.default_rng([SEED, seed]).bytes(size),
                         np.uint8)


if __name__ == "__main__":
    main()
