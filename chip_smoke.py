#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one CUDA card and check it.

    python3 chip_smoke.py            # from the root of a checkout

Phases (any failure raises and the script exits non-zero):

1. Device and build: the card's name and power limit, and the seconds it
   takes to build every CUDA source of ``src/repro_torch/csrc`` (one
   ``nvcc`` per source, started together).
2. Each kernel against its plain PyTorch version on the card, byte for
   byte, over a sweep of shapes (ragged widths, odd and large stripe
   counts, zero and one-hot coefficient rows) and the shapes the main path
   gives it; at the main-path shapes, the kernel's and the plain version's
   times (CUDA events, median) beside the least time the card could take.
3. The main path at real size: a ``StripeStore`` with the paper's P5
   (cp-azure, k=24, r=2, p=2), 1 MiB blocks and 28 nodes; seeded random
   objects until 64 stripes are sealed (1.5 GiB of user data); then
   ``repair_failed_nodes`` for one and for two failed nodes, the two-node
   repair once more under ``torch.profiler`` (device time by kind against
   the wall), and a degraded ``read`` and ``get`` with a node down. The
   failed nodes' block files are emptied before each repair and must hash
   as they did when sealed after it, the report's counts must be the
   reference's, and every kernel must have launched during this phase.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Without a CUDA card, or run
outside a checkout, it fails and prints no result.
"""
from __future__ import annotations

import hashlib
import json
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


def bound_ms(s: int, m: int, k: int, b: int) -> tuple[float, str]:
    """Least time for (m,k) x (S,k,B): every input byte read once and every
    output byte written once at the HBM rate, against one 32-bit operation
    per GF multiply-accumulate at the card's non-tensor peak."""
    mem = (s * (k + m) * b + m * k) / HBM_BYTES_PER_S * 1e3
    ops = s * m * k * b / SCALAR_OPS_PER_S * 1e3
    return (mem, "bytes") if mem >= ops else (ops, "operations")


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
    from repro_torch.ftx import StoreConfig, launch_step
    from repro_torch.kernels import _build, ref
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
    shapes = {(min(launch_step(cfg, k, cfg.pipeline_window), 16), m, k)
              for m in (1, 2, 4) for k in (12, 24)}
    # Windows the repair pipeline cuts for the run below: 4 groups of 16
    # stripes per failure, plans (m, reads) as the planner compiles them.
    for m, k in ((1, 12), (1, 2), (2, 24), (2, 13)):
        step = launch_step(cfg, k, cfg.pipeline_window)
        for s in {min(step, 16), 16 % step or step}:
            shapes.add((s, m, k))
    timings = {}
    for (s, m, k) in sorted(shapes):
        coef = rand((m, k))
        data = rand((s, k, B))
        compare(coef, data, (s, m, k, B))
        kms = cuda_ms(torch, lambda: gm.gf256_matmul_batched(coef, data), 10)
        pms = cuda_ms(torch,
                      lambda: ref.gf256_matmul_batched_ref(coef, data), 3)
        bms, by = bound_ms(s, m, k, B)
        timings[(s, m, k)] = (kms, pms, bms, by)
        print(f"[kernel] gf256_matmul_batched S={s} m={m} k={k} B={B}: "
              f"{kms:.4f} ms, plain {pms:.4f} ms, bound {bms:.4f} ms "
              f"({by})")
    # The seal-time flat encode: parity rows (4, 24) over one stripe.
    pcoef = torch.from_numpy(cfg_parity(cfg)).to(dev)
    pdata = rand((cfg.k, B))
    compare(pcoef, pdata[None], (1, 4, 24, B))
    flat_ms = cuda_ms(torch, lambda: gm.gf256_matmul(pcoef, pdata), 10)
    flat_plain = cuda_ms(torch, lambda: ref.gf256_matmul_ref(pcoef, pdata), 3)
    flat_bound, flat_by = bound_ms(1, 4, cfg.k, B)
    print(f"[kernel] gf256_matmul m=4 k=24 B={B}: {flat_ms:.4f} ms, plain "
          f"{flat_plain:.4f} ms, bound {flat_bound:.4f} ms ({flat_by})")
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

    # ------------------------------------------ 3. main path at real size
    (ROOT / "_smoke").mkdir(exist_ok=True)
    workdir = Path(tempfile.mkdtemp(prefix="store-", dir=ROOT / "_smoke"))
    try:
        gm.gf256_matmul.launches = 0
        gm.gf256_matmul_batched.launches = 0
        report = drive_main_path(np, torch, cfg, workdir, dev)
        launches = {"gf256_matmul_batched": gm.gf256_matmul_batched.launches,
                    "gf256_matmul": gm.gf256_matmul.launches}
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    for name, n in launches.items():
        check(n > 0, f"{name} was never launched on the main path")
    print(f"[main] kernel launches on the main path: {launches}; "
          f"{json.dumps(report)}")

    s, m, k = big
    kms, pms, bms, by = timings[big]
    kernels = [
        {"name": "gf256_matmul_batched", "route": "cuda",
         "source": "src/repro_torch/csrc/gf256_matmul.cu",
         "replaces": "src/repro/kernels/gf256_matmul.py:126",
         "launches": launches["gf256_matmul_batched"],
         "max_abs_err": max_err["gf256_matmul_batched"],
         "ms": kms, "plain_ms": pms, "bound_ms": bms, "bound_by": by,
         "library_ms": None, "shape": {"S": s, "m": m, "k": k, "B": B}},
        {"name": "gf256_matmul", "route": "cuda",
         "source": "src/repro_torch/csrc/gf256_matmul.cu",
         "replaces": "src/repro/kernels/gf256_matmul.py:92",
         "launches": launches["gf256_matmul"],
         "max_abs_err": max_err["gf256_matmul"],
         "ms": flat_ms, "plain_ms": flat_plain, "bound_ms": flat_bound,
         "bound_by": flat_by, "library_ms": None,
         "shape": {"S": 1, "m": 4, "k": cfg.k, "B": B}},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def cfg_parity(cfg):
    from repro_torch.core.schemes import make_scheme

    return make_scheme(cfg.scheme, cfg.k, cfg.r, cfg.p).parity_matrix()


def drive_main_path(np, torch, cfg, workdir: Path, device) -> dict:
    """Seal 64 stripes, repair one and two failed nodes, serve degraded."""
    from repro_torch.ftx import StripeStore, repair_failed_nodes
    from repro_torch.kernels import gf256_matmul as gm
    from repro_torch.kernels import ref

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
    print(f"[main] sealed {STRIPES} stripes ({total} bytes of objects, "
          f"{len(hashes)} block files) in {seal_s:.3f} s")

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
        before = gm.gf256_matmul_batched.launches
        rep = repair_failed_nodes(store, nodes, device=device)
        grew = gm.gf256_matmul_batched.launches - before
        patterns, reads, local, glob = EXPECTED[nodes]
        check(rep.stripes_repaired == STRIPES and rep.patterns == patterns
              and rep.blocks_read == reads and rep.repairs_local == local
              and rep.repairs_global == glob,
              f"repair {nodes}: counts differ from the reference: {rep}")
        check(rep.effective_backend == ("gf" if device.type == "cuda"
                                        else "ref"),
              f"repair {nodes} ran {rep.effective_backend!r}")
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
        print(f"[main] repair_failed_nodes{list(nodes)}: "
              + ", ".join(f"{f}={getattr(rep, f)}" for f in fields)
              + f"; {rebuilt} rebuilt files byte-equal; kernel "
              f"launches {grew}")
    if device.type == "cuda":
        out["profile_3_4"] = profile_repair(torch, lambda: repair((3, 4)))

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
    print(f"[main] degraded read of stripe {sid} block {block} in "
          f"{read_s:.4f} s and {served} degraded gets in {get_s:.4f} s: "
          f"byte-equal")
    out["seal_seconds"] = seal_s
    return out


def profile_repair(torch, run) -> dict:
    """Where the time goes: ``run`` (one repair) under torch.profiler, its
    device time by kind (the kernel, host->device and device->host
    copies, the rest) against the repair's wall time."""
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
        kind = ("kernel" if "gf256_matmul" in evt.name
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
        print(f"[profile] repair_failed_nodes[3, 4] under torch.profiler: "
              f"wall {rep.wall_seconds} s, compute span "
              f"{rep.compute_seconds} s; device ms: "
              + ", ".join(f"{k} {v / 1e3}" for k, v in device_us.items())
              + f"; device busy {result['device_busy_share']} of the wall")
    else:
        print("[profile] torch.profiler recorded no device time: device "
              "busy share not measured")
    return result


def payload(np, seed: int, size: int):
    """Object ``seed``'s bytes, the same every time they are asked for."""
    return np.frombuffer(np.random.default_rng([SEED, seed]).bytes(size),
                         np.uint8)


if __name__ == "__main__":
    main()
