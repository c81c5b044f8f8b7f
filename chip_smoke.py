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
   time the card could take; and the same at the shapes the serving and
   checkpoint paths of phases 4 and 5 give each batched kernel.
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
4. Serving, on the gf store of phase 3: with node 3 failed,
   ``BlockServer(store, clients=8).run(zipf_requests(store, 2000,
   seed=0))``. Every response must hash as the block read before the
   failure; prints the degraded-read report (p50/p99, coalescing ratio,
   decode launches).
5. Checkpointing a training state that lives on the card: internvl2-1b's
   Qwen2 backbone at its published widths (all 24 layers, about 494 M
   parameters in bf16 and their AdamW moments in fp32, 4.9 GB) under the
   default ``CheckpointConfig`` on gf: ``save_async`` (a tensor
   overwritten after it returns), two hosts' block files emptied and the
   hosts failed, a parallel degraded ``restore`` held byte for byte
   against the state as saved, and ``repair`` (the emptied files must hash
   as they did). crs and mxu then save the state cut to 2 layers, and
   their block files must hash as a gf save of it.
6. Reliability: the fleet simulator on the card. 6a: ``BitSource`` (the
   threefry chain in torch) against a table of the reference's bits and
   against the numpy chain over 2^20 random triples; the event select
   against numpy on schedules with ties and all-``inf`` rows. 6b: the
   reference's all-processes golden run (azure(4,2,1), 6 trials, seed 3):
   counts, exposure and a hash of the event logs equal to the reference's
   constants, and the port's oracle with host bits bit-identical to the
   card's engine. 6c: cp-azure and azure at P5 (24,2,2) on 28 nodes in 7
   racks under every failure process, 2000 trials each (a ``[sim]`` line
   each: losses, MTTDL, events, epochs, events/s, and the wall split
   between the device calls and the host loop), and at 500 trials the
   card's engine equal to the host's field for field. 6d: cp-azure P5
   with the bandwidth of phase 3's two-node repair, a calibration store
   (seal and repair: the GF(2^8) kernels' ``sim`` launches; the failed
   node's emptied block files rebuilt byte-equal, and every block file
   equal to a twin store's on the host) and
   ``python -m repro_torch.launch.simulate --calibrate ... --closed-form
   --oracle`` in a subprocess, which must exit 0 bit-identical.

7. Sharding and orchestration. 7a, right after phase 4 on phase 3's gf
   store with every node up: nodes 3 and 4 fail, their block files are
   emptied, and ``repair_failed_nodes`` runs under an 8x1 mesh of eight
   positions of the card: the reference's counts, 7 launches over 8
   devices (56 per-device launches of the GF(2^8) kernel: at 1 MiB blocks
   the 256 MiB stack budget splits each 16-stripe group of 24 reads into
   two windows; 4 and 32 hold at 1 KiB), block files hashing as sealed;
   the two-node plan on a 16-stripe window through crs and mxu split 8
   ways, byte-equal to the unsharded call and to the sealed blocks (phase
   2b holds both kernels to their plain versions at one shard's shape,
   S=2 R8=16 K8=192 P=131072); the window's
   time unsharded and split, and one shard's launch beside its bound. 7b:
   a new P5 store at 1 MiB blocks (64 stripes, 48 nodes in 24 two-node
   domains, spread width 16) replays ``tests/data/correlated_trace.json``
   with the global schedule, topology destinations, the failed nodes left
   down and a rebalance pass, then ``FailureInjector(store, seed=0)`` fails
   and repairs three more nodes; every failed node loses its block files,
   every count must be the reference's (the constants below), every block
   file must hash as sealed and the payload must come back. The replay
   command line then runs twice on the card and once on the host and
   must print the same JSON each time.
8. Serving a model (``[serve-model]`` lines). 8a: qwen2.5-3b at its
   published widths (3,085,938,688 bf16 parameters, 6,171,877,376 bytes,
   drawn on the card from the seed): prefill and one decode step against
   the full forward on a B=2, S=64 batch (under 0.02 relative), then
   ``ServeEngine(max_batch=4, max_len=128)`` serves the serving command's
   load (8 prompts of 4 to 31 tokens, 8 new tokens each) twice, with the
   same tokens both times; prefill and decode-step milliseconds (CUDA
   events), tokens/s, p50/p99 and peak memory. 8b: every decoder-only
   SMOKE config in fp32, weights made on the host and moved to the card:
   prefill logits within 1e-4 of the host's and the engines' tokens
   identical (gemma3 with a prompt shorter than its window). 8c: 8a's
   parameters through ``save_async`` under the default
   ``CheckpointConfig``, hosts 1 and 2 emptied and failed, a parallel
   degraded ``restore`` byte for byte, and a fresh engine on the restored
   parameters giving 8a's tokens exactly (the GF(2^8) kernels'
   ``serve_model`` launches).
9. Training a model (``[train]`` lines), after phase 8's model is
   released. 9a: qwen2.5-3b at its published widths and depth (bf16
   parameters drawn on the card, f32 AdamW moments: 37 GB of state with
   the gradients) trains 6 steps of ``make_train_step(donate=True)`` with
   remat on one card's slice of the reference's train_4k cell (B=1,
   T=4096, ``SyntheticLM`` seed 0) at the reference command's optimizer
   settings: finite losses and norms, the first loss within 1.0 of ln V,
   the parameters changed; step ms (CUDA events), tokens/s, peak memory,
   one profiled step, and the step's operations against the card's
   peaks. 9b: one fp32 step of every SMOKE config (seamless included) on
   the card against the host (loss, grad_norm, parameters within the
   tests' bounds), and microbatches 1, 2 and 4 agreeing. 9c: the widths
   at 2 layers trained 3 steps, ``save_async`` while the next runs, one
   more; hosts 1 and 2 emptied and failed, ``restore``, the same 2 steps
   again with deterministic algorithms: parameters and moments
   bit-identical, losses equal (the GF(2^8) kernels' ``train``
   launches). 9d: ``python -m repro_torch.launch.train`` (the reference
   command's demo: 30 steps, an async save every 10, host 2 killed and
   restored) in a subprocess on the card: exit 0 and falling losses.

Each path (3, 4, 5, 6, 7a, 7b, 8c, 9c) runs with the kernel wrappers'
launch counts set to 0 just before it and read just after, and fails if a
kernel it runs was never launched. The line before the last is a JSON
object with one entry per kernel (``launches`` is phase 3's count,
``launches_by_path`` each path's, ``sharded`` and ``replay`` for 7a and
7b, ``serve_model`` for 8c, ``train`` for 9c; the simulator's select and
draws are plain torch on the card, and the model's layers and the
optimizer stock torch operators, not kernels of this line); the last line
is ``{"ok": true, "device": {...}}``. Without a CUDA card, or run outside a
checkout, it fails and prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import math
import os
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
# Phase 7a: (launches, devices, device_launches) of that store's two-node
# repair under an 8x1 mesh: at 1 MiB blocks the 256 MiB stack budget cuts
# each 16-stripe group of 24 reads into two windows of 8 (held by
# tests/test_torch_dist.py against the reference on eight devices).
SHARDED_EXPECTED = (7, 8, 56)
# Phase 7b: the reference's replay of tests/data/correlated_trace.json on
# a P5 store of 64 stripes, 48 nodes in 24 two-node domains, spread width
# 16 (held by tests/test_torch_orchestration.py at 1 and 2 KiB blocks).
REPLAY_EXPECTED = {
    "nodes": [[7, 17], [4, 5], [3], [20, 21]],
    "blocks_read": [773, 858, 444, 924],
    "totals": {"blocks_read": 2999, "local_reads": 125, "remote_reads": 2874,
               "scheduled_local": 125, "contiguous_local": 125,
               "schedule_total": 2999, "blocks_relocated": 278,
               "repairs_local": 138, "repairs_global": 46},
    "rebalance": {"planned": 17, "moved": 17, "windows": 1,
                  "imbalance_before": 5, "imbalance_after": 1}}
# Then FailureInjector(store, seed=0).run(hours=40.0) on that store: the
# failed nodes, the blocks each repair read and whether it stayed local.
INJECTOR_EXPECTED = {"hours": 40.0, "nodes": [24, 12, 8],
                     "blocks_read": [516, 470, 478],
                     "local": [False, False, True]}


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
    t_start = time.perf_counter()
    sys.path.insert(0, str(ROOT / "src"))
    # Phase 9c's bit-exact restore runs cuBLAS deterministically, which
    # needs this before the process's first cuBLAS handle.
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    # The shapes the serving, checkpoint and calibration paths (phases 4,
    # 5 and 6) give the kernel, each beside its plain version and its
    # bound; compare() holds the flat kernel too where S = 1.
    for (path, s, m, k, bb) in GF_PATH_SHAPES:
        coef = rand((m, k))
        data = rand((s, k, bb))
        compare(coef, data, (path, s, m, k, bb))
        kms = cuda_ms(torch, lambda: gm.gf256_matmul_batched(coef, data), 10)
        dms = device_ms(torch, gm.gf256_matmul_batched, (coef, data))
        pms = cuda_ms(torch,
                      lambda: ref.gf256_matmul_batched_ref(coef, data), 3)
        bms, by = bound_ms(s, m, k, bb)
        print(f"[kernel] gf256_matmul_batched ({path}) S={s} m={m} k={k} "
              f"B={bb}: {kms:.4f} ms (device {dms:.4f} ms), plain "
              f"{pms:.4f} ms, bound {bms:.4f} ms ({by})")
    print(f"[kernel] {sweep} sweep shapes, {len(shapes) + 1} main-path "
          f"shapes and {len(GF_PATH_SHAPES)} serving, checkpoint and "
          f"calibration shapes "
          f"byte-equal to the plain version; no single PyTorch call "
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
    by_path = {fn.__name__: {} for fns in wrappers.values() for fn in fns}
    gf_hashes = None
    (ROOT / "_smoke").mkdir(exist_ok=True)
    for backend in ("gf", "crs", "mxu"):
        workdir = Path(tempfile.mkdtemp(prefix=f"store-{backend}-",
                                        dir=ROOT / "_smoke"))
        try:
            for fn in wrappers[backend]:
                fn.launches = 0
            report, hashes, store = drive_main_path(
                np, torch, dataclasses.replace(cfg, backend=backend),
                workdir, dev, wrappers[backend][0], gf_hashes)
            for fn in wrappers[backend]:
                launches[fn.__name__] = fn.launches
                by_path[fn.__name__]["main"] = fn.launches
            if backend == "gf":
                gf_report = report
                # ------------------------- 4. serving from the gf store
                for fn in wrappers["gf"]:
                    fn.launches = 0
                serve_phase(np, torch, store, wrappers["gf"][0])
                for fn in wrappers["gf"]:
                    by_path[fn.__name__]["serve"] = fn.launches
                check(by_path["gf256_matmul_batched"]["serve"] > 0,
                      "gf256_matmul_batched was never launched on the "
                      "serving path")
                # ---------- 7a. the gf store's repair split over a mesh
                sharded = sharded_phase(np, torch, store, workdir, hashes,
                                        dev, wrappers, by_path)
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

    # ------------------------------------------------- 5. checkpointing
    workdir = Path(tempfile.mkdtemp(prefix="ckpt-", dir=ROOT / "_smoke"))
    try:
        checkpoint_phase(np, torch, dev, workdir, wrappers, by_path,
                         QWEN2_LAYERS)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    # ---------------------------------------------------- 6. reliability
    workdir = Path(tempfile.mkdtemp(prefix="sim-", dir=ROOT / "_smoke"))
    try:
        reliability_phase(np, torch, dev, workdir, by_path,
                          gf_report["repair_3_4"])
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    # ------------------------- 7b. trace replay, injector, rebalancer
    workdir = Path(tempfile.mkdtemp(prefix="replay-", dir=ROOT / "_smoke"))
    try:
        replay = replay_phase(np, torch, dev, workdir, wrappers, by_path)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(f"[phase 7] 7a {sharded['phase_seconds']} s, 7b "
          f"{replay['phase_seconds']} s, in all "
          f"{sharded['phase_seconds'] + replay['phase_seconds']} s")

    # ------------------------------------------------ 8. serving a model
    served = serve_model_phase(np, torch, dev, smi)
    host_card_phase(np, torch, dev)
    workdir = Path(tempfile.mkdtemp(prefix="serve-model-",
                                    dir=ROOT / "_smoke"))
    try:
        checkpoint_serve_phase(np, torch, dev, workdir, served,
                               wrappers["gf"], by_path)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    del served

    # ----------------------------------------------- 9. training a model
    torch.cuda.empty_cache()
    train_full_phase(np, torch, dev, smi)
    torch.cuda.empty_cache()
    host_card_train_phase(np, torch, dev)
    workdir = Path(tempfile.mkdtemp(prefix="train-", dir=ROOT / "_smoke"))
    try:
        checkpoint_train_phase(np, torch, dev, workdir, wrappers["gf"],
                               by_path)
        train_cli_phase(np, torch, dev, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(f"[smoke] phases 1-9 in {time.perf_counter() - t_start} s of "
          f"the 1200 s limit (process start and imports aside)")

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
    for row in kernels:
        row["launches_by_path"] = by_path[row["name"]]
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
    # The checkpoint path's encode windows (phase 5's crs and mxu saves).
    for (path, s, m, k, p) in BIT_PATH_SHAPES:
        bm = torch.from_numpy(matrix_to_bitmatrix(
            rng.integers(0, 256, (m, k), dtype=np.uint8))).to(dev)
        pk = u8((s, 8 * k, p))
        label = f"({path}) S={s} R8={8 * m} K8={8 * k} P={p}"
        compare(bm, pk, label)
        for fam, (batched, _, plain_b, _) in fams.items():
            timed(batched, plain_b, bm, pk, fam, label)
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
    print(f"[kernel] bit-plane: {sweep} sweep shapes, {len(windows) + 1} "
          f"main-path shapes and {len(BIT_PATH_SHAPES)} checkpoint and "
          f"sharded shapes "
          f"byte-equal to the plain versions, the mod-2 "
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
# (path, S, m, k, B) of the launches phases 4 and 5 give the GF(2^8)
# kernel, as the planner cuts them (the S=4 and S=5 group tails aside):
# a single lost P5 block decoded from its 12-block local group at 1 MiB;
# the checkpoint store's (k=8, 256 KiB) encode windows of 32 stripes and
# the tail of 2355 stripes, and its decodes with hosts 1 and 2 lost, on
# restore (one or two targets) and repair; phase 6's calibration store
# (cp-azure(24,2,2) at 2 KiB blocks): its seal's flat parity encode, one a
# stripe, and its repair's local decode, one stripe a launch; phase 8c's
# save of qwen2.5-3b (2943 stripes): the tail window of 31 (its other
# windows are phase 5's).
GF_PATH_SHAPES = (("serve", 1, 1, 12, 1 << 20), ("save", 32, 4, 8, 1 << 18),
                  ("save", 19, 4, 8, 1 << 18),
                  ("serve_model", 31, 4, 8, 1 << 18),
                  ("restore", 32, 1, 4, 1 << 18),
                  ("restore", 32, 2, 8, 1 << 18),
                  ("repair", 32, 2, 5, 1 << 18), ("sim", 1, 4, 24, 2048),
                  ("sim", 1, 1, 12, 2048))
# (path, S, m, k, P) of the crs and mxu kernels' launches off the repair
# windows: phase 5's encode windows (791 stripes of the 2-layer state, 32 a
# window, P = 256 KiB / 8) and one shard of phase 7a's two-node window (16
# stripes split 8 ways, P = 1 MiB / 8).
BIT_PATH_SHAPES = (("save", 32, 4, 8, 1 << 15), ("save", 23, 4, 8, 1 << 15),
                   ("sharded", 2, 2, 24, 1 << 17))


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
                    want_hashes=None) -> tuple[dict, dict, object]:
    """Seal 64 stripes, repair one and two failed nodes, serve degraded,
    through ``cfg.backend``, whose stripe-batched kernel wrapper is
    ``batched``. The sealed block files must hash as ``want_hashes`` (by
    path under the store's root) when it is given. Returns the report, the
    sealed files' hashes and the store, with every node up again."""
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
              "blocks_read", "bytes_read", "sim_seconds", "wall_seconds",
              "read_seconds", "compute_seconds", "write_seconds")

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
    return out, by_path, store


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


# Phase 4's load: Zipfian reads of the gf store's data blocks by this many
# front-end clients, with this node failed.
SERVE_REQUESTS, SERVE_CLIENTS, SERVE_NODE = 2000, 8, 3


def serve_phase(np, torch, store, batched) -> dict:
    """Phase 4: a Zipfian multi-client block load through ``BlockServer``
    with node 3 failed. Every response must hash as the block read before
    the failure; the lost blocks' reads reconstruct through ``batched``
    (each decode launch is one call of it)."""
    from repro_torch.ftx import read_report
    from repro_torch.serve import BlockServer, zipf_requests

    requests = zipf_requests(store, SERVE_REQUESTS, seed=0)
    healthy = {key: hashlib.sha256(store.read(*key).tobytes()).hexdigest()
               for key in sorted(set(requests))}
    read_report(store, reset=True)
    store.fail_node(SERVE_NODE)
    lost = sum(store.stripes[sid].node_of_block[b] == SERVE_NODE
               for sid, b in requests)
    server = BlockServer(store, clients=SERVE_CLIENTS)
    before = batched.launches
    t0 = time.perf_counter()
    responses = server.run(requests)
    wall = time.perf_counter() - t0
    grew = batched.launches - before
    rep = read_report(store)
    store.revive_node(SERVE_NODE)
    bad = [key for key, data in zip(requests, responses)
           if hashlib.sha256(data.tobytes()).hexdigest() != healthy[key]]
    check(not bad, f"serving: {len(bad)} responses differ from the healthy "
          f"blocks, first {bad[:3]}")
    check(rep.degraded_reads == lost > 0 and rep.decode_launches > 0,
          f"serving: {rep.degraded_reads} degraded reads for {lost} requests "
          f"on node {SERVE_NODE}, {rep.decode_launches} decode launches")
    check(store.device.type != "cuda" or grew >= rep.decode_launches,
          f"serving: the kernel launched {grew} times for "
          f"{rep.decode_launches} decode launches")
    front = server.latency.snapshot()
    out = {"requests": len(requests), "clients": SERVE_CLIENTS,
           "distinct_blocks": len(healthy), "wall_seconds": wall,
           "direct_reads": rep.direct_reads,
           "degraded_reads": rep.degraded_reads,
           "coalesced_reads": rep.coalesced_reads,
           "decode_launches": rep.decode_launches,
           "kernel_launches": grew, "cache_hits": rep.cache_hits,
           "coalescing_ratio": rep.coalescing_ratio,
           "cache_hit_rate": rep.cache_hit_rate,
           "local_decode_fraction": rep.local_decode_fraction,
           "store_p50_ms": rep.p50_ms, "store_p99_ms": rep.p99_ms,
           "front_p50_ms": front["p50_ms"], "front_p99_ms": front["p99_ms"],
           "served_bytes": rep.served_bytes}
    print(f"[serve] BlockServer(clients={SERVE_CLIENTS}).run(zipf_requests("
          f"store, {SERVE_REQUESTS}, seed=0)) with node {SERVE_NODE} failed: "
          f"{len(requests)} responses hash as the healthy blocks; "
          + json.dumps(out))
    return out


# internvl2-1b's Qwen2 language backbone at its published widths (24
# layers, d_model 896, 14 query heads and 2 key/value heads of 64, SwiGLU
# d_ff 4864, vocabulary 151655, biases on q/k/v, embedding tied to the
# output head): about 494 M parameters.
QWEN2 = {"d_model": 896, "heads": 14, "kv_heads": 2, "d_ff": 4864,
         "vocab": 151655}
QWEN2_LAYERS = 24
# The depth crs and mxu save, each beside a gf save of the same state.
BIT_LAYERS = 2
CKPT_HOSTS = [1, 2]                     # hosts lost before the restore
CKPT_STEP = 1000


def qwen2_params(torch, dev, widths: dict, layers: int, gen):
    """Random bf16 parameters of a Qwen2 decoder (Hugging Face names, in
    module order) on ``dev``."""
    from collections import OrderedDict

    d, f = widths["d_model"], widths["d_ff"]
    kv = widths["kv_heads"] * d // widths["heads"]
    shapes = [("model.embed_tokens.weight", (widths["vocab"], d))]
    for i in range(layers):
        pre = f"model.layers.{i}."
        shapes += [(pre + "self_attn.q_proj.weight", (d, d)),
                   (pre + "self_attn.q_proj.bias", (d,)),
                   (pre + "self_attn.k_proj.weight", (kv, d)),
                   (pre + "self_attn.k_proj.bias", (kv,)),
                   (pre + "self_attn.v_proj.weight", (kv, d)),
                   (pre + "self_attn.v_proj.bias", (kv,)),
                   (pre + "self_attn.o_proj.weight", (d, d)),
                   (pre + "mlp.gate_proj.weight", (f, d)),
                   (pre + "mlp.up_proj.weight", (f, d)),
                   (pre + "mlp.down_proj.weight", (d, f)),
                   (pre + "input_layernorm.weight", (d,)),
                   (pre + "post_attention_layernorm.weight", (d,))]
    shapes.append(("model.norm.weight", (d,)))
    return OrderedDict(
        (name, (0.02 * torch.randn(shape, generator=gen, device=dev)
                ).to(torch.bfloat16)) for name, shape in shapes)


def train_state(np, torch, dev, widths: dict, layers: int) -> dict:
    """Parameters (bf16) and AdamW moments (fp32) of the backbone, made
    on ``dev`` from the seed, with the optimizer's step count carried in
    from numpy."""
    from collections import OrderedDict

    from repro_torch.convert import state_from_reference

    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = qwen2_params(torch, dev, widths, layers, gen)
    opt = state_from_reference({"step": np.int32(CKPT_STEP)}, device=dev)
    opt["m"] = OrderedDict(
        (k, 1e-3 * torch.randn(v.shape, generator=gen, device=dev))
        for k, v in params.items())
    opt["v"] = OrderedDict(
        (k, 1e-6 * torch.rand(v.shape, generator=gen, device=dev))
        for k, v in params.items())
    return {"params": params, "opt_state": opt}


def leaf_pairs(got, want, path=""):
    """(path, got leaf, want leaf) for every leaf of two nests of dicts."""
    if isinstance(want, dict):
        keys = sorted(want) if type(want) is dict else list(want)
        check(isinstance(got, dict) and list(got) == keys,
              f"restored nesting differs at {path or 'the root'}")
        for key in want:
            yield from leaf_pairs(got[key], want[key], f"{path}/{key}")
    else:
        yield path, got, want


def same_bytes(torch, got, want) -> bool:
    """``got`` (a restored CPU tensor) holds ``want``'s dtype, shape and
    bytes."""
    if got.dtype != want.dtype or got.shape != want.shape:
        return False
    return torch.equal(got.to(want.device).reshape(-1).view(torch.uint8),
                       want.reshape(-1).view(torch.uint8))


def checkpoint_phase(np, torch, dev, workdir: Path, wrappers: dict,
                     by_path: dict, layers: int, widths=None) -> dict:
    """Phase 5: erasure-coded checkpointing of a training state on the card
    (``widths`` at ``layers`` layers, the backbone's by default) under the
    default ``CheckpointConfig``. gf: ``save_async`` (the caller then
    overwrites a tensor), two hosts' block files emptied and the hosts
    failed, a parallel degraded ``restore`` held byte for byte against the
    state as it was saved, and ``repair`` (the emptied files must hash as
    they did). Then crs and mxu save the state cut to ``BIT_LAYERS``
    layers, and their block files must hash as a gf save of it. Each
    backend's wrappers count from 0 over its part into
    ``by_path[name]["checkpoint"]``."""
    from repro_torch.ftx import CheckpointConfig, CheckpointManager

    widths = widths or QWEN2
    default = CheckpointConfig()
    check(dev.type != "cuda" or default.store.backend == "gf",
          f"default checkpoint backend on CUDA is {default.store.backend!r}")
    state = train_state(np, torch, dev, widths, layers)
    nbytes = sum(t.numel() * t.element_size()
                 for part in (state["params"], state["opt_state"]["m"],
                              state["opt_state"]["v"]) for t in part.values())
    st = default.store
    need = 2 * nbytes * (st.k + st.r + st.p) // st.k
    free = shutil.disk_usage(workdir).free
    check(free > need, f"checkpoint needs {need} bytes of disk, {free} free")
    print(f"[ckpt] state on {dev}: {sum(t.numel() for t in state['params'].values())}"
          f" parameters (bf16) and two AdamW moments (fp32) over {layers} "
          f"layers, {nbytes} bytes; store {default.store}")
    gf = wrappers["gf"][0]
    for fn in wrappers["gf"]:
        fn.launches = 0

    # save_async: the snapshot is the caller's stall; overwriting a tensor
    # after it returns must not reach the checkpoint.
    cm = CheckpointManager(workdir / "gf", default, device=dev)
    embed = state["params"]["model.embed_tokens.weight"]
    saved_embed = embed.clone()
    fut = cm.save_async(1, state)
    embed.add_(1.0)
    info = fut.result()
    state["params"]["model.embed_tokens.weight"] = saved_embed
    del embed
    save_launches = gf.launches
    enc = info["encode"]
    on_card = dev.type == "cuda"
    check(enc["launches"] > 0 and (not on_card
                                   or save_launches >= enc["launches"]),
          f"checkpoint save: the kernel launched {save_launches} times for "
          f"{enc['launches']} encode launches")

    # Two hosts lost: their block files emptied (only a decode or the
    # repair can bring their bytes back) and the hosts failed.
    step_dir = workdir / "gf" / "step1"
    lost = {p: sha(p) for h in CKPT_HOSTS
            for p in (step_dir / f"node{h}").glob("*.blk")}
    for p in lost:
        p.write_bytes(b"")
    cm.fail_hosts(1, CKPT_HOSTS)
    before = gf.launches
    t0 = time.perf_counter()
    restored, tele = cm.restore(1, state)
    restore_wall = time.perf_counter() - t0
    restore_launches = gf.launches - before
    bad = [path for path, got, want in leaf_pairs(restored, state)
           if not same_bytes(torch, got, want)]
    check(not bad, f"restore after losing hosts {CKPT_HOSTS}: {len(bad)} "
          f"tensors differ, first {bad[:3]}")
    check(tele["degraded_blocks"] > 0
          and tele["restore_decode_launches"] > 0
          and (not on_card
               or restore_launches >= tele["restore_decode_launches"]),
          f"restore: {tele['degraded_blocks']} degraded blocks, "
          f"{tele['restore_decode_launches']} decode launches, kernel "
          f"launches {restore_launches}")
    del restored
    before = gf.launches
    rep = cm.repair(1)
    repair_launches = gf.launches - before
    bad = [p.name for p, h in lost.items() if sha(p) != h]
    check(not bad, f"repair: {len(bad)} rebuilt block files differ")
    check(rep["launches"] > 0
          and (not on_card or repair_launches >= rep["launches"]),
          f"repair: the kernel launched {repair_launches} times for "
          f"{rep['launches']} launches")
    for fn in wrappers["gf"]:
        by_path[fn.__name__]["checkpoint"] = fn.launches
    out = {"backend": "gf", "layers": layers, "bytes": info["bytes"],
           "stripes": info["stripes"],
           "snapshot_seconds": info["snapshot_seconds"],
           "encode_seconds": info["encode_seconds"], "encode": enc,
           "save_kernel_launches": save_launches,
           "restore_wall_seconds": restore_wall,
           "restore": tele, "restore_kernel_launches": restore_launches,
           "lost_block_files": len(lost),
           "repair": {k: rep[k] for k in (
               "stripes_repaired", "patterns", "launches", "windows",
               "blocks_read", "repairs_local", "repairs_global",
               "wall_seconds", "read_seconds", "compute_seconds",
               "write_seconds")},
           "repair_kernel_launches": repair_launches}
    print(f"[ckpt] gf: save_async + restore after losing hosts "
          f"{CKPT_HOSTS} ({len(lost)} block files emptied): every tensor "
          f"byte-equal; repair rebuilt the files byte-equal; "
          + json.dumps(out))
    shutil.rmtree(workdir / "gf", ignore_errors=True)

    # crs and mxu: the state cut to BIT_LAYERS layers, beside gf's save.
    cut = BIT_LAYERS if layers > BIT_LAYERS else layers
    keep = [k for k in state["params"]
            if not k.startswith("model.layers.")
            or int(k.split(".")[2]) < cut]
    small = {"params": {k: state["params"][k] for k in keep},
             "opt_state": {"step": state["opt_state"]["step"],
                           **{m: {k: state["opt_state"][m][k] for k in keep}
                              for m in ("m", "v")}}}
    hashes = {}
    for backend in ("gf", "crs", "mxu"):
        cfg = dataclasses.replace(
            default, store=dataclasses.replace(default.store,
                                               backend=backend))
        for fn in wrappers[backend]:
            fn.launches = 0
        root = workdir / backend
        t0 = time.perf_counter()
        info = CheckpointManager(root, cfg, device=dev).save(1, small)
        wall = time.perf_counter() - t0
        batched = wrappers[backend][0]
        check(info["encode"]["launches"] > 0
              and (not on_card
                   or batched.launches >= info["encode"]["launches"]),
              f"{backend} save: the kernel launched {batched.launches} "
              f"times for {info['encode']['launches']} encode launches")
        if backend != "gf":
            for fn in wrappers[backend]:
                by_path[fn.__name__]["checkpoint"] = fn.launches
        hashes[backend] = {p.relative_to(root).as_posix(): sha(p)
                           for p in sorted(root.rglob("*.blk"))}
        check(hashes[backend] == hashes["gf"],
              f"{backend}: checkpoint block files differ from gf's")
        print(f"[ckpt] {backend}: save of {cut} layers ({info['bytes']} "
              f"bytes, {info['stripes']} stripes, {len(hashes[backend])} "
              f"block files) in {wall} s, encode wall "
              f"{info['encode']['wall_seconds']} s, kernel launches "
              f"{batched.launches}"
              + ("" if backend == "gf" else
                 "; every block file hashes as gf's"))
        shutil.rmtree(root, ignore_errors=True)
    return out


# ------------------------------------------------ phase 6: reliability
# (seed, trial, stream, seq, bits) of the reference simulator's BitSource
# (tests/test_torch_sim.py holds every row to the JAX package): each field
# at 0 and at 0xFFFFFFFF, small ids, and random rows.
SIM_BITS = (
    (0x0, 0x0, 0x0, 0x0, 0x125deed8),
    (0x0, 0x0, 0x0, 0xffffffff, 0x928dcf22),
    (0x0, 0x0, 0xffffffff, 0x0, 0xf96f317a),
    (0x0, 0x0, 0xffffffff, 0xffffffff, 0xb54d8e37),
    (0x0, 0xffffffff, 0x0, 0x0, 0xb907b85e),
    (0x0, 0xffffffff, 0x0, 0xffffffff, 0x2e1525c1),
    (0x0, 0xffffffff, 0xffffffff, 0x0, 0x1afbde97),
    (0x0, 0xffffffff, 0xffffffff, 0xffffffff, 0x8b996003),
    (0xffffffff, 0x0, 0x0, 0x0, 0xec0c1903),
    (0xffffffff, 0x0, 0x0, 0xffffffff, 0xb242ce41),
    (0xffffffff, 0x0, 0xffffffff, 0x0, 0x342dc7f5),
    (0xffffffff, 0x0, 0xffffffff, 0xffffffff, 0xd9b3cba5),
    (0xffffffff, 0xffffffff, 0x0, 0x0, 0xfc19a3ac),
    (0xffffffff, 0xffffffff, 0x0, 0xffffffff, 0xf97ae7d4),
    (0xffffffff, 0xffffffff, 0xffffffff, 0x0, 0xdd61faea),
    (0xffffffff, 0xffffffff, 0xffffffff, 0xffffffff, 0xc464dc87),
    (0x0, 0x0, 0x0, 0x1, 0x15258749),
    (0x0, 0x1, 0x0, 0x0, 0xa00aa8f6),
    (0x0, 0x0, 0x1, 0x0, 0x042e5e8e),
    (0x1, 0x0, 0x0, 0x0, 0x3af20b35),
    (0x3, 0x5, 0x39, 0x2, 0xcd16619a),
    (0x2a, 0x7cf, 0x54, 0x11, 0xa1c5c6ad),
    (0x96cb5536, 0x6b9df1db, 0x5b5002e3, 0xed05c5fc, 0xd779f752),
    (0x61089ccf, 0x461c57f1, 0xe06f9b5b, 0xf5f5866, 0xf2aca180),
    (0x7109c66a, 0x4f7fc6ad, 0x7a75db7, 0xb7dafd33, 0xd9b54f00),
    (0xfef746e0, 0xc7ed5c40, 0x5289a5a7, 0x89e83b82, 0x68f4b823),
    (0xd8f4c05a, 0x4fc94e08, 0x6cc2d061, 0xea95e557, 0x69b28f5a),
    (0x3205bba6, 0xed965b52, 0xad0c7a3d, 0x6fbfd6b2, 0x4ceb6d57),
    (0xc99e0653, 0x68e19d48, 0x5be73b16, 0x9cfda39d, 0x17c540c6),
    (0xec272ef4, 0xb6af5889, 0xab279821, 0x9ec00b0e, 0x707fde38),
    (0xd6dae3e9, 0x6ed69a29, 0xbdfdefab, 0x71203ba9, 0xf120b64c),
    (0x9ab9a0b0, 0xa55fef8d, 0x5e28c429, 0xeaf91f0b, 0x40fad512),
)
SIM_RANDOM_TRIPLES = 1 << 20           # 6a: random triples against numpy
# 6a: (T, D, N, R) of the select's random schedules: the P5 runs' widths
# at their trial counts, a narrow one, and a single trial.
SIM_SELECT_SHAPES = ((2000, 28, 28, 7), (500, 28, 28, 7), (37, 7, 7, 2),
                     (1, 28, 28, 7))
# 6c and 6d: trials of the P5 runs, and of the card-against-host check.
SIM_TRIALS, SIM_CHECK_TRIALS, SIM_HORIZON = 2000, 500, 8000.0
# 6d: the command line's run. With its default failure processes no trial
# of 50 loses data, so the MTTDL (and sim_over_closed_form) would be
# undefined; P5's rack bursts over its 7 failure domains give losses.
SIM_CLI = ("--scheme", "cp-azure", "--k", "24", "--r", "2", "--p", "2",
           "--closed-form", "--oracle", "--trials", "50",
           "--rack-burst-hours", "80000", "--nodes", "28", "--domains", "7")

# 6b: what the reference's simulate gives on golden_config (held by
# tests/test_torch_sim.py against the JAX package).
SIM_GOLDEN = {
    "losses": 6, "observed_hours": "0x1.84e8346000000p+10", "events": 91,
    "epochs": 32, "rejected": 0,
    "counts": {"disk_fail": 20, "disk_fail_rejected": 0, "node_fail": 13,
               "rack_fail": 2, "sector_error": 23, "scrub": 2,
               "repair_done": 29, "data_loss": 6, "noop": 2},
    "log_sha256": "8bb7afd4faf44572dae4fbc79a892e4c3f83afb8164a1d2ecb72a0f8"
                  "39fb703b"}


def golden_config(reliability, sim, schemes, topology):
    """The reference's all-processes configuration (its engine-oracle
    bit-identity test): azure(4,2,1) spread over 8 nodes in 2 racks,
    Weibull lifetimes, node and rack bursts, latent errors, scrubbing,
    strict model, planner costs; 6 trials, seed 3, events recorded. The
    modules are passed in, so the same function builds it from the port
    or from the reference. Returns ``(scheme, params, simulate kwargs)``."""
    sch = schemes.make_scheme("azure", 4, 2, 1)
    rel = reliability.ReliabilityParams(
        node_mttf_years=0.02, bandwidth_gbps=0.002, detect_hours_single=2.0,
        detect_hours_multi=10.0)
    params = sim.SimParams(
        disk_mttf_hours=400.0, weibull_shape=1.4, node_burst_hours=900.0,
        rack_burst_hours=4000.0, lse_hours=700.0, scrub_hours=300.0,
        model="strict", cost_model="planner", reliability=rel)
    hier = sim.UnitHierarchy.from_topology(
        sch.n, topology.Topology(num_nodes=8, num_domains=2), "spread")
    return sch, params, dict(trials=6, horizon_hours=5000.0, seed=3,
                             hierarchy=hier, record_events=True)


def p5_config(reliability, sim, schemes, topology, scheme: str, rel=None):
    """The paper's P5 geometry, (24, 2, 2), one disk per node over 28
    nodes in 7 racks, contiguous placement, under every failure process:
    exponential disk lives of 2000 h, node and rack bursts, latent errors
    scrubbed every two weeks, planner repair costs at 0.002 Gbps (or
    ``rel``). Returns ``(scheme, params, hierarchy)``."""
    sch = schemes.make_scheme(scheme, 24, 2, 2)
    params = sim.SimParams(
        disk_mttf_hours=2000.0, weibull_shape=1.0, node_burst_hours=20000.0,
        rack_burst_hours=80000.0, lse_hours=20000.0, scrub_hours=336.0,
        cost_model="planner",
        reliability=rel or reliability.ReliabilityParams(bandwidth_gbps=0.002))
    hier = sim.UnitHierarchy.from_topology(
        sch.n, topology.Topology(num_nodes=28, num_domains=7), "contiguous")
    return sch, params, hier


def sim_digest(res, to_doc) -> dict:
    """A ``SimResult``'s outcome without its timings: counts, the exposure
    as ``float.hex`` and a SHA-256 of its ``to_doc`` event logs (a numpy
    scalar in a field, as the reference's engine leaves ``local``, written
    as the Python value it holds)."""
    logs = json.dumps([[to_doc(e) for e in trial] for trial in res.event_log],
                      sort_keys=True, default=lambda x: x.item())
    return {"losses": res.losses, "observed_hours": res.observed_hours.hex(),
            "events": res.events, "epochs": res.epochs,
            "rejected": res.rejected, "counts": res.counts,
            "log_sha256": hashlib.sha256(logs.encode()).hexdigest()}


SIM_FIELDS = ("scheme", "trials", "horizon_hours", "seed", "losses",
              "observed_hours", "loss_times", "events", "epochs", "rejected",
              "counts")


def same_run(a, b, to_doc, oracle: bool = False) -> bool:
    """Two ``SimResult``s agree field for field (timings aside), their
    event logs through ``to_doc``. Against the oracle (``oracle=True``),
    which runs one trial after another, the epochs are not compared and
    the loss times are compared as sets of times."""
    fields = [f for f in SIM_FIELDS
              if not oracle or f not in ("epochs", "loss_times")]
    return (all(getattr(a, f) == getattr(b, f) for f in fields)
            and (not oracle or sorted(a.loss_times) == sorted(b.loss_times))
            and [[to_doc(e) for e in t] for t in a.event_log]
            == [[to_doc(e) for e in t] for t in b.event_log])


def random_schedule(np, rng, t: int, d: int, n: int, r: int):
    """A select input of ``t`` trials: float32 times from a few values
    (ties in every row), a quarter of the entries ``inf``, and every
    fifth row ``inf`` throughout."""
    def part(*shape):
        x = rng.integers(0, 6, shape).astype(np.float32)
        x[rng.random(shape) < 0.25] = np.inf
        x[::5] = np.inf
        return x

    return (part(t, d), part(t, n), part(t, r), part(t, d), part(t),
            part(t))


def sim_line(label: str, res) -> str:
    """The ``[sim]`` line of a run: its outcome, and its wall split between
    the device calls (each select and draw batch with its copies and
    waits; per epoch beside the total) and the host loop."""
    host = res.wall_seconds - res.select_seconds - res.bits_seconds
    per = 1e3 / max(1, res.epochs)
    return (f"[sim] {label}: trials={res.trials} losses={res.losses} "
            f"mttdl_years={res.mttdl_years} events={res.events} "
            f"epochs={res.epochs} event_parallelism="
            f"{res.event_parallelism} events_per_s="
            f"{res.events / res.wall_seconds} wall={res.wall_seconds} s: "
            f"select {res.select_seconds} s ({res.select_seconds * per} ms "
            f"an epoch) and bits {res.bits_seconds} s ({res.bits_seconds * per}"
            f" ms an epoch) on the device (copies and waits included), host "
            f"loop {host} s")


@contextlib.contextmanager
def losing_disks(store_cls):
    """While open, ``store_cls.fail_node`` also empties the failed node's
    block files, as a lost disk would. Yields ``{path: sha256}`` of each
    emptied file as it was sealed."""
    lost, fail_node = {}, store_cls.fail_node

    def fail_and_empty(store, node):
        fail_node(store, node)
        for path in sorted((store.root / f"node{node}").glob("*.blk")):
            lost[path] = sha(path)
            path.write_bytes(b"")

    store_cls.fail_node = fail_and_empty
    try:
        yield lost
    finally:
        store_cls.fail_node = fail_node


def reliability_phase(np, torch, dev, workdir: Path, by_path: dict,
                      calib_tele: dict, trials: int = SIM_TRIALS,
                      check_trials: int = SIM_CHECK_TRIALS,
                      triples: int = SIM_RANDOM_TRIPLES,
                      cli: tuple = SIM_CLI) -> dict:
    """Phase 6: the fleet reliability path on ``dev``. 6a: the card's bits
    against the reference's table and the numpy chain, its select against
    numpy; 6b: the golden run against the reference's constants and the
    port's oracle; 6c: both schemes at P5, the card against the host at
    ``check_trials``; 6d: P5 calibrated by phase 3's repair telemetry
    ``calib_tele``, a calibration store (its GF(2^8) launches counted into
    ``by_path[name]["sim"]``) and the command line in a subprocess.
    Returns the readings."""
    from repro_torch import sim
    from repro_torch.core import reliability, schemes
    from repro_torch.dist import topology
    from repro_torch.ftx import StoreConfig, StripeStore
    from repro_torch.ftx.events import to_doc
    from repro_torch.kernels import gf256_matmul as gm
    from repro_torch.sim.engine import select, select_np
    from repro_torch.sim.rng import BitSource, threefry_bits_np

    t_phase = time.perf_counter()
    host = torch.device("cpu")
    out = {}

    # 6a. bits: the reference's table, then random triples against numpy.
    for (seed, trial, stream, seq, want) in SIM_BITS:
        got = int(BitSource(seed, dev).bit1(trial, stream, seq))
        check(got == want, f"bits of {(seed, trial, stream, seq)} on {dev}: "
              f"{got:#010x}, the reference's {want:#010x}")
    rng = np.random.default_rng(SEED)
    trip = rng.integers(0, 1 << 32, (triples, 3), dtype=np.uint64
                        ).astype(np.uint32)
    src = BitSource(SEED, dev)
    src.bits(trip[:1024])                          # warm
    t0 = time.perf_counter()
    got = src.bits(trip)
    bits_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = threefry_bits_np(src.key, trip)
    plain_s = time.perf_counter() - t0
    check(np.array_equal(got, want), f"bits of {triples} random triples on "
          f"{dev} differ from the numpy chain in "
          f"{int((got != want).sum())} rows")
    out["bits"] = {"triples": triples, "seconds": bits_s,
                   "numpy_seconds": plain_s}
    print(f"[sim] bits: {len(SIM_BITS)} reference rows and {triples} random "
          f"triples on {dev} equal to the reference and to the numpy chain; "
          f"one call of {triples} in {bits_s} s (copies included), numpy "
          f"{plain_s} s")
    # select: ties in every row and inf rows, against numpy.
    select(random_schedule(np, rng, *SIM_SELECT_SHAPES[0]), dev)   # warm
    for (t, d, n, r) in SIM_SELECT_SHAPES:
        sched = random_schedule(np, rng, t, d, n, r)
        want = select_np(sched)
        t0 = time.perf_counter()
        got = select(sched, dev)
        sel_s = time.perf_counter() - t0
        check(all(np.array_equal(g, w) for g, w in zip(got, want))
              and got[0].dtype == np.float32,
              f"select on {dev} differs from numpy at T={t} D={d}")
        out[f"select_{t}x{d}"] = sel_s
    print(f"[sim] select: {len(SIM_SELECT_SHAPES)} random schedules with "
          f"ties and inf rows on {dev} equal to numpy; one call at "
          f"T=2000, D=28 in {out['select_2000x28']} s (copies included)")

    # 6b. golden run: the reference's constants, and the oracle on the host.
    sch, params, kw = golden_config(reliability, sim, schemes, topology)
    res = sim.simulate(sch, params, device=dev, **kw)
    got = sim_digest(res, to_doc)
    check(got == SIM_GOLDEN, f"golden run on {dev} differs from the "
          f"reference: {got}")
    orc = sim.simulate_oracle(sch, params, device=host, **kw)
    check(same_run(res, orc, to_doc, oracle=True),
          f"the oracle with host bits differs from the engine on {dev}")
    print(f"[sim] golden run on {dev}: {json.dumps(got)}; equal to the "
          f"reference's and to the oracle's with host bits")

    # 6c. P5, both schemes; the card against the host at check_trials.
    for scheme in ("cp-azure", "azure"):
        sch, params, hier = p5_config(reliability, sim, schemes, topology,
                                      scheme)
        kw = dict(horizon_hours=SIM_HORIZON, seed=0, hierarchy=hier)
        res = sim.simulate(sch, params, trials=trials, device=dev, **kw)
        check(res.losses > 0 and np.isfinite(res.mttdl_years)
              and res.mttdl_years > 0,
              f"{scheme} P5: {res.losses} losses, MTTDL {res.mttdl_years}")
        print(sim_line(f"{scheme}(24,2,2) P5 on {dev}", res))
        a, b = (sim.simulate(sch, params, trials=check_trials,
                             record_events=True, device=d, **kw)
                for d in (dev, host))
        check(same_run(a, b, to_doc), f"{scheme} P5 at {check_trials} "
              f"trials: the engine on {dev} differs from it on the host")
        print(f"[sim] {scheme} P5 at {check_trials} trials: the engine on "
              f"{dev} equals it on the host field for field "
              f"({a.losses} losses, {a.events} events, every event log)")
        out[scheme] = {f: getattr(res, f) for f in (
            "trials", "losses", "events", "epochs", "mttdl_years",
            "event_parallelism", "wall_seconds", "select_seconds",
            "bits_seconds")}

    # 6d. calibration: phase 3's repair telemetry into the failure model.
    rel = sim.calibrated(reliability.ReliabilityParams(), calib_tele)
    sch, params, hier = p5_config(reliability, sim, schemes, topology,
                                  "cp-azure", rel)
    res = sim.simulate(sch, params, trials=trials, horizon_hours=SIM_HORIZON,
                       seed=0, hierarchy=hier, device=dev)
    check(res.observed_hours > 0, "calibrated run observed nothing")
    print(f"[sim] calibrated by phase 3's two-node repair: "
          f"{rel.bandwidth_gbps} Gbps")
    print(sim_line(f"cp-azure(24,2,2) P5 calibrated on {dev}", res))
    out["calibrated"] = {"gbps": rel.bandwidth_gbps, "losses": res.losses,
                         "mttdl_years": res.mttdl_years}
    # A calibration store, as the command line builds one, with the
    # GF(2^8) wrappers counted from 0; its failed node loses its disk, so
    # only the repair can bring those blocks back. A twin on the host
    # (plain versions) must seal and rebuild the same block files.
    calib_cfg = StoreConfig(scheme="cp-azure", k=24, r=2, p=2,
                            block_size=2048)
    check(dev.type != "cuda" or calib_cfg.backend == "gf",
          f"calibration store backend {calib_cfg.backend!r} on the card")
    wrappers = (gm.gf256_matmul_batched, gm.gf256_matmul)
    for fn in wrappers:
        fn.launches = 0
    with losing_disks(StripeStore) as lost:
        tele = sim.measure_repair_bandwidth(workdir / "calib", calib_cfg,
                                            device=dev)
    for fn in wrappers:
        by_path[fn.__name__]["sim"] = fn.launches
        check(dev.type != "cuda" or fn.launches > 0,
              f"{fn.__name__} was never launched on the calibration path")
    check(lost and all(sha(p) == h for p, h in lost.items()),
          f"calibration store on {dev}: rebuilt blocks differ from the "
          f"sealed ones: {[p.name for p, h in lost.items() if sha(p) != h]}")
    with losing_disks(StripeStore):
        twin = sim.measure_repair_bandwidth(workdir / "calib_host",
                                            calib_cfg, device=host)
    files = {root: {p.relative_to(root).as_posix(): sha(p)
                    for p in sorted(root.rglob("*.blk"))}
             for root in (workdir / "calib", workdir / "calib_host")}
    check(files[workdir / "calib"] == files[workdir / "calib_host"]
          and all(tele[f] == twin[f] for f in (
              "stripes_repaired", "blocks_read", "bytes_read", "launches")),
          f"calibration store on {dev} differs from its twin on the host")
    print(f"[sim] calibration store on {dev}: {tele['gbps']} Gbps from "
          f"{tele['bytes_read']} bytes read; {len(lost)} emptied block "
          f"files rebuilt byte-equal, all {len(files[workdir / 'calib'])} "
          f"block files equal to the host twin's; kernel launches "
          + json.dumps({fn.__name__: fn.launches for fn in wrappers}))
    # The command line, in a subprocess on the same device.
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.simulate", "--device",
         dev.type, "--calibrate", str(workdir / "cli"), *cli],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    cli_s = time.perf_counter() - t0
    check(run.returncode == 0, f"repro_torch.launch.simulate exited "
          f"{run.returncode}: {run.stderr[-2000:]}")
    doc = json.loads(run.stdout)
    check(doc["oracle"]["bit_identical"] and "sim_over_closed_form" in doc,
          f"repro_torch.launch.simulate: {run.stdout[-2000:]}")
    check(f"{tele['gbps']:.4f} Gbps" in run.stderr,
          f"the command line measured another bandwidth: {run.stderr}")
    print(f"[sim] repro_torch.launch.simulate --device {dev.type} "
          f"--calibrate ... {' '.join(cli)} in {cli_s} s: exit 0, "
          f"bit_identical true, losses {doc['losses']}, mttdl_years "
          f"{doc['mttdl_years']}, closed_form_years "
          f"{doc['closed_form_years']}, sim_over_closed_form "
          f"{doc['sim_over_closed_form']}")
    out["phase_seconds"] = time.perf_counter() - t_phase
    print(f"[sim] phase 6 in {out['phase_seconds']} s")
    return out


# ------------------------------------- phase 7: sharding and orchestration
SHARDED_MESH = (8, 1)                   # 7a: eight positions of the card
SHARDED_WINDOW = 16                     # 7a: stripes of the crs/mxu window
TRACE = ROOT / "tests" / "data" / "correlated_trace.json"
REPLAY_CLI = ("--replay", "tests/data/correlated_trace.json", "--nodes",
              "24", "--domains", "12", "--schedule", "global",
              "--destinations", "topology", "--rebalance")


def sharded_phase(np, torch, store, workdir: Path, hashes: dict, dev,
                  wrappers: dict, by_path: dict) -> dict:
    """Phase 7a on phase 3's gf store, every node up: the two-node repair
    under an 8x1 mesh of the card's positions (the failed nodes' block
    files emptied first; they must hash as sealed after it), then the
    two-node plan of stripe 0 on a 16-stripe window of the store's blocks
    through crs and mxu engines split 8 ways, each byte-equal to its
    unsharded call on the card (made before the counts are set to 0: a
    comparison). The wrappers' counts of this run go to
    ``by_path[name]["sharded"]``. Then the gf window's time through the
    engine unsharded and split, and one shard's launch beside its
    bound. On the CPU (a rehearsal) no wrapper counts."""
    from repro_torch.core.engine import BatchedCodecEngine
    from repro_torch.dist import make_mesh, with_rules
    from repro_torch.ftx import repair_failed_nodes
    from repro_torch.kernels import gf256_matmul as gm

    t_phase = time.perf_counter()
    on_card = dev.type == "cuda"
    nodes = (3, 4)
    mesh = make_mesh(SHARDED_MESH, ("data", "model"),
                     devices=(dev,) * math.prod(SHARDED_MESH))
    failed = [b for b, n in enumerate(store.stripes[0].node_of_block)
              if n in nodes]
    plan = store.codec.planner.multi_plan(failed)
    window = np.stack([np.stack([np.fromfile(store._block_path(sid, b),
                                             np.uint8) for b in plan.reads])
                       for sid in range(SHARDED_WINDOW)])
    bit = {backend: BatchedCodecEngine(store.scheme, backend=backend,
                                       device=dev)
           for backend in ("crs", "mxu")}
    want = {backend: eng.execute(plan, window) for backend, eng in
            bit.items()}
    for fns in wrappers.values():
        for fn in fns:
            fn.launches = 0
    rebuilt = [workdir / p for p in hashes
               if int(Path(p).parent.name[4:]) in nodes]
    for p in rebuilt:
        p.write_bytes(b"")
    with with_rules(mesh) as mr:
        rep = repair_failed_nodes(store, list(nodes), device=dev)
        got = {backend: eng.execute(plan, window, mr)
               for backend, eng in bit.items()}
        spans = {backend: eng.last_span for backend, eng in bit.items()}
    for fns in wrappers.values():
        for fn in fns:
            by_path[fn.__name__]["sharded"] = fn.launches
    counts = {fn.__name__: fn.launches for fns in wrappers.values()
              for fn in fns}
    check((rep.patterns, rep.blocks_read, rep.repairs_local,
           rep.repairs_global) == EXPECTED[nodes]
          and (rep.launches, rep.devices, rep.device_launches)
          == SHARDED_EXPECTED
          and rep.effective_backend == ("gf" if on_card else "ref"),
          f"sharded repair {nodes}: counts differ from the reference: {rep}")
    bad = [p.name for p in rebuilt
           if sha(p) != hashes[str(p.relative_to(workdir))]]
    check(not bad, f"sharded repair {nodes}: rebuilt blocks differ: "
          f"{bad[:5]}")
    check(not on_card or counts["gf256_matmul_batched"]
          == rep.device_launches,
          f"sharded repair: gf256_matmul_batched launched "
          f"{counts['gf256_matmul_batched']} times for "
          f"{rep.device_launches} device launches")
    span = math.prod(SHARDED_MESH)
    for backend, name in (("crs", "bitmatrix_encode_batched"),
                          ("mxu", "mod2_matmul_encode_batched")):
        check(spans[backend] == span and counts[name] == span * on_card
              and torch.equal(got[backend], want[backend]),
              f"sharded {backend} execute: span {spans[backend]}, "
              f"{counts[name]} launches of {name}, or bytes differ from "
              f"the unsharded call")
        # Held to the blocks' sealed bytes too: the unsharded call is the
        # same kernel, and phase 2b holds it to its plain version at this
        # shard's launch shape (BIT_PATH_SHAPES' "sharded" row).
        sealed = {Path(p).name: h for p, h in hashes.items()}
        wrong = [(sid, t) for sid in range(SHARDED_WINDOW)
                 for i, t in enumerate(plan.targets)
                 if hashlib.sha256(got[backend][sid, i].cpu().numpy()
                                   .tobytes()).hexdigest()
                 != sealed[store._block_path(sid, t).name]]
        check(not wrong, f"sharded {backend} execute: (stripe, block) "
              f"{wrong[:5]} differ from their sealed bytes")
    for name in ("gf256_matmul_batched", "bitmatrix_encode_batched",
                 "mod2_matmul_encode_batched"):
        check(not on_card or counts[name] > 0, f"{name} was never launched "
              f"on the sharded path")
    # The gf window through the engine on the card, one launch and split
    # eight ways, and one shard's launch (S = 16 / 8) beside its bound.
    stack = torch.from_numpy(window).to(dev)
    gf = BatchedCodecEngine(store.scheme, backend="gf", device=dev)
    whole_ms = cuda_ms(torch, lambda: gf.execute(plan, stack), 10)
    with with_rules(mesh) as mr:
        split_ms = cuda_ms(torch, lambda: gf.execute(plan, stack, mr), 10)
    coef = torch.from_numpy(plan.coeffs).to(dev)
    shard = stack[:SHARDED_WINDOW // span].contiguous()
    shard_ms = cuda_ms(torch, lambda: gm.gf256_matmul_batched(coef, shard),
                       10)
    shard_dev = device_ms(torch, gm.gf256_matmul_batched, (coef, shard))
    m, k = plan.coeffs.shape
    bound, by = bound_ms(shard.shape[0], m, k, shard.shape[2])
    out = {"repair": {f: getattr(rep, f) for f in (
               "stripes_repaired", "patterns", "launches", "devices",
               "device_launches", "blocks_read", "repairs_local",
               "repairs_global", "wall_seconds", "read_seconds",
               "compute_seconds", "write_seconds")},
           "launches": counts, "window_ms": whole_ms,
           "window_split_ms": split_ms, "shard_ms": shard_ms,
           "shard_device_ms": shard_dev, "shard_bound_ms": bound,
           "shard_bound_by": by,
           "phase_seconds": time.perf_counter() - t_phase}
    print(f"[sharded] repair_failed_nodes{list(nodes)} under a "
          f"{SHARDED_MESH[0]}x{SHARDED_MESH[1]} mesh of {dev}: "
          + json.dumps(out["repair"]) + f"; {len(rebuilt)} emptied block "
          f"files rebuilt byte-equal; crs and mxu two-node window "
          f"(S={SHARDED_WINDOW}, m={m}, k={k}) split {span} ways "
          f"byte-equal to the unsharded call; kernel launches "
          + json.dumps(counts))
    print(f"[sharded] gf window S={SHARDED_WINDOW} m={m} k={k} "
          f"B={shard.shape[2]} through the engine on {dev}: one launch "
          f"{whole_ms:.4f} ms, split {span} ways {split_ms:.4f} ms; one "
          f"shard's launch (S={shard.shape[0]}) {shard_ms:.4f} ms (device "
          f"{shard_dev:.4f} ms), bound {bound:.4f} ms ({by})")
    print(f"[sharded] phase 7a in {out['phase_seconds']} s")
    return out


def replay_phase(np, torch, dev, workdir: Path, wrappers: dict,
                 by_path: dict, block_size: int = 1 << 20) -> dict:
    """Phase 7b: a P5 store at 1 MiB blocks on gf (64 stripes, 48 nodes in
    24 two-node domains, spread width 16, topology seed 7) replays the
    committed failure trace with the global schedule, topology-chosen
    destinations, the failed nodes left down and a rebalance pass; then
    ``FailureInjector(store, seed=0)`` fails and repairs three nodes. Every
    node the store fails loses its block files. Every count must be the
    reference's, every block file must hash as sealed and the payload must
    come back; the wrappers' counts go to ``by_path[name]["replay"]``.
    Last, the replay command line runs twice on the card and once on the
    host, and must print the same bytes each time. On the CPU (the tests'
    rehearsal, at a small ``block_size``) every run is on the host and no
    wrapper counts."""
    from repro_torch.dist.topology import Topology
    from repro_torch.ftx import (FailureInjector, RepairOptions, StoreConfig,
                                 StripeStore, replay_trace)
    from repro_torch.ftx.events import load_trace

    t_phase = time.perf_counter()
    for fns in wrappers.values():
        for fn in fns:
            fn.launches = 0
    cfg = StoreConfig(scheme="cp-azure", k=24, r=2, p=2,
                      block_size=block_size, placement_policy="spread")
    check(dev.type != "cuda" or cfg.backend == "gf",
          f"replay store backend {cfg.backend!r} on the card")
    store = StripeStore(workdir / "replay", cfg, num_nodes=48,
                        topology=Topology(num_nodes=48, num_domains=24,
                                          spread_width=16, seed=7),
                        device=dev)
    blob = payload(np, STRIPES, STRIPES * cfg.k * cfg.block_size)
    t0 = time.perf_counter()
    store.put("blob", blob)
    store.seal()
    seal_s = time.perf_counter() - t0
    check(len(store.stripes) == STRIPES, f"{len(store.stripes)} stripes")
    sealed = {(sid, b): sha(store._block_path(sid, b))
              for sid in store.stripes for b in range(store.n)}

    def intact(label):
        up = {n for n, st in store.nodes.items() if st.name == "UP"}
        bad = [key for key, h in sealed.items()
               if sha(store._block_path(*key)) != h]
        check(not bad, f"{label}: block files differ from the sealed "
              f"ones: {bad[:5]}")
        check(all(n in up for st in store.stripes.values()
                  for n in st.node_of_block),
              f"{label}: a block is still addressed to a down node")
        check((store.get("blob") == blob).all(),
              f"{label}: get('blob') differs from the payload")

    want = REPLAY_EXPECTED
    with losing_disks(StripeStore) as lost:
        t0 = time.perf_counter()
        res = replay_trace(store, load_trace(TRACE), options=RepairOptions(
            schedule="global", destinations="topology"), revive=False,
            rebalance_after=True)
        replay_s = time.perf_counter() - t0
    rows, rebal = res["batches"], dict(res["rebalance"])
    check([r["nodes"] for r in rows] == want["nodes"]
          and [r["blocks_read"] for r in rows] == want["blocks_read"]
          and {k: res["totals"][k] for k in want["totals"]}
          == want["totals"]
          and rebal.pop("bytes_moved") == rebal["moved"] * cfg.block_size
          and rebal == want["rebalance"],
          f"replay counts differ from the reference: {res['totals']}, "
          f"{res['rebalance']}")
    check(len(lost) > 0, "the replay emptied no block file")
    intact("replay")
    inj_want = INJECTOR_EXPECTED
    with losing_disks(StripeStore) as lost_inj:
        t0 = time.perf_counter()
        inj = FailureInjector(store, seed=0)
        inj.run(hours=inj_want["hours"])
        inj_s = time.perf_counter() - t0
    got = [(e.unit, e.blocks_read, e.local) for e in inj.repairs()]
    check([e.node for e in inj.failures()] == inj_want["nodes"]
          and got == list(zip(inj_want["nodes"], inj_want["blocks_read"],
                              inj_want["local"])),
          f"injector repairs differ from the reference: {got}")
    intact("injector")
    for fns in wrappers.values():
        for fn in fns:
            by_path[fn.__name__]["replay"] = fn.launches
    counts = {fn.__name__: fn.launches for fn in wrappers["gf"]}
    for name, n in counts.items():
        check(dev.type != "cuda" or n > 0,
              f"{name} was never launched on the replay path")
    # The command line: twice on the card and once on the host.
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    outs, cli_s = [], []
    for i, device in enumerate((dev.type, dev.type, "cpu")):
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.simulate", *REPLAY_CLI,
             "--device", device, "--replay-store", str(workdir / f"cli{i}")],
            capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
        cli_s.append(time.perf_counter() - t0)
        check(run.returncode == 0, f"repro_torch.launch.simulate --replay "
              f"exited {run.returncode}: {run.stderr[-2000:]}")
        outs.append(run.stdout)
    check(outs[0] == outs[1] == outs[2], "the replay command line printed "
          "different JSON on a second run or on the host")
    doc = json.loads(outs[0])
    out = {"seal_seconds": seal_s, "replay_seconds": replay_s,
           "injector_seconds": inj_s, "cli_seconds": cli_s,
           "totals": res["totals"], "rebalance": res["rebalance"],
           "emptied_files": len(lost) + len(lost_inj), "launches": counts,
           "phase_seconds": time.perf_counter() - t_phase}
    print(f"[replay] P5 store on {dev}: sealed {STRIPES} stripes in "
          f"{seal_s} s; replay_trace of {TRACE.name} in {replay_s} s: "
          + json.dumps({"batches": [[r["nodes"], r["blocks_read"],
                                     r["sim_seconds"]] for r in rows],
                        "totals": res["totals"],
                        "rebalance": res["rebalance"]})
          + f"; FailureInjector(seed=0).run({inj_want['hours']}) in "
          f"{inj_s} s: {got}; {out['emptied_files']} emptied block files "
          f"rebuilt or moved byte-equal, get('blob') equal to the payload; "
          f"kernel launches " + json.dumps(counts))
    print(f"[replay] repro_torch.launch.simulate {' '.join(REPLAY_CLI)}: "
          f"exit 0 twice on {dev.type} ({cli_s[0]} s, {cli_s[1]} s) and "
          f"once on the host ({cli_s[2]} s), the same JSON each time: "
          f"{len(doc['batches'])} batches, totals "
          + json.dumps(doc["totals"]))
    print(f"[replay] phase 7b in {out['phase_seconds']} s")
    return out


# -------------------------------------------- phase 8: serving a model
# qwen2.5-3b, the reference serving command's default arch, at its
# published widths (36 layers, d_model 2048, 16 query and 2 key/value heads
# of 128, SwiGLU d_ff 11008, vocabulary 151936, biases on q/k/v) in bf16,
# from seed 0; the reference's param_count of it (tests/test_torch_models.py
# holds the port's count to the reference's).
MODEL_ARCH = "qwen2.5-3b"
MODEL_PARAMS = 3_085_938_688
# The reference command's load: its request count, tokens per request and
# slots; prompts of 4 to 31 tokens drawn as it draws them.
MODEL_REQUESTS, MODEL_MAX_NEW, MODEL_MAX_BATCH, MODEL_MAX_LEN = 8, 8, 4, 128
# 8b: the twin engines' load on every decoder-only SMOKE config (3 slots,
# 5 requests, so slots are reused); 9 tokens is shorter than gemma3
# SMOKE's window of 32.
HOST_PROMPTS = (36, 9, 47, 33, 40)
HOST_MAX_BATCH, HOST_MAX_LEN, HOST_MAX_NEW = 3, 96, 6


def gf_wrappers() -> tuple:
    """The GF(2^8) kernels' wrappers (K1, K2), which count their launches."""
    from repro_torch.kernels import gf256_matmul as gm

    return gm.gf256_matmul_batched, gm.gf256_matmul


def _rel(torch, want, got) -> float:
    want, got = want.float(), got.float().to(want.device)
    return float((want - got).abs().max() / (want.abs().max() + 1e-9))


def serve_prompts(np, vocab: int) -> list:
    """The serving command's prompts: ``MODEL_REQUESTS`` draws of 4 to 31
    tokens from ``default_rng(0)``, as ``serve_model`` makes them."""
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, int(rng.integers(4, 32)))
            for _ in range(MODEL_REQUESTS)]


def run_engine(np, torch, api, params, dev, prompts, max_batch: int,
               max_len: int, max_new: int) -> dict:
    """Serve ``prompts`` through a fresh ``ServeEngine`` on ``dev``: every
    request's tokens, the wall, the latency snapshot and each prefill's
    and decode step's milliseconds."""
    from repro_torch.serve.engine import ServeEngine

    engine = ServeEngine(api, max_batch=max_batch, max_len=max_len,
                         device=dev)
    engine.load(params)
    reqs = [engine.submit(p, max_new=max_new) for p in prompts]
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.run()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(all(r.done for r in reqs), "the engine left requests unfinished")
    call_ms = engine.call_ms()
    return {"tokens": [list(r.out_tokens) for r in reqs], "wall": wall,
            "latency": engine.latency_stats(),
            "prefill_ms": call_ms["prefill"], "decode_ms": call_ms["decode"]}


def profile_step(torch, fn, warmup: bool = True) -> dict:
    """One call of ``fn`` (after a warm-up call, unless ``warmup`` is
    false) under torch.profiler: its wall, the device time of every
    operator it ran on the card, the number of device kernels, the device's
    busy share of the wall and the top five device operators by time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if warmup:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name, kernels = {}, 0
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            kernels += 1
            by_name[evt.name] = (by_name.get(evt.name, 0.0)
                                 + evt.time_range.elapsed_us() / 1e3)
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return {"wall_ms": wall * 1e3, "device_ms": busy,
            "device_kernels": kernels,
            "device_busy_share": busy / (wall * 1e3) if busy else None,
            "top_device_ms": [[name[:100], ms] for name, ms in top]}


def serve_model_phase(np, torch, dev, smi: str, smoke: bool = False) -> dict:
    """Phase 8a: ``MODEL_ARCH`` (its SMOKE config with ``smoke``) drawn on
    ``dev`` from the seed in bf16; its parameter count and bytes; prefill
    and one decode step against the full forward on a B=2, S=64 batch
    (relative error under 0.02, the reference's bound); then the serving
    command's load through ``ServeEngine`` twice, every request finishing
    with ``MODEL_MAX_NEW`` tokens, the same tokens both times. Prints the
    ``[serve-model]`` line."""
    from repro_torch.configs import get_model
    from repro_torch.models import blocks, lm
    from repro_torch.models.common import make_generator
    from repro_torch.tree import tree_leaves

    t_phase = time.perf_counter()
    api = get_model(MODEL_ARCH, smoke=smoke)
    cfg = api.cfg
    count = api.param_count()
    check(smoke or count == MODEL_PARAMS,
          f"{MODEL_ARCH}: {count} parameters, the reference has "
          f"{MODEL_PARAMS}")
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = api.init_params(make_generator(SEED, dev))
    leaves = tree_leaves(params)
    if on_card:
        torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    nbytes = sum(t.numel() * t.element_size() for t in leaves)
    check(all(t.device == dev for t in leaves),
          f"parameters off {dev} after init_params")
    check(sum(t.numel() for t in leaves) == count and nbytes == 2 * count,
          f"{nbytes} bytes of parameters on {dev} for {count} bf16 "
          f"parameters")

    rng = np.random.default_rng(SEED)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 65))).to(dev)
    full = lm.forward(params, {"tokens": toks}, cfg)
    pre, caches = api.prefill(params, {"tokens": toks[:, :64]})
    caches = blocks.pad_caches(caches, cfg, 72)
    dec, _ = api.decode_step(params, caches, toks[:, 64:65], 64)
    consistency = {"prefill": _rel(torch, full[:, 63], pre[:, 0]),
                   "decode": _rel(torch, full[:, 64], dec[:, 0])}
    check(bool(torch.isfinite(full).all()) and full.shape
          == (2, 65, cfg.vocab_size), "forward logits not finite or shaped "
          f"{tuple(full.shape)}")
    check(max(consistency.values()) < 0.02,
          f"prefill/decode against forward: {consistency}")
    del full, pre, caches, dec

    prompts = serve_prompts(np, cfg.vocab_size)
    profiles = {}
    if on_card:
        # Where a step's time goes: one engine-shaped decode step (B = 4
        # slots, max_len 128) and one prefill of the first prompt.
        caches = api.init_caches(cfg, MODEL_MAX_BATCH, MODEL_MAX_LEN,
                                 device=dev)
        step_toks = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (MODEL_MAX_BATCH, 1))).to(dev)
        index = torch.tensor([len(p) for p in prompts[:MODEL_MAX_BATCH]],
                             device=dev)
        profiles["decode"] = profile_step(torch, lambda: api.decode_step(
            params, caches, step_toks, index))
        first_prompt = torch.from_numpy(prompts[0][None]).to(dev)
        profiles["prefill"] = profile_step(torch, lambda: api.prefill(
            params, {"tokens": first_prompt}))
        del caches
    runs = [run_engine(np, torch, api, params, dev, prompts, MODEL_MAX_BATCH,
                       MODEL_MAX_LEN, MODEL_MAX_NEW) for _ in range(2)]
    first = runs[0]
    check(all(len(t) == MODEL_MAX_NEW for t in first["tokens"]),
          f"token counts {[len(t) for t in first['tokens']]}")
    check(runs[1]["tokens"] == first["tokens"],
          "a second run of the engine gave other tokens")
    ntok = sum(len(t) for t in first["tokens"])
    out = {"arch": MODEL_ARCH if not smoke else cfg.name,
           "param_count": count, "param_bytes": nbytes,
           "init_seconds": init_s, "consistency": consistency,
           "requests": len(prompts),
           "prompt_lengths": [len(p) for p in prompts], "tokens_out": ntok,
           "prefill_ms_per_request": first["prefill_ms"],
           "prefill_ms_median": statistics.median(first["prefill_ms"]),
           "decode_steps": len(first["decode_ms"]),
           "decode_step_ms_median": statistics.median(first["decode_ms"]),
           "wall_seconds": [r["wall"] for r in runs],
           "tokens_per_second": ntok / first["wall"],
           "p50_ms": first["latency"]["p50_ms"],
           "p99_ms": first["latency"]["p99_ms"],
           "max_memory_allocated": (torch.cuda.max_memory_allocated()
                                    if on_card else None),
           "profiles": profiles,
           "card": smi, "phase_seconds": time.perf_counter() - t_phase}
    print("[serve-model] 8a " + json.dumps(out))
    out.update(api=api, params=params, prompts=prompts,
               tokens=first["tokens"])
    return out


def host_card_phase(np, torch, dev) -> dict:
    """Phase 8b: every decoder-only SMOKE config in fp32, its weights made
    on the host from the seed and moved to ``dev``: prefill logits on
    ``dev`` within 1e-4 (relative to the host's largest) of the host's, and
    the twin engines' tokens on ``HOST_PROMPTS`` identical. f32 products
    run in full f32 on the card (no TF32 during the phase; the flags are
    restored after it)."""
    from repro_torch.configs import ARCHS, get_config
    from repro_torch.models import build
    from repro_torch.models.common import make_generator
    from repro_torch.tree import tree_map

    t_phase = time.perf_counter()
    host = torch.device("cpu")
    rows = {}
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        for arch in ARCHS:
            cfg = get_config(arch, smoke=True)
            if cfg.family == "encdec":
                continue
            cfg = dataclasses.replace(cfg, param_dtype=torch.float32)
            api = build(cfg)
            params = api.init_params(make_generator(SEED, host))
            moved = tree_map(lambda t: t.to(dev), params)
            rng = np.random.default_rng(SEED)
            batch = {"tokens": torch.from_numpy(
                rng.integers(0, cfg.vocab_size, (2, 40)))}
            if cfg.frontend != "none":
                batch["prefix_embeds"] = torch.from_numpy(
                    rng.standard_normal((2, cfg.frontend_tokens,
                                         cfg.d_model))).to(torch.bfloat16)
            want, _ = api.prefill(params, batch)
            got, _ = api.prefill(moved, {k: v.to(dev)
                                         for k, v in batch.items()})
            err = _rel(torch, want, got)
            check(err < 1e-4, f"{arch}: prefill logits on {dev} differ from "
                  f"the host's by {err}")
            prompts = [np.random.default_rng([SEED, n]).integers(
                0, cfg.vocab_size, n) for n in HOST_PROMPTS]
            served = [run_engine(np, torch, api, p, d, prompts,
                                 HOST_MAX_BATCH, HOST_MAX_LEN,
                                 HOST_MAX_NEW)["tokens"]
                      for p, d in ((params, host), (moved, dev))]
            check(served[1] == served[0], f"{arch}: the engine's tokens on "
                  f"{dev} differ from the host's")
            rows[arch] = {"prefill_rel_err": err,
                          "tokens": sum(len(t) for t in served[1])}
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    out = {"archs": rows, "phase_seconds": time.perf_counter() - t_phase}
    print("[serve-model] 8b card against host, fp32: " + json.dumps(out))
    return out


def checkpoint_serve_phase(np, torch, dev, workdir: Path, served: dict,
                           wrappers, by_path: dict) -> dict:
    """Phase 8c: 8a's parameters saved with ``save_async`` under the
    default ``CheckpointConfig``, the block files of hosts 1 and 2 emptied
    and the hosts failed, a parallel degraded ``restore``, the restored
    tensors (byte-equal to the saved ones) moved to ``dev`` and loaded into
    a fresh ``ServeEngine``, which must give 8a's tokens exactly. The
    GF(2^8) wrappers count from 0 over the phase into
    ``by_path[name]["serve_model"]``."""
    from repro_torch.ftx import CheckpointConfig, CheckpointManager
    from repro_torch.tree import tree_leaves, tree_map

    t_phase = time.perf_counter()
    default = CheckpointConfig()
    params, api = served["params"], served["api"]
    nbytes = served["param_bytes"]
    st = default.store
    need = nbytes * (st.k + st.r + st.p) // st.k + (1 << 30)
    free = shutil.disk_usage(workdir).free
    check(free > need, f"the model checkpoint needs {need} bytes of disk, "
          f"{free} free")
    for fn in wrappers:
        fn.launches = 0
    cm = CheckpointManager(workdir / "serve", default, device=dev)
    t0 = time.perf_counter()
    info = cm.save_async(1, params).result()
    save_s = time.perf_counter() - t0
    step_dir = workdir / "serve" / "step1"
    lost = [p for h in CKPT_HOSTS for p in (step_dir / f"node{h}").glob("*.blk")]
    for p in lost:
        p.write_bytes(b"")
    cm.fail_hosts(1, CKPT_HOSTS)
    restored, tele = cm.restore(1, params)
    check(tele["degraded_blocks"] > 0,
          f"restore after losing hosts {CKPT_HOSTS}: no degraded block")
    loaded = tree_map(lambda t: t.to(dev), restored)
    del restored
    pairs = []
    tree_map(lambda want, got: pairs.append(same_bytes(torch, got, want)),
             params, loaded)
    check(all(pairs) and len(pairs) == len(tree_leaves(params)),
          f"{pairs.count(False)} restored tensors differ from the saved ones")
    run = run_engine(np, torch, api, loaded, dev, served["prompts"],
                     MODEL_MAX_BATCH, MODEL_MAX_LEN, MODEL_MAX_NEW)
    for fn in wrappers:
        by_path[fn.__name__]["serve_model"] = fn.launches
    equal = run["tokens"] == served["tokens"]
    check(equal, "the engine on the restored parameters gave other tokens")
    k1 = wrappers[0]
    check(dev.type != "cuda" or k1.launches > 0,
          f"{k1.__name__} was never launched on the serve_model path")
    del loaded
    shutil.rmtree(workdir / "serve", ignore_errors=True)
    out = {"bytes": info["bytes"], "stripes": info["stripes"],
           "save_seconds": save_s,
           "snapshot_seconds": info["snapshot_seconds"],
           "encode_launches": info["encode"]["launches"],
           "lost_block_files": len(lost), "restore": tele,
           "tokens_equal": equal,
           "launches": {fn.__name__: fn.launches for fn in wrappers},
           "phase_seconds": time.perf_counter() - t_phase}
    print("[serve-model] 8c from an erasure-coded checkpoint after losing "
          f"hosts {CKPT_HOSTS}: " + json.dumps(out))
    return out


# ------------------------------------------------ phase 9: training a model
# 9a: one card's slice of the reference's train_4k cell (a global batch of
# 256 x 4096 tokens over its 256-chip pod: B=1, T=4096), from SyntheticLM
# with seed 0, at the reference command's optimizer settings.
TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS = 4096, 1, 6
TRAIN_OPT = {"peak_lr": 3e-3, "warmup_steps": 10, "decay_steps": 20}
# The first loss against ln V: at init the final norm gives rms-1 features
# and the tied embedding is N(0, 0.02^2), so the logits' spread is about
# 0.02 * sqrt(d_model) (0.905 at d_model 2048) and the expected loss
# ln V + 0.905^2 / 2 = ln V + 0.41; the bound admits that and refuses a
# loss that is off by a scale (0, or tens).
TRAIN_LOSS_SLACK = 1.0
BF16_FLOPS_PER_S = 989e12               # H100 SXM dense bf16 tensor peak
F32_FLOPS_PER_S = 67e12                 # H100 SXM f32 peak, no tensor cores
# 9b: the card against the host, one fp32 step of every SMOKE config (the
# bounds of tests/test_torch_train.py: loss 1e-5 and grad_norm 1e-4
# relative; every parameter within 2 lr + 1e-6, the most a gradient near 0
# whose sign differs can move it at step 1, and all but 1% within
# 1e-3 lr), then microbatches 1, 2 and 4 on qwen2.5 SMOKE at the
# reference's bounds (loss 2e-2, the first leaf 3e-2).
TRAIN_HOST_LR = 1e-3
# 9c: qwen2.5-3b's widths cut to 2 layers (for the run's time): the
# parameter count and the train state's bytes (bf16 parameters, f32
# moments, the int32 step).
TRAIN_CKPT_LAYERS = 2
TRAIN_CKPT_PARAMS = 465_320_960
TRAIN_CKPT_BYTES = 4_653_209_604
TRAIN_CKPT_STEP = 3                     # steps before the save
# 9d: the reference train command's demo (its test_loss_decreases bound).
TRAIN_CLI = ("--steps", "30", "--batch", "4", "--seq", "64", "--ckpt-every",
             "10", "--ckpt-async", "--kill-host", "2")


def train_flops(cfg, params: int, tokens: int, seq: int) -> dict:
    """A remat step's operations: 8 N T for the products with the
    parameters (forward, the rematerialised forward, the backward's two),
    the attention's QK^T and PV as computed (the full square, 4 B T^2 H hd
    a layer forward, four times), and the tied head's f32 share of the
    first term (no remat: three passes of 2 T V d). The attention scores
    and the head run in f32 without tensor cores; the rest in bf16."""
    hd = cfg.resolved_head_dim
    attn = 16 * cfg.num_layers * tokens * seq * cfg.num_heads * hd
    head = 6 * tokens * cfg.vocab_size * cfg.d_model
    bf16 = 8 * params * tokens - 8 * tokens * cfg.vocab_size * cfg.d_model
    f32 = attn + head
    return {"total": bf16 + f32, "bf16": bf16, "f32": f32,
            "bound_ms": (bf16 / BF16_FLOPS_PER_S + f32 / F32_FLOPS_PER_S)
            * 1e3}


def train_batch(np, cfg, seq: int, batch: int, seed: int = SEED):
    from repro_torch.data.pipeline import DataConfig, make_pipeline

    return make_pipeline(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch,
        seed=seed, frontend=cfg.frontend, frontend_tokens=cfg.frontend_tokens,
        d_model=cfg.d_model))


def train_full_phase(np, torch, dev, smi: str, smoke: bool = False) -> dict:
    """Phase 9a: ``MODEL_ARCH`` at its published widths and depth (its
    SMOKE config with ``smoke``, at T=64), bf16 parameters drawn on
    ``dev`` and f32 moments, ``TRAIN_STEPS`` steps of
    ``make_train_step(donate=True)`` with remat at B=1, T=4096: finite
    losses and norms, the first loss near ln V, the parameters changed.
    Prints step ms (CUDA events, median of the steps after the first),
    tokens/s, peak memory, one profiled step and the step's operations
    against the card's peaks."""
    from repro_torch.configs import get_model
    from repro_torch.models.common import make_generator
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.train_step import TrainConfig, make_train_step
    from repro_torch.tree import tree_leaves

    t_phase = time.perf_counter()
    api = get_model(MODEL_ARCH, smoke=smoke)
    cfg = api.cfg
    count = api.param_count()
    check(smoke or count == MODEL_PARAMS,
          f"{MODEL_ARCH}: {count} parameters, the reference has "
          f"{MODEL_PARAMS}")
    seq = 64 if smoke else TRAIN_SEQ
    data = train_batch(np, cfg, seq, TRAIN_BATCH)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    params = api.init_params(make_generator(SEED, dev))
    opt = adamw_init(params)
    init_peak = torch.cuda.max_memory_allocated() if on_card else None
    state_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves((params, opt)))
    # Slices of two matrices (an update of lr ~ 1e-3 leaves a bf16 gain
    # of 1.0 where it is: under half its step).
    probes = {"embed": lambda p: p["embed"][:4],
              "wq": lambda p: p["stack"][0].mixer.wq[0, :8]}
    before = {k: f(params).clone() for k, f in probes.items()}
    step_fn = make_train_step(api, TrainConfig(opt=AdamWConfig(**TRAIN_OPT)),
                              donate=True)
    state = {"params": params, "opt": opt}
    rows = []

    def step(i: int) -> None:
        p, o, m = step_fn(state["params"], state["opt"], data.batch_at(i))
        state.update(params=p, opt=o)
        rows.append({k: float(v) for k, v in m.items()})

    ms = []
    for i in range(TRAIN_STEPS - 1):
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            step(i)
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            step(i)
            ms.append((time.perf_counter() - t0) * 1e3)
    profile = {}
    if on_card:
        profile = profile_step(torch, lambda: step(TRAIN_STEPS - 1),
                               warmup=False)
    else:
        step(TRAIN_STEPS - 1)
    losses = [r["loss"] for r in rows]
    norms = [r["grad_norm"] for r in rows]
    check(len(rows) == TRAIN_STEPS and all(
        math.isfinite(x) for x in losses + norms),
        f"losses {losses}, grad norms {norms}")
    ln_v = math.log(cfg.vocab_size)
    check(abs(losses[0] - ln_v) < TRAIN_LOSS_SLACK,
          f"first loss {losses[0]} against ln V = {ln_v}")
    params = state["params"]
    changed = {k: not torch.equal(v, probes[k](params))
               for k, v in before.items()}
    check(all(changed.values()), f"parameters unchanged: {changed}")
    check(int(state["opt"]["step"]) == TRAIN_STEPS
          and state["opt"]["step"].dtype == torch.int32,
          f"optimizer step {state['opt']['step']}")
    step_ms = statistics.median(ms[1:])
    tokens = TRAIN_BATCH * seq
    flops = train_flops(cfg, count, tokens, seq)
    out = {"arch": MODEL_ARCH if not smoke else cfg.name,
           "param_count": count, "state_bytes": state_bytes,
           "batch": TRAIN_BATCH, "seq": seq, "losses": losses,
           "grad_norms": norms, "lrs": [r["lr"] for r in rows],
           "first_loss_minus_ln_v": losses[0] - ln_v, "step_ms": ms,
           "step_ms_median": step_ms,
           "tokens_per_second": tokens / (step_ms / 1e3),
           "flops": flops, "achieved_tflops": flops["total"] / step_ms / 1e9,
           "bf16_peak_share": flops["total"] / BF16_FLOPS_PER_S
           / (step_ms / 1e3),
           "bound_share": flops["bound_ms"] / step_ms,
           "init_peak_memory": init_peak,
           "max_memory_allocated": (torch.cuda.max_memory_allocated()
                                    if on_card else None),
           "profile": profile, "card": smi,
           "phase_seconds": time.perf_counter() - t_phase}
    print("[train] 9a " + json.dumps(out))
    return out


def step_gap(want_p, got_p, lr: float) -> tuple[float, float]:
    """(largest parameter difference, share of elements past 1e-3 lr)."""
    from repro_torch.tree import tree_leaves

    worst, far, total = 0.0, 0, 0
    for a, b in zip(tree_leaves(want_p), tree_leaves(got_p)):
        diff = (a.float() - b.float().to(a.device)).abs()
        worst = max(worst, float(diff.max()) if diff.numel() else 0.0)
        far += int((diff > 1e-3 * lr).sum())
        total += diff.numel()
    return worst, far / max(total, 1)


def host_card_train_phase(np, torch, dev) -> dict:
    """Phase 9b: one fp32 ``make_train_step`` step of every SMOKE config
    (seamless included), weights made on the host from the seed and moved
    to ``dev``, against the same step on the host, at the bounds of
    ``TRAIN_HOST_LR``'s note; then microbatches 1, 2 and 4 on qwen2.5
    SMOKE (bf16) on ``dev``. f32 products run in full f32 (no TF32 during
    the phase; the flags are restored after it)."""
    from repro_torch.configs import ARCHS, get_config, get_model
    from repro_torch.models import build
    from repro_torch.models.common import make_generator
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.train_step import TrainConfig, make_train_step
    from repro_torch.tree import tree_leaves, tree_map

    t_phase = time.perf_counter()
    host = torch.device("cpu")
    tc = TrainConfig(opt=AdamWConfig(peak_lr=TRAIN_HOST_LR, warmup_steps=1))
    rows = {}
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        for arch in ARCHS:
            cfg = dataclasses.replace(get_config(arch, smoke=True),
                                      param_dtype=torch.float32)
            api = build(cfg)
            params = api.init_params(make_generator(SEED, host))
            moved = tree_map(lambda t: t.to(dev), params)
            batch = train_batch(np, cfg, 32, 2).batch_at(0)
            step = make_train_step(api, tc)
            want_p, _, want = step(params, adamw_init(params), batch)
            got_p, _, got = step(moved, adamw_init(moved), batch)
            check(all(t.device == dev for t in tree_leaves(got_p)),
                  f"{arch}: the step's parameters left {dev}")
            loss = abs(float(got["loss"]) - float(want["loss"])) \
                / abs(float(want["loss"]))
            gnorm = abs(float(got["grad_norm"]) - float(want["grad_norm"])) \
                / float(want["grad_norm"])
            lr = float(want["lr"])
            worst, far = step_gap(want_p, got_p, lr)
            check(loss <= 1e-5 and gnorm <= 1e-4,
                  f"{arch}: loss {loss}, grad_norm {gnorm} relative on {dev}")
            check(worst <= 2 * lr + 1e-6 and far <= 0.01,
                  f"{arch}: parameters differ by {worst} (lr {lr}), "
                  f"{far} of them past 1e-3 lr")
            rows[arch] = {"loss_rel": loss, "grad_norm_rel": gnorm,
                          "param_max_diff": worst,
                          "param_share_past_1e-3_lr": far}
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    api = get_model(MODEL_ARCH, smoke=True)
    params = api.init_params(make_generator(SEED, dev))
    state = adamw_init(params)
    batch = train_batch(np, api.cfg, 32, 8, seed=1).batch_at(0)
    micro = {}
    for n in (1, 2, 4):
        step = make_train_step(api, TrainConfig(
            opt=AdamWConfig(peak_lr=TRAIN_HOST_LR), microbatches=n))
        p2, _, m = step(params, state, batch)
        micro[n] = (float(m["loss"]), tree_leaves(p2)[0].float())
    for n in (2, 4):
        check(abs(micro[n][0] - micro[1][0]) < 2e-2
              and float((micro[n][1] - micro[1][1]).abs().max()) < 3e-2,
              f"microbatches {n} against 1: losses {micro[n][0]} and "
              f"{micro[1][0]}")
    out = {"archs": rows, "microbatch_losses": {n: v[0] for n, v in
                                                micro.items()},
           "phase_seconds": time.perf_counter() - t_phase}
    print("[train] 9b card against host, fp32: " + json.dumps(out))
    return out


def checkpoint_train_phase(np, torch, dev, workdir: Path, wrappers,
                           by_path: dict, smoke: bool = False) -> dict:
    """Phase 9c: ``MODEL_ARCH``'s widths at ``TRAIN_CKPT_LAYERS`` layers
    (SMOKE with ``smoke``) trained ``TRAIN_CKPT_STEP`` steps in place,
    ``save_async`` under the default ``CheckpointConfig`` while the next
    step runs, one more step (the reference trajectory); then the block
    files of hosts 1 and 2 emptied and the hosts failed, a degraded
    ``restore`` moved back to ``dev``, and the same two steps again:
    parameters and moments bit-identical, losses equal. Deterministic
    algorithms are on for the phase (restored after it). The GF(2^8)
    wrappers count from 0 over the phase into ``by_path[name]["train"]``."""
    from repro_torch.configs import get_config
    from repro_torch.ftx import CheckpointConfig, CheckpointManager
    from repro_torch.models import build
    from repro_torch.models.common import make_generator
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.train_step import TrainConfig, make_train_step
    from repro_torch.tree import tree_leaves, tree_map

    t_phase = time.perf_counter()
    cfg = get_config(MODEL_ARCH, smoke=smoke)
    if not smoke:
        cfg = dataclasses.replace(cfg, num_layers=TRAIN_CKPT_LAYERS)
    api = build(cfg)
    count = api.param_count()
    check(smoke or count == TRAIN_CKPT_PARAMS,
          f"{count} parameters at {TRAIN_CKPT_LAYERS} layers, expected "
          f"{TRAIN_CKPT_PARAMS}")
    default = CheckpointConfig()
    st = default.store
    nbytes = 10 * count + 4
    need = nbytes * (st.k + st.r + st.p) // st.k + (1 << 30)
    free = shutil.disk_usage(workdir).free
    check(free > need, f"the train checkpoint needs {need} bytes of disk, "
          f"{free} free")
    data = train_batch(np, cfg, 64 if smoke else TRAIN_SEQ, TRAIN_BATCH)
    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        step_fn = make_train_step(api, TrainConfig(
            opt=AdamWConfig(**TRAIN_OPT)), donate=True)
        params = api.init_params(make_generator(SEED, dev))
        opt = adamw_init(params)
        for i in range(TRAIN_CKPT_STEP):
            params, opt, _ = step_fn(params, opt, data.batch_at(i))
        for fn in wrappers:
            fn.launches = 0
        cm = CheckpointManager(workdir / "train", default, device=dev)
        fut = cm.save_async(TRAIN_CKPT_STEP, {"params": params, "opt": opt})
        ref_losses, during = [], 0
        for i in (TRAIN_CKPT_STEP, TRAIN_CKPT_STEP + 1):
            params, opt, m = step_fn(params, opt, data.batch_at(i))
            ref_losses.append(float(m["loss"]))
            during += not fut.done()
        info = fut.result()
        check(smoke or info["bytes"] == TRAIN_CKPT_BYTES,
              f"checkpoint of {info['bytes']} bytes, expected "
              f"{TRAIN_CKPT_BYTES}")
        step_dir = workdir / "train" / f"step{TRAIN_CKPT_STEP}"
        lost = [p for h in CKPT_HOSTS
                for p in (step_dir / f"node{h}").glob("*.blk")]
        for p in lost:
            p.write_bytes(b"")
        cm.fail_hosts(TRAIN_CKPT_STEP, CKPT_HOSTS)
        restored, tele = cm.restore(TRAIN_CKPT_STEP,
                                    {"params": params, "opt": opt})
        check(tele["degraded_blocks"] > 0,
              f"restore after losing hosts {CKPT_HOSTS}: no degraded block")
        re_params = tree_map(lambda t: t.to(dev), restored["params"])
        re_opt = tree_map(lambda t: t.to(dev), restored["opt"])
        del restored
        check(re_opt["step"].dtype == torch.int32
              and int(re_opt["step"]) == TRAIN_CKPT_STEP,
              f"restored optimizer step {re_opt['step']}")
        re_losses = []
        for i in (TRAIN_CKPT_STEP, TRAIN_CKPT_STEP + 1):
            re_params, re_opt, m = step_fn(re_params, re_opt,
                                           data.batch_at(i))
            re_losses.append(float(m["loss"]))
    finally:
        torch.use_deterministic_algorithms(deterministic)
    for fn in wrappers:
        by_path[fn.__name__]["train"] = fn.launches
    pairs = [torch.equal(a, b) and a.dtype == b.dtype for a, b in
             zip(tree_leaves((params, opt)),
                 tree_leaves((re_params, re_opt)))]
    check(all(pairs) and len(pairs) == len(tree_leaves((params, opt))),
          f"{pairs.count(False)} tensors differ after the restored steps")
    check(re_losses == ref_losses,
          f"losses {re_losses} after the restore, {ref_losses} before")
    k1 = wrappers[0]
    check(dev.type != "cuda" or k1.launches > 0,
          f"{k1.__name__} was never launched on the train path")
    del params, opt, re_params, re_opt
    shutil.rmtree(workdir / "train", ignore_errors=True)
    out = {"param_count": count, "bytes": info["bytes"],
           "stripes": info["stripes"],
           "snapshot_ms": fut.snapshot_seconds * 1e3,
           "encode_seconds": info["encode_seconds"],
           "steps_during_encode": during,
           "encode_launches": info["encode"]["launches"],
           "lost_block_files": len(lost), "restore": tele,
           "losses": ref_losses, "bit_identical": all(pairs),
           "launches": {fn.__name__: fn.launches for fn in wrappers},
           "phase_seconds": time.perf_counter() - t_phase}
    print("[train] 9c checkpoint, hosts "
          f"{CKPT_HOSTS} lost, restored, continued: " + json.dumps(out))
    return out


def train_cli_phase(np, torch, dev, workdir: Path) -> dict:
    """Phase 9d: ``python -m repro_torch.launch.train`` with
    ``TRAIN_CLI`` in a subprocess on ``dev``: exit 0, ``[ftx ] restored``
    and ``done: 30 steps`` printed, and the last printed loss at least 0.5
    under the first."""
    t_phase = time.perf_counter()
    cmd = [sys.executable, "-m", "repro_torch.launch.train", *TRAIN_CLI,
           "--ckpt-dir", str(workdir / "cli"), "--device", dev.type]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    run = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=600)
    check(run.returncode == 0,
          f"the train command exited {run.returncode}: {run.stderr[-2000:]}")
    lines = run.stdout.splitlines()
    losses = [float(re.search(r"loss=([0-9.]+)", line).group(1))
              for line in lines if line.startswith("step ")]
    check(any(line.startswith("  [ftx ] restored") for line in lines)
          and any(line.startswith("done: 30 steps") for line in lines),
          f"the train command printed {run.stdout[-2000:]}")
    check(len(losses) >= 2 and losses[-1] < losses[0] - 0.5,
          f"the train command's losses {losses} do not fall")
    out = {"command": " ".join(cmd[1:]), "losses": losses,
           "lines": [line for line in lines if not line.startswith("step ")],
           "phase_seconds": time.perf_counter() - t_phase}
    print("[train] 9d " + json.dumps(out))
    return out


def payload(np, seed: int, size: int):
    """Object ``seed``'s bytes, the same every time they are asked for."""
    return np.frombuffer(np.random.default_rng([SEED, seed]).bytes(size),
                         np.uint8)


if __name__ == "__main__":
    main()
