"""The traced run's idle gaps take the program's span names: the harness's
``profiling.reduce`` names a gap after the shortest program span around
its middle, and a repair's coordinator opens such spans (the port's
``repair.plan`` and ``pipeline.*``) wherever it waits with the card idle.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
for _p in (ROOT, ROOT / "src"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from portbench import profiling  # noqa: E402

PROGRAM_SPANS = ("repair.plan", "pipeline.read_wait", "pipeline.copy_in",
                 "pipeline.kernel", "pipeline.copy_out",
                 "pipeline.drain_wait")


def test_reduce_names_a_gap_after_the_program_span_around_it():
    device = [("gf256_matmul_batched_kernel", 0.0, 10.0),
              ("Memcpy HtoD (Pageable -> Device)", 100.0, 130.0)]
    host = [("portbench.repair", 5.0, 200.0),
            ("pipeline.read_wait", 12.0, 95.0),
            ("aten::empty", 20.0, 21.0)]
    out = profiling.reduce(device, host, (0.0, 200.0))
    assert out["idle_gaps"] == [
        ["portbench.repair / pipeline.read_wait", 90e-6],
        ["portbench.repair / host code outside torch", 70e-6]]
    # An operator around the middle is shorter than the span: it names it.
    host.append(("aten::copy_", 50.0, 60.0))
    assert profiling.reduce(device, host, (0.0, 200.0))["idle_gaps"][0] \
        == ["portbench.repair / aten::copy_", 90e-6]


def test_a_traced_repair_names_every_gap_before_its_last_copy(tmp_path):
    """A pipelined repair on the CPU under the harness's tracer and marks,
    with the card standing busy from each launch's copy in to its copy
    back: every idle gap from the window's start to the last copy back
    that holds a quarter of a read (10 ms) lies in a program span. The
    reads are slept long enough (each about 40 ms) to outlast the plain
    kernel on 512-byte blocks, as the cells' 1 Gbps links outlast the
    card. A shorter gap can fall where the coordinator hands a window to
    the writer and submits the next reads: under a millisecond here. (The gap after the last copy back is the last
    write-back's, ``pipeline.drain_wait``, when that outlasts the return,
    as 1 MiB blocks do on the card.)"""
    from repro_torch.ftx import StoreConfig, StripeStore, repair_failed_nodes

    cfg = StoreConfig(scheme="cp-azure", k=6, r=2, p=2, block_size=512,
                      batch_stripes=4, pipeline_window=4, prefetch_threads=2,
                      io_stall_scale=4.0)
    store = StripeStore(tmp_path, cfg, device="cpu")
    store.put("blob", np.random.default_rng(1).integers(
        0, 256, 8 * cfg.k * cfg.block_size, dtype=np.uint8).tobytes())
    store.seal()
    tracer = profiling.Tracer(True)
    with tracer:
        with tracer.mark(profiling.WINDOW):
            with tracer.mark("portbench.repair"):
                rep = repair_failed_nodes(store, [0], device="cpu")
    assert rep.windows > 1
    window, host = None, []
    for evt in tracer.prof.events():
        span = (evt.time_range.start, evt.time_range.end)
        if evt.name == profiling.WINDOW:
            window = span
        else:
            host.append((evt.name, *span))
    assert {name for name, *_ in host} >= set(PROGRAM_SPANS)
    # The card stands busy from each launch's copy in to its copy back.
    ins = sorted(s for name, s, _ in host if name == "pipeline.copy_in")
    outs = sorted(e for name, _, e in host if name == "pipeline.copy_out")
    assert len(ins) == len(outs) == rep.launches > 1
    device = [("gf256_matmul_batched_kernel", s, e)
              for s, e in zip(ins, outs)]
    gaps = profiling.reduce(device, host, (window[0], outs[-1]),
                            top=rep.launches + 1)["idle_gaps"]
    assert len(gaps) == rep.launches
    long = [name for name, seconds in gaps if seconds > 0.01]
    assert long and all(name.split(" / ")[0] == "portbench.repair"
                        and name.split(" / ")[1] in PROGRAM_SPANS
                        for name in long), gaps
