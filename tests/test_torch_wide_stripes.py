"""The paper's widest stripe, P8 (k=96, r=5, p=4, n=105), through the
port's normal repair path on the CPU.

* Fleets of 105 nodes with one stripe on each of the 15 arcs that
  contiguous placement (stride 7) gives, on both CP constructions, lose
  1 to 5 adjacent nodes (two nodes in each of the benchmark's 7 strata);
  every rebuilt block equals the benchmark's plain reference
  (``portbench/reference``), byte for byte. These repairs run the
  synchronous path, which launches as the pipeline does (one launch per
  pattern chunk, ``launch_step``) without reader threads; the counters'
  test runs both.
* The port's plan for every one of the 105 adjacent pairs equals the
  JAX package's: reads, coefficients and steps.
* The report's counters of the planning and of the GF(2^8) kernel
  (``plans_compiled``, ``repairs_cascaded``, ``reads_global``,
  ``kernel_table_chunks``) equal counts taken from the plans and the
  launch shapes.
"""
import math
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.reference import lrc  # noqa: E402
from repro.core.planner import RepairPlanner as RefPlanner  # noqa: E402
from repro.core.schemes import PAPER_PARAMS  # noqa: E402
from repro.core.schemes import make_scheme as ref_scheme  # noqa: E402
from repro_torch.core.planner import RepairPlanner  # noqa: E402
from repro_torch.core.schemes import make_scheme  # noqa: E402
from repro_torch.ftx import (RepairOptions, StoreConfig,  # noqa: E402
                             StripeStore, repair_failed_nodes)
from repro_torch.ftx.stripestore import launch_step  # noqa: E402
from repro_torch.kernels import gf256_matmul as gm  # noqa: E402

P8 = PAPER_PARAMS["P8"]
NODES = 105
ARCS = 15                      # stripes 0..14 start on nodes 0, 7, ..., 98
BLOCK = 4096
SCHEMES = ["cp-azure", "cp-uniform"]
# (nodes lost a repair, first node of each repair): two adjacent nodes in
# every stratum (the first node mod 7), and one run of 1, 3, 4 and 5.
FAILURES = [(2, tuple(range(7))), (1, (0,)), (3, (5,)), (4, (52,)),
            (5, (101,))]


def _fleet(root, scheme, seed=0):
    k, r, p = P8
    store = StripeStore(root, StoreConfig(scheme=scheme, k=k, r=r, p=p,
                                          block_size=BLOCK, backend="gf",
                                          placement_policy="contiguous"),
                        num_nodes=NODES, device="cpu")
    data = torch.randint(0, 256, (ARCS, k, BLOCK), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(seed))
    for sid in range(ARCS):
        store.put(f"s{sid}", data[sid].numpy())
    store.seal()
    assert len(store.stripes) == ARCS
    want = torch.cat([data, lrc.encode(lrc.generator(scheme, *P8), data)],
                     dim=1)
    return store, want


def _lose(store, nodes):
    """Take the nodes' block files away, so only the repair brings them
    back; the lost (stripe, block) pairs."""
    lost = []
    for sid, st in store.stripes.items():
        for b, node in enumerate(st.node_of_block):
            if node in nodes:
                store._block_path(sid, b).unlink()
                lost.append((sid, b))
    return lost


def _adjacent(first, count):
    return tuple((first + i) % NODES for i in range(count))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module: the plain products' tensors
    are small, and a parallel region per op stalls for seconds when the
    host's cores are all busy (as under several test workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def fleets(tmp_path_factory):
    """One sealed fleet a construction, shared by the byte tests: each
    repair leaves the fleet as it was sealed."""
    return {scheme: _fleet(tmp_path_factory.mktemp(scheme), scheme)
            for scheme in SCHEMES}


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("count,firsts", FAILURES,
                         ids=[f"{c}node" for c, _ in FAILURES])
def test_p8_repair_rebuilds_the_reference_bytes(scheme, count, firsts,
                                                fleets):
    store, want = fleets[scheme]
    for first in firsts:
        nodes = _adjacent(first, count)
        lost = _lose(store, nodes)
        assert len(lost) == ARCS * count
        rep = repair_failed_nodes(store, nodes, device="cpu",
                                  options=RepairOptions(pipeline=False))
        assert rep.stripes_repaired == ARCS and rep.patterns == ARCS
        # On the CPU the plain product runs: no kernel, no table chunks.
        assert rep.effective_backend == "ref"
        assert rep.kernel_table_chunks == 0
        for sid, b in lost:
            got = np.fromfile(store._block_path(sid, b), np.uint8)
            assert np.array_equal(got, want[sid, b].numpy()), (nodes, sid, b)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_p8_adjacent_pair_plans_equal_the_reference(scheme):
    port = RepairPlanner(make_scheme(scheme, *P8))
    ref = RefPlanner(ref_scheme(scheme, *P8))
    kinds = set()
    for b in range(NODES):
        pair = {b, (b + 1) % NODES}
        got, want = port.multi_plan(pair), ref.multi_plan(pair)
        assert got.targets == want.targets and got.reads == want.reads
        assert np.array_equal(got.coeffs, want.coeffs)
        assert got.meta.steps == want.meta.steps
        assert got.meta.all_local == want.meta.all_local
        kinds.add((len(got.reads), got.meta.all_local))
    # Global decodes read all k blocks; the local plans read fewer.
    assert (P8[0], False) in kinds
    assert any(local and reads < P8[0] for reads, local in kinds)


def _launches_with_table_chunks(monkeypatch):
    """The engine on the CPU recording its launches' table chunks as on
    the card: a "gf" launch reports that it ran the GF(2^8) kernel (the
    plain product still runs)."""
    from repro_torch.core import engine

    monkeypatch.setattr(engine, "effective_backend",
                        lambda backend, device: backend)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_p8_report_counts_follow_the_plans_and_launches(scheme, tmp_path,
                                                        monkeypatch):
    _launches_with_table_chunks(monkeypatch)
    store, _ = _fleet(tmp_path, scheme, seed=1)
    planner = RepairPlanner(make_scheme(scheme, *P8))
    seen = set()
    # Through the pipeline and the synchronous path; strata 0 and 3 twice,
    # where the second repair finds every plan cached.
    for first, pipeline in ((0, True), (3, False), (7, False), (10, True)):
        nodes = _adjacent(first, 2)
        _lose(store, nodes)
        groups = {}
        for sid, st in store.stripes.items():
            down = frozenset(b for b, n in enumerate(st.node_of_block)
                             if n in nodes)
            groups.setdefault(down, []).append(sid)
        plans = {down: planner.multi_plan(down) for down in groups}
        local = cascaded = glob = glob_reads = reads = launches = chunks = 0
        for down, sids in groups.items():
            plan = plans[down]
            if plan.meta.all_local:
                local += len(sids)
                cascaded += len(sids) * any(
                    m == "cascade" for _, m in plan.meta.steps)
            else:
                glob += len(sids)
                glob_reads += len(sids) * len(plan.reads)
            reads += len(sids) * len(plan.reads)
            step = launch_step(store.cfg, len(plan.reads))
            n = math.ceil(len(sids) / step)
            launches += n
            chunks += n * math.ceil(len(plan.reads) / gm.TABLE_CHUNK_ROWS)
        rep = repair_failed_nodes(store, nodes, device="cpu",
                                  options=RepairOptions(pipeline=pipeline))
        assert rep.plans_compiled == len(set(groups) - seen)
        assert rep.plans_compiled == rep.plan_cache["misses"]
        assert rep.plan_compile_seconds <= rep.plan_seconds
        assert (rep.plan_compile_seconds > 0) == (rep.plans_compiled > 0)
        seen |= set(groups)
        assert (rep.repairs_local, rep.repairs_cascaded, rep.repairs_global,
                rep.reads_global, rep.blocks_read, rep.launches) == \
            (local, cascaded, glob, glob_reads, reads, launches)
        assert rep.repairs_cascaded <= rep.repairs_local
        assert rep.kernel_table_chunks == chunks
        # At P8 a global decode reads 96 blocks: two 64-row chunks.
        assert chunks >= 2 * glob > 0
    tele = store.telemetry
    assert tele.plans_compiled == len(seen) > 0
    tele.reset()
    assert (tele.plans_compiled, tele.repairs_cascaded, tele.reads_global,
            tele.plan_compile_seconds, tele.kernel_table_chunks) == \
        (0, 0, 0, 0.0, 0)


def test_table_chunks_count_ceil_k_over_64():
    ks = (1, 64, 65, 96, 128, 129)
    assert [gm.table_chunks(k) for k in ks] == [1, 1, 2, 2, 2, 3]
    before = gm.gf256_matmul.launches
    for _ in ks:
        gm._count(gm.gf256_matmul)
    assert gm.gf256_matmul.launches - before == len(ks)
