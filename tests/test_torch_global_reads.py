"""The surviving blocks a repair reads for its global decodes
(``reads_global``), on the CPU: on Azure-LRC and CP-Azure P5 fleets of 28
nodes (contiguous placement, every stripe one block on every node), one
node of each of the 7 classes lost in turn, the report's count equals the
plans' reads of the stripes that took a global decode and never exceeds
``blocks_read``. Azure-LRC decodes both globals from 24 reads; CP-Azure
rebuilds G2 from its cascade, so only G1 costs a global decode there."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.planner import RepairPlanner  # noqa: E402
from repro_torch.core.schemes import make_scheme  # noqa: E402
from repro_torch.ftx import (RepairOptions, StoreConfig,  # noqa: E402
                             StripeStore, repair_failed_nodes)

P5 = (24, 2, 2)
NODES = 28
STRIPES = 4                    # node x holds blocks x, x-7, x-14, x-21
G1, G2 = 26, 27                # the globals' block ids at P5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the plain products' tensors are small, and a
    parallel region per op stalls when the host's cores are all busy."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fleet(root, scheme):
    k, r, p = P5
    store = StripeStore(root, StoreConfig(scheme=scheme, k=k, r=r, p=p,
                                          block_size=1024, backend="gf",
                                          placement_policy="contiguous"),
                        num_nodes=NODES, device="cpu")
    data = np.random.default_rng(3).integers(
        0, 256, (STRIPES, k, 1024), dtype=np.uint8)
    for sid in range(STRIPES):
        store.put(f"s{sid}", data[sid])
    store.seal()
    return store


def _global_reads(store, planner, node):
    """Take the node's block files away; the reads of the global plans
    its repair should run, stripe by stripe."""
    total = 0
    for sid, st in store.stripes.items():
        down = frozenset(b for b, n in enumerate(st.node_of_block)
                         if n == node)
        for b in down:
            store._block_path(sid, b).unlink()
        plan = planner.multi_plan(down)
        if not plan.meta.all_local:
            total += len(plan.reads)
    return total


@pytest.mark.parametrize("pipeline", [True, False],
                         ids=["pipeline", "synchronous"])
@pytest.mark.parametrize("scheme", ["azure", "cp-azure"])
def test_reads_global_are_the_global_plans_reads(scheme, pipeline,
                                                 tmp_path):
    store = _fleet(tmp_path, scheme)
    planner = RepairPlanner(make_scheme(scheme, *P5))
    by_class = []
    for node in range(7):
        want = _global_reads(store, planner, node)
        rep = repair_failed_nodes(store, [node], device="cpu",
                                  options=RepairOptions(pipeline=pipeline))
        assert rep.reads_global == want
        assert rep.reads_global <= rep.blocks_read
        assert (rep.reads_global > 0) == (rep.repairs_global > 0)
        by_class.append(rep.reads_global)
    # Node 5 holds G1 of one stripe and node 6 G2: a global decode reads
    # the k data blocks' worth, 24.
    g2 = P5[0] if scheme == "azure" else 0
    assert by_class == [0, 0, 0, 0, 0, P5[0], g2]
    assert store.stripes[1].node_of_block[G1] == 5
    assert store.stripes[1].node_of_block[G2] == 6
    tele = store.telemetry
    assert tele.reads_global == P5[0] + g2
    tele.reset()
    assert tele.reads_global == 0
