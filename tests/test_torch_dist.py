"""The port's single-device distribution layer against the JAX reference.

Spans, window alignment and gather geometry on a one-device mesh must be
the reference's; a mesh of several devices raises until multi-device
launches land. Twin stores on a multi-domain topology (spread placement,
topology-chosen rebuild destinations) must place, schedule, repair and
re-home blocks exactly as the reference does. The port runs on the CPU.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.dist import placement as ref_placement  # noqa: E402
from repro.dist import sharding as ref_sharding  # noqa: E402
from repro.dist import stripes as ref_stripes  # noqa: E402
from repro.dist.schedule import schedule_group as ref_schedule  # noqa: E402
from repro.dist.topology import Topology as RefTopology  # noqa: E402
from repro.ftx.fleet import repair_failed_nodes as ref_repair  # noqa: E402
from repro.ftx.options import RepairOptions as RefOptions  # noqa: E402
from repro.ftx.stripestore import StoreConfig as RefConfig  # noqa: E402
from repro.ftx.stripestore import StripeStore as RefStore  # noqa: E402
from repro_torch.dist import (Mesh, PlacementMap, Topology,  # noqa: E402
                              align_stripe_window, block_loads,
                              current_rules, plan_gather, schedule_group,
                              shard_layout, sharded_launch, stripe_axis_span,
                              stripe_span, with_rules)
from repro_torch.ftx import (RepairOptions, StoreConfig,  # noqa: E402
                             StripeStore, repair_failed_nodes)


@pytest.mark.parametrize("s", [1, 7, 64])
def test_single_device_spans_match_reference(s):
    shape = (s, 12, 128)
    ref_mesh = jax.make_mesh((1, 1), ("data", "model"))
    with ref_sharding.with_rules(ref_mesh) as rmr, \
            with_rules(Mesh({"data": 1, "model": 1})) as pmr:
        assert current_rules() is pmr
        assert stripe_span(shape, pmr) == ref_stripes.stripe_span(shape, rmr)
        assert stripe_axis_span(pmr) == ref_stripes.stripe_axis_span(rmr)
        for window in (1, 5, 32):
            assert align_stripe_window(window, pmr) == \
                ref_stripes.align_stripe_window(window, rmr)
        for mr, place in ((pmr, shard_layout), (None, shard_layout),
                          (rmr, ref_placement.shard_layout),
                          (None, ref_placement.shard_layout)):
            assert place(shape, mr) is None
        layout, parts = plan_gather(shape, pmr, None)
        want_layout, want = ref_placement.plan_gather(shape, rmr, None)
        assert layout is None and want_layout is None
        assert [(p.lo, p.hi, p.shard, p.buf.shape, p.buf.dtype)
                for p in parts] == \
            [(p.lo, p.hi, p.shard, p.buf.shape, p.buf.dtype) for p in want]
    assert current_rules() is None


def test_multi_device_meshes_raise():
    with pytest.raises(NotImplementedError, match="later slice"):
        with with_rules(Mesh({"data": 2, "model": 1})):
            pass
    assert current_rules() is None
    coef, batch = torch.ones(1, 2), torch.zeros(3, 2, 4)
    assert sharded_launch(lambda c, b, scale: b + scale, coef, batch, None,
                          scale=1).sum() == batch.numel()


def _twin_topology_stores(tmp_path, *, scheme):
    args = dict(scheme=scheme, k=6, r=2, p=2, block_size=512,
                batch_stripes=8, pipeline_window=8, prefetch_threads=2,
                placement_policy="spread", backend="ref")
    topo = dict(num_nodes=40, num_domains=8, spread_width=3, seed=7)
    ref = RefStore(tmp_path / "ref", RefConfig(**args), num_nodes=40,
                   topology=RefTopology(**topo))
    port = StripeStore(tmp_path / "port", StoreConfig(**args), num_nodes=40,
                       topology=Topology(**topo), device="cpu")
    payload = np.random.default_rng(3).integers(0, 256, 24 * 6 * 512,
                                                dtype=np.uint8)
    for st in (ref, port):
        st.put("blob", payload.tobytes())
        st.seal()
    return ref, port, payload


@pytest.mark.parametrize("scheme", ["cp-azure", "cp-uniform"])
def test_topology_stores_place_and_rehome_like_reference(scheme, tmp_path):
    ref, port, payload = _twin_topology_stores(tmp_path, scheme=scheme)
    placed = {sid: s.node_of_block for sid, s in port.stripes.items()}
    assert placed == {sid: s.node_of_block for sid, s in ref.stripes.items()}
    assert block_loads(placed.values(), 40) == ref_placement.block_loads(
        placed.values(), 40)
    pmap = PlacementMap.from_store(port, num_shards=8)
    rmap = ref_placement.PlacementMap.from_store(ref, num_shards=8)
    assert pmap.shard_of_node == rmap.shard_of_node
    assert pmap.remote_multiplier == rmap.remote_multiplier
    assert all(pmap.locate(sid, b) == rmap.locate(sid, b)
               for sid in placed for b in range(port.n))
    sids = sorted(placed)
    reads = list(range(port.scheme.k))
    for got, want in zip(
            schedule_group(sids, reads, port.placement, None, step=8),
            ref_schedule(sids, reads, ref.placement, None, step=8)):
        assert (got.sids, got.scheduled_local, got.total_reads) == \
            (want.sids, want.scheduled_local, want.total_reads)

    victims = port.topology.nodes_in(3)[:2]
    want = ref_repair(ref, victims,
                      options=RefOptions(destinations="topology"))
    got = repair_failed_nodes(port, victims, device="cpu",
                              options=RepairOptions(destinations="topology"))
    assert got.blocks_relocated == want.blocks_relocated > 0
    assert (got.stripes_repaired, got.blocks_read, got.launches,
            got.destinations) == (want.stripes_repaired, want.blocks_read,
                                  want.launches, want.destinations)
    assert {sid: s.node_of_block for sid, s in port.stripes.items()} == \
        {sid: s.node_of_block for sid, s in ref.stripes.items()}
    for sid in port.stripes:
        for b in range(port.n):
            assert port._block_path(sid, b).read_bytes() == \
                ref._block_path(sid, b).read_bytes()
    assert np.asarray(port.get("blob")).tobytes() == payload.tobytes()

