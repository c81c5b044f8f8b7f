"""Node death during a repair: twin stores, the reference's and the port's
(``device="cpu"``), built as ``tests/test_pipeline.py::_build`` builds
them, driven through the same failures.

* an unrecoverable pattern raises ``IOError`` on both;
* the feasible group sorted before an unrecoverable one repairs first;
* a node that dies at a pipeline hook (``prefetch`` or ``launch``) leaves
  every block as the pre-failure truth.

The first two are held to the reference's block bytes and telemetry
counts. The third is held to the block bytes only: its counts depend on
which of a window's reads were already submitted when the node died, a
race in both packages.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.ftx.options import RepairOptions as RefOptions  # noqa: E402
from repro.ftx.stripestore import StoreConfig as RefConfig  # noqa: E402
from repro.ftx.stripestore import StripeStore as RefStore  # noqa: E402
from repro_torch.ftx import (RepairOptions, StoreConfig,  # noqa: E402
                             StripeStore)

# Telemetry counters that a repair sets deterministically (the wall-clock
# spans are left out; sim_seconds is compared to a relative 1e-9).
COUNTS = ("blocks_read", "bytes_read", "repairs_local", "repairs_global",
          "local_reads", "remote_reads", "gather_bytes_per_shard",
          "blocks_relocated")


def _build(root, package, *, stripes=40, block_size=512, batch_stripes=8,
           window=4, threads=4, num_nodes=None):
    cfg_cls, store_cls, kw = ((RefConfig, RefStore, {}) if package == "ref"
                              else (StoreConfig, StripeStore,
                                    {"device": "cpu"}))
    cfg = cfg_cls(scheme="cp-azure", k=6, r=2, p=2, block_size=block_size,
                  batch_stripes=batch_stripes, pipeline_window=window,
                  prefetch_threads=threads)
    if num_nodes is not None:
        kw["num_nodes"] = num_nodes
    store = store_cls(root, cfg, **kw)
    payload = np.random.default_rng(3).integers(
        0, 256, stripes * cfg.k * block_size, dtype=np.uint8)
    store.put("blob", payload.tobytes())
    store.seal()
    assert len(store.stripes) == stripes
    return store


def _twins(tmp_path, **kw):
    return (_build(tmp_path / "ref", "ref", **kw),
            _build(tmp_path / "port", "port", **kw))


def _all_blocks(store):
    return {(sid, b): store._block_path(sid, b).read_bytes()
            for sid in store.stripes for b in range(store.scheme.n)}


def _options(package, **kw):
    return (RefOptions if package == "ref" else RepairOptions)(**kw)


def _assert_same_counts(ref, port):
    for f in COUNTS:
        assert getattr(port.telemetry, f) == getattr(ref.telemetry, f), f
    assert port.telemetry.sim_seconds == pytest.approx(
        ref.telemetry.sim_seconds, rel=1e-9)


@pytest.mark.parametrize("pipeline", [True, False])
def test_unrecoverable_pattern_raises_on_both(tmp_path, pipeline):
    """test_pipeline.py:126: five blocks of stripe 0 down (beyond n - k):
    both packages raise IOError and leave the same bytes and counts."""
    ref, port = _twins(tmp_path, stripes=10)
    for store in (ref, port):
        for b in range(5):
            store.fail_node(store.stripes[0].node_of_block[b])
    for package, store in (("ref", ref), ("port", port)):
        with pytest.raises(IOError):
            store.repair_all(options=_options(package, pipeline=pipeline))
    _assert_same_counts(ref, port)
    assert _all_blocks(port) == _all_blocks(ref)


@pytest.mark.parametrize("pipeline", [True, False])
def test_feasible_group_repairs_before_the_ioerror(tmp_path, pipeline):
    """test_pipeline.py:134: nodes 9-13 hold five blocks of stripe 1
    (unrecoverable) and one of stripe 0, whose group sorts first and must
    repair before the IOError, in both packages alike."""
    ref, port = _twins(tmp_path, stripes=8, num_nodes=20)
    for package, store in (("ref", ref), ("port", port)):
        for node in range(9, 14):
            store.fail_node(node)
        assert len(store._down_blocks(1)) == 5
        assert len(store._down_blocks(0)) == 1
        with pytest.raises(IOError):
            store.repair_all(options=_options(package, pipeline=pipeline))
        assert (store.telemetry.repairs_local
                + store.telemetry.repairs_global) == 1
    _assert_same_counts(ref, port)
    assert _all_blocks(port) == _all_blocks(ref)


@pytest.mark.parametrize("fail_at,stage,offset,window", [
    (0, "prefetch", 1, 1), (0, "launch", 5, 4), (1, "prefetch", 5, 2),
    (1, "launch", 1, 1), (3, "prefetch", 1, 2), (3, "launch", 5, 1),
    (9, "prefetch", 5, 4), (9, "launch", 1, 2)])
def test_node_death_at_a_pipeline_hook_keeps_the_bytes(
        tmp_path, fail_at, stage, offset, window):
    """test_pipeline.py:176: a second node dies when the pipeline reaches
    window ``fail_at``'s ``stage`` hook (in both packages, or in neither
    when the repair has fewer windows); both stores end with every block
    equal to the pre-failure truth, and so to each other."""
    ref, port = _twins(tmp_path, stripes=20, window=window)
    truth = _all_blocks(ref)
    assert _all_blocks(port) == truth
    fired_in = {}
    for package, store in (("ref", ref), ("port", port)):
        node = store.stripes[0].node_of_block[0]
        second = (node + offset) % store.num_nodes
        if second == node:
            second = (node + 1) % store.num_nodes
        store.fail_node(node)
        fired = []

        def hook(hook_stage, index, store=store, second=second, fired=fired):
            if hook_stage == stage and index == fail_at and not fired:
                fired.append(index)
                store.fail_node(second)

        tele = store.repair_all(options=_options(
            package, pipeline=True, pipeline_hook=hook))
        assert tele["pipelined"]
        store.revive_node(node)
        store.revive_node(second)
        assert _all_blocks(store) == truth, package
        fired_in[package] = fired
    assert fired_in["port"] == fired_in["ref"]     # the same windows

