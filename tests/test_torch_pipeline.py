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

The port's own staging (``repro_torch.ftx.pipeline.STAGING``: readers
write each block straight into a reused window buffer) is held to the
synchronous path on windows of alternating shapes, to a truncated block
file, and to the pool's bounds.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.ftx.options import RepairOptions as RefOptions  # noqa: E402
from repro.ftx.stripestore import StoreConfig as RefConfig  # noqa: E402
from repro.ftx.stripestore import StripeStore as RefStore  # noqa: E402
from repro_torch.ftx import (RepairOptions, StoreConfig,  # noqa: E402
                             StripeStore)
from repro_torch.ftx.pipeline import STAGING, StagingPool  # noqa: E402
from repro_torch.ftx.stripestore import launch_step  # noqa: E402

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
        if package == "port":
            # Every window, replanned sub-windows too, gathered into a
            # staging buffer, and the pool keeps at most three idle.
            assert tele["staging_reused"] + tele["staging_allocated"] \
                >= tele["windows"]
            assert STAGING.idle() <= 3
        store.revive_node(node)
        store.revive_node(second)
        assert _all_blocks(store) == truth, package
        fired_in[package] = fired
    assert fired_in["port"] == fired_in["ref"]     # the same windows



# ------------------------------------------------------------ staging

def _p5(root, *, window=4, threads=4, block_size=512, stripes=29):
    """A CP-Azure P5 store (k=24, r=2, p=2, n=28) of 29 nodes: the
    stride-7 arcs put a node's blocks at every position of the stripe, so
    its loss mixes local-group repairs (12 reads), G1's global decode (24)
    and the cascade (2), and the windows alternate those shapes."""
    cfg = StoreConfig(scheme="cp-azure", k=24, r=2, p=2,
                      block_size=block_size, batch_stripes=window,
                      pipeline_window=window, prefetch_threads=threads)
    store = StripeStore(root, cfg, num_nodes=29, device="cpu")
    payload = np.random.default_rng(11).integers(
        0, 256, stripes * cfg.k * block_size, dtype=np.uint8)
    store.put("blob", payload.tobytes())
    store.seal()
    return store


def _lose(store, node):
    """Fail ``node`` and delete its block files, so that only the repair
    can bring them back; returns the lost ``(sid, block)`` pairs."""
    store.fail_node(node)
    lost = [(sid, b) for sid, s in store.stripes.items()
            for b, n in enumerate(s.node_of_block) if n == node]
    for sid, b in lost:
        store._block_path(sid, b).unlink()
    return lost


def test_a_reused_staging_slot_never_leaks_bytes(tmp_path):
    """Two pipelined repairs back to back over windows of alternating
    shapes rebuild every block as the synchronous path does, the second
    with no new staging buffer; a truncated surviving block then raises
    ``ValueError`` and its window writes no rebuilt block."""
    piped, sync = _p5(tmp_path / "piped"), _p5(tmp_path / "sync")
    truth = _all_blocks(sync)
    node = 5
    shapes = {len(piped.engine.planner.multi_plan(
        frozenset({piped.stripes[sid].node_of_block.index(node)})).reads)
        for sid in piped.stripes if node in piped.stripes[sid].node_of_block}
    assert shapes == {2, 12, 24}
    for _ in range(2):
        for store, pipeline in ((piped, True), (sync, False)):
            _lose(store, node)
            tele = store.repair_all(options=RepairOptions(pipeline=pipeline))
            store.revive_node(node)
            assert tele["pipelined"] is pipeline
        assert _all_blocks(piped) == _all_blocks(sync) == truth
    assert tele["windows"] == 0 and tele["staging_allocated"] == 0
    piped_tele = piped.telemetry.reset()
    assert piped_tele.staging_allocated + piped_tele.staging_reused > 4

    # Truncate a block that the first window reads.
    lost = dict(_lose(piped, node))
    sid0 = min(piped.stripes)
    down = frozenset({lost[sid0]})
    plan = piped.engine.planner.multi_plan(down)
    group = [sid for sid in sorted(piped.stripes)
             if piped._down_blocks(sid) == down]
    first = group[:launch_step(piped.cfg, len(plan.reads), 4)]
    victim = piped._block_path(sid0, plan.reads[0])
    victim.write_bytes(victim.read_bytes()[:-1])
    with pytest.raises(ValueError, match="bytes"):
        piped.repair_all(options=RepairOptions(pipeline=True))
    assert not any(piped._block_path(sid, lost[sid]).exists()
                   for sid in first)
    assert STAGING.idle() <= 3


def test_read_block_into_a_slot(tmp_path):
    """``_read_block(out=...)`` fills its slot byte for byte and touches
    nothing around it; a file of another size raises ``ValueError``; a
    missing file still raises ``OSError``, the pipeline's node failure."""
    store = _build(tmp_path, "port", stripes=2)
    B = store.cfg.block_size
    want = np.fromfile(store._block_path(1, 3), np.uint8)
    buf = np.full(3 * B, 0xA5, np.uint8)
    got = store._read_block(1, 3, out=buf[B:2 * B])
    assert np.shares_memory(got, buf)
    assert np.array_equal(buf[B:2 * B], want)
    assert (buf[:B] == 0xA5).all() and (buf[2 * B:] == 0xA5).all()
    assert store.telemetry.blocks_read == 1
    assert store.telemetry.bytes_read == B

    path = store._block_path(1, 4)
    path.write_bytes(path.read_bytes()[:B // 2])
    with pytest.raises(ValueError):
        store._read_block(1, 4, out=buf[:B])
    path.write_bytes(bytes(B + 1))
    with pytest.raises(ValueError):
        store._read_block(1, 4, out=buf[:B])
    store._block_path(1, 5).unlink()
    with pytest.raises(OSError):
        store._read_block(1, 5, out=buf[:B])
    assert store.telemetry.blocks_read == 1
    # A surviving block gone missing fails the window's reads as a node
    # failure would: the pipeline replans, and raises IOError, not
    # ValueError, when the block stays missing.
    store = _build(tmp_path / "missing", "port", stripes=2)
    store.fail_node(store.stripes[0].node_of_block[0])
    plan = store.engine.planner.multi_plan(store._down_blocks(0))
    store._block_path(0, plan.reads[0]).unlink()
    with pytest.raises(IOError, match="re-plan"):
        store.repair_all(options=RepairOptions(pipeline=True))


def test_staging_pool_reuses_rounds_and_bounds(monkeypatch):
    """A pool hands back a released buffer that fits, sizes new buffers
    to the largest request seen (a power of two), keeps at most three
    idle, and gives plain buffers once page-locking fails."""
    pool = StagingPool()
    a, reused = pool.acquire(3000, False)
    assert not reused and a.capacity == 4096 and not a.pinned
    pool.release(a)
    b, reused = pool.acquire(1000, False)
    assert reused and b is a
    c, reused = pool.acquire(4000, False)
    assert not reused and c.capacity == 4096     # the largest seen
    held = [pool.acquire(5000, False)[0] for _ in range(3)]
    assert all(h.capacity == 8192 for h in held)
    for buf in (b, c, *held):
        pool.release(buf)
    assert pool.idle() == 3
    assert all(pool.acquire(8192, False)[1] for _ in range(3))

    def no_pinning(*args, pin_memory=False, **kwargs):
        if pin_memory:
            raise RuntimeError("no page-locked memory")
        return torch.empty(*args, **kwargs)

    monkeypatch.setattr(torch, "empty", no_pinning)
    d, reused = pool.acquire(100, True)
    assert not reused and not d.pinned
    pool.release(d)
    assert pool.acquire(100, True) == (d, True)


def test_plan_gather_views_one_backing_buffer():
    """With ``out``, every shard's buffer is the view of its stripe range
    of the batch laid out in ``out``; a degraded batch is one view."""
    from repro_torch.dist import make_mesh, plan_gather, with_rules

    shape = (8, 3, 16)
    out = np.zeros(2 * np.prod(shape), np.uint8)
    with with_rules(make_mesh((4, 1), ("data", "model"),
                              devices=("cpu",) * 4)) as mr:
        layout, parts = plan_gather(shape, mr, None, out=out)
    assert layout is not None and len(parts) == 4
    for part in parts:
        assert np.shares_memory(part.buf, out)
        part.buf[...] = part.lo + 1
    batch = out[:np.prod(shape)].reshape(shape)
    for part in parts:
        assert (batch[part.lo:part.hi] == part.lo + 1).all()
    assert not out[np.prod(shape):].any()
    layout, parts = plan_gather((5, 3, 16), None, None, out=out)
    assert layout is None and parts[0].buf.shape == (5, 3, 16)
    assert np.shares_memory(parts[0].buf, out)
