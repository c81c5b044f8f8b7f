"""Erasure-coded checkpointing in the port, held to the reference.

Twin managers — the reference's and the port's — save the same seeded
state: their step directories must hold byte-identical block files and
store manifests, and ``ckpt_meta.json`` must agree on every field but the
timings. A checkpoint written by either package restores in the other,
after host loss, on every backend. The flattener lays leaves out in the
reference's order under its dtype names, for torch tensors, numpy arrays
and Python scalars. The rest are the reference's own checkpoint tests
(``tests/test_checkpoint.py``) run on the port. The port runs on the CPU
here (``device="cpu"``)."""
import collections
import hashlib
import json

import jax
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.ftx.checkpoint import CheckpointConfig as RefCkptConfig  # noqa: E402
from repro.ftx.checkpoint import CheckpointManager as RefManager  # noqa: E402
from repro.ftx.checkpoint import _flatten_bytes as ref_flatten  # noqa: E402
from repro.ftx.checkpoint import _unflatten_bytes as ref_unflatten  # noqa: E402
from repro.ftx.pipeline import EncodePipeline as RefEncodePipeline  # noqa: E402
from repro.ftx.stripestore import StoreConfig as RefConfig  # noqa: E402
from repro.ftx.stripestore import StripeStore as RefStore  # noqa: E402
from repro_torch.convert import state_from_reference  # noqa: E402
from repro_torch.ftx import (CheckpointConfig, CheckpointManager,  # noqa: E402
                             EncodePipeline, StoreConfig, StripeStore)
from repro_torch.ftx.checkpoint import (_flatten_bytes,  # noqa: E402
                                        _unflatten_bytes)

BACKENDS = ("ref", "gf", "crs", "mxu")
# The fields of ckpt_meta.json that are wall-clock readings.
TIMINGS = ("overlap_fraction",)


def _state(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((96, 64)).astype(np.float32),
            "opt": {"m": rng.standard_normal(257).astype(np.float64),
                    "v": rng.integers(0, 255, 1000, np.uint8)},
            "step": np.int64(41)}


def _store_args(scheme="cp-azure", backend=None):
    over = {} if backend is None else {"backend": backend}
    return dict(scheme=scheme, k=6, r=2, p=2, block_size=2048, **over)


def _twin_cfgs(scheme="cp-azure", backend=None, **kw):
    args = _store_args(scheme, backend)
    return (RefCkptConfig(store=RefConfig(**args), encode_window=2, **kw),
            CheckpointConfig(store=StoreConfig(**args), encode_window=2,
                             **kw))


def _cfg(scheme="cp-azure", backend=None, **kw):
    return _twin_cfgs(scheme, backend, **kw)[1]


def _manager(root, cfg=None):
    return CheckpointManager(root, cfg or _cfg(), device="cpu")


def _assert_tree_equal(got, want):
    """``got`` (the port's restore: CPU tensors) holds ``want``'s leaves
    (numpy arrays or tensors) with the same dtype names, shapes and
    bytes, in the same nesting."""
    assert jax.tree.structure(got) == jax.tree.structure(want)
    _, got_meta = _flatten_bytes(got)
    _, want_meta = _flatten_bytes(want)
    assert got_meta == want_meta
    for x, y in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
        assert _flatten_bytes(x)[0].tobytes() == _flatten_bytes(y)[0].tobytes()


def _disk(step_dir):
    """Every block file's hash by path, and the store manifest."""
    blocks = {p.relative_to(step_dir).as_posix():
              hashlib.sha256(p.read_bytes()).hexdigest()
              for p in sorted(step_dir.rglob("*.blk"))}
    return blocks, json.loads((step_dir / "manifest.json").read_text())


def _ckpt_meta(step_dir):
    """``ckpt_meta.json`` without its timing fields."""
    def strip(doc):
        return {k: strip(v) if isinstance(v, dict) else v
                for k, v in doc.items()
                if not k.endswith("_seconds") and k not in TIMINGS}
    return strip(json.loads((step_dir / "ckpt_meta.json").read_text()))


def _assert_same_checkpoint(a, b):
    blocks, manifest = _disk(a)
    assert blocks and (blocks, manifest) == _disk(b)
    assert _ckpt_meta(a) == _ckpt_meta(b)


# ------------------------------------------------------------ save identity

@pytest.mark.parametrize("backend", BACKENDS)
def test_twin_saves_bit_identical(tmp_path, backend):
    """sync, async and serial saves leave the reference's step directory,
    byte for byte, on every backend; the three modes' block files and
    manifests are the same."""
    state = _state()
    ref_cfg, cfg = _twin_cfgs(backend=backend)
    modes = {
        "sync": lambda cm: cm.save(5, state),
        "async": lambda cm: cm.save_async(5, state).result(),
        "serial": lambda cm: cm.save_async(5, state,
                                           pipelined=False).result()}
    for name, submit in modes.items():
        want = submit(RefManager(tmp_path / "ref" / name, ref_cfg))
        info = submit(_manager(tmp_path / name, cfg))
        assert info["step"] == 5 and info["stripes"] == want["stripes"] > 0
        assert info["encode"]["pipelined"] == (name != "serial")
        _assert_same_checkpoint(tmp_path / name / "step5",
                                tmp_path / "ref" / name / "step5")
    assert _disk(tmp_path / "serial" / "step5") == \
        _disk(tmp_path / "sync" / "step5")


@pytest.mark.parametrize("backend", BACKENDS)
def test_streamed_object_bit_identical_to_put(tmp_path, backend):
    """The streaming put path registers exactly what put+seal would have,
    and streams what the reference streams."""
    payload = np.random.default_rng(5).integers(
        0, 256, 6 * 2048 * 3 + 777, dtype=np.uint8)
    args = _store_args(backend=backend)
    packed = StripeStore(tmp_path / "packed", StoreConfig(**args),
                         device="cpu")
    packed.put("state", payload.tobytes())
    packed.seal()
    streamed = StripeStore(tmp_path / "streamed", StoreConfig(**args),
                           device="cpu")
    stream = streamed.stream_writer("state", len(payload))
    res = EncodePipeline(streamed, window=2).run(stream, payload)
    stream.close()
    ref = RefStore(tmp_path / "ref", RefConfig(**args))
    ref_stream = ref.stream_writer("state", len(payload))
    want = RefEncodePipeline(ref, window=2).run(ref_stream, payload)
    ref_stream.close()
    for name in ("windows", "launches", "devices", "device_launches"):
        assert getattr(res, name) == getattr(want, name), name
    assert stream.num_stripes == ref_stream.num_stripes == 4
    for st in (packed, streamed, ref):
        st.save_manifest()
    assert _disk(tmp_path / "streamed") == _disk(tmp_path / "packed") \
        == _disk(tmp_path / "ref")
    assert streamed.objects == packed.objects
    assert np.array_equal(streamed.get("state"), payload)


def test_stream_writer_contract(tmp_path):
    cfg = StoreConfig(scheme="cp-azure", k=6, r=2, p=2, block_size=1024)
    store = StripeStore(tmp_path / "s", cfg, device="cpu")
    stream = store.stream_writer("obj", 3 * 6 * 1024)
    assert stream.num_stripes == 3
    with pytest.raises(ValueError):           # not (S, n, B)
        stream.write_window(0, np.zeros((1, store.n, 512), np.uint8))
    with pytest.raises(ValueError):           # out of range
        stream.write_window(3, np.zeros((1, store.n, 1024), np.uint8))
    with pytest.raises(RuntimeError):         # unwritten stripes
        stream.close()
    allocated = set(store.stripes)
    stream.abort()
    assert not (allocated & set(store.stripes))
    # an open (put-buffered) stripe blocks streaming
    store.put("x", b"abc")
    with pytest.raises(RuntimeError):
        store.stream_writer("y", 10)


def test_snapshot_isolation(tmp_path):
    """Tensors (and arrays) mutated after save_async returns do not leak
    into the checkpoint: the snapshot was taken before the call returned."""
    want = _state()
    state = state_from_reference(want, device="cpu")
    state["opt"]["v"] = want["opt"]["v"].copy()       # a numpy leaf too
    cm = _manager(tmp_path)
    fut = cm.save_async(3, state)
    state["w"].fill_(-1.0)
    state["opt"]["m"].zero_()
    state["opt"]["v"][:] = 0
    fut.result()
    got, _ = cm.restore(3, state)
    _assert_tree_equal(got, want)


# ------------------------------------------------- degraded restore parity

@pytest.mark.parametrize("scheme", ["cp-azure", "cp-uniform"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_restore_after_host_loss_parity(tmp_path, scheme, backend):
    """Parallel and serial degraded restores equal the state, and the
    parallel one reads and decodes what the reference's does."""
    state = _state(seed=3)
    ref_cfg, cfg = _twin_cfgs(scheme=scheme, backend=backend)
    ref_cm = RefManager(tmp_path / "ref", ref_cfg)
    ref_cm.save(7, state)
    ref_cm.fail_hosts(7, [1, 2])
    _, want = ref_cm.restore(7, state)
    cm = _manager(tmp_path / "port", cfg)
    cm.save(7, state_from_reference(state, device="cpu"))
    cm.fail_hosts(7, [1, 2])
    par, tele = cm.restore(7, state)
    ser, _ = cm.restore(7, state, parallel=False)
    _assert_tree_equal(par, ser)
    _assert_tree_equal(par, state)
    assert tele["parallel"] and tele["degraded_blocks"] > 0
    assert tele["restore_decode_launches"] > 0
    # live data sources come from the restore buffer: only the plans'
    # extra (parity) sources hit disk on top of the healthy gather
    assert tele["extra_source_reads"] < tele["blocks_read"]
    for name in ("blocks_read", "bytes_read", "degraded_blocks",
                 "restore_decode_launches", "extra_source_reads"):
        assert tele[name] == want[name], name
    assert tele["sim_seconds"] == pytest.approx(want["sim_seconds"],
                                                rel=1e-9)


@pytest.mark.parametrize("backend", BACKENDS)
def test_restore_across_packages(tmp_path, backend):
    """A reference-written checkpoint restores in the port, and a
    port-written one in the reference, after two hosts are lost."""
    state = _state(seed=8)
    ref_cfg, cfg = _twin_cfgs(backend=backend)
    RefManager(tmp_path / "ref", ref_cfg).save(2, state)
    _manager(tmp_path / "port", cfg).save(
        2, state_from_reference(state, device="cpu"))
    port_reader = _manager(tmp_path / "ref", cfg)
    port_reader.fail_hosts(2, [0, 3])
    for parallel in (True, False):
        got, tele = port_reader.restore(2, state, parallel=parallel)
        _assert_tree_equal(got, state)
    assert tele["blocks_read"] > 0
    ref_reader = RefManager(tmp_path / "port", ref_cfg)
    ref_reader.fail_hosts(2, [0, 3])
    got, tele = ref_reader.restore(2, state)
    assert tele["degraded_blocks"] > 0
    assert jax.tree.structure(got) == jax.tree.structure(state)
    for x, y in zip(jax.tree.leaves(got), jax.tree.leaves(state)):
        assert x.dtype == np.asarray(y).dtype
        assert np.array_equal(x, y)


def test_healthy_parallel_restore_reads_each_needed_block_once(tmp_path):
    state = _state(seed=4)
    cm = _manager(tmp_path)
    info = cm.save(9, state)
    store = cm.store_for(9)
    before = store.telemetry.copy()
    got, tele = cm.restore(9, state)
    _assert_tree_equal(got, state)
    assert tele["degraded_blocks"] == 0
    assert store.telemetry.bytes_read - before.bytes_read == info["bytes"]
    k, B = cm.cfg.store.k, cm.cfg.store.block_size
    assert tele["blocks_read"] == -(-info["bytes"] // B) <= \
        info["stripes"] * k


def test_repair_after_host_loss_matches_reference(tmp_path):
    """``repair`` rebuilds the lost hosts' blocks as the reference does:
    the same files and the same counts."""
    state = _state(seed=2)
    ref_cfg, cfg = _twin_cfgs()
    ref_cm = RefManager(tmp_path / "ref", ref_cfg)
    cm = _manager(tmp_path / "port", cfg)
    for m in (ref_cm, cm):
        m.save(1, state)
        for p in (m.root / "step1").glob("node[14]/*.blk"):
            p.write_bytes(b"")               # only repair brings them back
        m.fail_hosts(1, [1, 4])
    want, got = ref_cm.repair(1), cm.repair(1)
    for name in ("blocks_read", "bytes_read", "stripes_repaired", "patterns",
                 "launches", "repairs_local", "repairs_global"):
        assert got[name] == want[name], name
    assert _disk(tmp_path / "port" / "step1")[0] == \
        _disk(tmp_path / "ref" / "step1")[0]
    restored, _ = cm.restore(1, state)
    _assert_tree_equal(restored, state)


# ------------------------------------------------------- crash consistency

def test_crash_mid_save_preserves_previous_checkpoint(tmp_path):
    state = _state()
    cm = _manager(tmp_path)
    cm.save(1, state)

    def boom(stage, index):
        if stage == "drain" and index >= 1:
            raise RuntimeError("disk died mid-save")

    fut = cm.save_async(2, _state(seed=9), hook=boom)
    err = fut.exception()
    assert isinstance(err, RuntimeError)
    with pytest.raises(RuntimeError):
        fut.result()
    # the failed save left nothing: no step2, no staging dir
    assert cm.available() == [1]
    assert not (tmp_path / "step2.tmp").exists()
    assert not (tmp_path / "step2").exists()
    got, _ = cm.restore(1, state)
    _assert_tree_equal(got, state)
    # the manager recovers: the next save of the same step succeeds
    cm.save(2, state)
    assert cm.available() == [1, 2]


def test_init_sweeps_orphaned_save_debris(tmp_path):
    state = _state()
    cm = _manager(tmp_path)
    cm.save(4, state)
    # simulate a hard crash: a staging dir and a meta-less step dir
    (tmp_path / "step9.tmp" / "node0").mkdir(parents=True)
    (tmp_path / "step9.tmp" / "node0" / "s0_b0.blk").write_bytes(b"junk")
    (tmp_path / "step7").mkdir()
    (tmp_path / "step7" / "manifest.json").write_text("{}")
    cm2 = _manager(tmp_path)
    assert cm2.available() == [4]
    assert not (tmp_path / "step9.tmp").exists()
    assert not (tmp_path / "step7").exists()
    got, _ = cm2.restore(4, state)
    _assert_tree_equal(got, state)


def test_retention_under_interleaved_async_saves(tmp_path):
    state = _state()
    cm = _manager(tmp_path, _cfg(keep=2))
    futs = [cm.save_async(step, state) for step in (1, 2, 3, 4, 5)]
    infos = [f.result() for f in futs]
    assert [i["step"] for i in infos] == [1, 2, 3, 4, 5]
    assert cm.available() == [4, 5]
    assert sorted(p.name for p in tmp_path.glob("step*")) == \
        ["step4", "step5"]
    got, _ = cm.restore(5, state)
    _assert_tree_equal(got, state)


def test_available_ignores_junk_entries(tmp_path):
    cm = _manager(tmp_path)
    cm.save(11, _state())
    (tmp_path / "stepXYZ").mkdir()          # junk that is not a checkpoint
    (tmp_path / "step12.tmp").mkdir()
    assert cm.available() == [11]


def test_encode_telemetry_shape(tmp_path):
    cm = _manager(tmp_path)
    info = cm.save(1, _state())
    enc = info["encode"]
    assert enc["windows"] >= 2 and enc["launches"] == enc["windows"]
    assert 0.0 <= enc["overlap_fraction"] <= 1.0
    assert info["snapshot_seconds"] < info["encode_seconds"]


def test_manager_runs_on_the_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        assert CheckpointManager(tmp_path).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            CheckpointManager(tmp_path)
    assert CheckpointConfig().store == StoreConfig(k=8, r=2, p=2,
                                                   block_size=1 << 18)


# ------------------------------------------- leaf order and dtype names

Pair = collections.namedtuple("Pair", "first second")


def _trees():
    rng = np.random.default_rng(11)
    bf16 = rng.standard_normal((3, 5)).astype(ml_dtypes.bfloat16)
    return {
        "dict": {"b": rng.standard_normal(7).astype(np.float32),
                 "a": rng.integers(0, 9, (2, 3)), "c": np.bool_(True)},
        "ordered": collections.OrderedDict(
            [("z", np.arange(4, dtype=np.int16)),
             ("a", rng.standard_normal((2, 2)))]),
        "nested": [(np.float32(2.5), [np.zeros((0, 4), np.int32), None]),
                   (np.arange(3, dtype=np.uint8),), None],
        "scalars": {"i": 41, "f": 0.25, "t": True, "n": None,
                    "u": np.uint16(7)},
        "bf16": {"p": bf16, "s": np.asarray(1.5, ml_dtypes.bfloat16),
                 "m": rng.standard_normal((3, 5)).astype(np.float32)},
        "named": Pair(np.int64(3), {"y": np.float16(1.0), "x": [1, 2]}),
    }


@pytest.mark.parametrize("kind", sorted(_trees()))
def test_flatten_matches_reference(kind):
    """Leaf order, dtype names, shapes and bytes are the reference's, for
    numpy leaves and for the same state as torch tensors; unflattening
    rebuilds the reference's nesting."""
    tree = _trees()[kind]
    want_flat, want_meta = ref_flatten(tree)
    for state in (tree, state_from_reference(tree, device="cpu")):
        flat, meta = _flatten_bytes(state)
        assert meta == want_meta
        assert flat.tobytes() == want_flat.tobytes()
    got = _unflatten_bytes(tree, want_flat, want_meta)
    want = ref_unflatten(tree, want_flat, want_meta)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for x, y in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert isinstance(x, torch.Tensor) and list(x.shape) == list(y.shape)
        assert _flatten_bytes(x)[0].tobytes() == y.tobytes()


def test_module_state_dict_keeps_insertion_order(tmp_path):
    """A torch module's state_dict (an OrderedDict, keys not sorted)
    checkpoints in insertion order, as the reference lays out the same
    OrderedDict of numpy arrays; restore hands back its keys and tensors."""
    torch.manual_seed(0)
    net = torch.nn.Sequential(torch.nn.Linear(5, 3), torch.nn.ReLU(),
                              torch.nn.Linear(3, 2, bias=False))
    state = {"model": net.state_dict(), "step": 12}
    ref_state = {"model": collections.OrderedDict(
        (k, v.numpy()) for k, v in net.state_dict().items()), "step": 12}
    flat, meta = _flatten_bytes(state)
    want_flat, want_meta = ref_flatten(ref_state)
    assert meta == want_meta and flat.tobytes() == want_flat.tobytes()
    cm = _manager(tmp_path)
    cm.save(1, state)
    got, _ = cm.restore(1, state)
    assert list(got["model"]) == list(net.state_dict())
    _assert_tree_equal(got, state)


def test_state_from_reference_keeps_nesting_dtypes_and_bytes():
    tree = _trees()["bf16"] | {"rest": _trees()["nested"]}
    got = state_from_reference(tree, device="cpu")
    assert jax.tree.structure(got) == jax.tree.structure(tree)
    assert got["p"].dtype == torch.bfloat16 and got["s"].shape == ()
    for x, y in zip(jax.tree.leaves(got), jax.tree.leaves(tree)):
        assert isinstance(x, torch.Tensor)
        assert _flatten_bytes(x)[0].tobytes() == np.asarray(y).tobytes()
