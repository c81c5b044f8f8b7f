"""Twin stores: the reference's and the port's, driven through the same
operations, must leave byte-identical block files and manifests and report
the same counts. The port runs on the CPU here (``device="cpu"``)."""
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.ftx.fleet import repair_failed_nodes as ref_repair  # noqa: E402
from repro.ftx.options import RepairOptions as RefOptions  # noqa: E402
from repro.ftx.stripestore import StoreConfig as RefConfig  # noqa: E402
from repro.ftx.stripestore import StripeStore as RefStore  # noqa: E402
from repro_torch.convert import from_reference  # noqa: E402
from repro_torch.ftx import (RepairOptions, StoreConfig,  # noqa: E402
                             StripeStore, read_report, repair_failed_nodes)

ROOT = Path(__file__).resolve().parent.parent
REPORT_COUNTS = ("failed_nodes", "stripes_repaired", "patterns", "launches",
                 "devices", "device_launches", "windows", "replans",
                 "pipelined", "blocks_read", "bytes_read", "repairs_local",
                 "repairs_global", "plan_cache", "effective_backend",
                 "local_reads", "remote_reads", "gather_bytes_per_shard",
                 "schedule", "scheduled_local_read_fraction",
                 "contiguous_local_read_fraction", "destinations",
                 "blocks_relocated")


def _twins(tmp_path, rng, *, backend, objects=10, **cfg):
    args = dict(scheme="cp-azure", k=6, r=2, p=2, block_size=1024,
                backend=backend, **cfg)
    ref = RefStore(tmp_path / "ref", RefConfig(**args))
    port = StripeStore(tmp_path / "port", StoreConfig(**args), device="cpu")
    blobs = {}
    for i in range(objects):
        blob = rng.integers(0, 256, int(rng.integers(50, 9000)),
                            dtype=np.uint8)
        blobs[f"o{i}"] = blob
        for st in (ref, port):
            st.put(f"o{i}", blob.tobytes() if i % 2 else blob)
    for st in (ref, port):
        st.seal()
        st.save_manifest()
    return ref, port, blobs


def _assert_same_disk(ref, port):
    ref_files = sorted(p.relative_to(ref.root)
                       for p in ref.root.glob("node*/*.blk"))
    port_files = sorted(p.relative_to(port.root)
                        for p in port.root.glob("node*/*.blk"))
    assert ref_files == port_files and ref_files
    for rel in ref_files:
        assert (ref.root / rel).read_bytes() == (port.root / rel).read_bytes()
    assert (ref.root / "manifest.json").read_bytes() == \
        (port.root / "manifest.json").read_bytes()


def _assert_same_report(got, want):
    for f in REPORT_COUNTS:
        assert getattr(got, f) == getattr(want, f), f
    assert got.sim_seconds == pytest.approx(want.sim_seconds, rel=1e-9)


@pytest.mark.parametrize("nodes,pipeline,schedule,backend", [
    ((1,), True, "global", "gf"),
    ((1,), False, "none", "ref"),
    ((1, 2), True, "none", "ref"),
    ((1, 2), False, "global", "gf"),
    ((1,), True, "global", "crs"),
    ((1,), False, "none", "crs"),
    ((1, 2), True, "none", "crs"),
    ((1, 2), False, "global", "crs"),
    ((1,), True, "none", "mxu"),
    ((1,), False, "global", "mxu"),
    ((1, 2), True, "global", "mxu"),
    ((1, 2), False, "none", "mxu"),
])
def test_twin_stores_repair_identically(nodes, pipeline, schedule, backend,
                                        tmp_path, rng):
    ref, port, blobs = _twins(tmp_path, rng, backend=backend,
                              pipeline_window=2)
    _assert_same_disk(ref, port)
    # Wipe the lost blocks so the files can only come back through repair.
    for st in (ref, port):
        for path in st.root.glob("node*/*.blk"):
            if int(path.parent.name[4:]) in nodes:
                path.write_bytes(b"")
    want = ref_repair(ref, nodes, options=RefOptions(pipeline=pipeline,
                                                     schedule=schedule))
    got = repair_failed_nodes(port, nodes, device="cpu",
                              options=RepairOptions(pipeline=pipeline,
                                                    schedule=schedule))
    _assert_same_report(got, want)
    # gf and ref run the plain table path on the CPU; crs and mxu their own.
    assert got.effective_backend == ("ref" if backend in ("gf", "ref")
                                     else backend)
    assert got.stripes_repaired == len(port.stripes) and got.launches > 0
    assert got.pipelined == pipeline
    for st in (ref, port):
        st.save_manifest()
    _assert_same_disk(ref, port)
    for key, blob in blobs.items():
        assert (port.get(key) == blob).all()


@pytest.mark.parametrize("nodes,backend", [
    pytest.param((3,), "ref", id="nodes0"),
    pytest.param((3, 4), "ref", id="nodes1"),
    pytest.param((3,), "crs", id="nodes0-crs"),
    pytest.param((3, 4), "crs", id="nodes1-crs"),
    pytest.param((3,), "mxu", id="nodes0-mxu"),
    pytest.param((3, 4), "mxu", id="nodes1-mxu"),
])
def test_twin_stores_serve_degraded_identically(nodes, backend, tmp_path,
                                                rng):
    ref, port, blobs = _twins(tmp_path, rng, backend=backend)
    for st in (ref, port):
        for node in nodes:
            st.fail_node(node)
    for key, blob in blobs.items():
        got, want = port.get(key), ref.get(key)
        assert (got == want).all() and (got == blob).all()
    for sid, stripe in sorted(port.stripes.items()):
        for b, node in enumerate(stripe.node_of_block):
            if node in nodes:
                got = port.read(sid, b)
                assert (got == ref.read(sid, b)).all()
                assert (port.read_range(sid, b, 5, 900)
                        == ref.read_range(sid, b, 5, 900)).all()
    g, w = read_report(port), read_report(ref)
    for f in ("direct_reads", "degraded_reads", "coalesced_reads",
              "decode_launches", "local_decodes", "global_decodes",
              "replans", "cache_hits", "cache_misses", "cache_invalidations",
              "served_bytes", "blocks_read", "bytes_read"):
        assert getattr(g, f) == getattr(w, f), f
    assert port.telemetry.sim_seconds == pytest.approx(
        ref.telemetry.sim_seconds, rel=1e-9)
    assert port.engine.effective_backend == ref.engine.effective_backend \
        == backend


@pytest.mark.parametrize("backend", ["ref", "gf"])
@pytest.mark.parametrize("down", [1, 2])
def test_twin_stores_hedged_reads_identically(backend, down, tmp_path, rng):
    """``StoreConfig(hedge=2)``: a degraded ``get`` ranks the single
    repairs whose sources live by the simulated node latencies (the hedged
    path of ``_pick_single_plan``) and falls back to a multi-block plan when
    none lives (``down=2`` fails two blocks of one local group). Bytes,
    read counts and simulated seconds agree with the reference's. In every
    scheme a data block has one single-repair candidate, so the ranking
    picks among one: no choice of it shows in what ``get`` returns, in
    either package."""
    ref, port, blobs = _twins(tmp_path, rng, backend=backend, hedge=2)
    assert ref.latency_ms == port.latency_ms
    nodes = ref.stripes[0].node_of_block[:down]
    for st in (ref, port):
        for node in nodes:
            st.fail_node(node)
    for key, blob in blobs.items():
        got, want = port.get(key), ref.get(key)
        assert (got == want).all() and (got == blob).all()
    g, w = read_report(port), read_report(ref)
    for f in ("direct_reads", "degraded_reads", "coalesced_reads",
              "decode_launches", "local_decodes", "global_decodes",
              "replans", "cache_hits", "cache_misses", "served_bytes",
              "blocks_read", "bytes_read"):
        assert getattr(g, f) == getattr(w, f), f
    assert port.telemetry.blocks_read == ref.telemetry.blocks_read > 0
    assert port.telemetry.sim_seconds == pytest.approx(
        ref.telemetry.sim_seconds, rel=1e-9)


def test_manifest_round_trip_and_from_reference(tmp_path, rng):
    ref, port, blobs = _twins(tmp_path, rng, backend="ref")
    doc = json.loads((ref.root / "manifest.json").read_text())
    carried = from_reference(doc, root=ref.root, device="cpu")
    loaded = StripeStore.load(port.root, device="cpu")
    for st in (carried, loaded):
        assert st.cfg == port.cfg and st.device.type == "cpu"
        assert {s: v.node_of_block for s, v in st.stripes.items()} == \
            {s: v.node_of_block for s, v in ref.stripes.items()}
        st.fail_node(2)
        for key, blob in blobs.items():
            assert (st.get(key) == blob).all()
    with pytest.raises(ValueError, match="root"):
        from_reference(doc)
    with pytest.raises(TypeError):
        from_reference(42)


def test_store_default_backend_and_device_argument(tmp_path, monkeypatch):
    monkeypatch.delenv("REPRO_BACKEND", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert StoreConfig().backend == RefConfig().backend == "ref"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert StoreConfig().backend == "gf"          # the kernel on a card
    monkeypatch.setenv("REPRO_BACKEND", "ref")
    assert StoreConfig().backend == "ref"
    assert "device" not in StoreConfig.__dataclass_fields__
    assert list(StoreConfig.__dataclass_fields__) == \
        list(RefConfig.__dataclass_fields__)
    store = StripeStore(tmp_path, StoreConfig(k=6, block_size=64),
                        device="cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        repair_failed_nodes(store, [0], device="meta")


def test_smoke_store_counts_match_reference(tmp_path):
    """The store chip_smoke.py drives on the card (P5, 28 nodes, 64
    stripes), at a tiny block size: the reference and the port report the
    counts the smoke asserts."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    args = dict(scheme="cp-azure", k=24, r=2, p=2, block_size=64,
                backend="ref")
    ref = RefStore(tmp_path / "ref", RefConfig(**args))
    port = StripeStore(tmp_path / "port", StoreConfig(**args), device="cpu")
    zeros = np.zeros(smoke.STRIPES * 24 * 64, np.uint8)
    for st in (ref, port):
        st.put("x", zeros)
        st.seal()
        assert len(st.stripes) == smoke.STRIPES and st.num_nodes == 28
    for nodes, (patterns, reads, local, glob) in smoke.EXPECTED.items():
        want = ref_repair(ref, nodes)
        got = repair_failed_nodes(port, nodes, device="cpu")
        _assert_same_report(got, want)
        assert (got.patterns, got.blocks_read, got.repairs_local,
                got.repairs_global) == (patterns, reads, local, glob)
