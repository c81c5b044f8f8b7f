"""The block-serving front end and fleet expansion in the port, held to
the reference.

Twin stores (the reference's and the port's, same puts) must yield the
same Zipfian request streams and serve the same bytes through
``BlockServer`` with a node down; served sequentially they must also count
the same direct, degraded and coalesced reads, decode launches and cache
hits. ``expand`` must give the reference's new nodes, latencies,
manifest and later placements. The rest are the reference's own front-end
tests (``tests/test_degraded_read.py``) run on the port, and the
``--blocks`` command line. The port runs on the CPU here
(``device="cpu"``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.dist.topology import Topology as RefTopology  # noqa: E402
from repro.ftx import read_report as ref_read_report  # noqa: E402
from repro.ftx.stripestore import StoreConfig as RefConfig  # noqa: E402
from repro.ftx.stripestore import StripeStore as RefStore  # noqa: E402
from repro.serve.blocks import BlockServer as RefServer  # noqa: E402
from repro.serve.blocks import zipf_requests as ref_zipf  # noqa: E402
from repro_torch.dist.topology import Topology  # noqa: E402
from repro_torch.ftx import StoreConfig, StripeStore, read_report  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.serve import BlockServer, zipf_requests  # noqa: E402

REPORT_COUNTS = ("direct_reads", "degraded_reads", "coalesced_reads",
                 "decode_launches", "local_decodes", "global_decodes",
                 "cache_hits", "served_bytes", "coalescing_ratio",
                 "cache_hit_rate", "local_decode_fraction")


def _twins(tmp_path, *, scheme="cp-azure", backend="ref", stripes=12,
           block_size=256):
    args = dict(scheme=scheme, k=6, r=2, p=2, block_size=block_size,
                pipeline_window=0, backend=backend)
    ref = RefStore(tmp_path / "ref", RefConfig(**args))
    port = StripeStore(tmp_path / "port", StoreConfig(**args), device="cpu")
    payload = np.random.default_rng(7).integers(
        0, 256, stripes * 6 * block_size, dtype=np.uint8)
    for st in (ref, port):
        st.put("blob", payload.tobytes())
        st.seal()
        assert len(st.stripes) == stripes
    return ref, port


def _healthy(store):
    return {(sid, b): store.read(sid, b).tobytes()
            for sid in store.stripes for b in range(store.scheme.n)}


# ------------------------------------------------------- request streams
@pytest.mark.parametrize("num,alpha,seed,pool", [
    (500, 1.2, 9, "data"), (500, 1.2, 10, "data"), (100, 1.1, 0, "all"),
    (2000, 0.8, 3, "data")])
def test_zipf_requests_match_reference(tmp_path, num, alpha, seed, pool):
    ref, port = _twins(tmp_path)
    got = zipf_requests(port, num, alpha=alpha, seed=seed, block_pool=pool)
    assert got == ref_zipf(ref, num, alpha=alpha, seed=seed, block_pool=pool)


def test_zipf_requests_deterministic_and_skewed(tmp_path):
    _, store = _twins(tmp_path)
    a = zipf_requests(store, 500, alpha=1.2, seed=9)
    b = zipf_requests(store, 500, alpha=1.2, seed=9)
    assert a == b                            # same seed, same stream
    assert a != zipf_requests(store, 500, alpha=1.2, seed=10)
    assert all(0 <= blk < store.cfg.k for _, blk in a)   # data pool only
    counts = {}
    for key in a:
        counts[key] = counts.get(key, 0) + 1
    top = max(counts.values())
    assert top >= 5 * (500 / (len(store.stripes) * store.cfg.k))  # skew
    full = zipf_requests(store, 100, block_pool="all")
    assert any(blk >= store.cfg.k for _, blk in full)
    with pytest.raises(ValueError):
        zipf_requests(store, 10, block_pool="bogus")


# ------------------------------------------------------------ the server
@pytest.mark.parametrize("scheme,backend,nodes", [
    ("cp-azure", "ref", 1), ("cp-azure", "gf", 2), ("cp-uniform", "crs", 1),
    ("cp-uniform", "mxu", 2)])
def test_block_server_matches_reference(tmp_path, scheme, backend, nodes):
    """With one or two nodes down, both front ends serve the healthy bytes
    in request order; one client at a time, the stores count alike."""
    ref, port = _twins(tmp_path, scheme=scheme, backend=backend)
    truth = _healthy(port)
    assert truth == _healthy(ref)
    for st in (ref, port):
        for b in range(nodes):
            st.fail_node(st.stripes[0].node_of_block[b])
    requests = zipf_requests(port, 120, seed=4)
    read_report(port, reset=True)
    ref_read_report(ref, reset=True)
    got = BlockServer(port, clients=1).run(requests)
    want = RefServer(ref, clients=1).run(requests)
    assert [d.tobytes() for d in got] == [d.tobytes() for d in want] \
        == [truth[k] for k in requests]
    rep, ref_rep = read_report(port), ref_read_report(ref)
    for name in REPORT_COUNTS:
        assert getattr(rep, name) == getattr(ref_rep, name), name
    assert rep.degraded_reads > 0 and rep.decode_launches > 0
    # many clients: the same bytes, whatever the interleaving
    out = BlockServer(port, clients=6).run(requests)
    assert [d.tobytes() for d in out] == [truth[k] for k in requests]


def test_block_server_preserves_order_and_latency(tmp_path):
    _, store = _twins(tmp_path)
    truth = _healthy(store)
    store.fail_node(store.stripes[0].node_of_block[0])
    requests = zipf_requests(store, 64, seed=3)
    server = BlockServer(store, clients=4)
    out = server.run(requests)
    assert [d.tobytes() for d in out] == [truth[k] for k in requests]
    assert server.latency.snapshot()["count"] == len(requests)
    timed = server.run(requests[:8], timed=True)
    assert all(dt >= 0.0 for _, dt in timed)
    assert server.report().degraded_reads >= 0
    with pytest.raises(ValueError):
        BlockServer(store, clients=0)


def test_serve_blocks_cli(capsys):
    serve_cli.main(["--blocks", "--device", "cpu", "--requests", "200",
                    "--stripes", "8", "--clients", "4"])
    out = capsys.readouterr().out
    assert "200 reads (4 clients, cpu" in out and "latency p50" in out
    with pytest.raises(SystemExit) as exc:
        serve_cli.main(["--device", "cpu"])
    assert exc.value.code != 0
    assert "model scaffold" in capsys.readouterr().err
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            serve_cli.main(["--blocks", "--requests", "4", "--stripes", "1"])


# ------------------------------------------------------- fleet expansion
@pytest.mark.parametrize("policy", ["spread", "round_robin"])
def test_expand_matches_reference(tmp_path, policy):
    """New nodes join up and empty with the reference's latencies (the old
    prefix bit-identical), the manifest round-trips, and stripes placed
    after the expansion land where the reference puts them."""
    kw = dict(num_nodes=24, num_domains=12, spread_width=2, seed=7)
    args = dict(scheme="cp-azure", k=6, r=2, p=2, block_size=512,
                batch_stripes=8, pipeline_window=8, prefetch_threads=2,
                placement_policy=policy, backend="ref")
    ref = RefStore(tmp_path / "ref", RefConfig(**args), num_nodes=24,
                   topology=RefTopology(**kw))
    port = StripeStore(tmp_path / "port", StoreConfig(**args), num_nodes=24,
                       topology=Topology(**kw), device="cpu")
    payload = np.random.default_rng(3).integers(0, 256, 10 * 6 * 512,
                                                dtype=np.uint8)
    for st in (ref, port):
        st.put("blob", payload.tobytes())
        st.seal()
    before = dict(port.latency_ms)
    grow = dict(kw, num_nodes=26, num_domains=13)
    added = port.expand(Topology(**grow))
    assert added == ref.expand(RefTopology(**grow)) == [24, 25]
    assert {n: port.latency_ms[n] for n in before} == before
    assert port.latency_ms == ref.latency_ms
    assert port.num_nodes == 26 and all(
        port.nodes[n].name == "UP" for n in added)
    assert list(port.placement.shard_of_node) == \
        list(ref.placement.shard_of_node)
    with pytest.raises(ValueError):
        port.expand(Topology(num_nodes=24, num_domains=12))
    for st in (ref, port):
        st.put("more", payload[:4 * 6 * 512].tobytes())
        st.seal()
        st.save_manifest()
    assert (ref.root / "manifest.json").read_bytes() == \
        (port.root / "manifest.json").read_bytes()
    for path in sorted(ref.root.glob("node*/*.blk")):
        rel = path.relative_to(ref.root)
        assert (port.root / rel).read_bytes() == path.read_bytes(), rel
    loaded = StripeStore.load(port.root, device="cpu")
    assert loaded.num_nodes == 26 and loaded.topology == Topology(**grow)
    assert loaded.latency_ms == port.latency_ms
    assert np.array_equal(loaded.get("more"), payload[:4 * 6 * 512])
