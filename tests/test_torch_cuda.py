"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips without a card. The file
imports neither JAX nor the reference, so it runs on a machine with
PyTorch built for CUDA and ``nvcc`` alone:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The kernels build at first use into ``src/repro_torch/_build/``. Erasure
coding is exact: every comparison is byte for byte.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import bitmatrix_encode as bme  # noqa: E402
from repro_torch.kernels import gf256_matmul as gm  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

pytestmark = pytest.mark.cuda

# tests/test_kernels.py's (m, k, B) sweep.
GF_SHAPES = [(2, 4, 128), (4, 6, 256), (8, 24, 512), (9, 96, 128),
             (3, 17, 384)]
# The GF(2^8) kernel's edges, (S, m, k, B): k past its 64-row table chunk;
# m off its 1/2/4/8-row tiles and past 8 (m = k = 24: a full decode); S=1
# at the seal's B = 1 MiB (one wave of warps), even and ragged; more
# (stripe, m tile) pairs than a grid's 65535 rows at a small B.
GF_EDGES = [(3, 4, 65, 4096), (2, 2, 257, 1000), (1, 9, 300, 4096 + 13),
            (7, 3, 24, 4096), (7, 9, 24, 4096), (3, 16, 24, 4096),
            (3, 24, 24, 4096 + 13), (1, 4, 24, 1 << 20),
            (1, 4, 24, (1 << 20) + 13), (66000, 1, 3, 32),
            (22000, 24, 2, 16)]
# (R8, K8, P): repair-window, seal and decode widths of the P5 store at a
# small P, ragged ones, and a deep bitmatrix at a wider P; then the mod-2
# kernel's edges: K8 not a multiple of its 32-deep k step (40, 104), R8 not
# a multiple of its 16-row groups (24, 40), enough (stripe, 32-byte tile)
# work items at S=64 to pass one wave of its persistent grid (P=16384),
# and a bitmatrix too deep for its fragments to stay in shared memory;
# then a K8 smaller than the select-and-XOR kernel's K slices.
BIT_SHAPES = [(8, 16, 64), (16, 104, 40), (32, 192, 33), (24, 40, 7),
              (192, 192, 16), (8, 768, 4096), (16, 96, 4096 + 5),
              (24, 104, 4096), (40, 40, 4096), (40, 104, 300),
              (16, 192, 16384), (24, 2056, 64), (32, 3, 4096)]
# The select-and-XOR kernel's split-K edges at S=1, where it splits K8
# over the most warps: (kind, R8, K8, P) with kind "zero" (every row zero:
# an empty compact list), "sparse" (three live columns: slices left
# empty) or "random", and a wide P (a reduction in every block).
BIT_EDGES = [("zero", 32, 192, 131072), ("sparse", 32, 192, 131072),
             ("random", 32, 192, 131072), ("sparse", 16, 104, 4096),
             ("random", 8, 3, 4096 + 5)]
BIT_WRAPPERS = {
    "bitmatrix_encode": (bme.bitmatrix_encode, bme.bitmatrix_encode_batched,
                         ref.bitmatrix_encode_ref,
                         ref.bitmatrix_encode_batched_ref),
    "mod2_matmul_encode": (bme.mod2_matmul_encode,
                           bme.mod2_matmul_encode_batched,
                           ref.mod2_matmul_encode_ref,
                           ref.mod2_matmul_encode_batched_ref),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    return torch.device("cuda", 0)


def _u8(rng, shape, device, high=256):
    return torch.from_numpy(rng.integers(0, high, shape, dtype=np.uint8)
                            ).to(device)


@pytest.mark.parametrize("m,k,b", GF_SHAPES)
@pytest.mark.parametrize("s,ragged", [(1, 0), (7, 13), (64, 1)])
def test_cuda_gf_kernel_matches_plain_version(cuda, m, k, b, s, ragged,
                                              rng):
    c = _u8(rng, (m, k), cuda)
    c[0] = 0                                     # an all-zero row
    d = _u8(rng, (s, k, b + ragged), cuda)
    before = gm.gf256_matmul_batched.launches
    got = gm.gf256_matmul_batched(c, d)
    want = ref.gf256_matmul_batched_ref(c, d)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert gm.gf256_matmul_batched.launches == before + 1
    flat = gm.gf256_matmul(c, d[0])
    torch.cuda.synchronize()
    assert torch.equal(flat, want[0])


@pytest.mark.parametrize("s,m,k,b", GF_EDGES)
def test_cuda_gf_kernel_at_its_edges(cuda, s, m, k, b, rng):
    c = _u8(rng, (m, k), cuda)
    c[0] = 0                                     # an all-zero row
    if m > 1:
        c[1] = 0
        c[1, k // 2] = 1                         # a one-hot row
    d = _u8(rng, (s, k, b), cuda)
    got = gm.gf256_matmul_batched(c, d)
    want = ref.gf256_matmul_batched_ref(c, d)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    if s == 1:
        flat = gm.gf256_matmul(c, d[0])
        torch.cuda.synchronize()
        assert torch.equal(flat, want[0])


@pytest.mark.parametrize("kind", ["zero", "one", "onehot", "max"])
@pytest.mark.parametrize("s,b", [(1, 1 << 20), (16, 4096 + 13)])
def test_cuda_gf_kernel_with_coefficients_of_one_kind(cuda, kind, s, b, rng):
    """Every coefficient 0, every one 1, one 1 in each row, or every one
    0x8E, whose log (254) is the largest."""
    m, k = 4, 24
    c = torch.zeros((m, k), dtype=torch.uint8)
    if kind == "onehot":
        c[torch.arange(m), torch.arange(m)] = 1
    else:
        c[:] = {"zero": 0, "one": 1, "max": 0x8E}[kind]
    c = c.to(cuda)
    d = _u8(rng, (s, k, b), cuda)
    got = gm.gf256_matmul_batched(c, d)
    want = ref.gf256_matmul_batched_ref(c, d)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    if kind == "one":                            # XOR of the k rows
        x = d[:, 0].clone()
        for j in range(1, k):
            x ^= d[:, j]
        assert torch.equal(got[:, 0], x)


@pytest.mark.parametrize("s,m,k,b", [(7, 4, 24, 4096), (3, 9, 65, 1000),
                                     (1, 4, 24, 1 << 20)])
def test_cuda_gf_kernel_takes_pointers_off_alignment(cuda, s, m, k, b, rng):
    """data and out 1 byte off a 16-byte boundary, launched through the C
    interface since the wrappers allocate an aligned out."""
    c = _u8(rng, (m, k), cuda)
    d = _u8(rng, (s * k * b + 1,), cuda)[1:].view(s, k, b)
    out_buf = torch.zeros(s * m * b + 2, dtype=torch.uint8, device=cuda)
    out = out_buf[1:-1].view(s, m, b)
    assert d.data_ptr() % 16 == 1 and out.data_ptr() % 16 == 1
    err = gm._launcher()(c.data_ptr(), d.data_ptr(), out.data_ptr(),
                         gm._tables(cuda).data_ptr(), m, k, b, s,
                         torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    assert torch.equal(out, ref.gf256_matmul_batched_ref(c, d))
    assert int(out_buf[0]) == 0 and int(out_buf[-1]) == 0


@pytest.mark.parametrize("name", sorted(BIT_WRAPPERS))
@pytest.mark.parametrize("r8,k8,p", BIT_SHAPES)
@pytest.mark.parametrize("s", [1, 7, 64])
def test_cuda_bit_plane_kernel_matches_plain_version(cuda, name, r8, k8, p,
                                                     s, rng):
    bm = _u8(rng, (r8, k8), cuda, 2)
    bm[0] = 0                                    # an all-zero row
    bm[1] = 0
    bm[1, k8 // 2] = 1                           # a one-hot row
    pk = _u8(rng, (s, k8, p), cuda)
    flat, batched, flat_ref, batched_ref = BIT_WRAPPERS[name]
    before = (batched.launches, flat.launches)
    got = batched(bm, pk)
    want = batched_ref(bm, pk)
    flat_got = flat(bm, pk[0])
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(flat_got, flat_ref(bm, pk[0]))
    assert (batched.launches, flat.launches) == (before[0] + 1,
                                                 before[1] + 1)


@pytest.mark.parametrize("r8,k8,p", BIT_SHAPES)
def test_cuda_mod2_kernel_matches_select_and_xor_kernel(cuda, r8, k8, p,
                                                        rng):
    bm = _u8(rng, (r8, k8), cuda, 2)
    pk = _u8(rng, (7, k8, p), cuda)
    got = bme.mod2_matmul_encode_batched(bm, pk)
    want = bme.bitmatrix_encode_batched(bm, pk)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("kind,r8,k8,p", BIT_EDGES)
def test_cuda_bit_plane_kernels_at_split_k_edges(cuda, kind, r8, k8, p, rng):
    if kind == "random":
        bm = _u8(rng, (r8, k8), cuda, 2)
    else:
        bm = torch.zeros((r8, k8), dtype=torch.uint8, device=cuda)
        if kind == "sparse":
            bm[:, torch.from_numpy(rng.choice(k8, 3, replace=False))] = 1
    pk = _u8(rng, (1, k8, p), cuda)
    want = ref.bitmatrix_encode_batched_ref(bm, pk)
    got = bme.bitmatrix_encode_batched(bm, pk)
    flat = bme.bitmatrix_encode(bm, pk[0])
    mod2 = bme.mod2_matmul_encode_batched(bm, pk)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(flat, want[0])
    assert torch.equal(mod2, got)


@pytest.mark.parametrize("source,plain", [
    ("bitmatrix_encode", ref.bitmatrix_encode_batched_ref),
    ("mod2_matmul", ref.mod2_matmul_encode_batched_ref)])
@pytest.mark.parametrize("r8,k8,p", [(16, 192, 4096), (24, 40, 1000),
                                     (40, 104, 517)])
def test_cuda_bit_plane_kernels_take_pointers_off_alignment(cuda, source,
                                                            plain, r8, k8,
                                                            p, rng):
    """packets and out 1 byte off a 16-byte boundary (contiguous views of
    buffers sliced at 1), launched through the C interface since the
    wrappers allocate an aligned out."""
    s = 7
    bm = _u8(rng, (r8, k8), cuda, 2)
    pk = _u8(rng, (s * k8 * p + 1,), cuda)[1:].view(s, k8, p)
    out_buf = torch.zeros(s * r8 * p + 2, dtype=torch.uint8, device=cuda)
    out = out_buf[1:-1].view(s, r8, p)
    assert pk.data_ptr() % 16 == 1 and out.data_ptr() % 16 == 1
    err = bme._launcher(source)(bm.data_ptr(), pk.data_ptr(), out.data_ptr(),
                                r8, k8, p, s,
                                torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    assert torch.equal(out, plain(bm, pk))
    assert int(out_buf[0]) == 0 and int(out_buf[-1]) == 0


def test_cuda_packetize_round_trip(cuda, rng):
    blocks = _u8(rng, (3, 24, 8 * 1000), cuda)
    packets = ref.packetize_batched(blocks)
    cpu = ref.packetize_batched(blocks.cpu())
    assert torch.equal(packets.cpu(), cpu)
    assert torch.equal(ref.unpacketize_batched(packets), blocks)


@pytest.mark.parametrize("backend", ["gf", "crs", "mxu"])
def test_cuda_main_path_matches_cpu(cuda, backend, tmp_path, rng):
    """A store on the card and a store on the CPU, same operations: the
    same block files and the same report counts, and each report names
    the formulation that ran."""
    from repro_torch.ftx import StoreConfig, StripeStore, repair_failed_nodes

    cfg = StoreConfig(scheme="cp-azure", k=6, r=2, p=2, block_size=4096,
                      backend=backend)
    stores = [StripeStore(tmp_path / d.type, cfg, device=d)
              for d in (cuda, torch.device("cpu"))]
    for i in range(12):
        blob = rng.integers(0, 256, int(rng.integers(100, 30000)),
                            dtype=np.uint8)
        for st in stores:
            st.put(f"o{i}", blob)
    reports = []
    for st in stores:
        st.seal()
        reports.append(repair_failed_nodes(st, [1, 2], device=st.device))
    assert reports[0].effective_backend == backend
    assert reports[1].effective_backend == ("ref" if backend == "gf"
                                            else backend)
    assert reports[0].blocks_read == reports[1].blocks_read
    for f in sorted((tmp_path / "cuda").glob("node*/*.blk")):
        twin = tmp_path / "cpu" / f.relative_to(tmp_path / "cuda")
        assert f.read_bytes() == twin.read_bytes()


def test_cuda_p8_repair_counts_two_table_chunks_a_global_launch(cuda,
                                                                tmp_path,
                                                                rng):
    """The paper's widest stripe (k=96, r=5, p=4) on 105 nodes, one stripe
    on each of its 15 arcs, two adjacent nodes lost: the card rebuilds the
    CPU twin's block files, and the report counts the kernel's 64-row
    table chunks, two a launch of a 96-read plan."""
    from repro_torch.ftx import StoreConfig, StripeStore, repair_failed_nodes

    cfg = StoreConfig(scheme="cp-azure", k=96, r=5, p=4, block_size=4096,
                      backend="gf", placement_policy="contiguous")
    stores = [StripeStore(tmp_path / d.type, cfg, num_nodes=105, device=d)
              for d in (cuda, torch.device("cpu"))]
    data = rng.integers(0, 256, (15, 96 * 4096), dtype=np.uint8)
    for st in stores:
        for sid in range(15):
            st.put(f"s{sid}", data[sid])
        st.seal()
        for sid, stripe in st.stripes.items():     # only the repair restores
            for b, node in enumerate(stripe.node_of_block):
                if node in (40, 41):
                    st._block_path(sid, b).unlink()
    rep, twin = [repair_failed_nodes(st, [40, 41], device=st.device)
                 for st in stores]
    plans = [stores[0].engine.planner.multi_plan(
        {b for b, n in enumerate(st.node_of_block) if n in (40, 41)})
        for st in stores[0].stripes.values()]
    assert rep.launches == len(plans) == 15
    assert rep.kernel_table_chunks == sum(-(-len(p.reads) // 64)
                                          for p in plans)
    assert sum(len(p.reads) == 96 for p in plans) == rep.repairs_global > 0
    assert twin.kernel_table_chunks == 0
    files = sorted((tmp_path / "cuda").glob("node*/*.blk"))
    assert len(files) == 15 * 105
    for f in files:
        other = tmp_path / "cpu" / f.relative_to(tmp_path / "cuda")
        assert f.read_bytes() == other.read_bytes()


BATCHED = {"gf": gm.gf256_matmul_batched,
           "crs": bme.bitmatrix_encode_batched,
           "mxu": bme.mod2_matmul_encode_batched}


@pytest.mark.parametrize("backend", ["gf", "crs", "mxu"])
def test_cuda_sharded_launch_over_four_positions_of_the_card(cuda, backend,
                                                             rng):
    """A 16-stripe window of P5's two-node plan under a 4x1 mesh on one
    card: one kernel launch per slice, from a host stack and from an
    assembled batch, byte-equal to the unsharded launch."""
    from repro_torch.core.engine import BatchedCodecEngine
    from repro_torch.core.schemes import make_scheme
    from repro_torch.dist import (assemble_shards, make_mesh, shard_layout,
                                  with_rules)

    scheme = make_scheme("cp-azure", 24, 2, 2)
    plain = BatchedCodecEngine(scheme, backend=backend, device=cuda)
    plan = plain.planner.multi_plan([3, 4])
    stack = rng.integers(0, 256, (16, len(plan.reads), 4096 + 5),
                         dtype=np.uint8)
    want = plain.execute(plan, stack)
    mesh = make_mesh((4, 1), ("data", "model"), devices=("cuda:0",) * 4)
    with with_rules(mesh) as mr:
        eng = BatchedCodecEngine(scheme, backend=backend, device=cuda,
                                 mesh_rules=mr)
        layout = shard_layout(stack.shape, mr)
        assembled = assemble_shards(stack.shape, mr, layout,
                                    [stack[sl.lo:sl.hi] for sl in layout])
        before = BATCHED[backend].launches
        got = [eng.execute(plan, stack), eng.execute(plan, assembled)]
        launched = BATCHED[backend].launches - before
    assert eng.last_span == 4 and launched == 8
    assert all(s.device == cuda for s in assembled.shards)
    for out in got:
        assert out.device == cuda and torch.equal(out, want)


# ------------------------------------------------- the fleet simulator

def test_cuda_bits_match_the_numpy_chain(cuda):
    from repro_torch.sim.rng import BitSource, threefry_bits_np

    g = np.random.default_rng(5)
    t = g.integers(0, 1 << 32, (100003, 3), dtype=np.uint64).astype(np.uint32)
    t[:2] = [[0, 0, 0], [0xFFFFFFFF] * 3]
    for seed in (0, 3, 0xFFFFFFFF):
        src = BitSource(seed, cuda)
        assert src.device.type == "cuda"
        assert np.array_equal(src.bits(t), threefry_bits_np(src.key, t))
        assert src.bit1(7, 8, 9) == threefry_bits_np(src.key, [[7, 8, 9]])[0]


@pytest.mark.parametrize("t,d,n,r", [(2000, 28, 28, 7), (37, 7, 7, 2),
                                     (1, 4, 1, 1)])
def test_cuda_select_breaks_ties_as_numpy(cuda, t, d, n, r):
    """Ties take the first column, then the lowest unit, and all-inf rows
    pick column 0 and unit 0, as ``np.argmin`` (and the reference's
    ``jnp.argmin``) do."""
    from repro_torch.sim.engine import select, select_np

    g = np.random.default_rng(t)

    def part(*shape):
        x = g.integers(0, 4, shape).astype(np.float32)
        x[g.random(shape) < 0.3] = np.inf
        x[::4] = np.inf
        return x

    sched = (part(t, d), part(t, n), part(t, r), part(t, d), part(t),
             part(t))
    got, want = select(sched, cuda), select_np(sched)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)


def test_cuda_simulate_matches_cpu(cuda):
    """40 trials of the P5 configuration with every failure process: the
    engine on the card and on the host give the same result and events."""
    from repro_torch import sim
    from repro_torch.core.reliability import ReliabilityParams
    from repro_torch.core.schemes import make_scheme
    from repro_torch.dist.topology import Topology
    from repro_torch.ftx.events import to_doc

    sch = make_scheme("cp-azure", 24, 2, 2)
    params = sim.SimParams(
        disk_mttf_hours=2000.0, node_burst_hours=20000.0,
        rack_burst_hours=80000.0, lse_hours=20000.0, scrub_hours=336.0,
        cost_model="planner",
        reliability=ReliabilityParams(bandwidth_gbps=0.002))
    hier = sim.UnitHierarchy.from_topology(
        sch.n, Topology(num_nodes=28, num_domains=7), "contiguous")
    a, b = (sim.simulate(sch, params, trials=40, horizon_hours=8000.0,
                         seed=0, hierarchy=hier, record_events=True,
                         device=dev)
            for dev in (cuda, torch.device("cpu")))
    for f in ("losses", "observed_hours", "loss_times", "events", "epochs",
              "rejected", "counts"):
        assert getattr(a, f) == getattr(b, f), f
    assert [[to_doc(e) for e in t] for t in a.event_log] == \
        [[to_doc(e) for e in t] for t in b.event_log]
    assert a.losses > 0
