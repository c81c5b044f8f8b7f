"""The port's GF(2^8) kernel layer against the JAX reference, byte for byte.

On this CPU the kernel wrappers run their plain PyTorch versions; the
tests hold those to the reference's oracles and Pallas kernel, hold the
kernel's table argument to the field's multiplication table, and check
the dispatch layer (backends, effective backend, errors). The tests marked
``cuda`` hold the CUDA kernel itself to its plain version and skip without
a card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.gf import GF_MUL_TABLE, gf_matmul  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels import ref as R  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import gf256_matmul as gm  # noqa: E402

# tests/test_kernels.py's (m, k, B) sweep.
SHAPES = [(2, 4, 128), (4, 6, 256), (8, 24, 512), (9, 96, 128), (3, 17, 384)]


def _case(rng, s, m, k, b, zero_row=True):
    coef = rng.integers(0, 256, (m, k), dtype=np.uint8)
    if zero_row:
        coef[0] = 0
    data = rng.integers(0, 256, (s, k, b), dtype=np.uint8)
    return coef, data


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ----------------------------------------------------------- plain versions
@pytest.mark.parametrize("m,k,b", SHAPES)
@pytest.mark.parametrize("s,ragged", [(1, 0), (3, 5), (8, 0)])
def test_batched_ref_matches_gf_algebra(m, k, b, s, ragged, rng):
    coef, data = _case(rng, s, m, k, b + ragged)
    got = ref.gf256_matmul_batched_ref(_t(coef), _t(data)).numpy()
    assert got.dtype == np.uint8 and got.shape == (s, m, b + ragged)
    for i in range(s):
        assert (got[i] == gf_matmul(coef, data[i])).all()
    assert (got[:, 0] == 0).all()                 # zero coefficients give zero


@pytest.mark.parametrize("m,k,b", SHAPES)
def test_batched_ref_matches_reference_oracle(m, k, b, rng):
    coef, data = _case(rng, 3, m, k, b + 5)
    want = np.asarray(R.gf256_matmul_batched_ref(jnp.asarray(coef),
                                                 jnp.asarray(data)))
    got = ref.gf256_matmul_batched_ref(_t(coef), _t(data)).numpy()
    assert (got == want).all()


@pytest.mark.parametrize("m,k,b", SHAPES)
def test_flat_refs_match_gf_algebra(m, k, b, rng):
    coef, data = _case(rng, 1, m, k, b + 3)
    want = gf_matmul(coef, data[0])
    assert (ref.gf256_matmul_ref(_t(coef), _t(data[0])).numpy() == want).all()
    assert (ref.gf256_matmul_shift_ref(_t(coef), _t(data[0])).numpy()
            == want).all()


def test_plain_version_matches_reference_pallas_kernel(rng):
    """The batched-grid Pallas kernel itself (interpreted), on one small
    ragged case."""
    coef, data = _case(rng, 3, 2, 9, 257, zero_row=False)
    want = np.asarray(ref_ops.gf_matmul_batch_op(
        coef, data, backend="gf", interpret=True, force_pallas=True))
    got = ref.gf256_matmul_batched_ref(_t(coef), _t(data)).numpy()
    assert (got == want).all()


def test_launch_tables_reproduce_the_field():
    """The kernel multiplies as exp[log a + log b] over its table argument;
    emulated here for every pair of bytes, it must be the field's table."""
    tab = gm.launch_tables()
    exp = tab[:1040]
    log = tab[1040:].view("<u2").astype(np.int64)
    assert tab.shape == (1040 + 512,)
    a = np.arange(256)
    prod = exp[log[a][:, None] + log[a][None, :]]
    assert (prod == GF_MUL_TABLE).all()


# ----------------------------------------------------------------- wrappers
@pytest.mark.parametrize("s,m,k,b", [(1, 1, 1, 1), (7, 3, 17, 385),
                                     (2, 9, 96, 128), (4, 0, 5, 64),
                                     (2, 3, 0, 16)])
def test_wrappers_on_cpu_run_the_plain_version(s, m, k, b, rng):
    coef, data = _case(rng, s, m, k, b, zero_row=False)
    before = (gm.gf256_matmul_batched.launches, gm.gf256_matmul.launches)
    got = gm.gf256_matmul_batched(_t(coef), _t(data))
    flat = gm.gf256_matmul(_t(coef), _t(data[0]))
    want = np.stack([gf_matmul(coef, data[i]) if m and k
                     else np.zeros((m, b), np.uint8) for i in range(s)])
    assert got.shape == (s, m, b) and (got.numpy() == want).all()
    assert (flat.numpy() == want[0]).all()
    # Nothing launched: the CPU path is the plain version, not the kernel.
    assert (gm.gf256_matmul_batched.launches, gm.gf256_matmul.launches) \
        == before


def test_wrappers_check_their_inputs(rng):
    coef = _t(rng.integers(0, 256, (2, 3), dtype=np.uint8))
    data = _t(rng.integers(0, 256, (2, 3, 16), dtype=np.uint8))
    with pytest.raises(TypeError):
        gm.gf256_matmul_batched(coef.int(), data)
    with pytest.raises(ValueError, match="shape mismatch"):
        gm.gf256_matmul_batched(coef[:, :2].contiguous(), data)
    with pytest.raises(ValueError):
        gm.gf256_matmul_batched(coef, data[0])
    with pytest.raises(ValueError, match="contiguous"):
        gm.gf256_matmul_batched(coef, data[:, :, ::2])
    with pytest.raises(ValueError):
        gm.gf256_matmul(coef, data)


# ---------------------------------------------------------------- dispatch
@pytest.mark.parametrize("backend", ["gf", "ref"])
@pytest.mark.parametrize("s,m,k,b", [(1, 1, 5, 100), (3, 2, 9, 257),
                                     (2, 9, 24, 515)])
def test_ops_match_reference_ops(backend, s, m, k, b, rng):
    """Ragged m and B: the port masks in the kernel where the reference
    pads and slices, so the outputs must agree in shape and bytes."""
    coef, data = _case(rng, s, m, k, b, zero_row=False)
    want = np.asarray(ref_ops.gf_matmul_batch_op(coef, data, backend=backend))
    got = ops.gf_matmul_batch_op(coef, data, backend=backend, device="cpu")
    assert got.device.type == "cpu"
    assert got.shape == want.shape and (got.numpy() == want).all()
    flat_want = np.asarray(ref_ops.gf_matmul_op(coef, data[0],
                                                backend=backend))
    flat = ops.gf_matmul_op(coef, _t(data[0]), backend=backend)
    assert flat.shape == flat_want.shape and (flat.numpy() == flat_want).all()
    enc = ops.encode_batch_op(coef, _t(data), backend=backend)
    assert (enc.numpy() == want).all()
    assert (ops.encode_op(coef, _t(data[0]), backend=backend).numpy()
            == flat_want).all()


def test_effective_backend_mirrors_reference():
    for backend in ("gf", "ref"):
        assert ops.effective_backend(backend, "cpu") \
            == ref_ops.effective_backend(backend, interpret=True)
    assert ops.effective_backend("gf", "cuda") == "gf"
    assert ops.effective_backend("ref", "cuda") == "ref"
    with pytest.raises(ValueError, match="unknown kernel backend"):
        ops.effective_backend("nope", "cpu")


@pytest.mark.parametrize("backend", ["crs", "mxu"])
def test_bit_plane_backends_raise_not_implemented(backend, rng):
    coef = rng.integers(0, 256, (2, 3), dtype=np.uint8)
    data = _t(rng.integers(0, 256, (2, 3, 16), dtype=np.uint8))
    calls = [lambda: ops.gf_matmul_op(coef, data[0], backend=backend),
             lambda: ops.gf_matmul_batch_op(coef, data, backend=backend),
             lambda: ops.encode_op(coef, data[0], backend=backend),
             lambda: ops.encode_batch_op(coef, data, backend=backend)]
    for call in calls:
        with pytest.raises(NotImplementedError, match="later slice"):
            call()


def test_unknown_backend_raises(rng):
    data = _t(rng.integers(0, 256, (2, 3, 16), dtype=np.uint8))
    with pytest.raises(ValueError, match="unknown kernel backend"):
        ops.gf_matmul_batch_op(np.ones((1, 3), np.uint8), data,
                               backend="nope")


def test_default_backend(monkeypatch):
    monkeypatch.delenv("REPRO_BACKEND", raising=False)
    assert ops.default_backend() == "gf"
    assert ops.default_backend("ref") == "ref"
    monkeypatch.setenv("REPRO_BACKEND", "ref")
    assert ops.default_backend() == "ref"
    assert ops.default_backend("gf") == "ref"
    monkeypatch.setenv("REPRO_BACKEND", "bogus")
    with pytest.raises(ValueError):
        ops.default_backend()


# ------------------------------------------------------------------ devices
def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch,
                                                           tmp_path):
    from repro_torch.core.codec import StripeCodec
    from repro_torch.core.engine import BatchedCodecEngine
    from repro_torch.core.schemes import make_scheme
    from repro_torch.ftx import StoreConfig, StripeStore, repair_failed_nodes

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    s = make_scheme("cp-azure", 6, 2, 2)
    for make in (lambda: BatchedCodecEngine(s, backend="gf"),
                 lambda: StripeCodec(s, backend="gf"),
                 lambda: StripeStore(tmp_path / "a",
                                     StoreConfig(k=6, block_size=64))):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            make()
    store = StripeStore(tmp_path / "b", StoreConfig(k=6, block_size=64),
                        device="cpu")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        repair_failed_nodes(store, [0])
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ops.gf_matmul_op(np.ones((1, 2), np.uint8), np.ones((2, 8), np.uint8))
    assert BatchedCodecEngine(s, backend="gf", device="cpu").device.type \
        == "cpu"


def test_build_paths(monkeypatch, tmp_path):
    path = _build.library_path("gf256_matmul")
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("libgf256_matmul-") and path.suffix == ".so"
    assert _build.SOURCES == ("gf256_matmul",)
    assert (_build.CSRC / "gf256_matmul.cu").is_file()
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()


# ----------------------------------------------------- on the card only
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,b", SHAPES)
@pytest.mark.parametrize("s,ragged", [(1, 0), (7, 13), (64, 1)])
def test_cuda_kernel_matches_plain_version(cuda, m, k, b, s, ragged, rng):
    coef, data = _case(rng, s, m, k, b + ragged)
    c, d = _t(coef).to(cuda), _t(data).to(cuda)
    before = gm.gf256_matmul_batched.launches
    got = gm.gf256_matmul_batched(c, d)
    want = ref.gf256_matmul_batched_ref(c, d)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert gm.gf256_matmul_batched.launches == before + 1
    flat = gm.gf256_matmul(c, d[0])
    torch.cuda.synchronize()
    assert torch.equal(flat, want[0])


@pytest.mark.cuda
def test_cuda_main_path_matches_cpu(cuda, tmp_path, rng):
    """A store on the card and a store on the CPU, same operations: the
    same block files and the same report counts."""
    from repro_torch.ftx import StoreConfig, StripeStore, repair_failed_nodes

    cfg = StoreConfig(scheme="cp-azure", k=6, r=2, p=2, block_size=4096,
                      backend="gf")
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
    assert reports[0].effective_backend == "gf"
    assert reports[1].effective_backend == "ref"
    assert reports[0].blocks_read == reports[1].blocks_read
    for f in sorted((tmp_path / "cuda").glob("node*/*.blk")):
        twin = tmp_path / "cpu" / f.relative_to(tmp_path / "cuda")
        assert f.read_bytes() == twin.read_bytes()
