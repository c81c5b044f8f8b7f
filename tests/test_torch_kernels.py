"""The port's GF(2^8) kernel layer against the JAX reference, byte for byte.

On this CPU the kernel wrappers run their plain PyTorch versions; the
tests hold those to the reference's oracles and Pallas kernel, hold the
kernel's table argument to the field's multiplication table, and check
the dispatch layer (backends, effective backend, errors). The bit-plane
kernels have their own file, ``test_torch_bitplane.py``, and the CUDA
kernels are held to their plain versions on the card in
``test_torch_cuda.py``.
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


# A numpy model of the kernel's multiply (csrc/gf256_matmul.cu): split
# tables built as its prologue builds them, looked up by PRMT.
def _prmt(lo, hi, sel):
    """PTX ``prmt.b32`` in its default mode, elementwise: byte n of the
    result is byte (sel >> 4n) & 7 of {hi, lo}, or that byte's sign
    replicated where bit 3 of the nibble is set."""
    lo, hi, sel = (np.asarray(x, np.uint64) for x in (lo, hi, sel))
    both = (hi << np.uint64(32)) | lo
    out = np.zeros(np.broadcast(lo, hi, sel).shape, np.uint64)
    for n in range(4):
        nib = (sel >> np.uint64(4 * n)) & np.uint64(15)
        byte = (both >> (np.uint64(8) * (nib & np.uint64(7)))) & np.uint64(255)
        byte = np.where(nib & np.uint64(8),
                        np.where(byte & np.uint64(128), 255, 0), byte)
        out |= byte.astype(np.uint64) << np.uint64(8 * n)
    return out.astype(np.uint32)


def _split_tables(coefs):
    """(c, field, half) words of the kernel's tables: byte b of half h of
    field f is exp[log c + log((4h + b) << 3f & 0xFF)] over launch_tables()'s
    exp/log layout (log 0 = 512, into the zero tail)."""
    tab = gm.launch_tables()
    exp = tab[:1040].astype(np.uint32)
    log = tab[1040:].view("<u2").astype(np.int64)
    v = np.arange(8)
    words = np.zeros((len(coefs), 3, 2), np.uint32)
    for f in range(3):
        x = (v << (3 * f)) & 0xFF
        prod = exp[log[coefs][:, None] + log[x][None, :]]    # (c, 8)
        for b in range(4):
            words[:, f, :] |= prod[:, b::4] << np.uint32(8 * b)
    return words


def _selectors(words):
    """PRMT selectors of each field of each word: fields of bytes 0, 2, 1,
    3 in nibbles 0..3 (the kernel's ``selectors`` of word >> 3f)."""
    words = np.asarray(words, np.uint32)
    fields = [(words >> np.uint32(3 * f)) & np.uint32(0x07070707)
              for f in range(3)]
    return [(x + (x >> np.uint32(12))).astype(np.uint32) for x in fields]


def _kernel_products(coefs, words):
    """gfmul(c, word) bytewise for each coefficient and word, as packed
    words: three PRMTs XORed, then put back in byte order."""
    t = _split_tables(coefs)[:, None]                      # (c, 1, 3, 2)
    acc = np.zeros((len(coefs), len(words)), np.uint32)
    for f, sel in enumerate(_selectors(words)):
        acc ^= _prmt(t[..., f, 0], t[..., f, 1], sel[None, :])
    return _prmt(acc, 0, 0x3120)


def _bytes_of(words):
    return np.asarray(words, "<u4").view(np.uint8).reshape(*np.shape(words),
                                                           4)


def test_split_table_products_of_every_pair():
    """Every coefficient against every byte, in every byte position of a
    word: the kernel's table scheme gives the field's product."""
    coefs = np.arange(256)
    for shift in range(4):
        data = np.roll(np.arange(256, dtype=np.uint8), shift)
        words = data.view("<u4")
        got = _bytes_of(_kernel_products(coefs, words)).reshape(256, 256)
        want = gf_matmul(coefs.astype(np.uint8)[:, None], data[None, :])
        assert (got == want).all()


def test_split_table_selectors_and_tables(rng):
    """Random words: no selector nibble sets PRMT's sign bit, the 2-bit
    field's table repeats its four entries (so the bit it takes from the
    next byte picks a repeat), and the products are the field's."""
    words = rng.integers(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
    for sel in _selectors(words):
        assert not (sel & 0x8888).any()          # PRMT reads the low half
    coefs = rng.integers(0, 256, 64)
    tabs = _split_tables(coefs)
    assert (tabs[:, 2, 0] == tabs[:, 2, 1]).all()
    assert (tabs[coefs == 0] == 0).all()
    got = _bytes_of(_kernel_products(coefs, words))        # (c, w, 4)
    want = GF_MUL_TABLE[coefs[:, None, None], _bytes_of(words)[None]]
    assert (got == want).all()


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
def test_bit_plane_backends_match_reference(backend, rng):
    """The four ops run crs and mxu (bit-plane plain versions on the CPU)
    and give the reference's bytes with the same backend."""
    coef = rng.integers(0, 256, (2, 3), dtype=np.uint8)
    data = rng.integers(0, 256, (2, 3, 16), dtype=np.uint8)
    pairs = [(ops.gf_matmul_op(coef, _t(data[0]), backend=backend),
              ref_ops.gf_matmul_op(coef, data[0], backend=backend)),
             (ops.gf_matmul_batch_op(coef, _t(data), backend=backend),
              ref_ops.gf_matmul_batch_op(coef, data, backend=backend)),
             (ops.encode_op(coef, _t(data[0]), backend=backend),
              ref_ops.encode_op(coef, data[0], backend=backend)),
             (ops.encode_batch_op(coef, _t(data), backend=backend),
              ref_ops.encode_batch_op(coef, data, backend=backend))]
    for got, want in pairs:
        want = np.asarray(want)
        assert got.shape == want.shape and (got.numpy() == want).all()
    assert ops.effective_backend(backend, "cpu") \
        == ref_ops.effective_backend(backend, interpret=True) == backend


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


def test_ptxas_report_reads_each_entry_function(monkeypatch, tmp_path):
    """``-Xptxas -v`` lines: each entry function's registers, static shared
    memory, stack and spills; a device function's properties between two
    entries are not taken for the entry's."""
    log = (
        "ptxas info    : 0 bytes gmem\n"
        "ptxas info    : Compiling entry function '_Zk2' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Zk2\n"
        "    40 bytes stack frame, 48 bytes spill stores, 84 bytes spill "
        "loads\n"
        "ptxas info    : Used 168 registers, used 1 barriers, 40 bytes "
        "cumulative stack size\n"
        "ptxas info    : Compiling entry function '_Zk1' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Zdev\n"
        "    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads\n"
        "ptxas info    : Function properties for _Zk1\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 40 registers, used 1 barriers, 2048 bytes smem, "
        "400 bytes cmem[0]\n")
    parsed = [
        {"kernel": "_Zk2", "registers": 168, "smem": 0, "stack": 40,
         "spill_stores": 48, "spill_loads": 84},
        {"kernel": "_Zk1", "registers": 40, "smem": 2048, "stack": 0,
         "spill_stores": 0, "spill_loads": 0}]
    assert _build.parse_ptxas(log) == parsed
    assert "-Xptxas" in _build.NVCC_FLAGS and "-v" in _build.NVCC_FLAGS
    # The log kept beside a library is what ptxas_report reads.
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    assert _build.ptxas_report("mod2_matmul") == []
    _build.library_path("mod2_matmul").with_suffix(".log").write_text(log)
    assert _build.ptxas_report("mod2_matmul") == parsed


def test_build_paths(monkeypatch, tmp_path):
    path = _build.library_path("gf256_matmul")
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("libgf256_matmul-") and path.suffix == ".so"
    assert _build.SOURCES == ("gf256_matmul", "bitmatrix_encode",
                              "mod2_matmul")
    for name in _build.SOURCES:
        assert (_build.CSRC / f"{name}.cu").is_file()
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()
