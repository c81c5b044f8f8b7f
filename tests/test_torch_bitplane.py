"""The port's bit-plane (crs/mxu) layer against the JAX reference, byte for
byte.

On this CPU the kernel wrappers run their plain PyTorch versions; the
tests hold those to the reference's jnp oracles and to its Pallas kernels
(interpreted), and hold the dispatch, the engine and the codec with crs
and mxu to the reference with the same backend. GF(2) is exact: the
tolerance is zero everywhere. ``test_torch_cuda.py`` holds each CUDA
kernel to its plain version on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import planner as ref_planner  # noqa: E402
from repro.core.codec import StripeCodec as RefCodec  # noqa: E402
from repro.core.engine import BatchedCodecEngine as RefEngine  # noqa: E402
from repro.core.schemes import make_scheme as ref_scheme  # noqa: E402
from repro.kernels.bitmatrix_encode import (  # noqa: E402
    bitmatrix_encode as ref_bitmatrix_encode,
    bitmatrix_encode_batched as ref_bitmatrix_encode_batched,
    mod2_matmul_encode as ref_mod2_matmul_encode,
    mod2_matmul_encode_batched as ref_mod2_matmul_encode_batched)
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels import ref as R  # noqa: E402
from repro_torch.core import planner  # noqa: E402
from repro_torch.core.codec import StripeCodec  # noqa: E402
from repro_torch.core.engine import BatchedCodecEngine  # noqa: E402
from repro_torch.core.gf import matrix_to_bitmatrix  # noqa: E402
from repro_torch.core.schemes import make_scheme  # noqa: E402
from repro_torch.kernels import bitmatrix_encode as bme  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

BIT_BACKENDS = ("crs", "mxu")
# (R8, K8, P): repair-window, seal and decode widths of the P5 store, cut
# to a small P, plus ragged ones.
BIT_SHAPES = [(8, 16, 64), (16, 104, 40), (32, 192, 33), (24, 40, 7),
              (192, 192, 16)]
WRAPPERS = {
    "bitmatrix_encode": (bme.bitmatrix_encode, bme.bitmatrix_encode_batched,
                         ref.bitmatrix_encode_ref,
                         ref.bitmatrix_encode_batched_ref),
    "mod2_matmul_encode": (bme.mod2_matmul_encode,
                           bme.mod2_matmul_encode_batched,
                           ref.mod2_matmul_encode_ref,
                           ref.mod2_matmul_encode_batched_ref),
}


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _bit_case(rng, s, r8, k8, p):
    """A random 0/1 bitmatrix with an all-zero and a one-hot row, and
    random packets."""
    bm = rng.integers(0, 2, (r8, k8), dtype=np.uint8)
    bm[0] = 0
    if r8 > 1:
        bm[1] = 0
        bm[1, k8 // 2] = 1
    return bm, rng.integers(0, 256, (s, k8, p), dtype=np.uint8)


# ------------------------------------------------------------------ layout
@pytest.mark.parametrize("s,k,b", [(1, 1, 8), (2, 3, 64), (3, 24, 1024),
                                   (1, 5, 8 * 33)])
def test_packetize_matches_reference(s, k, b, rng):
    blocks = rng.integers(0, 256, (s, k, b), dtype=np.uint8)
    want = np.asarray(R.packetize_batched(jnp.asarray(blocks)))
    got = ref.packetize_batched(_t(blocks))
    assert got.dtype == torch.uint8 and got.shape == (s, k * 8, b // 8)
    assert (got.numpy() == want).all()
    assert (ref.packetize(_t(blocks[0])).numpy() == want[0]).all()
    back = ref.unpacketize_batched(got)
    assert (back.numpy() == blocks).all()
    assert (back.numpy() == np.asarray(R.unpacketize_batched(
        jnp.asarray(want)))).all()
    assert (ref.unpacketize(got[0]).numpy() == blocks[0]).all()


def test_packetize_takes_views_and_rejects_ragged_widths(rng):
    blocks = _t(rng.integers(0, 256, (4, 3, 72), dtype=np.uint8))
    view = blocks[1:, :, 8:]                  # offset and strided
    assert (ref.packetize_batched(view).numpy()
            == ref.packetize_batched(view.contiguous()).numpy()).all()
    with pytest.raises(ValueError, match="divisible by 8"):
        ref.packetize(blocks[0, :, :13])
    with pytest.raises(ValueError, match="divisible by 8"):
        ref.unpacketize(_t(np.zeros((5, 4), np.uint8)))


# ----------------------------------------------------------- plain versions
@pytest.mark.parametrize("r8,k8,p", BIT_SHAPES)
@pytest.mark.parametrize("s", [1, 3])
def test_plain_versions_match_reference_oracles(r8, k8, p, s, rng):
    bm, pk = _bit_case(rng, s, r8, k8, p)
    want = np.asarray(R.bitmatrix_encode_batched_ref(jnp.asarray(bm),
                                                     jnp.asarray(pk)))
    assert (np.asarray(R.mod2_matmul_encode_batched_ref(
        jnp.asarray(bm), jnp.asarray(pk))) == want).all()
    for flat, batched, flat_ref, batched_ref in WRAPPERS.values():
        got = batched_ref(_t(bm), _t(pk))
        assert got.dtype == torch.uint8 and got.shape == (s, r8, p)
        assert (got.numpy() == want).all()
        assert (flat_ref(_t(bm), _t(pk[0])).numpy() == want[0]).all()
    assert (want[:, 0] == 0).all()             # an all-zero row gives zero
    if r8 > 1:
        assert (want[:, 1] == pk[:, k8 // 2]).all()   # one-hot: a copy


def test_plain_versions_are_the_gf_product_of_the_blocks(rng):
    """Bitmatrix of a GF(2^8) matrix on packets == the GF(2^8) product."""
    coef = rng.integers(0, 256, (3, 7), dtype=np.uint8)
    blocks = rng.integers(0, 256, (2, 7, 96), dtype=np.uint8)
    bm = _t(matrix_to_bitmatrix(coef))
    want = ref.gf256_matmul_batched_ref(_t(coef), _t(blocks)).numpy()
    packets = ref.packetize_batched(_t(blocks))
    for _, batched, _, batched_ref in WRAPPERS.values():
        got = ref.unpacketize_batched(batched_ref(bm, packets))
        assert (got.numpy() == want).all()


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_plain_versions_match_reference_pallas_kernels(name, rng):
    """The reference's Pallas kernels run as its own tests run them
    (``interpret=True``, tile_p dividing P), flat and stripe-batched."""
    bm, pk = _bit_case(rng, 2, 16, 24, 128)
    flat_k, batched_k = {
        "bitmatrix_encode": (ref_bitmatrix_encode,
                             ref_bitmatrix_encode_batched),
        "mod2_matmul_encode": (ref_mod2_matmul_encode,
                               ref_mod2_matmul_encode_batched)}[name]
    want = np.asarray(batched_k(jnp.asarray(bm), jnp.asarray(pk), tile_p=64,
                                interpret=True))
    want_flat = np.asarray(flat_k(jnp.asarray(bm), jnp.asarray(pk[0]),
                                  tile_p=64, interpret=True))
    flat, batched, _, _ = WRAPPERS[name]
    assert (batched(_t(bm), _t(pk)).numpy() == want).all()
    assert (flat(_t(bm), _t(pk[0])).numpy() == want_flat).all()
    assert (want_flat == want[0]).all()


# ----------------------------------------------------------------- wrappers
@pytest.mark.parametrize("s,r8,k8,p", [(1, 8, 16, 1), (3, 16, 104, 37),
                                       (2, 0, 8, 16), (2, 8, 0, 16),
                                       (0, 8, 8, 16)])
def test_wrappers_on_cpu_run_the_plain_version(s, r8, k8, p, rng):
    bm, pk = _bit_case(rng, s, r8, k8, p) if r8 and k8 else (
        np.zeros((r8, k8), np.uint8), np.zeros((s, k8, p), np.uint8))
    want = np.zeros((s, r8, p), np.uint8)
    for i in range(s):
        for r in range(r8):
            for j in np.flatnonzero(bm[r]):
                want[i, r] ^= pk[i, j]
    before = {n: (f.launches, b.launches)
              for n, (f, b, _, _) in WRAPPERS.items()}
    for flat, batched, _, _ in WRAPPERS.values():
        got = batched(_t(bm), _t(pk))
        assert got.shape == (s, r8, p) and (got.numpy() == want).all()
        if s:
            assert (flat(_t(bm), _t(pk[0])).numpy() == want[0]).all()
    # Nothing launched: the CPU path is the plain version, not the kernel.
    assert before == {n: (f.launches, b.launches)
                      for n, (f, b, _, _) in WRAPPERS.items()}


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_wrappers_check_their_inputs(name, rng):
    flat, batched, _, _ = WRAPPERS[name]
    bm = _t(rng.integers(0, 2, (8, 16), dtype=np.uint8))
    pk = _t(rng.integers(0, 256, (2, 16, 32), dtype=np.uint8))
    with pytest.raises(TypeError):
        batched(bm.int(), pk)
    with pytest.raises(ValueError, match="shape mismatch"):
        batched(bm[:, :8].contiguous(), pk)
    with pytest.raises(ValueError):
        batched(bm, pk[0])
    with pytest.raises(ValueError, match="contiguous"):
        batched(bm, pk[:, :, ::2])
    with pytest.raises(ValueError):
        flat(bm, pk)


def test_mod2_padded_shape_follows_the_kernel_tiles():
    assert bme.mod2_padded_shape(8, 104) == (16, 128)
    assert bme.mod2_padded_shape(16, 16) == (16, 32)
    assert bme.mod2_padded_shape(32, 192) == (32, 192)
    assert bme.mod2_padded_shape(40, 8) == (64, 32)
    assert bme.mod2_padded_shape(192, 768) == (192, 768)


# ---------------------------------------------------------------- dispatch
@pytest.mark.parametrize("backend", BIT_BACKENDS)
@pytest.mark.parametrize("s,m,k,b", [(1, 1, 5, 100), (3, 2, 9, 257),
                                     (2, 4, 24, 515), (2, 3, 4, 8)])
def test_bit_plane_ops_match_reference_ops(backend, s, m, k, b, rng):
    """Ragged B: the port pads to a multiple of 8 where the reference pads
    to its tile, so the first b bytes must agree."""
    coef = rng.integers(0, 256, (m, k), dtype=np.uint8)
    data = rng.integers(0, 256, (s, k, b), dtype=np.uint8)
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
    enc_want = np.asarray(ref_ops.encode_op(coef, data[0], backend=backend))
    assert (ops.encode_op(coef, _t(data[0]), backend=backend).numpy()
            == enc_want).all()
    crs = ops.crs_encode_op(coef, _t(data[0]), backend=backend)
    assert (crs.numpy() == np.asarray(ref_ops.crs_encode_op(
        coef, data[0], backend=backend))).all()


def test_crs_encode_op_ref_backend_matches_reference(rng):
    coef = rng.integers(0, 256, (4, 6), dtype=np.uint8)
    blocks = rng.integers(0, 256, (6, 203), dtype=np.uint8)
    want = np.asarray(ref_ops.crs_encode_op(coef, blocks, backend="ref"))
    got = ops.crs_encode_op(coef, _t(blocks), backend="ref")
    assert (got.numpy() == want).all()


@pytest.mark.parametrize("backend", BIT_BACKENDS)
def test_precomputed_bitmatrix_is_used_and_shape_checked(backend, rng):
    coef = rng.integers(0, 256, (2, 3), dtype=np.uint8)
    data = rng.integers(0, 256, (2, 3, 40), dtype=np.uint8)
    bm = matrix_to_bitmatrix(coef)
    want = ops.gf_matmul_batch_op(coef, data, backend=backend, device="cpu")
    got = ops.gf_matmul_batch_op(coef, data, backend=backend, device="cpu",
                                 bitmatrix=bm)
    assert (got.numpy() == want.numpy()).all()
    bad = np.zeros((8, 16), np.uint8)
    with pytest.raises(ValueError) as ref_err:
        ref_ops.gf_matmul_batch_op(coef, data, backend=backend, bitmatrix=bad)
    calls = [lambda: ops.gf_matmul_batch_op(coef, data, backend=backend,
                                            device="cpu", bitmatrix=bad),
             lambda: ops.gf_matmul_op(coef, data[0], backend=backend,
                                      device="cpu", bitmatrix=bad),
             lambda: ops.encode_batch_op(coef, data, backend=backend,
                                         device="cpu", bitmatrix=bad)]
    for call in calls:
        with pytest.raises(ValueError) as err:
            call()
        assert str(err.value) == str(ref_err.value)


# ----------------------------------------------------------- engine, codec
def _pattern(scheme, kind):
    return frozenset({0} if kind == "single" else {0, scheme.k})


@pytest.mark.parametrize("kind", ["single", "double"])
@pytest.mark.parametrize("name", ["cp-azure", "cp-uniform"])
@pytest.mark.parametrize("backend", BIT_BACKENDS)
def test_engine_matches_reference(backend, name, kind, rng):
    """The counterpart of tests/test_backend_parity.py: encode, the
    failure pattern's repair and a decode through crs/mxu, against the
    reference engine with the same backend; the same effective backend
    and the same number of bitmatrix expansions."""
    s, rs = make_scheme(name, 8, 2, 2), ref_scheme(name, 8, 2, 2)
    port = BatchedCodecEngine(s, backend=backend, device="cpu")
    refe = RefEngine(rs, backend=backend)
    data = rng.integers(0, 256, (4, s.k, 516), dtype=np.uint8)
    before = (planner.bitmatrix_expansions(),
              ref_planner.bitmatrix_expansions())

    got = port.encode(data)
    want = np.asarray(refe.encode(data))
    assert got.device.type == "cpu" and (got.numpy() == want).all()
    assert port.effective_backend == refe.effective_backend == backend
    pattern = _pattern(s, kind)
    avail = {b: want[:, b, :] for b in range(s.n) if b not in pattern}
    g, gp = port.repair_multi(pattern, avail)
    w, wp = refe.repair_multi(pattern, avail)
    assert sorted(g) == sorted(w) == sorted(pattern)
    assert gp.reads == wp.reads and gp.targets == wp.targets
    for b in pattern:
        assert (g[b].numpy() == np.asarray(w[b])).all()
        assert (g[b].numpy() == want[:, b]).all()
    ids = [b for b in range(s.n) if b not in pattern]
    dec = port.decode({i: want[:, i, :] for i in ids})
    assert (dec.numpy() == np.asarray(
        refe.decode({i: want[:, i, :] for i in ids}))).all()
    assert (dec.numpy() == data).all()
    assert port.effective_backend == refe.effective_backend == backend
    assert (planner.bitmatrix_expansions() - before[0]
            == ref_planner.bitmatrix_expansions() - before[1] == 3)


@pytest.mark.parametrize("name", ["cp-azure", "cp-uniform"])
@pytest.mark.parametrize("backend", BIT_BACKENDS)
def test_codec_matches_reference(backend, name, rng):
    s = make_scheme(name, 6, 2, 2)
    port = StripeCodec(s, backend=backend, device="cpu")
    refc = RefCodec(ref_scheme(name, 6, 2, 2), backend=backend)
    data = rng.integers(0, 256, (s.k, 300), dtype=np.uint8)
    stripe = port.encode(data).numpy()
    assert (stripe == np.asarray(refc.encode(data))).all()
    avail = {b: stripe[b] for b in range(s.n)}
    rest = {b: v for b, v in avail.items() if b not in (0, 7)}
    g, _ = port.repair_multi((0, 7), rest)
    w, _ = refc.repair_multi((0, 7), rest)
    for b in w:
        assert (g[b].numpy() == np.asarray(w[b])).all()
        assert (g[b].numpy() == stripe[b]).all()
    alive = {b: avail[b] for b in range(2, s.n)}
    dec = port.decode_all(alive).numpy()
    assert (dec == data).all() and (dec == np.asarray(
        refc.decode_all(alive))).all()
    blk, meta = port.repair_single(3, avail)
    wblk, wmeta = refc.repair_single(3, avail)
    assert (blk.numpy() == np.asarray(wblk)).all()
    assert (blk.numpy() == stripe[3]).all() and meta.reads == wmeta.reads
