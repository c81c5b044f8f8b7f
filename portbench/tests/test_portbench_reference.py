"""The benchmark's plain reference: GF(2^8) facts, and at small sizes on
the CPU, the port's generator matrices, placement and sealed bytes."""
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
for _p in (ROOT, ROOT / "src"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from portbench.reference import gf256, lrc  # noqa: E402

# The first powers of the generator 2 under 0x11D, as every
# Reed-Solomon text over this field lists them.
EXP_PREFIX = [1, 2, 4, 8, 16, 32, 64, 128, 29, 58, 116, 232, 205, 135, 19,
              38, 76, 152, 45, 90, 180, 117, 234, 201, 143, 3, 6, 12, 24, 48]
GEOMETRIES = [(6, 2, 2), (12, 2, 2), (16, 3, 2), (20, 3, 5), (24, 2, 2)]


def test_field_tables_are_gf256_over_0x11d():
    x, powers = 1, []
    for _ in range(255):
        powers.append(x)
        x = int(gf256.MUL[x, 2])
    assert powers[:len(EXP_PREFIX)] == EXP_PREFIX
    assert x == 1 and len(set(powers)) == 255       # 2 is primitive
    assert np.array_equal(gf256.MUL, gf256.MUL.T)
    assert not gf256.MUL[0].any()
    a = np.arange(1, 256, dtype=np.uint8)
    assert (gf256.MUL[a, gf256.INV[a]] == 1).all()
    rng = np.random.default_rng(0)
    b, c = rng.integers(0, 256, (2, 4096), dtype=np.uint8)
    d = rng.integers(0, 256, 4096, dtype=np.uint8)
    assert np.array_equal(gf256.mul(b, c ^ d),
                          gf256.mul(b, c) ^ gf256.mul(b, d))


def test_matrix_inverse_and_rank():
    rng = np.random.default_rng(1)
    m = rng.integers(0, 256, (12, 12), dtype=np.uint8)
    inv = gf256.mat_inv(m)
    assert np.array_equal(gf256.matmul(m, inv), np.eye(12, dtype=np.uint8))
    singular = m.copy()
    singular[3] = singular[5] ^ gf256.mul(7, singular[8])
    assert gf256.rank(singular) == 11
    with pytest.raises(np.linalg.LinAlgError):
        gf256.mat_inv(singular)


def test_cauchy_coefficients():
    alpha = lrc.cauchy(24, 2)
    for j in range(2):
        for i in range(24):
            assert gf256.MUL[alpha[j, i], (2 + i) ^ j] == 1


@pytest.mark.parametrize("xor_only", [False, True])
def test_apply_matches_scalar_products(xor_only):
    rng = np.random.default_rng(2)
    coef = rng.integers(0, 256, (3, 5), dtype=np.uint8)
    coef[1, 2] = 0
    coef[2, 0] = 1
    blocks = torch.randint(0, 256, (2, 5, 33), dtype=torch.uint8)
    want = np.zeros((2, 3, 33), np.uint8)
    for i in range(3):
        for j in range(5):
            c = (coef[i, j] != 0) if xor_only else coef[i, j]
            want[:, i] ^= gf256.mul(c, blocks[:, j].numpy())
    got = gf256.apply(coef, blocks, xor_only=xor_only)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("scheme", lrc.SCHEMES)
@pytest.mark.parametrize("krp", GEOMETRIES, ids=str)
def test_generator_is_the_ports(scheme, krp):
    from repro_torch.core.schemes import make_scheme

    gen = lrc.generator(scheme, *krp)
    assert np.array_equal(gen, make_scheme(scheme, *krp).gen)


def test_placement_is_the_ports():
    from repro_torch.dist.topology import Topology, place_stripe

    for nodes in (28, 31):
        for sid in range(70):
            assert lrc.placement("contiguous", nodes, sid, 28, 7) \
                == place_stripe("contiguous", Topology(num_nodes=nodes),
                                sid, 28)


def _decode_coefficients(gen, lost, survivors):
    """The coefficients the reference's decode puts on each survivor:
    its product over one-hot blocks, survivor b's a byte 1 at column b."""
    n = gen.shape[0]
    probe = {b: torch.eye(n, dtype=torch.uint8)[b][None] for b in survivors}
    return lrc.decode(gen, lost, probe)[0].numpy()


@pytest.mark.parametrize("scheme", lrc.SCHEMES)
def test_sealed_bytes_and_decode(scheme):
    """A small port store seals what the reference encodes; the
    reference decodes every pattern of two losses exactly, and its GF(2)
    control does not wherever a coefficient of the decode is neither 0
    nor 1: at every pattern of the CP constructions, and at least at a
    lost global of the baselines, whose XOR local parities a GF(2) decode
    rebuilds exactly."""
    from repro_torch.ftx import StoreConfig, StripeStore

    k, r, p, size = 24, 2, 2, 256
    gen = lrc.generator(scheme, k, r, p)
    data = torch.randint(0, 256, (3, k, size), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(3))
    with tempfile.TemporaryDirectory() as tmp:
        store = StripeStore(tmp, StoreConfig(scheme=scheme, k=k, r=r, p=p,
                                             block_size=size, backend="ref"),
                            device="cpu")
        for sid in range(3):
            store.put(f"s{sid}", data[sid].numpy())
        store.seal()
        sealed = torch.stack([torch.stack([torch.from_numpy(np.fromfile(
            Path(tmp) / f"node{store.stripes[sid].node_of_block[b]}"
            / f"s{sid}_b{b}.blk", np.uint8)) for b in range(k + r + p)])
            for sid in range(3)])
    assert torch.equal(sealed[:, :k], data)
    assert torch.equal(sealed[:, k:], lrc.encode(gen, data))
    wrong_in_gf2 = []
    for lost in ([0], [k], [k + p + r - 1], [3, 4], [0, 12], [k, k + 1],
                 [5, k + p]):
        survivors = {b: sealed[:, b] for b in range(k + r + p)
                     if b not in lost}
        assert torch.equal(lrc.decode(gen, lost, survivors), sealed[:, lost])
        binary = (_decode_coefficients(gen, lost, survivors) <= 1).all()
        xor = lrc.decode(gen, lost, survivors, xor_only=True)
        assert torch.equal(xor, sealed[:, lost]) == binary, lost
        wrong_in_gf2.append(not binary)
    if scheme.startswith("cp-"):
        assert all(wrong_in_gf2)
    assert wrong_in_gf2[2]                  # G_r
