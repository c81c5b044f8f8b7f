"""The port's planning copies and codec/engine against the JAX reference.

Generator matrices, compiled plans (reads, targets, coefficients) and
every codec/engine output must be byte-identical to the reference's; the
port runs on the CPU here (``device="cpu"``), through the plain versions
of its kernel.
"""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.codec import StripeCodec as RefCodec  # noqa: E402
from repro.core.engine import BatchedCodecEngine as RefEngine  # noqa: E402
from repro.core.planner import RepairPlanner as RefPlanner  # noqa: E402
from repro.core.schemes import PAPER_PARAMS  # noqa: E402
from repro.core.schemes import SCHEMES as REF_SCHEMES  # noqa: E402
from repro.core.schemes import make_scheme as ref_scheme  # noqa: E402
from repro_torch.convert import from_reference  # noqa: E402
from repro_torch.core.codec import StripeCodec, cached_codec  # noqa: E402
from repro_torch.core.engine import BatchedCodecEngine  # noqa: E402
from repro_torch.core.planner import RepairPlanner  # noqa: E402
from repro_torch.core.schemes import SCHEMES, make_scheme  # noqa: E402

CPU = "cpu"
P1_TO_P5 = [PAPER_PARAMS[f"P{i}"] for i in range(1, 6)]


def _same_plan(port, ref):
    assert port.op == ref.op
    assert port.targets == ref.targets and port.reads == ref.reads
    assert port.coeffs.dtype == np.uint8
    assert np.array_equal(port.coeffs, ref.coeffs)


# ------------------------------------------------------------------ schemes
@pytest.mark.parametrize("geom", P1_TO_P5, ids=[f"P{i}" for i in range(1, 6)])
@pytest.mark.parametrize("name", sorted(REF_SCHEMES))
def test_generator_matrices_match(name, geom):
    assert sorted(SCHEMES) == sorted(REF_SCHEMES)
    port, ref = make_scheme(name, *geom), ref_scheme(name, *geom)
    assert port.gen.dtype == ref.gen.dtype
    assert np.array_equal(port.gen, ref.gen)
    assert [g.items for g in port.groups] == [g.items for g in ref.groups]
    assert [g.coeffs for g in port.groups] == [g.coeffs for g in ref.groups]
    assert (port.cascade is None) == (ref.cascade is None)
    if port.cascade is not None:
        assert port.cascade.members == ref.cascade.members
    assert port.tolerance == ref.tolerance
    carried = from_reference(ref)
    assert np.array_equal(carried.gen, port.gen)
    assert (carried.name, carried.k, carried.r, carried.p) == \
        (port.name, port.k, port.r, port.p)
    assert carried.groups == port.groups and carried.cascade == port.cascade
    assert carried.tolerance == port.tolerance


# ------------------------------------------------------------------ planner
def _patterns(n):
    return [(i,) for i in range(n)] + list(itertools.combinations(range(n), 2))


@pytest.mark.parametrize("geom", [(6, 2, 2), (24, 2, 2)])
@pytest.mark.parametrize("name", ["cp-azure", "cp-uniform"])
def test_plans_match_for_every_one_and_two_block_pattern(name, geom):
    port = RepairPlanner(make_scheme(name, *geom))
    ref = RefPlanner(ref_scheme(name, *geom))
    n = port.scheme.n
    for failed in range(n):
        _same_plan(port.single_plan(failed), ref.single_plan(failed))
    for pattern in _patterns(n):
        try:
            want = ref.multi_plan(pattern)
        except RuntimeError:
            with pytest.raises(RuntimeError):
                port.multi_plan(pattern)
            continue
        got = port.multi_plan(pattern)
        _same_plan(got, want)
        assert got.meta.all_local == want.meta.all_local
        assert got.meta.steps == want.meta.steps
        _same_plan(from_reference(want), want)
    assert port.stats.snapshot() == ref.stats.snapshot()


@pytest.mark.parametrize("geom", [(6, 2, 2), (24, 2, 2)])
@pytest.mark.parametrize("name", ["cp-azure", "cp-uniform"])
def test_decode_plans_match(name, geom):
    """Every 1- and 2-block pattern at (6,2,2); at (24,2,2), where one
    decode solve costs ~10 ms a package, every 1-block pattern and a seeded
    sample of 40 of the 378 2-block patterns."""
    port = RepairPlanner(make_scheme(name, *geom))
    ref = RefPlanner(ref_scheme(name, *geom))
    n = port.scheme.n
    patterns = _patterns(n)
    if n > 10:
        pairs = patterns[n:]
        pick = np.random.default_rng(11).choice(len(pairs), 40, replace=False)
        patterns = patterns[:n] + [pairs[i] for i in sorted(pick)]
    for pattern in patterns:
        alive = [b for b in range(n) if b not in pattern]
        try:
            want = ref.decode_plan(alive)
        except RuntimeError:
            with pytest.raises(RuntimeError):
                port.decode_plan(alive)
            continue
        _same_plan(port.decode_plan(alive), want)


def test_bit_coeffs_and_expansion_counter():
    from repro_torch.core import planner as P

    plan = RepairPlanner(make_scheme("cp-azure", 6, 2, 2)).multi_plan({0, 7})
    ref = RefPlanner(ref_scheme("cp-azure", 6, 2, 2)).multi_plan({0, 7})
    before = P.bitmatrix_expansions()
    assert np.array_equal(plan.bit_coeffs(), ref.bit_coeffs())
    plan.bit_coeffs()
    assert P.bitmatrix_expansions() == before + 1


# ------------------------------------------------------------ codec, engine
def _pairs(name, geom):
    s, rs = make_scheme(name, *geom), ref_scheme(name, *geom)
    port = BatchedCodecEngine(s, backend="gf", device=CPU)
    ref = RefEngine(rs, backend="ref")
    return s, port, ref


@pytest.mark.parametrize("geom", [(6, 2, 2), (24, 2, 2)])
@pytest.mark.parametrize("name", ["cp-azure", "cp-uniform"])
def test_engine_bytes_match_reference(name, geom, rng):
    s, port, ref = _pairs(name, geom)
    data = rng.integers(0, 256, (8, s.k, 1000), dtype=np.uint8)
    got = port.encode(data)
    want = np.asarray(ref.encode(data))
    assert got.device.type == "cpu" and np.array_equal(got.numpy(), want)
    assert port.effective_backend == "ref"        # gf on the CPU: plain path
    avail = {b: want[:, b, :] for b in range(s.n)}
    # Every block against the original bytes; against the reference engine
    # (slow: eager jnp) the first and last data block and every parity.
    held = [0, s.k - 1] + list(range(s.k, s.n))
    for failed in range(s.n):
        g, gp = port.repair_single(failed, avail)
        assert np.array_equal(g.numpy(), want[:, failed])
        if failed in held:
            w, wp = ref.repair_single(failed, avail)
            assert np.array_equal(g.numpy(), np.asarray(w))
            _same_plan(gp, wp)
    for pattern in [(0, 1), (0, s.k), (s.k, s.n - 1), (1, s.n - 2)]:
        rest = {b: v for b, v in avail.items() if b not in pattern}
        g, _ = port.repair_multi(pattern, rest)
        w, _ = ref.repair_multi(pattern, rest)
        assert sorted(g) == sorted(w)
        for b in g:
            assert np.array_equal(g[b].numpy(), np.asarray(w[b]))
            assert np.array_equal(g[b].numpy(), want[:, b])
    alive = {b: avail[b] for b in range(2, s.n)}
    assert np.array_equal(port.decode(alive).numpy(),
                          np.asarray(ref.decode(alive)))
    assert np.array_equal(port.decode(want, ids=range(2, s.n)).numpy(),
                          data)
    assert port.last_exec_seconds >= 0.0 and port.last_span == 1


@pytest.mark.parametrize("name", ["cp-azure", "cp-uniform"])
def test_codec_bytes_match_reference(name, rng):
    s = make_scheme(name, 6, 2, 2)
    port = StripeCodec(s, backend="gf", device=CPU)
    ref = RefCodec(ref_scheme(name, 6, 2, 2), backend="ref")
    data = rng.integers(0, 256, (s.k, 777), dtype=np.uint8)
    stripe = port.encode(data).numpy()
    assert np.array_equal(stripe, np.asarray(ref.encode(data)))
    avail = {b: stripe[b] for b in range(s.n)}
    for failed in [0, s.k - 1] + list(range(s.k, s.n)):
        g, gmeta = port.repair_single(failed, avail)
        w, wmeta = ref.repair_single(failed, avail)
        assert np.array_equal(g.numpy(), np.asarray(w))
        assert gmeta.reads == wmeta.reads and gmeta.method == wmeta.method
    rest = {b: v for b, v in avail.items() if b not in (0, 7)}
    g, gmeta = port.repair_multi((0, 7), rest)
    w, _ = ref.repair_multi((0, 7), rest)
    for b in w:
        assert np.array_equal(g[b].numpy(), np.asarray(w[b]))
    alive = {b: avail[b] for b in range(2, s.n)}
    assert np.array_equal(port.decode_all(alive).numpy(), data)
    assert np.array_equal(port.decode_all(alive).numpy(),
                          np.asarray(ref.decode_all(alive)))
    reads = sorted(port.planner.single_plan(2).reads)
    coeffs = port.reconstruction_coeffs(2, reads)
    assert np.array_equal(coeffs, ref.reconstruction_coeffs(2, reads))
    assert np.array_equal(port.combine(coeffs, [avail[b] for b in reads])
                          .numpy(), stripe[2])


def test_engine_errors_match_reference(rng):
    s, port, ref = _pairs("cp-azure", (6, 2, 2))
    flat = rng.integers(0, 256, (s.k, 64), dtype=np.uint8)
    for engine in (port, ref):
        with pytest.raises(ValueError):
            engine.encode(flat)
    data = rng.integers(0, 256, (2, s.n, 64), dtype=np.uint8)
    plan = port.planner.single_plan(0)
    missing = {b: data[:, b] for b in range(1, s.n) if b != plan.reads[0]}
    with pytest.raises(KeyError, match=f"block {plan.reads[0]}"):
        port.repair_single(0, missing)
    with pytest.raises(ValueError, match="stack for plan reads"):
        port.execute(plan, data[:, :len(plan.reads) + 1])
    with pytest.raises(ValueError, match="different scheme"):
        BatchedCodecEngine(make_scheme("cp-azure", 6, 2, 2),
                           planner=port.planner, device=CPU)


def test_cached_codec_keys_on_backend_and_device():
    a = cached_codec(("cp-azure", 6, 2, 2), "gf", device=CPU)
    assert a is cached_codec(("cp-azure", 6, 2, 2), "gf", device="cpu")
    assert a is not cached_codec(("cp-azure", 6, 2, 2), "ref", device=CPU)
    assert a.device == torch.device("cpu") and a.backend == "gf"
