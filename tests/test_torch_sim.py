"""The fleet reliability simulator in the port, held to the reference.

Every draw of both simulators is addressed by ``(trial, stream, seq)``
and every timestamp is rounded once on a float32 grid, so the port's
threefry chain (torch int64 masked to 32 bits), its torch event select and
its host loop must give the reference's bits, events and floats exactly:
no tolerance anywhere. The port runs on the CPU here (``device="cpu"``);
the smoke script's committed constants (its bit table and golden run) are
held to the reference too, so its card-side checks compare against the
JAX package's numbers."""
import dataclasses
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import reliability as ref_rel  # noqa: E402
from repro.core import schemes as ref_schemes  # noqa: E402
from repro.dist import topology as ref_topology  # noqa: E402
from repro import sim as ref_sim  # noqa: E402
from repro.ftx.events import to_doc as ref_to_doc  # noqa: E402
from repro.ftx.options import RepairOptions as RefOptions  # noqa: E402
from repro.ftx.stripestore import StoreConfig as RefConfig  # noqa: E402
from repro.launch import simulate as ref_cli  # noqa: E402
from repro.sim import rng as ref_rng  # noqa: E402
from repro_torch import sim  # noqa: E402
from repro_torch.core import reliability, schemes  # noqa: E402
from repro_torch.dist import topology  # noqa: E402
from repro_torch.ftx.events import to_doc  # noqa: E402
from repro_torch.ftx.options import RepairOptions  # noqa: E402
from repro_torch.ftx.stripestore import StoreConfig, StripeStore  # noqa: E402
from repro_torch.launch import simulate as cli  # noqa: E402
from repro_torch.sim import rng  # noqa: E402
from repro_torch.sim.engine import select, select_np  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
M32 = 0xFFFFFFFF
PORT = (reliability, sim, schemes, topology)
REF = (ref_rel, ref_sim, ref_schemes, ref_topology)


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _logs(res, doc):
    """Event logs as documents; the reference's engine leaves ``local`` a
    numpy bool, equal to the port's Python bool."""
    return [[doc(e) for e in trial] for trial in res.event_log]


FIELDS = ("scheme", "trials", "horizon_hours", "seed", "losses",
          "observed_hours", "loss_times", "events", "epochs", "rejected",
          "counts")


def _same(a, b, fields=FIELDS):
    for f in fields:
        assert getattr(a, f) == getattr(b, f), f
    assert _logs(a, to_doc) == _logs(b, ref_to_doc if b.__class__.__module__
                                     .startswith("repro.") else to_doc)


# ------------------------------------------------------------------ bits

def _triples(seed):
    g = np.random.default_rng(seed)
    t = g.integers(0, 1 << 32, (4096, 3), dtype=np.uint64).astype(np.uint32)
    t[:8] = [[a, b, c] for a in (0, M32) for b in (0, M32) for c in (0, M32)]
    t[8:12] = [[0, 0, 1], [1, 0, 0], [0, 1, 0], [5, 57, 2]]
    return t


@pytest.mark.parametrize("seed", [0, 3, 2 ** 31 + 7, M32])
def test_bits_equal_reference(seed):
    t = _triples(seed)
    want = ref_rng.BitSource(seed).bits(t)
    src = rng.BitSource(seed, device="cpu")
    got = src.bits(t)
    assert got.dtype == np.uint32 and np.array_equal(got, want)
    assert np.array_equal(rng.threefry_bits_np(src.key, t), want)
    assert src.bit1(*map(int, t[20])) == want[20]
    assert src.bits(np.zeros((0, 3), np.uint32)).size == 0


def test_duration_transforms_equal_reference():
    bits = rng.BitSource(11, device="cpu").bits(_triples(11))
    bits[:2] = [0, M32]                      # both ends of uniform01
    assert np.array_equal(rng.uniform01(bits), ref_rng.uniform01(bits))
    for mean in (0.5, 336.0, 2000.0, 35064.0):
        assert np.array_equal(rng.exp_hours(bits, mean),
                              ref_rng.exp_hours(bits, mean))
        for shape in (0.7, 1.0, 1.4):
            scale = rng.weibull_scale(mean, shape)
            assert scale == ref_rng.weibull_scale(mean, shape)
            assert np.array_equal(rng.weibull_hours(bits, scale, shape),
                                  ref_rng.weibull_hours(bits, scale, shape))
    t = rng.exp_hours(bits[:64], 100.0)
    assert all(rng.later(a, b) == ref_rng.later(a, b)
               for a, b in zip(t, t[::-1]))


def test_smoke_bit_table_equals_reference():
    table = _smoke().SIM_BITS
    assert len(table) >= 32
    for field in range(4):
        assert {row[field] for row in table} >= {0, M32}
    for (seed, trial, stream, seq, want) in table:
        assert int(ref_rng.BitSource(seed).bit1(trial, stream, seq)) == want
        assert int(rng.BitSource(seed, device="cpu").bit1(
            trial, stream, seq)) == want


# ---------------------------------------------------------------- select

@pytest.mark.parametrize("t,d,n,r", [(64, 7, 7, 2), (300, 28, 28, 7),
                                     (1, 4, 1, 1)])
def test_select_equals_numpy_with_ties_and_inf_rows(t, d, n, r):
    sched = _smoke().random_schedule(np, np.random.default_rng(t), t, d, n,
                                     r)
    got, want = select(sched, CPU), select_np(sched)
    assert got[0].dtype == np.float32
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    # all-inf rows pick column 0, unit 0, at inf
    assert np.isinf(got[0][0]) and got[1][0] == 0 and got[2][0] == 0


def test_select_takes_the_first_of_tied_columns_and_units():
    inf = np.float32(np.inf)
    nf = np.array([[5, 2, 2], [inf, inf, inf], [1, 1, 1]], np.float32)
    nn = np.array([[2, 3], [7, 4], [inf, inf]], np.float32)
    nr = np.array([[9], [4], [1]], np.float32)
    nl = np.full((3, 3), inf, np.float32)
    rt = np.array([2, 4, 1], np.float32)
    ns = np.array([inf, 4, 0.5], np.float32)
    tmin, col, unit = select((nf, nn, nr, nl, rt, ns), CPU)
    assert tmin.tolist() == [2.0, 4.0, 0.5]
    assert col.tolist() == [0, 1, 5] and unit.tolist() == [1, 1, 0]


# ------------------------------------------------------------- hierarchy

@pytest.mark.parametrize("policy", ["contiguous", "spread", "round_robin"])
@pytest.mark.parametrize("nodes,domains,n", [(12, 3, 8), (28, 7, 28),
                                             (8, 2, 7)])
def test_hierarchy_equals_reference(policy, nodes, domains, n):
    got = sim.UnitHierarchy.from_topology(
        n, topology.Topology(num_nodes=nodes, num_domains=domains), policy)
    want = ref_sim.UnitHierarchy.from_topology(
        n, ref_topology.Topology(num_nodes=nodes, num_domains=domains),
        policy)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    streams = [(got.stream_disk_fail(d), got.stream_lse(d)) for d in range(n)]
    assert streams == [(want.stream_disk_fail(d), want.stream_lse(d))
                       for d in range(n)]
    assert got.stream_repair == want.stream_repair
    assert [got.disks_of_rack(j) for j in range(got.num_racks)] == \
        [want.disks_of_rack(j) for j in range(want.num_racks)]
    default = sim.UnitHierarchy.from_topology(n)
    assert dataclasses.astuple(default) == dataclasses.astuple(
        ref_sim.UnitHierarchy.from_topology(n))


@pytest.mark.parametrize("cost_model", ["average", "planner"])
def test_stripe_model_equals_reference_on_every_mask(cost_model):
    from itertools import combinations

    rel = dict(node_mttf_years=0.02, bandwidth_gbps=0.002)
    port = sim.StripeModel(
        schemes.make_scheme("azure", 4, 2, 1),
        sim.SimParams(cost_model=cost_model,
                      reliability=reliability.ReliabilityParams(**rel)))
    ref = ref_sim.StripeModel(
        ref_schemes.make_scheme("azure", 4, 2, 1),
        ref_sim.SimParams(cost_model=cost_model,
                          reliability=ref_rel.ReliabilityParams(**rel)))
    assert port.fmax == ref.fmax == 3
    for f in range(port.fmax + 2):
        for mask in map(frozenset, combinations(range(7), f)):
            assert port.decodable(mask) == ref.decodable(mask)
            if f and port.decodable(mask):
                assert port.cost_blocks(mask) == ref.cost_blocks(mask)
                assert port.tau_hours(mask) == ref.tau_hours(mask)
    with pytest.raises(ValueError):
        sim.SimParams(model="bogus")
    with pytest.raises(ValueError):
        sim.SimParams(weibull_shape=0.0)


# ---------------------------------------------------------------- engine

def _params(mod, rel_mod, **over):
    """tests/test_sim.py's accelerated environment."""
    rel = rel_mod.ReliabilityParams(node_mttf_years=0.02, bandwidth_gbps=0.002,
                                    detect_hours_single=2.0,
                                    detect_hours_multi=10.0)
    base = dict(disk_mttf_hours=0.02 * rel_mod.HOURS_PER_YEAR,
                weibull_shape=1.0, model="paper", cost_model="average",
                reliability=rel)
    base.update(over)
    return mod.SimParams(**base)


def test_golden_run_equals_reference_and_smoke_constants():
    """tests/test_sim.py's all-processes configuration; chip_smoke.py's
    phase 6b holds the card to the same constants."""
    smoke = _smoke()
    sch, params, kw = smoke.golden_config(*REF)
    want = ref_sim.simulate(sch, params, **kw)
    assert smoke.sim_digest(want, ref_to_doc) == smoke.SIM_GOLDEN
    sch, params, kw = smoke.golden_config(*PORT)
    got = sim.simulate(sch, params, device="cpu", **kw)
    _same(got, want)
    assert smoke.sim_digest(got, to_doc) == smoke.SIM_GOLDEN
    assert got.select_seconds > 0 and got.bits_seconds > 0
    assert got.select_seconds + got.bits_seconds < got.wall_seconds
    # the port's oracle, against its engine and against the reference's
    orc = sim.simulate_oracle(sch, params, device="cpu", **kw)
    assert smoke.same_run(got, orc, to_doc, oracle=True)
    ref_orc = ref_sim.simulate_oracle(*smoke.golden_config(*REF)[:2],
                                      **smoke.golden_config(*REF)[2])
    _same(orc, ref_orc)


def test_thinning_run_equals_reference():
    """tests/test_sim.py's paper-model thinning case."""
    kw = dict(trials=20, horizon_hours=6000.0, seed=3, record_events=True)
    got = sim.simulate(schemes.make_scheme("azure", 6, 2, 1),
                       _params(sim, reliability, disk_mttf_hours=100.0),
                       device="cpu", **kw)
    want = ref_sim.simulate(ref_schemes.make_scheme("azure", 6, 2, 1),
                            _params(ref_sim, ref_rel, disk_mttf_hours=100.0),
                            **kw)
    assert got.rejected > 0
    _same(got, want)
    orc = sim.simulate_oracle(schemes.make_scheme("azure", 6, 2, 1),
                              _params(sim, reliability,
                                      disk_mttf_hours=100.0),
                              device="cpu", **kw)
    assert _smoke().same_run(got, orc, to_doc, oracle=True)


@pytest.mark.parametrize("seed", [7, 8])
def test_determinism_runs_equal_reference(seed):
    """tests/test_sim.py's determinism case, and a packed hierarchy with
    node bursts (its burst case)."""
    kw = dict(trials=20, horizon_hours=3000.0, seed=seed, record_events=True)
    _same(sim.simulate(schemes.make_scheme("azure", 4, 2, 1),
                       _params(sim, reliability), device="cpu", **kw),
          ref_sim.simulate(ref_schemes.make_scheme("azure", 4, 2, 1),
                           _params(ref_sim, ref_rel), **kw))
    packed = dict(node_of_disk=tuple(d % 2 for d in range(10)),
                  rack_of_node=(0, 0))
    over = dict(disk_mttf_hours=1e9, node_burst_hours=300.0)
    _same(sim.simulate(schemes.make_scheme("azure", 6, 2, 2),
                       _params(sim, reliability, **over), device="cpu",
                       hierarchy=sim.UnitHierarchy(**packed), **kw),
          ref_sim.simulate(ref_schemes.make_scheme("azure", 6, 2, 2),
                           _params(ref_sim, ref_rel, **over),
                           hierarchy=ref_sim.UnitHierarchy(**packed), **kw))


def test_p5_run_equals_reference():
    """A few trials of chip_smoke.py's phase 6c configuration."""
    smoke = _smoke()
    kw = dict(trials=12, horizon_hours=8000.0, seed=0, record_events=True)
    sch, params, hier = smoke.p5_config(*PORT, "cp-azure")
    got = sim.simulate(sch, params, hierarchy=hier, device="cpu", **kw)
    sch, params, hier = smoke.p5_config(*REF, "cp-azure")
    _same(got, ref_sim.simulate(sch, params, hierarchy=hier, **kw))
    assert got.losses > 0


def test_censoring_and_hierarchy_mismatch():
    got = sim.simulate(schemes.make_scheme("azure", 4, 2, 1),
                       _params(sim, reliability, disk_mttf_hours=1e9),
                       trials=10, horizon_hours=100.0, device="cpu")
    assert got.losses == 0 and got.mttdl_years == float("inf")
    assert got.observed_hours == 1000.0
    with pytest.raises(ValueError):
        sim.simulate(schemes.make_scheme("azure", 4, 2, 1),
                     _params(sim, reliability), trials=1, horizon_hours=1.0,
                     hierarchy=sim.UnitHierarchy.from_topology(5),
                     device="cpu")


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is the card")
    sch = schemes.make_scheme("azure", 4, 2, 1)
    for call in (lambda: rng.BitSource(0),
                 lambda: sim.simulate(sch, _params(sim, reliability),
                                      trials=1, horizon_hours=1.0),
                 lambda: sim.simulate_oracle(sch, _params(sim, reliability),
                                             trials=1, horizon_hours=1.0)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


# ----------------------------------------------------------- calibration

PORT_SPLIT = {"plan_seconds", "read_wait_seconds", "copy_in_seconds",
              "kernel_seconds", "copy_out_seconds", "drain_wait_seconds",
              "reader_busy_seconds", "reader_threads", "no_read_seconds",
              "h2d_bytes", "h2d_pinned_bytes", "staging_reused",
              "staging_allocated", "plans_compiled", "plan_compile_seconds",
              "repairs_cascaded", "reads_global", "kernel_table_chunks",
              "read_open_seconds", "read_copy_seconds", "read_sleep_seconds",
              "read_overshoot_seconds", "read_lock_seconds",
              "read_handoff_seconds", "read_cpu_seconds"}


def test_measure_repair_bandwidth_equals_reference_on_twin_stores(tmp_path):
    args = dict(scheme="cp-azure", k=4, r=2, p=1, block_size=1024,
                backend="ref")
    # The synchronous repair reads in a fixed order: every field but the
    # wall timings is equal. The default pipeline's reader threads add
    # their link times in the order they finish, in either package, so
    # there sim_seconds (and gbps) may differ from run to run in the last
    # bits; every other field is equal.
    for opts, exact in ((RepairOptions(pipeline=False),
                         RefOptions(pipeline=False)), (None, None)):
        got = sim.measure_repair_bandwidth(
            tmp_path / f"port{exact is None}", StoreConfig(**args),
            objects=2, options=opts, device="cpu")
        want = ref_sim.measure_repair_bandwidth(
            tmp_path / f"ref{exact is None}", RefConfig(**args), objects=2,
            options=exact)
        timing = {k for k in want if k.endswith("_seconds")
                  and k != "sim_seconds"}
        if exact is None:
            timing |= {"sim_seconds", "gbps"}
            for k in ("sim_seconds", "gbps"):
                assert got[k] == pytest.approx(want[k], rel=1e-12, abs=0)
        # The port's own split of where the repair's time went and how its
        # gathers were staged: fields the reference does not report,
        # timings but for the reader count, the bytes sent to the device
        # (every block read, once; none page-locked on the CPU) and one
        # staging buffer a launch.
        assert set(got) - set(want) == PORT_SPLIT
        assert got["reader_threads"] == (1 if exact is not None else
                                         StoreConfig().prefetch_threads)
        assert got["h2d_bytes"] == got["bytes_read"]
        assert got["h2d_pinned_bytes"] == 0
        assert got["staging_reused"] + got["staging_allocated"] == \
            got["launches"]
        assert got["plans_compiled"] == got["patterns"]
        assert got["kernel_table_chunks"] == 0
        timing |= PORT_SPLIT
        assert {k: v for k, v in got.items() if k not in timing} == \
            {k: v for k, v in want.items() if k not in timing}
        assert got["gbps"] > 0 and got["bytes_read"] > 0
        assert got["pipelined"] == (exact is None)
    rel = sim.calibrated(reliability.ReliabilityParams(), got)
    assert rel.bandwidth_gbps == got["gbps"]
    assert sim.measured_bandwidth({"bytes_read": 2_000_000_000,
                                   "sim_seconds": 8.0}) == 2.0
    assert sim.calibrated(None, 0.5).bandwidth_gbps == 0.5
    with pytest.raises(ValueError):
        sim.measured_bandwidth({"bytes_read": 1, "sim_seconds": 0.0})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            sim.measure_repair_bandwidth(tmp_path / "card",
                                         StoreConfig(**args))


def _calib_config():
    return StoreConfig(scheme="cp-azure", k=24, r=2, p=2, block_size=2048,
                       backend="gf")


def test_smoke_sim_path_shapes_are_the_calibration_stores(tmp_path,
                                                          monkeypatch):
    """chip_smoke.py holds the GF(2^8) kernels to their plain version at
    the (S, m, k, B) of its "sim" rows: those the calibration store's seal
    and repair give them."""
    from repro_torch.kernels import ref as ref_lib

    seen = set()
    for name in ("gf256_matmul_batched_ref", "gf256_matmul_ref"):
        real = getattr(ref_lib, name)

        def record(coef, data, _real=real):
            stripes = data.shape[0] if data.dim() == 3 else 1
            seen.add((stripes, *coef.shape, data.shape[-1]))
            return _real(coef, data)

        monkeypatch.setattr(ref_lib, name, record)
    sim.measure_repair_bandwidth(tmp_path, _calib_config(), device="cpu")
    rows = {row[1:] for row in _smoke().GF_PATH_SHAPES if row[0] == "sim"}
    assert seen == rows == {(1, 4, 24, 2048), (1, 1, 12, 2048)}


def test_smoke_lost_disk_is_rebuilt_by_the_calibration_repair(tmp_path):
    """chip_smoke.py's phase 6d empties the failed node's block files as
    the store fails it; only the repair brings them back, byte-equal."""
    smoke = _smoke()
    with smoke.losing_disks(StripeStore) as lost:
        tele = sim.measure_repair_bandwidth(tmp_path, _calib_config(),
                                            device="cpu")
    assert len(lost) == tele["stripes_repaired"] == 2
    assert all(smoke.sha(p) == h for p, h in lost.items())
    assert "fail_and_empty" not in StripeStore.fail_node.__qualname__


# ------------------------------------------------------------ the CLI

TIMING = ("wall_seconds", "events_per_sec")
# azure(4,2,1) on 8 nodes in 2 racks, contiguous: a rack burst downs 4
# disks, past p + r = 3, so trials lose data within the horizon.
CLI_ARGS = ["--scheme", "azure", "--k", "4", "--r", "2", "--p", "1",
            "--trials", "20", "--horizon-hours", "3000",
            "--disk-mttf-hours", "400", "--bandwidth-gbps", "0.002",
            "--closed-form", "--oracle", "--rack-burst-hours", "2000",
            "--nodes", "8", "--domains", "2"]


def _run(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, json.loads(out.out), out.err


def test_cli_equals_reference(capsys, tmp_path):
    rc, got, _ = _run(cli.main, CLI_ARGS + ["--device", "cpu"], capsys)
    ref_rc, want, _ = _run(ref_cli.main, CLI_ARGS, capsys)
    assert rc == ref_rc == 0 and got["oracle"]["bit_identical"]
    assert "sim_over_closed_form" in got
    for k in TIMING:
        got.pop(k), want.pop(k)
    assert got == want
    # --events writes the engine's logs (the reference's engine leaves a
    # numpy bool in RepairDoneEvent.local, which JSON cannot write).
    events = tmp_path / "events.json"
    rc, got, _ = _run(cli.main, CLI_ARGS[:16] + [
        "--device", "cpu", "--events", str(events)], capsys)
    assert rc == 0 and got["events_path"] == str(events)
    logs = json.loads(events.read_text())
    c = got["counts"]
    assert len(logs) == 20 and sum(map(len, logs)) == (
        got["events"] - c["noop"] - c["disk_fail_rejected"] + c["data_loss"])
    assert c["repair_done"] > 0


def test_cli_calibrate_equals_reference(capsys, tmp_path):
    argv = ["--scheme", "cp-azure", "--k", "4", "--r", "2", "--p", "1",
            "--trials", "10", "--horizon-hours", "2000",
            "--disk-mttf-hours", "300", "--calibrate"]
    rc, got, err = _run(cli.main, argv + [str(tmp_path / "port"), "--device",
                                          "cpu"], capsys)
    ref_rc, want, ref_err = _run(ref_cli.main, argv + [str(tmp_path / "ref")],
                                 capsys)
    assert rc == ref_rc == 0

    def measured(text):
        return [ln for ln in text.splitlines() if ln.startswith("# measured")]

    assert measured(err) == measured(ref_err) and len(measured(err)) == 1
    for k in TIMING:
        got.pop(k), want.pop(k)
    assert got == want


def test_cli_oracle_divergence_exits_1(capsys, monkeypatch):
    real = cli.simulate_oracle

    def off_by_one(*a, **kw):
        res = real(*a, **kw)
        return dataclasses.replace(res, observed_hours=res.observed_hours
                                   + 1.0)

    monkeypatch.setattr(cli, "simulate_oracle", off_by_one)
    rc, got, err = _run(cli.main, CLI_ARGS[:10] + ["--oracle", "--device",
                                                   "cpu"], capsys)
    assert rc == 1 and not got["oracle"]["bit_identical"]
    assert "diverged" in err


# tests/test_orchestration.py's --replay command line, then each knob of
# the replay on its own and the reference CLI's defaults.
REPLAY_ARGS = ["--replay", str(ROOT / "tests" / "data" /
                               "correlated_trace.json"),
               "--nodes", "24", "--domains", "12", "--policy", "spread"]


@pytest.mark.parametrize("knobs", [
    ["--schedule", "global", "--destinations", "topology", "--rebalance"],
    ["--schedule", "locality", "--destinations", "in_place"],
    ["--schedule", "none", "--destinations", "topology"],
    ["--destinations", "in_place", "--rebalance"],
    []], ids=["global-topology-rebalance", "locality-in_place",
              "none-topology", "in_place-rebalance", "defaults"])
def test_cli_replay_equals_reference(knobs, capsys, tmp_path):
    """``--replay`` prints the reference command's JSON byte for byte."""
    argv = REPLAY_ARGS + knobs
    assert cli.main(argv + ["--replay-store", str(tmp_path / "port"),
                            "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert ref_cli.main(argv + ["--replay-store",
                                str(tmp_path / "ref")]) == 0
    want = capsys.readouterr().out
    assert got == want
    doc = json.loads(got)
    assert doc["trace_events"] == 6 and len(doc["batches"]) == 4
    assert (doc["rebalance"] is None) == ("--rebalance" not in knobs)


def test_cli_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is the card")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--trials", "1"])
