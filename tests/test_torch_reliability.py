"""Repair metrics, the MTTDL chain, fleet sizing and the fleet-event
schema in the port, held to the reference.

The port keeps its own copies of ``core/metrics.py``,
``core/reliability.py``, ``ftx/events.py`` and the sizing half of
``ftx/fleet.py``; on the same schemes and parameters every number must be
the reference's exactly (the same numpy arithmetic and the same exact
``Fraction`` elimination), and every event must serialize to the same
document and trace bytes."""
import dataclasses
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import metrics as ref_metrics  # noqa: E402
from repro.core import reliability as ref_rel  # noqa: E402
from repro.core.schemes import PAPER_PARAMS  # noqa: E402
from repro.core.schemes import make_scheme as ref_make  # noqa: E402
from repro.ftx import events as ref_events  # noqa: E402
from repro.ftx import fleet as ref_fleet  # noqa: E402
from repro_torch import core as port_core  # noqa: E402
from repro_torch import ftx as port_ftx  # noqa: E402
from repro_torch.core import metrics, reliability  # noqa: E402
from repro_torch.core.schemes import make_scheme  # noqa: E402
from repro_torch.ftx import events, fleet  # noqa: E402

TRACE = Path(__file__).resolve().parent / "data" / "correlated_trace.json"
SCHEMES = ("azure", "cp-azure", "cp-uniform")
GEOMETRIES = [(name, pset) for name in SCHEMES for pset in ("P1", "P5")]


def _twins(name, pset):
    k, r, p = PAPER_PARAMS[pset]
    return ref_make(name, k, r, p), make_scheme(name, k, r, p)


# ------------------------------------------------------------- metrics

@pytest.mark.parametrize("name,pset", GEOMETRIES)
def test_summarize_equals_reference(name, pset):
    ref, port = _twins(name, pset)
    assert metrics.summarize(port) == ref_metrics.summarize(ref)
    assert metrics.adrc(port, "paper") == ref_metrics.adrc(ref, "paper")


@pytest.mark.parametrize("name,pset", GEOMETRIES)
def test_arc_f_and_unrecoverable_fraction_equal_reference(name, pset):
    ref, port = _twins(name, pset)
    # P1 enumerates every pattern; P5 passes the exact caps and samples.
    samples, cap = (400, 20000) if pset == "P1" else (60, 100)
    for f in (3, 4):
        assert metrics.arc_f(port, f, samples=samples, seed=5) == \
            ref_metrics.arc_f(ref, f, samples=samples, seed=5)
    for f in (0, 1, 2, 3, 4, ref.p + ref.r + 1):
        assert metrics.unrecoverable_fraction(
            port, f, samples=300, exact_cap=cap) == \
            ref_metrics.unrecoverable_fraction(ref, f, samples=300,
                                               exact_cap=cap)


# --------------------------------------------------------- Markov chain

REL = dict(node_mttf_years=0.5, bandwidth_gbps=0.05, detect_hours_single=1.0,
           detect_hours_multi=4.0)


@pytest.mark.parametrize("model", ["paper", "strict"])
@pytest.mark.parametrize("name", SCHEMES)
def test_stripe_mttdl_equals_reference(name, model):
    ref, port = _twins(name, "P1")
    assert reliability.stripe_mttdl_years(port, model=model) == \
        ref_rel.stripe_mttdl_years(ref, model=model)
    got = reliability.stripe_mttdl_years(
        port, reliability.ReliabilityParams(**REL), samples=400, seed=3,
        model=model)
    assert got == ref_rel.stripe_mttdl_years(
        ref, ref_rel.ReliabilityParams(**REL), samples=400, seed=3,
        model=model)


def test_stripe_mttdl_at_p5_equals_reference():
    ref, port = _twins("cp-azure", "P5")
    assert reliability.stripe_mttdl_years(port, samples=30) == \
        ref_rel.stripe_mttdl_years(ref, samples=30)


def test_unknown_reliability_model_raises():
    with pytest.raises(ValueError):
        reliability.stripe_mttdl_years(make_scheme("azure", 4, 2, 1),
                                       model="bogus")


@pytest.mark.parametrize("name", SCHEMES)
def test_profiles_equal_reference(name):
    ref, port = _twins(name, "P1")
    samples = 200
    assert np.array_equal(
        reliability.repair_cost_profile(port, samples=samples),
        ref_rel.repair_cost_profile(ref, samples=samples))
    assert np.array_equal(
        reliability.unrecoverable_profile(port, samples=samples),
        ref_rel.unrecoverable_profile(ref, samples=samples))


def test_repair_hours_and_calibrate_scale_equal_reference():
    prm, ref_prm = (mod.ReliabilityParams(**REL) for mod in (reliability,
                                                              ref_rel))
    for f in (1, 2, 3):
        assert reliability.repair_hours(7.5, f, prm) == \
            ref_rel.repair_hours(7.5, f, ref_prm)
    ref, port = ref_make("azure", 4, 2, 1), make_scheme("azure", 4, 2, 1)
    got = reliability.calibrate_scale(port, 50.0, prm, samples=50)
    want = ref_rel.calibrate_scale(ref, 50.0, ref_prm, samples=50)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert reliability.HOURS_PER_YEAR == ref_rel.HOURS_PER_YEAR


def test_core_exports_metrics_and_reliability():
    assert port_core.metrics is metrics
    assert port_core.reliability is reliability


# ------------------------------------------------------- fleet sizing

def _fields(cands):
    return [dataclasses.asdict(c) for c in cands]


def test_size_fleet_equals_reference():
    """tests/test_fleet.py's ranking case on narrow geometries, with ties
    in overhead (the wide chains are held to the reference above)."""
    kw = dict(detect_hours_single=0.0, detect_hours_multi=0.0)
    ref_spec = ref_fleet.FleetSpec(nodes=512, state_bytes=1 << 40,
                                   target_mttdl_years=1.0,
                                   params=ref_rel.ReliabilityParams(**kw))
    spec = fleet.FleetSpec(nodes=512, state_bytes=1 << 40,
                           target_mttdl_years=1.0,
                           params=reliability.ReliabilityParams(**kw))
    args = dict(schemes=("azure", "cp-azure"),
                geometries=[(4, 2, 1), (6, 2, 2)], samples=40)
    got = fleet.size_fleet(spec, **args)
    assert got and _fields(got) == _fields(ref_fleet.size_fleet(ref_spec,
                                                                **args))
    assert [c.meets for c in got] == [True] * len(got)


@pytest.mark.parametrize("state_bytes", [1 << 34, 1 << 36])
def test_evaluate_equals_reference(state_bytes):
    """tests/test_fleet.py's stripe-count case, at P1."""
    ref_spec = ref_fleet.FleetSpec(nodes=64, state_bytes=state_bytes,
                                   target_mttdl_years=0.0)
    spec = fleet.FleetSpec(nodes=64, state_bytes=state_bytes,
                           target_mttdl_years=0.0)
    got = fleet.evaluate(spec, "cp-azure", 6, 2, 2, samples=40)
    want = ref_fleet.evaluate(ref_spec, "cp-azure", 6, 2, 2, samples=40)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_size_fleet_skips_geometries_it_cannot_build_or_place():
    spec = fleet.FleetSpec(nodes=12, state_bytes=1 << 30,
                           target_mttdl_years=0.0)
    ref_spec = ref_fleet.FleetSpec(nodes=12, state_bytes=1 << 30,
                                   target_mttdl_years=0.0)
    # azure+1 needs p >= 2; (12, 2, 2) needs 16 nodes.
    args = dict(schemes=("azure+1", "azure"),
                geometries=[(4, 2, 1), (6, 2, 2), (12, 2, 2)], samples=60)
    got = fleet.size_fleet(spec, **args)
    assert _fields(got) == _fields(ref_fleet.size_fleet(ref_spec, **args))
    assert {(c.scheme, c.k, c.p) for c in got} == {
        ("azure", 4, 1), ("azure", 6, 2), ("azure+1", 6, 2)}


# -------------------------------------------------------------- events

EVENTS = [
    ("DiskFailEvent", dict(t=1.5, disk=3, node=1, rack=0)),
    ("NodeFailEvent", dict(t=2.0, node=4, rack=1)),
    ("RackFailEvent", dict(t=2.0, rack=2)),
    ("SectorErrorEvent", dict(t=0.25, disk=5, block=9)),
    ("ScrubEvent", dict(t=336.0)),
    ("RepairDoneEvent", dict(t=9.0, unit=3, kind="disk", started_at=1.5,
                             blocks_read=12, sim_seconds=27000.0,
                             local=True)),
    ("DataLossEvent", dict(t=11.0, blocks=(0, 3, 5))),
]


@pytest.mark.parametrize("cls,fields", EVENTS, ids=[c for c, _ in EVENTS])
def test_event_docs_equal_reference(cls, fields):
    port = getattr(events, cls)(**fields)
    ref = getattr(ref_events, cls)(**fields)
    doc = events.to_doc(port)
    assert doc == ref_events.to_doc(ref)
    assert events.kind_of(port) == ref_events.kind_of(ref)
    assert events.event_order(port) == ref_events.event_order(ref)
    assert events.from_doc(doc) == port
    assert ref_events.to_doc(ref_events.from_doc(doc)) == doc
    assert getattr(port_ftx, cls) is getattr(events, cls)


def test_event_errors():
    with pytest.raises(ValueError):
        events.from_doc({"event": "meteor", "t": 0.0})
    with pytest.raises(TypeError):
        events.kind_of(events.FleetEvent(t=0.0))


def test_sort_events_equals_reference():
    rows = [dict(e, t=t) for t in (3.0, 1.0, 1.0) for _, e in EVENTS]
    port = [getattr(events, c)(**f) for (c, _), f in
            zip(EVENTS * 3, rows)]
    ref = [getattr(ref_events, c)(**f) for (c, _), f in
           zip(EVENTS * 3, rows)]
    assert [events.to_doc(e) for e in events.sort_events(port)] == \
        [ref_events.to_doc(e) for e in ref_events.sort_events(ref)]


def test_trace_round_trips_byte_for_byte(tmp_path):
    evs = events.load_trace(TRACE)
    assert [events.to_doc(e) for e in evs] == \
        [ref_events.to_doc(e) for e in ref_events.load_trace(TRACE)]
    out = tmp_path / "trace.json"
    events.dump_trace(list(reversed(evs)), out)
    assert out.read_bytes() == TRACE.read_bytes()
    # A bare list of docs loads too.
    bare = tmp_path / "bare.json"
    bare.write_text("[" + ", ".join(
        '{"event": "scrub", "t": %s}' % t for t in (5.0, 1.0)) + "]")
    assert [e.t for e in events.load_trace(bare)] == [1.0, 5.0]
