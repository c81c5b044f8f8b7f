"""The port's orchestration layer against the JAX reference: failure
injection, correlated trace replay, topology-aware destinations, the
rebalancer and elastic re-striping.

:func:`orchestration_cases` runs every case on one package and returns
what it saw (event logs, replay rows and totals, move plans, rebalance
reports, manifests and block-file digests). It runs once for the
reference, in a subprocess whose JAX has eight host devices (the replay's
scheduled-locality counts depend on the mesh), and once for the port in
this process on a mesh of eight ``cpu`` positions; the tests compare the
two. Simulated seconds are exact where a repair runs synchronously and
held to a relative 1e-12 where reader threads sum them.
"""
import hashlib
import importlib.util
import json
import math
import os
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
TRACE = Path(__file__).resolve().parent / "data" / "correlated_trace.json"
MODES_8DEV = ("global", "locality", "none")
# Phase 7b's injector horizon after the replay: three failures.
P5_INJECTOR_HOURS = 40.0
REBALANCE = ("planned", "moved", "windows", "bytes_moved",
             "imbalance_before", "imbalance_after")


def _api(pkg: str) -> SimpleNamespace:
    """The orchestration names of the reference ("repro") or the port
    ("repro_torch", on the CPU)."""
    if pkg == "repro":
        from repro.dist.sharding import with_rules
        from repro.dist.topology import Topology
        from repro.ftx import (FailureInjector, RepairOptions, StoreConfig,
                               StripeStore, plan_moves, rebalance)
        from repro.ftx.events import load_trace, to_doc
        from repro.ftx.failures import replay_trace, restripe

        def mesh(shape):
            return jax.make_mesh(shape, ("data", "model"))

        kw = {}
    else:
        from repro_torch.dist import make_mesh, with_rules
        from repro_torch.dist.topology import Topology
        from repro_torch.ftx import (FailureInjector, RepairOptions,
                                     StoreConfig, StripeStore, plan_moves,
                                     rebalance, replay_trace, restripe)
        from repro_torch.ftx.events import load_trace, to_doc

        def mesh(shape):
            return make_mesh(shape, ("data", "model"),
                             devices=("cpu",) * math.prod(shape))

        kw = {"device": "cpu"}
    return SimpleNamespace(
        with_rules=with_rules, Topology=Topology,
        FailureInjector=FailureInjector, Options=RepairOptions,
        Config=StoreConfig, Store=StripeStore, plan_moves=plan_moves,
        rebalance=rebalance, load_trace=load_trace, to_doc=to_doc,
        replay_trace=replay_trace, restripe=restripe, mesh=mesh, kw=kw)


def _files(store) -> str:
    """Digest of every block file, in (stripe, block) order."""
    h = hashlib.sha256()
    for sid in sorted(store.stripes):
        for b in range(store.scheme.n):
            h.update(store._block_path(sid, b).read_bytes())
    return h.hexdigest()


def _placement(store) -> dict:
    """Where the store says each block lives, the block files that exist
    (paths under its root) and the manifest it writes."""
    store.save_manifest()
    return {
        "node_of_block": {str(sid): list(s.node_of_block)
                          for sid, s in sorted(store.stripes.items())},
        "paths": sorted(str(p.relative_to(store.root))
                        for p in store.root.glob("node*/*.blk")),
        "manifest": json.loads((store.root / "manifest.json").read_text()),
        "files": _files(store)}


def _trace_store(api, root, *, stripes=40, block=512, num_nodes=24,
                 domains=12, spread_width=2, scheme="cp-azure",
                 policy="spread"):
    """tests/test_orchestration.py's store on the trace fixture's
    geometry: 2-node racks."""
    topo = api.Topology(num_nodes=num_nodes, num_domains=domains,
                        spread_width=spread_width, seed=7)
    cfg = api.Config(scheme=scheme, k=6, r=2, p=2, block_size=block,
                     batch_stripes=8, pipeline_window=8, prefetch_threads=2,
                     placement_policy=policy)
    store = api.Store(root, cfg, num_nodes=num_nodes, topology=topo,
                      **api.kw)
    store.put("blob", np.random.default_rng(3).integers(
        0, 256, stripes * cfg.k * block, dtype=np.uint8).tobytes())
    store.seal()
    assert len(store.stripes) == stripes
    return store


def p5_trace_store(api, root, block):
    """chip_smoke.py phase 7b's store at ``block``-byte blocks: cp-azure P5
    (k=24, r=2, p=2), 64 stripes, 48 nodes in 24 two-node domains,
    ``spread`` placement of width 16, topology seed 7."""
    cfg = api.Config(scheme="cp-azure", k=24, r=2, p=2, block_size=block,
                     placement_policy="spread")
    topo = api.Topology(num_nodes=48, num_domains=24, spread_width=16,
                        seed=7)
    store = api.Store(root, cfg, num_nodes=48, topology=topo, **api.kw)
    store.put("blob", np.random.default_rng(3).integers(
        0, 256, 64 * 24 * block, dtype=np.uint8).tobytes())
    store.seal()
    assert len(store.stripes) == 64
    return store


def _replay(api, res) -> dict:
    return {"batches": res["batches"], "totals": res["totals"],
            "events": [api.to_doc(e) for e in res["events"]],
            "rebalance": res["rebalance"]}


def _report(rep) -> dict:
    return {f: getattr(rep, f) for f in REBALANCE}


def _injector_cases(api, root: Path) -> dict:
    out = {}
    for pipeline in (None, False):
        store = api.Store(root / f"inj-{pipeline}", api.Config(
            scheme="cp-azure", k=6, r=2, p=2, block_size=2048), **api.kw)
        rng = np.random.default_rng(0)
        for i in range(6):
            store.put(f"o{i}", rng.integers(0, 256, int(rng.integers(
                64, 6000)), dtype=np.uint8).tobytes())
        store.seal()
        inj = api.FailureInjector(store, mttf_hours=10.0, seed=1,
                                  pipeline=pipeline)
        events = inj.run(hours=12.0)
        out[f"run/{pipeline}"] = {
            "events": [api.to_doc(e) for e in events],
            "failures": len(inj.failures()), "repairs": len(inj.repairs()),
            "clock": inj.clock, "files": _files(store)}
    store = _trace_store(api, root / "inj-replay", stripes=24)
    inj = api.FailureInjector(store, seed=0, pipeline=False)
    events = inj.replay(api.load_trace(TRACE))
    out["replay"] = {"events": [api.to_doc(e) for e in events],
                     "clock": inj.clock, "files": _files(store)}
    return out


def _replay_cases(api, root: Path, p5_blocks) -> dict:
    out = {}
    events = api.load_trace(TRACE)
    for mode in ("global", "none"):
        store = _trace_store(api, root / f"one-{mode}", stripes=24)
        res = api.replay_trace(store, events,
                               options=api.Options(schedule=mode))
        out[f"1dev/{mode}"] = {**_replay(api, res), "files": _files(store)}
    base = _trace_store(api, root / "eight", stripes=96)
    base.save_manifest()
    with api.with_rules(api.mesh((8, 1))):
        for mode in MODES_8DEV:
            shutil.copytree(base.root, root / f"eight-{mode}")
            store = api.Store.load(root / f"eight-{mode}", **api.kw)
            res = api.replay_trace(store, events, options=api.Options(
                schedule=mode, pipeline=True))
            out[f"8dev/{mode}"] = {**_replay(api, res),
                                   "files": _files(store)}
    store = _trace_store(api, root / "permanent", stripes=24)
    res = api.replay_trace(store, events, options=api.Options(
        destinations="topology", pipeline=False), revive=False,
        rebalance_after=True)
    out["permanent"] = {**_replay(api, res), **_placement(store),
                        "down": sorted(n for n, s in store.nodes.items()
                                       if s.name != "UP")}
    for block in p5_blocks:
        store = p5_trace_store(api, root / f"p5-{block}", block)
        res = api.replay_trace(store, events, options=api.Options(
            schedule="global", destinations="topology", pipeline=False),
            revive=False, rebalance_after=True)
        inj = api.FailureInjector(store, seed=0, pipeline=False)
        inj.run(hours=P5_INJECTOR_HOURS)
        out[f"p5/{block}"] = {**_replay(api, res), "files": _files(store),
                              "injector": [api.to_doc(e)
                                           for e in inj.events]}
    return out


def _rebalance_cases(api, root: Path) -> dict:
    out = {}
    expand = dict(num_nodes=26, num_domains=13, spread_width=2, seed=7)
    store = _trace_store(api, root / "rr", stripes=48, policy="round_robin")
    store.expand(api.Topology(**expand))
    plan = api.plan_moves(store)
    capped = api.plan_moves(store, max_moves=5)
    hooks = []
    rep = api.rebalance(store, hook=lambda stage, i: hooks.append((stage,
                                                                    i)))
    again = api.rebalance(store)
    out["expand"] = {"plan": [[m.sid, m.block, m.src, m.dst] for m in plan],
                     "capped": [[m.sid, m.block, m.src, m.dst]
                                for m in capped],
                     "report": _report(rep), "again": _report(again),
                     "hooks": sorted(hooks), **_placement(store)}
    store = _trace_store(api, root / "frozen", stripes=24)
    store.expand(api.Topology(**expand))
    out["frozen"] = {"plan": len(api.plan_moves(store)),
                     "report": _report(api.rebalance(store))}
    store = _trace_store(api, root / "drain", stripes=24, num_nodes=40,
                         domains=8, spread_width=3)
    victim = store.stripes[min(store.stripes)].node_of_block[0]
    store.fail_node(victim)
    store.repair_all(options=api.Options(destinations="in_place",
                                         pipeline=False))
    plan = api.plan_moves(store)
    rep = api.rebalance(store, pipelined=False)
    out["drain"] = {"plan": [[m.sid, m.block, m.src, m.dst] for m in plan],
                    "report": _report(rep), "victim": victim,
                    **_placement(store)}
    return out


def _restripe_cases(api, root: Path) -> dict:
    store = api.Store(root / "a", api.Config(
        scheme="cp-azure", k=4, r=2, p=2, block_size=1024), **api.kw)
    rng = np.random.default_rng(0)
    for i in range(4):
        store.put(f"o{i}", rng.integers(0, 256, int(rng.integers(64, 6000)),
                                        dtype=np.uint8).tobytes())
    store.seal()
    new, tele = api.restripe(store, api.Config(
        scheme="cp-uniform", k=8, r=2, p=2, block_size=1024), root / "b")
    return {"telemetry": tele, **_placement(new),
            "objects": {k: hashlib.sha256(np.asarray(new.get(k)).tobytes())
                        .hexdigest() for k in sorted(new.objects)}}


def orchestration_cases(pkg: str, root) -> dict:
    """Every case of this module on ``pkg``; JSON-able. Phase 7b's store
    replays at 1 KiB blocks on both packages and at 2 KiB on the port
    too, whose counts must not move with the block size."""
    api, root = _api(pkg), Path(root)
    p5_blocks = (1024,) if pkg == "repro" else (1024, 2048)
    return {"injector": _injector_cases(api, root / "injector"),
            "replay": _replay_cases(api, root / "replay", p5_blocks),
            "rebalance": _rebalance_cases(api, root / "rebalance"),
            "restripe": _restripe_cases(api, root / "restripe")}


def _reference(fn: str, root: Path) -> subprocess.Popen:
    """Start ``fn("repro", root)`` of this module in a process whose JAX
    has eight host devices; :func:`_result` reads what it printed."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(Path(__file__).parent)]))
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") +
                        " --xla_force_host_platform_device_count=8").strip()
    code = (f"import json, sys, {Path(__file__).stem} as t; "
            f"print(json.dumps(t.{fn}('repro', sys.argv[1])))")
    return subprocess.Popen([sys.executable, "-c", code, str(root)],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _result(proc: subprocess.Popen) -> dict:
    try:
        out, err = proc.communicate(timeout=600)
    finally:
        proc.kill()
    assert proc.returncode == 0, err[-4000:]
    return json.loads(out.splitlines()[-1])


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    proc = _reference("orchestration_cases", tmp_path_factory.mktemp("ref"))
    try:
        port = orchestration_cases("repro_torch", tmp_path_factory.mktemp("port"))
    except BaseException:
        proc.kill()
        raise
    return _result(proc), json.loads(json.dumps(port))


def _same(got, want, path="", inexact=False):
    """Equal, but ``sim_seconds`` (and event times, which add it) to a
    relative 1e-12 under ``inexact``: a pipelined repair sums reader
    threads' link times in their finishing order."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _same(got[k], want[k], f"{path}/{k}", inexact)
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}[{i}]", inexact)
    elif inexact and isinstance(want, float):
        assert got == pytest.approx(want, rel=1e-12, abs=0), path
    else:
        assert got == want, path


@pytest.mark.parametrize("case", ["run/None", "run/False", "replay"])
def test_failure_injector_logs_equal_reference(cases, case):
    """FailureInjector.run (Poisson failures from the explicit generator)
    and .replay: the same event log, clock and block files; exact with
    synchronous repairs."""
    ref, port = cases
    _same(port["injector"][case], ref["injector"][case], case,
          inexact=case == "run/None")
    got = port["injector"][case]
    fails = [e for e in got["events"] if e["event"] == "node_fail"]
    assert fails and len(fails) * 2 == len(got["events"])
    if case.startswith("run"):
        assert got["failures"] == got["repairs"] == len(fails)


@pytest.mark.parametrize("case", ["1dev/global", "1dev/none"]
                         + [f"8dev/{m}" for m in MODES_8DEV])
def test_replay_trace_equals_reference(cases, case):
    """replay_trace's rows, events and totals on the fixture store, and
    the block files it leaves, on one device and under an 8x1 mesh."""
    ref, port = cases
    _same(port["replay"][case], ref["replay"][case], case, inexact=True)
    rows = port["replay"][case]["batches"]
    assert [r["nodes"] for r in rows] == [[7, 17], [4, 5], [3], [20, 21]]


def test_replay_schedule_modes_keep_bytes_and_order_locality(cases):
    """One device: the scheduler is inert. Eight: global beats greedy
    beats contiguous on scheduled shard-local reads, and all three modes
    leave the same bytes."""
    got = cases[1]["replay"]
    one = [got[f"1dev/{m}"] for m in ("global", "none")]
    assert one[0]["files"] == one[1]["files"]
    assert all(r["totals"]["scheduled_local"] ==
               r["totals"]["contiguous_local"] for r in one)
    eight = {m: got[f"8dev/{m}"] for m in MODES_8DEV}
    assert len({c["files"] for c in eight.values()}) == 1
    g, l, c = (eight[m]["totals"]["scheduled_local"] for m in MODES_8DEV)
    assert g > l > c
    assert eight["global"]["totals"]["schedule_total"] == \
        eight["none"]["totals"]["schedule_total"] > 0


def test_permanent_loss_relocates_like_reference(cases):
    """revive=False with topology destinations: the failed nodes stay
    down, and manifests, node_of_block, block-file paths, the rebalance
    pass and the bytes equal the reference's."""
    ref, port = cases
    _same(port["replay"]["permanent"], ref["replay"]["permanent"])
    got = port["replay"]["permanent"]
    assert got["down"] == [3, 4, 5, 7, 17, 20, 21]
    assert got["totals"]["blocks_relocated"] > 0
    assert not any(n in got["down"] for nodes in
                   got["node_of_block"].values() for n in nodes)


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.parametrize("block", [1024, 2048])
def test_p5_replay_counts_are_the_smoke_constants(cases, block):
    """chip_smoke.py phase 7b's geometry: every count at 1 KiB and 2 KiB
    blocks equal to the reference's at 1 KiB (everything, bytes and
    simulated times too, at 1 KiB) and to the constants the smoke holds
    the card's 1 MiB run to; only the bytes moved scale with the
    block."""
    ref, port = cases
    got, want = port["replay"][f"p5/{block}"], ref["replay"]["p5/1024"]
    if block == 1024:
        _same(got, want)

    def counts(rows):
        return [{k: v for k, v in r.items() if k != "sim_seconds"}
                for r in rows]

    def repairs(events):
        return [(e["unit"], e["blocks_read"], e["local"]) for e in events
                if e["event"] == "repair_done"]

    assert counts(got["batches"]) == counts(want["batches"])
    assert repairs(got["injector"]) == repairs(want["injector"])
    smoke = _smoke()
    replay, inj = smoke.REPLAY_EXPECTED, smoke.INJECTOR_EXPECTED
    assert [r["nodes"] for r in got["batches"]] == replay["nodes"]
    assert [r["blocks_read"] for r in got["batches"]] == \
        replay["blocks_read"]
    assert {k: got["totals"][k] for k in replay["totals"]} == \
        replay["totals"]
    rebal = dict(got["rebalance"])
    assert rebal.pop("bytes_moved") == rebal["moved"] * block
    assert rebal == replay["rebalance"]
    assert inj["hours"] == P5_INJECTOR_HOURS
    assert repairs(got["injector"]) == list(zip(
        inj["nodes"], inj["blocks_read"], inj["local"]))


@pytest.mark.parametrize("case", ["expand", "frozen", "drain"])
def test_rebalance_equals_reference(cases, case):
    """plan_moves and rebalance after an expansion (round_robin), on
    saturated spread copysets (an empty plan), and draining a node left
    down by an in-place repair: the same moves, reports, placements,
    manifests and block files."""
    ref, port = cases
    _same(port["rebalance"][case], ref["rebalance"][case], case)
    got = port["rebalance"][case]
    if case == "expand":
        rep = got["report"]
        assert rep["planned"] == rep["moved"] == len(got["plan"]) > 0
        assert got["capped"] == got["plan"][:5]
        assert rep["imbalance_after"] < rep["imbalance_before"]
        assert got["again"]["planned"] == 0
        assert sorted({i for s, i in got["hooks"] if s == "commit"}) == \
            list(range(rep["windows"]))
    elif case == "frozen":
        assert got["plan"] == got["report"]["moved"] == 0
    else:
        assert got["report"]["moved"] >= 1
        assert all(got["victim"] not in nodes
                   for nodes in got["node_of_block"].values())


def test_restripe_equals_reference(cases):
    ref, port = cases
    _same(port["restripe"], ref["restripe"])
    assert port["restripe"]["telemetry"]["bytes_moved"] > 0


def test_smoke_replay_phase_runs_on_the_host(tmp_path):
    """chip_smoke.py phase 7b, rehearsed on the CPU at 1 KiB blocks: its
    checks (the constants above, block files as sealed, the payload, the
    command line printing the same JSON three times) hold on the host."""
    from repro_torch.kernels import bitmatrix_encode as bme
    from repro_torch.kernels import gf256_matmul as gm

    wrappers = {"gf": (gm.gf256_matmul_batched, gm.gf256_matmul),
                "crs": (bme.bitmatrix_encode_batched, bme.bitmatrix_encode),
                "mxu": (bme.mod2_matmul_encode_batched,
                        bme.mod2_matmul_encode)}
    by_path = {fn.__name__: {} for fns in wrappers.values() for fn in fns}
    out = _smoke().replay_phase(np, torch, torch.device("cpu"), tmp_path,
                                wrappers, by_path, block_size=1024)
    assert out["emptied_files"] > 0
    assert all(path == {"replay": 0} for path in by_path.values())
