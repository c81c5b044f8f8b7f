"""The port's distribution layer against the JAX reference.

Spans, window alignment and gather geometry on a one-device mesh must be
the reference's. Twin stores on a multi-domain topology (spread placement,
topology-chosen rebuild destinations) must place, schedule, repair and
re-home blocks exactly as the reference does. The port runs on the CPU.

The multi-device cases need the reference on eight devices, which JAX
takes only from ``XLA_FLAGS`` before it starts: :func:`multi_device_cases`
runs once for the reference in a subprocess with eight forced host
devices, and once for the port in this process on meshes of eight
``cpu`` positions; the tests compare the two results piece by piece
(layouts by mesh position, spans, launch counts, block-file digests).
"""
import hashlib
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

from repro.dist import placement as ref_placement  # noqa: E402
from repro.dist import sharding as ref_sharding  # noqa: E402
from repro.dist import stripes as ref_stripes  # noqa: E402
from repro.dist.schedule import schedule_group as ref_schedule  # noqa: E402
from repro.dist.topology import Topology as RefTopology  # noqa: E402
from repro.ftx.fleet import repair_failed_nodes as ref_repair  # noqa: E402
from repro.ftx.options import RepairOptions as RefOptions  # noqa: E402
from repro.ftx.stripestore import StoreConfig as RefConfig  # noqa: E402
from repro.ftx.stripestore import StripeStore as RefStore  # noqa: E402
from repro_torch.dist import (Mesh, PlacementMap, Topology,  # noqa: E402
                              align_stripe_window, block_loads,
                              current_rules, make_mesh, plan_gather,
                              schedule_group, shard_layout, sharded_launch,
                              stripe_axis_span, stripe_span, with_rules)
from repro_torch.ftx import (RepairOptions, StoreConfig,  # noqa: E402
                             StripeStore, repair_failed_nodes)


@pytest.mark.parametrize("s", [1, 7, 64])
def test_single_device_spans_match_reference(s):
    shape = (s, 12, 128)
    ref_mesh = jax.make_mesh((1, 1), ("data", "model"))
    with ref_sharding.with_rules(ref_mesh) as rmr, \
            with_rules(Mesh({"data": 1, "model": 1})) as pmr:
        assert current_rules() is pmr
        assert stripe_span(shape, pmr) == ref_stripes.stripe_span(shape, rmr)
        assert stripe_axis_span(pmr) == ref_stripes.stripe_axis_span(rmr)
        for window in (1, 5, 32):
            assert align_stripe_window(window, pmr) == \
                ref_stripes.align_stripe_window(window, rmr)
        for mr, place in ((pmr, shard_layout), (None, shard_layout),
                          (rmr, ref_placement.shard_layout),
                          (None, ref_placement.shard_layout)):
            assert place(shape, mr) is None
        layout, parts = plan_gather(shape, pmr, None)
        want_layout, want = ref_placement.plan_gather(shape, rmr, None)
        assert layout is None and want_layout is None
        assert [(p.lo, p.hi, p.shard, p.buf.shape, p.buf.dtype)
                for p in parts] == \
            [(p.lo, p.hi, p.shard, p.buf.shape, p.buf.dtype) for p in want]
    assert current_rules() is None


def test_over_wide_mesh_without_devices_raises():
    """A mesh wider than the machine's cards needs its devices named: it
    never falls back to the CPU. A one-position mesh needs none."""
    wide = max(2, torch.cuda.device_count() + 1)
    for build in (lambda: Mesh({"data": wide}),
                  lambda: make_mesh((wide, 1), ("data", "model"))):
        with pytest.raises(ValueError, match="devices explicitly"):
            build()
    with pytest.raises(ValueError, match="3 devices"):
        make_mesh((2, 1), ("data", "model"), devices=("cpu",) * 3)
    assert Mesh({"data": 1}).devices == ()
    mesh = make_mesh((2, 1), ("data", "model"), devices=("cpu",) * 2)
    assert mesh.devices == (torch.device("cpu"),) * 2
    with with_rules(mesh) as mr:
        assert current_rules() is mr
        assert sharded_launch(lambda c, b, scale: b + scale,
                              torch.ones(1, 2), torch.zeros(4, 2, 4), mr,
                              scale=1).sum() == 32
    assert current_rules() is None


def test_sharded_batch_launches_only_under_its_own_layout():
    """An assembled batch is consumed shard by shard under the rules it was
    built with; under other rules, or none, it raises rather than being
    copied onto one device."""
    from repro_torch.dist import assemble_shards

    stack = np.arange(16 * 2 * 8, dtype=np.uint8).reshape(16, 2, 8)
    with with_rules(make_mesh((8, 1), ("data", "model"),
                              devices=("cpu",) * 8)) as mr:
        layout = shard_layout(stack.shape, mr)
        batch = assemble_shards(stack.shape, mr, layout,
                                [stack[sl.lo:sl.hi] for sl in layout])
        seen = []
        out = sharded_launch(lambda c, b: seen.append(b) or b + 1,
                             torch.zeros(1, 2), batch, mr)
        assert [s.data_ptr() for s in seen] == \
            [s.data_ptr() for s in batch.shards]
        assert np.array_equal(out.numpy(), stack + 1)
    other = make_mesh((4, 2), ("data", "model"), devices=("cpu",) * 8)
    with with_rules(other) as mr:
        with pytest.raises(ValueError, match="assembled with"):
            sharded_launch(lambda c, b: b, torch.zeros(1, 2), batch, mr)
    with pytest.raises(ValueError, match="assembled with"):
        sharded_launch(lambda c, b: b, torch.zeros(1, 2), batch, None)


def _twin_topology_stores(tmp_path, *, scheme):
    args = dict(scheme=scheme, k=6, r=2, p=2, block_size=512,
                batch_stripes=8, pipeline_window=8, prefetch_threads=2,
                placement_policy="spread", backend="ref")
    topo = dict(num_nodes=40, num_domains=8, spread_width=3, seed=7)
    ref = RefStore(tmp_path / "ref", RefConfig(**args), num_nodes=40,
                   topology=RefTopology(**topo))
    port = StripeStore(tmp_path / "port", StoreConfig(**args), num_nodes=40,
                       topology=Topology(**topo), device="cpu")
    payload = np.random.default_rng(3).integers(0, 256, 24 * 6 * 512,
                                                dtype=np.uint8)
    for st in (ref, port):
        st.put("blob", payload.tobytes())
        st.seal()
    return ref, port, payload


@pytest.mark.parametrize("scheme", ["cp-azure", "cp-uniform"])
def test_topology_stores_place_and_rehome_like_reference(scheme, tmp_path):
    ref, port, payload = _twin_topology_stores(tmp_path, scheme=scheme)
    placed = {sid: s.node_of_block for sid, s in port.stripes.items()}
    assert placed == {sid: s.node_of_block for sid, s in ref.stripes.items()}
    assert block_loads(placed.values(), 40) == ref_placement.block_loads(
        placed.values(), 40)
    pmap = PlacementMap.from_store(port, num_shards=8)
    rmap = ref_placement.PlacementMap.from_store(ref, num_shards=8)
    assert pmap.shard_of_node == rmap.shard_of_node
    assert pmap.remote_multiplier == rmap.remote_multiplier
    assert all(pmap.locate(sid, b) == rmap.locate(sid, b)
               for sid in placed for b in range(port.n))
    sids = sorted(placed)
    reads = list(range(port.scheme.k))
    for got, want in zip(
            schedule_group(sids, reads, port.placement, None, step=8),
            ref_schedule(sids, reads, ref.placement, None, step=8)):
        assert (got.sids, got.scheduled_local, got.total_reads) == \
            (want.sids, want.scheduled_local, want.total_reads)

    victims = port.topology.nodes_in(3)[:2]
    want = ref_repair(ref, victims,
                      options=RefOptions(destinations="topology"))
    got = repair_failed_nodes(port, victims, device="cpu",
                              options=RepairOptions(destinations="topology"))
    assert got.blocks_relocated == want.blocks_relocated > 0
    assert (got.stripes_repaired, got.blocks_read, got.launches,
            got.destinations) == (want.stripes_repaired, want.blocks_read,
                                  want.launches, want.destinations)
    assert {sid: s.node_of_block for sid, s in port.stripes.items()} == \
        {sid: s.node_of_block for sid, s in ref.stripes.items()}
    for sid in port.stripes:
        for b in range(port.n):
            assert port._block_path(sid, b).read_bytes() == \
                ref._block_path(sid, b).read_bytes()
    assert np.asarray(port.get("blob")).tobytes() == payload.tobytes()



# ------------------------------------------------ multi-device, 8 devices
ROOT = Path(__file__).resolve().parent.parent
MESHES = ((8, 1), (4, 2))
REPORT = ("stripes_repaired", "patterns", "launches", "windows", "devices",
          "device_launches", "blocks_read", "bytes_read", "repairs_local",
          "repairs_global", "local_reads", "remote_reads", "pipelined",
          "schedule", "scheduled_local_read_fraction",
          "contiguous_local_read_fraction", "sim_seconds")


def _api(pkg: str) -> SimpleNamespace:
    """The names a multi-device case needs, from the reference ("repro",
    on JAX's devices) or the port ("repro_torch", on ``cpu`` positions)."""
    if pkg == "repro":
        from repro.core.engine import BatchedCodecEngine
        from repro.core.schemes import make_scheme
        from repro.dist import placement, sharding, stripes
        from repro.dist.topology import Topology as Topo
        from repro.ftx import stripestore
        from repro.ftx import (RepairOptions as Options,
                               StoreConfig as Config, StripeStore as Store,
                               repair_failed_nodes as repair)

        def mesh(shape):
            return jax.make_mesh(shape, ("data", "model"))

        def position(m):
            where = {d.id: i for i, d in enumerate(m.devices.flat)}
            return lambda devs: [where[d.id] for d in devs]

        def index_map(shape, mr):
            found = stripes.stripe_sharding(
                shape, mr).addressable_devices_indices_map(shape)
            pos = position(mr.mesh)
            out = [None] * len(found)
            for dev, idx in found.items():
                out[pos([dev])[0]] = idx[0]
            return out

        def spec0(shape, mr):
            e = stripes.stripe_spec(shape, mr)[0]
            return [] if e is None else [e] if isinstance(e, str) \
                else list(e)

        return SimpleNamespace(
            Engine=BatchedCodecEngine, make_scheme=make_scheme,
            placement=placement, sharding=sharding, stripes=stripes,
            Topology=Topo, Options=Options, Config=Config, Store=Store,
            repair=repair, stripestore=stripestore, mesh=mesh,
            index_map=index_map, spec0=spec0,
            slice_positions=lambda sl, batch, mr: position(mr.mesh)(
                sl.devices),
            host=np.asarray, kw={})
    from repro_torch.core.engine import BatchedCodecEngine
    from repro_torch.core.schemes import make_scheme
    from repro_torch.dist import placement, sharding, stripes
    from repro_torch.dist.topology import Topology as Topo
    from repro_torch.ftx import stripestore
    from repro_torch.ftx import (RepairOptions as Options,
                                 StoreConfig as Config, StripeStore as Store,
                                 repair_failed_nodes as repair)

    def mesh(shape):
        return make_mesh(shape, ("data", "model"),
                         devices=("cpu",) * math.prod(shape))

    return SimpleNamespace(
        Engine=BatchedCodecEngine, make_scheme=make_scheme,
        placement=placement, sharding=sharding, stripes=stripes,
        Topology=Topo, Options=Options, Config=Config, Store=Store,
        repair=repair, stripestore=stripestore, mesh=mesh,
        index_map=lambda shape, mr: [
            idx[0] for _, idx in
            stripes.stripe_sharding(shape, mr).devices_indices_map(shape)],
        spec0=lambda shape, mr: list(stripes.stripe_spec(shape, mr)[0]),
        slice_positions=lambda sl, batch, mr: [
            pos for pos, (_, idx) in enumerate(
                stripes.stripe_sharding(batch, mr).devices_indices_map(batch))
            if (idx[0].start, idx[0].stop) == (sl.lo, sl.hi)],
        host=lambda x: x.cpu().numpy(), kw={"device": "cpu"})


def _digest(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def _files(store) -> str:
    """Digest of every block file, in (stripe, block) order."""
    return _digest(*(np.frombuffer(store._block_path(sid, b).read_bytes(),
                                   np.uint8)
                     for sid in sorted(store.stripes)
                     for b in range(store.scheme.n)))


def _report(rep) -> dict:
    out = {f: getattr(rep, f) for f in REPORT}
    out["gather_bytes_per_shard"] = {
        str(k): v for k, v in sorted(rep.gather_bytes_per_shard.items())}
    return out


def _store(api, root, *, stripes, block=512, k=6, num_nodes=None,
           topo=None, **cfg):
    cfg = api.Config(scheme="cp-azure", k=k, r=2, p=2, block_size=block,
                     **cfg)
    extra = {} if num_nodes is None else {"num_nodes": num_nodes}
    if topo is not None:
        extra["topology"] = api.Topology(**topo)
    store = api.Store(root, cfg, **extra, **api.kw)
    store.put("blob", np.random.default_rng(3).integers(
        0, 256, stripes * k * block, dtype=np.uint8).tobytes())
    store.seal()
    assert len(store.stripes) == stripes
    return store


def _layout_cases(api) -> dict:
    out = {}
    for shape in MESHES:
        m = api.mesh(shape)
        with api.sharding.with_rules(m) as mr:
            for s in (32, 16, 13, 8, 4, 1):
                batch = (s, 3, 64)
                layout = api.placement.shard_layout(batch, mr)
                out[f"{shape}/S={s}"] = {
                    "spec": api.spec0(batch, mr),
                    "span": api.stripes.stripe_span(batch, mr),
                    "axis_span": api.stripes.stripe_axis_span(mr),
                    "align": [api.stripes.align_stripe_window(w, mr)
                              for w in (3, 8, 20, 64)],
                    "index": [[0 if i.start is None else i.start,
                               s if i.stop is None else i.stop]
                              for i in api.index_map(batch, mr)],
                    "layout": None if layout is None else [
                        [sl.index, sl.lo, sl.hi, sl.size,
                         api.slice_positions(sl, batch, mr)]
                        for sl in layout]}
            for shards in (1, 3, 8):
                pm = api.placement.PlacementMap(
                    shard_of_node=tuple(i * shards // 24 for i in range(24)))
                for s in (16, 13):
                    layout, parts = api.placement.plan_gather(
                        (s, 3, 64), mr, pm)
                    out[f"{shape}/gather/{shards}/S={s}"] = [
                        [p.lo, p.hi, p.shard, list(p.buf.shape),
                         str(p.buf.dtype), p.slice_ is None]
                        for p in parts]
    return out


def _engine_cases(api) -> dict:
    """Encode and a two-block repair per backend on 16 stripes (sharded,
    on both meshes) and 13 (degraded, on 8x1), against the unsharded
    engine."""
    scheme = api.make_scheme("cp-azure", 6, 2, 2)
    out = {}
    for backend in ("gf", "crs", "mxu", "ref"):
        plain = api.Engine(scheme, backend=backend, **api.kw)
        for s in (16, 13):
            data = np.random.default_rng(s).integers(0, 256, (s, 6, 200),
                                                     dtype=np.uint8)
            full = api.host(plain.encode(data))
            avail = {i: full[:, i, :] for i in range(scheme.n)
                     if i not in (0, 7)}
            want, _ = plain.repair_multi([0, 7], avail)
            want = [api.host(v) for v in want.values()]
            for shape in MESHES[:2 if s == 16 else 1]:
                with api.sharding.with_rules(api.mesh(shape)) as mr:
                    eng = api.Engine(scheme, backend=backend, mesh_rules=mr,
                                     **api.kw)
                    enc = api.host(eng.encode(data))
                    enc_span = eng.last_span
                    got, _ = eng.repair_multi([0, 7], avail)
                    got = [api.host(v) for v in got.values()]
                out[f"{backend}/{shape}/S={s}"] = {
                    "encode": _digest(enc), "encode_span": enc_span,
                    "repair": _digest(*got), "repair_span": eng.last_span,
                    "effective_backend": eng.effective_backend,
                    "as_unsharded": bool((enc == full).all() and all(
                        (a == b).all() for a, b in zip(got, want)))}
    return out


def _store_cases(api, root: Path) -> dict:
    """The reference's multi-device store tests, run on both packages:
    test_dist_stripes.py:140, test_placement.py:208/240/253,
    test_pipeline.py:231, test_schedule.py:277, the P5 store of
    chip_smoke.py phase 7a at 1 KiB blocks, and a 4x2 mesh. Each
    geometry is sealed once; its cases repair copies of it."""
    out = {}

    def clone(store, tag):
        store.save_manifest()
        shutil.copytree(store.root, root / tag)
        return api.Store.load(root / tag, **api.kw)

    def run(name, store, nodes=None, mesh=(8, 1), **options):
        nodes = nodes or [store.stripes[0].node_of_block[0]]
        opts = api.Options(**options)
        if mesh is None:
            rep = api.repair(store, nodes, options=opts, **api.kw)
        else:
            with api.sharding.with_rules(api.mesh(mesh)):
                rep = api.repair(store, nodes, options=opts, **api.kw)
        out[name] = {"report": _report(rep), "files": _files(store)}

    run("dist_stripes", _store(api, root / "stripes", stripes=80,
                               block=1024))
    base = _store(api, root / "placement", stripes=80, batch_stripes=8,
                  pipeline_window=8, prefetch_threads=2)
    for tag, pipe, mesh in (("sharded_pipelined", True, (8, 1)),
                            ("sharded_sync", False, (8, 1)),
                            ("unsharded_sync", False, None),
                            ("replicated_4x2", True, (4, 2))):
        run(f"placement/{tag}", clone(base, tag), mesh=mesh, pipeline=pipe)
    run("pipeline", base, pipeline=True)
    run("placement/ragged", _store(api, root / "ragged", stripes=50,
                                   batch_stripes=5, pipeline_window=5,
                                   prefetch_threads=2), pipeline=True)
    base = _store(api, root / "schedule", stripes=320, num_nodes=40,
                  topo=dict(num_nodes=40, num_domains=8, spread_width=2,
                            seed=7),
                  batch_stripes=8, pipeline_window=8, prefetch_threads=2,
                  placement_policy="spread")
    for tag, pipe, mode in (("locality_pipelined", True, "locality"),
                            ("none_sync", False, "none"),
                            ("locality_sync", False, "locality")):
        run(f"schedule/{tag}", clone(base, tag), pipeline=pipe,
            schedule=mode)
    store = _store(api, root / "p5", stripes=64, block=1024, k=24,
                   num_nodes=28)
    for nodes in ([3], [3, 4]):
        run(f"p5/{nodes}", store, nodes)
    # Again with the gathered-stack byte budget cut as the block is, by
    # 1024: the windows the smoke's store gets at 1 MiB blocks.
    ss = api.stripestore
    budget, defaults = ss._BATCH_BYTE_BUDGET, ss.launch_step.__defaults__
    ss._BATCH_BYTE_BUDGET = budget >> 10
    ss.launch_step.__defaults__ = defaults[:-1] + (budget >> 10,)
    try:
        for nodes in ([3], [3, 4]):
            run(f"p5_mib_windows/{nodes}", store, nodes)
    finally:
        ss._BATCH_BYTE_BUDGET, ss.launch_step.__defaults__ = budget, defaults
    return out


def multi_device_cases(pkg: str, root) -> dict:
    """Every multi-device case of this module on ``pkg``; JSON-able."""
    api = _api(pkg)
    return {"layout": _layout_cases(api), "engine": _engine_cases(api),
            "store": _store_cases(api, Path(root)),
            "logical": _logical_cases(pkg, api)}


def _axes(spec) -> list:
    """A spec as a list of mesh axes per dimension, from either package's
    form (a ``PartitionSpec``, or tuples of axes)."""
    return [[] if e is None else [e] if isinstance(e, str) else list(e)
            for e in getattr(spec, "spec", spec)]


def _spec_leaves(pkg: str, tree) -> list:
    if pkg == "repro":
        return [_axes(s) for s in jax.tree.leaves(tree)]
    from repro_torch.train.train_step import _is_spec
    from repro_torch.tree import tree_map

    out = []
    tree_map(lambda s: out.append(_axes(s)), tree, is_leaf=_is_spec)
    return out


# (shape, logical names) of tests/test_sharding.py's 2x4 resolutions
RESOLVE_2X4 = (((8, 8), ("batch", "ff")), ((6, 3), ("batch", "heads")),
               ((3, 8), ("batch", "ff")),
               ((3, 16, 32), ("experts", None, "expert_ff")),
               ((4, 16, 32), ("experts", None, "expert_ff")))
KV_SEQ_2X4 = (((1, 1024, 4, 64), ("batch", "kv_seq", "kv_heads", None)),
              ((4, 1024, 4, 64), ("batch", "kv_seq", "kv_heads", None)))
TRAIN_ARCHS = (("qwen25_3b", False), ("arctic_480b", False),
               ("arctic_480b", True), ("jamba_52b", True),
               ("seamless_m4t_medium", False))


def _logical_cases(pkg: str, api) -> dict:
    """``tests/test_sharding.py``'s 2x4 cases (resolution, degradation,
    ``opt_state_sharding``, a rule override) and ``train_shardings`` of
    SMOKE configs (FSDP on and off) on both meshes."""
    import dataclasses
    import importlib

    configs = importlib.import_module(f"{pkg}.configs")
    build = importlib.import_module(f"{pkg}.models.registry").build
    ts = importlib.import_module(f"{pkg}.train.train_step")
    sh = api.sharding
    out = {}
    with sh.with_rules(api.mesh((2, 4))) as mr:
        out["resolve"] = [_axes(sh._resolve(shape, names, mr))
                          for shape, names in RESOLVE_2X4]
        out["opt_state"] = [_axes(sh.opt_state_sharding((), shape, mr))
                            for shape in ((7, 4), (7, 5))]
    with sh.with_rules(api.mesh((2, 4)), {"kv_seq": ("data",)}) as mr:
        out["kv_seq"] = [_axes(sh._resolve(shape, names, mr))
                         for shape, names in KV_SEQ_2X4]
    for shape in MESHES:
        for arch, fsdp in TRAIN_ARCHS:
            cfg = dataclasses.replace(configs.get_config(arch, smoke=True),
                                      fsdp_params=fsdp)
            batch = configs.input_specs(arch, "train_4k", smoke=True)["batch"]
            with sh.with_rules(api.mesh(shape)) as mr:
                out[f"train/{shape}/{arch}/{fsdp}"] = _spec_leaves(
                    pkg, ts.train_shardings(build(cfg), mr, batch))
    return out


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
def cases8(tmp_path_factory):
    proc = _reference("multi_device_cases", tmp_path_factory.mktemp("ref"))
    try:
        port = multi_device_cases("repro_torch", tmp_path_factory.mktemp("port"))
    except BaseException:
        proc.kill()
        raise
    return _result(proc), json.loads(json.dumps(port))


def _same(got, want, path=""):
    """Equal, but ``sim_seconds`` of a pipelined repair to a relative
    1e-12: it sums reader threads' link times in their finishing order."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _same(got[k], want[k], f"{path}/{k}")
    elif path.endswith("sim_seconds"):
        assert got == pytest.approx(want, rel=1e-12, abs=0), path
    else:
        assert got == want, path


# ------------------------------------------- logical-axis rules and specs
def test_resolve_divisible_matches_reference():
    from repro_torch.dist.sharding import _resolve

    with ref_sharding.with_rules(jax.make_mesh((1, 1), ("data", "model"))) \
            as rmr, with_rules(Mesh({"data": 1, "model": 1})) as pmr:
        got = _resolve((32, 64), ("batch", "ff"), pmr)
        assert got == (("data",), ("model",))
        assert _axes(got) == _axes(ref_sharding._resolve(
            (32, 64), ("batch", "ff"), rmr))


def test_axis_used_once_like_reference():
    from repro_torch.dist.sharding import _resolve

    with ref_sharding.with_rules(jax.make_mesh((1, 1), ("data", "model"))) \
            as rmr, with_rules(Mesh({"data": 1, "model": 1})) as pmr:
        got = _resolve((4, 4), ("heads", "ff"), pmr)   # both want "model"
        assert got[0] == ("model",) and got[1] == ()
        assert _axes(got) == _axes(ref_sharding._resolve(
            (4, 4), ("heads", "ff"), rmr))


def test_opt_state_extends_like_reference():
    from repro_torch.dist import opt_state_sharding

    with ref_sharding.with_rules(jax.make_mesh((1, 1), ("data", "model"))) \
            as rmr, with_rules(Mesh({"data": 1, "model": 1})) as pmr:
        got = opt_state_sharding(((), ("model",)), (8, 4), pmr)
        assert got[0] == ("data",)
        want = ref_sharding.opt_state_sharding(
            jax.sharding.PartitionSpec(None, "model"), (8, 4), rmr)
        assert _axes(got) == _axes(want)


def test_logical_rules_and_shard_activation_match_reference():
    """The reference's rules and data axes; ``shard_activation`` returns
    its input, inside a ``with_rules`` block or outside one."""
    from repro_torch.dist import DATA_AXES, DEFAULT_RULES, shard_activation

    assert DEFAULT_RULES == ref_sharding.DEFAULT_RULES
    assert DATA_AXES == ref_sharding.DATA_AXES
    x = torch.zeros(4, 6)
    assert shard_activation(x, "batch", None) is x
    with with_rules(Mesh({"data": 1, "model": 1})):
        assert shard_activation(x, "batch", "heads") is x


def test_resolve_indivisible_degrades_like_reference(cases8):
    """``tests/test_sharding.py::test_resolve_indivisible_degrades`` on a
    2x4 mesh: the reference's values, in both packages."""
    want, got = cases8[0]["logical"], cases8[1]["logical"]
    assert got["resolve"] == want["resolve"] == [
        [["data"], ["model"]], [["data"], []], [[], ["model"]],
        [[], [], ["model"]], [["model"], [], []]]
    assert got["opt_state"] == want["opt_state"] == [[[], ["data"]],
                                                     [[], []]]


def test_rule_overrides_and_freed_axes_like_reference(cases8):
    want, got = cases8[0]["logical"], cases8[1]["logical"]
    assert got["kv_seq"] == want["kv_seq"] == [
        [[], ["data"], ["model"], []], [["data"], [], ["model"], []]]


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_train_shardings_match_reference(cases8, shape):
    """Parameter, moment and batch specs of SMOKE configs (FSDP on and
    off) under the 8x1 and 4x2 meshes."""
    want, got = cases8[0]["logical"], cases8[1]["logical"]
    for arch, fsdp in TRAIN_ARCHS:
        key = f"train/{shape}/{arch}/{fsdp}"
        assert got[key] == want[key], key


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_multi_device_layouts_match_reference(cases8, shape):
    """stripe_spec, spans, window alignment, each position's stripe slice,
    shard_layout (replica devices by mesh position) and plan_gather's
    reader-shard attribution, for stripe counts that shard and that
    degrade (13, 4, 1 on an 8-way axis)."""
    ref, port = cases8
    keys = [k for k in ref["layout"] if k.startswith(f"{shape}/")]
    assert len(keys) == 12
    for k in keys:
        _same(port["layout"][k], ref["layout"][k], k)
    span = shape[0]
    got = port["layout"][f"{shape}/S=16"]
    assert got["span"] == span and got["layout"] == [
        [i, i * 16 // span, (i + 1) * 16 // span, 16 // span,
         list(range(i * shape[1], (i + 1) * shape[1]))]
        for i in range(span)]
    assert port["layout"][f"{shape}/S=13"]["layout"] is None


@pytest.mark.parametrize("backend", ["gf", "crs", "mxu", "ref"])
def test_sharded_engine_matches_reference(cases8, backend):
    ref, port = cases8
    for shape, s in ((MESHES[0], 16), (MESHES[1], 16), (MESHES[0], 13)):
        k = f"{backend}/{shape}/S={s}"
        _same(port["engine"][k], ref["engine"][k], k)
        got = port["engine"][k]
        assert got["as_unsharded"]
        assert got["repair_span"] == got["encode_span"] == (
            shape[0] if s == 16 else 1)


STORE_CASES = ["dist_stripes", "placement/sharded_pipelined",
               "placement/sharded_sync", "placement/unsharded_sync",
               "placement/replicated_4x2", "placement/ragged", "pipeline",
               "schedule/locality_pipelined", "schedule/none_sync",
               "schedule/locality_sync", "p5/[3]", "p5/[3, 4]",
               "p5_mib_windows/[3]", "p5_mib_windows/[3, 4]"]


@pytest.mark.parametrize("name", STORE_CASES)
def test_sharded_store_repair_matches_reference(cases8, name):
    """Report counts, spans, locality and per-shard gather bytes, and the
    block files, of each multi-device store case equal the reference's."""
    ref, port = cases8
    assert sorted(ref["store"]) == sorted(STORE_CASES)
    _same(port["store"][name], ref["store"][name], name)


def test_sharded_repairs_are_bit_identical_and_balanced(cases8):
    """The reference tests' own claims, on the port: sharded repairs (sync,
    pipelined, 4x2) write the unsharded repair's bytes, every launch
    spans the mesh's stripe axis, and gather bytes split evenly."""
    got = cases8[1]["store"]
    truth = got["placement/unsharded_sync"]
    assert truth["report"]["devices"] == 1
    for tag, span in (("sharded_pipelined", 8), ("sharded_sync", 8),
                      ("replicated_4x2", 4)):
        case = got[f"placement/{tag}"]
        rep = case["report"]
        assert case["files"] == truth["files"], tag
        assert rep["devices"] == span
        assert rep["device_launches"] == span * rep["launches"]
        assert rep["blocks_read"] == truth["report"]["blocks_read"]
        shards = rep["gather_bytes_per_shard"]
        assert len(shards) == span and len(set(shards.values())) == 1
        assert sum(shards.values()) == rep["bytes_read"]
    ragged = got["placement/ragged"]["report"]
    assert ragged["devices"] == 1 and list(
        ragged["gather_bytes_per_shard"]) == ["0"]
    assert got["pipeline"]["report"]["pipelined"]
    assert got["dist_stripes"]["report"]["device_launches"] == \
        8 * got["dist_stripes"]["report"]["launches"]
    sched = {t: got[f"schedule/{t}"] for t in
             ("locality_pipelined", "none_sync", "locality_sync")}
    assert len({c["files"] for c in sched.values()}) == 1
    base = sched["none_sync"]["report"]
    for t in ("locality_pipelined", "locality_sync"):
        rep = sched[t]["report"]
        frac = rep["local_reads"] / rep["blocks_read"]
        assert frac > base["local_reads"] / base["blocks_read"]
        assert rep["scheduled_local_read_fraction"] > 1.2 * \
            rep["contiguous_local_read_fraction"]


def test_p5_sharded_counts_are_the_smoke_constants(cases8):
    """chip_smoke.py phase 7a's expectations for its P5 store (1 MiB
    blocks) under an 8x1 mesh, held to the reference at 1 KiB blocks with
    the stack byte budget cut by as much: the budget splits each 16-stripe
    group of 24 reads in two windows of 8, so the two-node repair takes 7
    launches (4 at 1 KiB with the full budget)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    want = cases8[0]["store"]
    for nodes, expected in smoke.EXPECTED.items():
        for case in ("p5", "p5_mib_windows"):
            rep = want[f"{case}/{list(nodes)}"]["report"]
            assert (rep["patterns"], rep["blocks_read"],
                    rep["repairs_local"], rep["repairs_global"]) == expected
            assert rep["devices"] == 8
            assert rep["device_launches"] == 8 * rep["launches"]
    rep = want["p5_mib_windows/[3, 4]"]["report"]
    assert (rep["launches"], rep["devices"], rep["device_launches"]) == \
        smoke.SHARDED_EXPECTED
    assert want["p5/[3, 4]"]["report"]["launches"] == 4


def test_smoke_sharded_phase_runs_on_the_host(tmp_path, monkeypatch):
    """chip_smoke.py phase 7a, rehearsed on the CPU on phase 3's store at
    1 KiB blocks, with the stack byte budget cut by as much so the windows
    are those of 1 MiB blocks (its timers, which need CUDA events, call
    once and read 0)."""
    import importlib.util

    from repro_torch.ftx import StoreConfig, stripestore
    from repro_torch.kernels import bitmatrix_encode as bme
    from repro_torch.kernels import gf256_matmul as gm

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    budget = stripestore._BATCH_BYTE_BUDGET >> 10
    monkeypatch.setattr(stripestore, "_BATCH_BYTE_BUDGET", budget)
    monkeypatch.setattr(stripestore.launch_step, "__defaults__",
                        stripestore.launch_step.__defaults__[:-1] + (budget,))
    monkeypatch.setattr(smoke, "cuda_ms",
                        lambda torch, fn, reps: (fn(), 0.0)[1])
    monkeypatch.setattr(smoke, "device_ms",
                        lambda torch, fn, args: (fn(*args), 0.0)[1])
    wrappers = {"gf": (gm.gf256_matmul_batched, gm.gf256_matmul),
                "crs": (bme.bitmatrix_encode_batched, bme.bitmatrix_encode),
                "mxu": (bme.mod2_matmul_encode_batched,
                        bme.mod2_matmul_encode)}
    by_path = {fn.__name__: {} for fns in wrappers.values() for fn in fns}
    cpu = torch.device("cpu")
    cfg = StoreConfig(scheme="cp-azure", k=24, r=2, p=2, block_size=1024)
    _, hashes, store = smoke.drive_main_path(
        np, torch, cfg, tmp_path, cpu, gm.gf256_matmul_batched)
    out = smoke.sharded_phase(np, torch, store, tmp_path, hashes, cpu,
                              wrappers, by_path)
    assert (out["repair"]["launches"], out["repair"]["devices"],
            out["repair"]["device_launches"]) == smoke.SHARDED_EXPECTED
    assert all(path == {"sharded": 0} for path in by_path.values())
