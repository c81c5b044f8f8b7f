"""The port's analysis tools against the JAX reference's.

``launch/serve_shardings.py``: decode-cache specs leaf for leaf on every
SMOKE arch (1x1 and 2x4 meshes, with and without the long-context
``kv_seq`` rule). ``launch/roofline.py``: ``wire_bytes``, ``model_flops``
on all 40 cells, ``_advice``, ``render`` and ``build_table`` row for row
against the reference's on the same counts once the port's constants
are set to the reference's. ``launch/dryrun.py``: the argument bytes of
the smoke cells against ``compiled.memory_analysis()`` and their product
FLOPs against the reference's program (each difference named), the
dispatch mode's counts, both meshes' records, and phase 9a's reckoning
held to the count. ``launch/perf_iter.py``: ``--device meta``
rows and no fallback without a card.

The reference's 2x4 mesh needs eight host devices, which JAX takes only
from ``XLA_FLAGS`` before it starts, and its compile of the smoke cells
takes tens of seconds: :func:`reference_cases` runs in three subprocesses
at once (eight forced host devices each) while the port's side runs here.
The reference lowers on meshes with ``Auto`` axes: the installed JAX's
``jax.make_mesh`` default (``Explicit``) refuses its sharding constraints
(``tests/test_sharding.py::test_smoke_lowering_compiles``).
"""
import json
import math
import os
import subprocess
import sys
from collections import Counter
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.launch import roofline as ref_roofline  # noqa: E402
from repro_torch.configs import ALIASES, SHAPES, cell_valid  # noqa: E402
from repro_torch.dist.sharding import make_mesh, with_rules  # noqa: E402
from repro_torch.launch import dryrun, perf_iter, roofline  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.launch.serve_shardings import cache_shardings  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
MESHES = ((1, 1), (2, 4))
RULES = (None, {"kv_seq": ("data",)})
MEMORY_ARCHS = ("qwen2.5-3b", "seamless-m4t-medium", "jamba-v0.1-52b",
                "mamba2-2.7b", "arctic-480b")
MEMORY_SHAPES = ("train_4k", "prefill_32k", "decode_32k")
# The reference's compiles, split over three processes by their time.
PARTS = {"specs": [(a, s) for a in MEMORY_ARCHS
                   for s in ("prefill_32k", "decode_32k")],
         "train": [(a, "train_4k") for a in MEMORY_ARCHS
                   if a != "jamba-v0.1-52b"],
         "jamba": [("jamba-v0.1-52b", "train_4k")]}


def _axes(spec) -> list:
    """A spec as a list of mesh axes per dimension, from either package's
    form (a ``PartitionSpec``, or tuples of axes)."""
    return [[] if e is None else [e] if isinstance(e, str) else list(e)
            for e in getattr(spec, "spec", spec)]


def _cache_cells():
    return [(a, s) for a in ALIASES for s in ("decode_32k", "long_500k")
            if cell_valid(a, s)[0]]


def _dot_flops(jaxpr, mult: int, out: Counter) -> Counter:
    """The products of ``jaxpr`` and its sub-jaxprs (a scan's body times
    its length), 2 FLOPs a multiply-add: by operand dtype where they
    contract a dimension, under "outer" where they contract none."""
    from jax.extend import core as jcore

    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            (lc, rc), (lb, rb) = eqn.params["dimension_numbers"]
            lhs, rhs = (v.aval for v in eqn.invars)
            free = [n for i, n in enumerate(rhs.shape)
                    if i not in rc and i not in rb]
            key = str(lhs.dtype) if lc else "outer"
            out[key] += mult * 2 * math.prod(lhs.shape) * math.prod(free)
        n = mult * (eqn.params["length"] if eqn.primitive.name == "scan"
                    else 1)
        for v in eqn.params.values():
            for sub in v if isinstance(v, (tuple, list)) else (v,):
                if isinstance(sub, jcore.ClosedJaxpr):
                    _dot_flops(sub.jaxpr, n, out)
                elif isinstance(sub, jcore.Jaxpr):
                    _dot_flops(sub, n, out)
    return out


def _reference_dots(arch: str, shape: str) -> dict:
    """:func:`_dot_flops` of the function the reference's ``lower_cell``
    lowers for a smoke cell, traced by ``jax.make_jaxpr``."""
    from repro.configs import SHAPES as REF_SHAPES
    from repro.configs import get_model, input_specs
    from repro.train.optimizer import adamw_init
    from repro.train.train_step import make_train_step

    api = get_model(arch, smoke=True)
    specs = input_specs(arch, shape, smoke=True)
    kind = REF_SHAPES[shape].kind
    if kind == "train":
        params = api.abstract_params()
        fn = make_train_step(api, None)
        args = (params, jax.eval_shape(adamw_init, params), specs["batch"])
    elif kind == "prefill":
        fn, args = api.prefill, (api.abstract_params(), specs["batch"])
    else:
        fn, args = api.decode_step, (api.abstract_params(), specs["caches"],
                                     specs["tokens"], specs["index"])
    return dict(_dot_flops(jax.make_jaxpr(fn)(*args).jaxpr, 1, Counter()))


def reference_cases(part: str) -> dict:
    """The reference's side of ``part`` (run in a subprocess): its
    cache specs on both meshes (part "specs"), and for the part's cells
    the memory analysis of ``lower_cell`` on a 1x1 mesh with ``Auto``
    axes and the products of the function it lowers."""
    from jax.sharding import AxisType

    from repro.configs import input_specs
    from repro.dist.sharding import with_rules as ref_rules
    from repro.launch.dryrun import lower_cell
    from repro.launch.serve_shardings import cache_shardings as ref_caches

    def mesh(shape):
        return jax.make_mesh(shape, ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2)

    out = {"memory": {}, "dots": {}}
    for arch, shape in PARTS[part]:
        record, _, _ = lower_cell(arch, shape, mesh((1, 1)), smoke=True)
        out["memory"][f"{arch}|{shape}"] = record["memory"]
        out["dots"][f"{arch}|{shape}"] = _reference_dots(arch, shape)
    if part == "specs":
        for shape in MESHES:
            for rules in RULES:
                for arch, cell in _cache_cells():
                    caches = input_specs(arch, cell, smoke=True)["caches"]
                    with ref_rules(mesh(shape), rules) as mr:
                        specs = ref_caches(caches, mr)
                    out[f"{shape}/{rules}/{arch}/{cell}"] = [
                        _axes(s) for s in jax.tree.leaves(specs)]
    return out


class _Reference:
    """:func:`reference_cases`' subprocesses, started together; ``get``
    waits for them once and returns their merged results."""

    def __init__(self):
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   PYTHONPATH=os.pathsep.join(
                       [str(ROOT / "src"), str(Path(__file__).parent)]))
        env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") +
                            " --xla_force_host_platform_device_count=8"
                            ).strip()
        code = (f"import json, sys, {Path(__file__).stem} as t; "
                f"print(json.dumps(t.reference_cases(sys.argv[1])))")
        self.procs = [subprocess.Popen(
            [sys.executable, "-c", code, part], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for part in PARTS]
        self.out = None

    def get(self) -> dict:
        if self.out is None:
            out = {"memory": {}, "dots": {}}
            for proc in self.procs:
                got, err = proc.communicate(timeout=600)
                assert proc.returncode == 0, err[-4000:]
                got = json.loads(got.splitlines()[-1])
                out["memory"].update(got.pop("memory"))
                out["dots"].update(got.pop("dots"))
                out.update(got)
            self.out = out
        return self.out

    def close(self) -> None:
        for proc in self.procs:
            proc.kill()
            proc.communicate()


@pytest.fixture(scope="module", autouse=True)
def reference():
    """Starts the reference's side with the module's first test, so the
    port's tests run while it compiles; the comparisons come last."""
    ref = _Reference()
    try:
        yield ref
    finally:
        ref.close()


# ------------------------------------------------------- serve_shardings
def _port_specs(shape, rules, arch, cell) -> list:
    from repro_torch.configs import input_specs

    caches = input_specs(arch, cell, smoke=True)["caches"]
    mesh = make_mesh(shape, ("data", "model"),
                     devices=("cpu",) * math.prod(shape))
    with with_rules(mesh, rules) as mr:
        specs = cache_shardings(caches, mr)
    out = []
    tree_map(lambda t, s: out.append(_axes(s)), caches, specs)
    return out


def test_cache_shardings_dispatch_on_node_types():
    """KV, SSM conv and state, and a bare leaf of another rank."""
    from repro_torch.models.attention import KVCache
    from repro_torch.models.ssm import SSMCache

    def t(*shape):
        return torch.empty(shape, device="meta")

    mesh = make_mesh((2, 4), ("data", "model"), devices=("cpu",) * 8)
    nest = [KVCache(k=t(3, 4, 64, 8, 16), v=t(3, 4, 64, 8, 16)),
            SSMCache(conv=t(3, 4, 3, 32), state=t(3, 4, 8, 16, 16)),
            (t(4, 7),)]
    with with_rules(mesh, {"kv_seq": ("data",)}) as mr:
        got = cache_shardings(nest, mr)
    kv = ((), ("data",), (), ("model",), ())
    assert got == [KVCache(k=kv, v=kv),
                   SSMCache(conv=((), ("data",), (), ("model",)),
                            state=((), ("data",), ("model",), (), ())),
                   ((("data",), ()),)]
    with with_rules(mesh, {"kv_seq": ("data",)}) as mr:
        # batch 1: "data" is free for the length
        one = cache_shardings(KVCache(k=t(3, 1, 64, 8, 16),
                                      v=t(3, 1, 64, 8, 16)), mr)
    assert one.k == ((), (), ("data",), ("model",), ())


# --------------------------------------------------------------- roofline
def test_wire_bytes_model():
    """``tests/test_roofline.py``'s input."""
    coll = {"all-reduce": {"in": 100, "out": 100, "count": 1},
            "all-gather": {"in": 10, "out": 160, "count": 1},
            "reduce-scatter": {"in": 160, "out": 10, "count": 1},
            "all-to-all": {"in": 80, "out": 80, "count": 1},
            "collective-permute": {"in": 40, "out": 40, "count": 1}}
    assert roofline.wire_bytes(coll) == 2 * 100 + 160 + 160 + 80 + 40
    assert roofline.wire_bytes(coll) == ref_roofline.wire_bytes(coll)


def test_model_flops_match_reference_on_all_cells():
    cells = [(a, s) for a in ALIASES for s in SHAPES]
    assert len(cells) == 40
    for arch, shape in cells:
        assert roofline.model_flops(arch, shape) == \
            ref_roofline.model_flops(arch, shape), (arch, shape)


def test_constants_are_the_h100s():
    assert roofline.PEAK_FLOPS == {"bfloat16": 989e12, "float16": 989e12,
                                   "float32": 67e12}
    assert roofline.HBM_BW == 3.35e12
    assert roofline.SCALAR_OPS_PER_S == 67e12
    assert roofline.INT8_TENSOR_OPS_PER_S == 1979e12
    assert roofline.RESULTS_DIR == ROOT / "chiprun_out" / "analysis"


SYNTHETIC_ROWS = [
    {"arch": "a", "shape": "train_4k", "skip": "because"},
    {"arch": "b", "shape": "decode_32k", "compute_s": 0.5, "memory_s": 2.0,
     "collective_s": 0.25, "dominant": "memory", "useful": 0.3,
     "mfu_like": 0.25, "coll_detail": {"all-gather": 5, "all-reduce": 9}},
    {"arch": "c", "shape": "prefill_32k", "compute_s": 1.0, "memory_s": 0.5,
     "collective_s": 3.0, "dominant": "collective", "useful": 0.9,
     "mfu_like": 0.3333, "coll_detail": {"all-gather": 5, "all-reduce": 9}},
]


@pytest.mark.parametrize("useful", [0.1, 0.45, 0.6])
@pytest.mark.parametrize("dom", ["compute", "memory", "collective"])
def test_advice_matches_reference(dom, useful):
    row = {"useful": useful, "coll_detail": {"all-gather": 5,
                                             "all-reduce": 9}}
    assert roofline._advice(dom, row) == ref_roofline._advice(dom, row)


def test_render_matches_reference_and_notes_the_split():
    want = ref_roofline.render(SYNTHETIC_ROWS)
    assert roofline.render(SYNTHETIC_ROWS) == want
    port_rows = [dict(r, wire_bytes_per_chip=0.0) for r in SYNTHETIC_ROWS[1:]]
    port_rows[0]["flops_by_dtype_per_chip"] = {"bfloat16": 1.0}
    got = roofline.render(port_rows).splitlines()
    assert got[:-2] == ref_roofline.render(port_rows).splitlines()
    assert "split evenly" in got[-2] and "eager operators' traffic" in got[-2]
    assert got[-1] == "coll_s: no collectives (no partitioner)"


def _record(arch, shape, flops, scale, chips=(16, 16)):
    """A port record: the whole step's count, all of it bf16."""
    return {"arch": arch, "shape": shape, "kind": SHAPES[shape].kind,
            "mesh": dict(zip(("data", "model"), chips)),
            "cost": {"flops": flops, "bytes accessed": flops * scale,
                     "flops_by_dtype": {"bfloat16": flops}},
            "flops_scope": "global",
            "collectives": {k: {"in": 0, "out": 0, "count": 0}
                            for k in ref_roofline._WIRE},
            "memory": {"argument_size_in_bytes": 123}}


def test_build_table_matches_reference_under_its_constants(tmp_path,
                                                          monkeypatch):
    """Port records (whole-step counts on the 16x16 mesh) give the rows
    that the reference computes from the same counts split per device by
    hand, once the port's peaks are the reference's: every key the two
    rows share, but ``unrolled`` (the reference's names its file)."""
    port, ref = {}, {}
    for i, arch in enumerate(ALIASES):
        for j, shape in enumerate(SHAPES):
            if cell_valid(arch, shape)[0] and (i + j) % 5:
                rec = _record(arch, shape, 1e12 * (i + 1) * (j + 2),
                              0.01 * (i + j))
                port[f"{arch}|{shape}"] = rec
                cost = {k: rec["cost"][k] / 256
                        for k in ("flops", "bytes accessed")}
                ref[f"{arch}|{shape}"] = {
                    k: v for k, v in dict(rec, cost=cost).items()
                    if k != "flops_scope"}
    (tmp_path / "port").mkdir()
    (tmp_path / "port" / "dryrun_single.json").write_text(json.dumps(port))
    (tmp_path / "dryrun_single.json").write_text(json.dumps(ref))
    monkeypatch.setattr(ref_roofline, "RESULTS_DIR", tmp_path)
    want = ref_roofline.build_table("single")
    monkeypatch.setitem(roofline.PEAK_FLOPS, "bfloat16",
                        ref_roofline.PEAK_FLOPS)
    monkeypatch.setattr(roofline, "HBM_BW", ref_roofline.HBM_BW)
    got = roofline.build_table("single", tmp_path / "port")
    assert len(got) == len(want) == 40
    for g, w in zip(got, want):
        keys = (set(g) & set(w)) - {"unrolled"}
        assert {k: g[k] for k in keys} == {k: w[k] for k in keys}
        assert g.get("skip") == w.get("skip")
    assert sum(1 for r in got if r.get("skip") == "no dry-run record") > 0


def test_build_table_splits_a_global_count(tmp_path):
    """The port's record (the whole step, f32 and bf16 FLOPs) on the 16x16
    mesh: each term is the count over 256 at its dtype's peak."""
    rec = _record("qwen2.5-3b", "train_4k", 3e15, 0.5)
    rec["cost"]["flops_by_dtype"] = {"bfloat16": 2e15, "float32": 1e15}
    (tmp_path / "dryrun_single.json").write_text(json.dumps(
        {"qwen2.5-3b|train_4k": rec}))
    row = [r for r in roofline.build_table("single", tmp_path)
           if not r.get("skip")]
    assert len(row) == 1
    row = row[0]
    assert row["flops_per_chip"] == 3e15 / 256
    assert row["compute_s"] == pytest.approx(2e15 / 256 / 989e12
                                             + 1e15 / 256 / 67e12, rel=1e-12)
    assert row["memory_s"] == pytest.approx(1.5e15 / 256 / 3.35e12,
                                            rel=1e-12)
    assert row["collective_s"] == 0.0 and row["unrolled"]
    assert row["useful"] == pytest.approx(
        roofline.model_flops("qwen2.5-3b", "train_4k") / 3e15, rel=1e-12)


@pytest.mark.parametrize("field", ["flops_scope", "collectives"])
def test_build_table_reads_only_port_records(tmp_path, field):
    """A per-device count (the reference's records) or a record with wire
    bytes is refused, not priced at the card's rates."""
    rec = _record("qwen2.5-3b", "train_4k", 1e12, 1.0)
    if field == "flops_scope":
        del rec["flops_scope"]
    else:
        rec["collectives"]["all-gather"]["out"] = 3e5
    (tmp_path / "dryrun_single.json").write_text(json.dumps(
        {"qwen2.5-3b|train_4k": rec}))
    with pytest.raises(ValueError, match="not a record of the port's"):
        roofline.build_table("single", tmp_path)


# ----------------------------------------------------------------- dryrun
def test_cost_mode_counts_products_by_dtype_and_bytes():
    a = torch.empty((8, 16), dtype=torch.bfloat16, device="meta")
    b = torch.empty((16, 4), dtype=torch.bfloat16, device="meta")
    c = torch.empty((2, 8, 16), device="meta")
    with dryrun.CostMode() as mode:
        a @ b                          # mm: 2*8*16*4, bf16
        torch.bmm(c, c.transpose(1, 2))  # a view, then bmm: 2*2*8*16*8
        (c + 1).sum()
    assert dict(mode.flops_by_dtype) == {"bfloat16": 1024, "float32": 4096}
    assert mode.flops == 5120
    mm = (8 * 16 + 16 * 4 + 8 * 4) * 2
    bmm = (2 * 8 * 16 * 2) * 4 + 2 * 8 * 8 * 4
    add = (2 * 8 * 16 * 2) * 4                 # the input and the output
    total = (2 * 8 * 16) * 4 + 4
    assert mode.bytes == mm + bmm + add + total


def test_records_of_both_meshes_from_one_count(tmp_path):
    """``run`` over a few cells for both production meshes (over ``meta``
    positions): the reference's schema, the 7-cell long_500k skip, the
    kv_seq rule at batch 1, and a second run served from the cache."""
    cells = (["qwen2.5-3b", "mamba2-2.7b"], ["decode_32k", "long_500k"])
    out = dryrun.run(("single", "multi"), *cells, results_dir=tmp_path)
    single, multi = out["single"], out["multi"]
    assert sorted(single) == sorted(multi) == sorted(
        f"{a}|{s}" for a in cells[0] for s in cells[1])
    assert "skip" in single["qwen2.5-3b|long_500k"]
    for key in ("qwen2.5-3b|decode_32k", "mamba2-2.7b|long_500k"):
        s, m = single[key], multi[key]
        assert s["mesh"] == {"data": 16, "model": 16}
        assert m["mesh"] == {"pod": 2, "data": 16, "model": 16}
        assert s["cost"] == m["cost"] and s["flops_scope"] == "global"
        assert set(s["collectives"]) == set(ref_roofline._WIRE)
        assert not any(v["count"] for v in s["collectives"].values())
        assert s["memory"]["temp_size_in_bytes"] is None
        assert m["memory"]["argument_size_in_bytes"] <= \
            s["memory"]["argument_size_in_bytes"]
    assert json.loads((tmp_path / "dryrun_multi.json").read_text()) == multi
    again = dryrun.run("single", *cells, results_dir=tmp_path)
    assert again == single
    rows = roofline.build_table("single", tmp_path)
    live = [r for r in rows if not r.get("skip")]
    assert {(r["arch"], r["shape"]) for r in live} == {
        ("qwen2.5-3b", "decode_32k"), ("mamba2-2.7b", "decode_32k"),
        ("mamba2-2.7b", "long_500k")}
    assert all(0 < r["useful"] < 2 and r["compute_s"] > 0 for r in live)


def test_production_mesh_on_meta_positions():
    mesh = make_production_mesh(multi_pod=True, devices=("meta",) * 512)
    assert dict(mesh.shape) == {"pod": 2, "data": 16, "model": 16}
    assert {d.type for d in mesh.devices} == {"meta"}
    with pytest.raises(ValueError):
        make_production_mesh()          # 256 cards on this machine: none


def test_train_reckoning_agrees_with_the_count(monkeypatch):
    """Phase 9a's ``train_flops`` for qwen2.5-3b at B=1, T=4096 against the
    dry run's count of the same step, within 1% per dtype (the remat's
    recompute stops before each layer's MLP down projection)."""
    from repro_torch.configs import get_model

    monkeypatch.syspath_prepend(str(ROOT))
    sys.modules.pop("chip_smoke", None)
    import chip_smoke

    api = get_model("qwen2.5-3b")
    t = 4096
    tokens = torch.empty((1, t), dtype=torch.int32, device="meta")
    count = dryrun.count_step(api, "train", {"batch": {
        "tokens": tokens, "labels": tokens.clone()}})
    want = chip_smoke.train_flops(api.cfg, api.param_count(), t, t)
    got = count.cost["flops_by_dtype"]
    assert set(got) == {"bfloat16", "float32"}
    assert got["bfloat16"] == pytest.approx(want["bf16"], rel=0.01)
    assert got["float32"] == pytest.approx(want["f32"], rel=0.01)
    assert count.cost["flops"] == pytest.approx(want["total"], rel=0.01)
    sys.modules.pop("chip_smoke", None)


# ---------------------------------------------------------------- perf_iter
def test_perf_iter_meta_rows_on_a_smoke_config():
    rows = {v: perf_iter.measure("qwen2.5-3b", "train_4k", v, smoke=True)
            for v in ("baseline", "flash2048", "micro2")}
    count = dryrun.count_cell("qwen2.5-3b", "train_4k", smoke=True)
    for name, r in rows.items():
        assert set(r) == {"variant", "compile_s", "temp_gb", "flops_per_dev",
                          "flops_by_dtype_per_dev", "bytes_per_dev",
                          "wire_bytes_per_dev", "compute_s", "memory_s",
                          "collective_s", "collectives"}
        assert r["variant"] == name and r["temp_gb"] is None
        assert r["wire_bytes_per_dev"] == r["collective_s"] == 0.0
        assert r["flops_per_dev"] == sum(r["flops_by_dtype_per_dev"].values())
        assert r["compute_s"] == pytest.approx(roofline.compute_seconds(
            r["flops_by_dtype_per_dev"]), rel=1e-12)
        assert r["memory_s"] == r["bytes_per_dev"] / roofline.HBM_BW
    base = rows["baseline"]
    assert base["flops_per_dev"] == count.cost["flops"] / 256
    assert base["bytes_per_dev"] == count.cost["bytes accessed"] / 256
    # T=256 sits under a 2048 tile: the same step; two microbatches add
    # the gradient sums' traffic, not products
    assert rows["flash2048"]["flops_per_dev"] == base["flops_per_dev"]
    assert rows["micro2"]["flops_per_dev"] == base["flops_per_dev"]
    assert rows["micro2"]["bytes_per_dev"] > base["bytes_per_dev"]


def test_perf_iter_variants_each_change_the_step():
    """No variant of the table runs ``baseline``'s step unchanged (the
    reference's rule- and ``fsdp_params``-only variants are not ported)."""
    base_api, base_tc = perf_iter.variant("qwen2.5-3b", "baseline",
                                          smoke=True)
    assert base_tc is None
    for name in perf_iter.VARIANTS:
        if name == "baseline":
            continue
        api, tc = perf_iter.variant("qwen2.5-3b", name, smoke=True)
        assert api.cfg != base_api.cfg or tc is not None, name


def test_perf_iter_never_falls_back_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device meta"):
        perf_iter.main(["--arch", "qwen2.5-3b", "--shape", "train_4k",
                        "--device", "cuda"])
    with pytest.raises(RuntimeError):
        perf_iter.CardState.build("qwen2.5-3b", "train_4k", "cpu", 1)
    # with a card, prefill and decode cells are counted, not timed
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="--device meta"):
        perf_iter.CardState.build("qwen2.5-3b", "decode_32k", "cuda", 1)


# ------------------------------------- against the reference's subprocesses
@pytest.mark.parametrize("rules", RULES, ids=("default", "kv_seq"))
@pytest.mark.parametrize("shape", MESHES, ids=("1x1", "2x4"))
def test_cache_shardings_match_reference(reference, shape, rules):
    """Every SMOKE arch's decode_32k caches, and long_500k's where the
    cell is valid: the same spec on every leaf, in the same order."""
    cells = _cache_cells()
    assert len(cells) == 13
    for arch, cell in cells:
        key = f"{shape}/{rules}/{arch}/{cell}"
        want = reference.get()[key]
        assert _port_specs(shape, rules, arch, cell) == want, key


@pytest.mark.parametrize("shape", MEMORY_SHAPES)
@pytest.mark.parametrize("arch", MEMORY_ARCHS)
def test_smoke_flops_match_reference(reference, arch, shape):
    """The dry run's product FLOPs of a smoke cell against every
    dot_general of the reference's program for it (its jaxpr; a scan's
    body times its length: the compiled ``cost_analysis`` visits a scan
    body once, and counts elementwise FLOPs too). The totals are equal
    but for three named gaps, each a formula of the config:

    * the reference's outer products (a dot_general that contracts no
      dimension: the SSD's three-operand einsums, contracted pair by pair)
      are broadcast multiplies in the port, which count no product;
    * in a train step, the gradients of those outer products: three
      contractions of 2 B T H N (heads H, state N) a state-space layer in
      the reference, multiplies and sums in the port;
    * in a train step of a MoE layer with a dense residual (arctic), the
      port's remat recomputes the combine product (2 B T E C d, C the
      expert capacity): ``torch.utils.checkpoint`` stops after the last
      activation the backward saves, the dense MLP's, which follows it;
      JAX's remat drops every recomputation the backward does not read.

    The dtype split differs by design: the port runs the attention's
    products in f32 (``PERF.md`` §5), the reference in bf16."""
    from repro_torch.configs import get_config, input_specs
    from repro_torch.models.blocks import build_period

    cfg = get_config(arch, smoke=True)
    count = dryrun.count_cell(arch, shape, smoke=True)
    ref = reference.get()["dots"][f"{arch}|{shape}"]
    want = sum(v for k, v in ref.items() if k != "outer")
    specs = build_period(cfg)
    repeats = cfg.num_layers // len(specs)
    ssm = repeats * sum(s.mixer == "ssm" for s in specs)
    moe = repeats * sum(s.ffn == "moe" for s in specs)
    if SHAPES[shape].kind == "train":
        b, t = input_specs(arch, shape, smoke=True)["batch"]["tokens"].shape
        heads = cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim
        want -= 3 * ssm * 2 * b * t * heads * cfg.ssm_state
        if cfg.dense_residual:
            g = max(1, min(cfg.moe_group_size, b * t))
            while (b * t) % g:
                g -= 1
            cap = max(int(g * cfg.experts_per_tok / cfg.num_experts
                          * cfg.capacity_factor), cfg.experts_per_tok)
            want += moe * 2 * b * t * cfg.num_experts * cap * cfg.d_model
    assert ("outer" in ref) == (ssm > 0)
    assert count.cost["flops"] == want, (count.cost["flops_by_dtype"], ref)


@pytest.mark.parametrize("shape", MEMORY_SHAPES)
@pytest.mark.parametrize("arch", MEMORY_ARCHS)
def test_smoke_memory_matches_reference(reference, arch, shape):
    """``argument_size_in_bytes`` of ``lower_cell(smoke=True)`` on a 1x1
    mesh is the reference's, but for what its ``jit`` prunes: arguments
    the step never reads (``keep_unused=False``). Output sizes differ by
    XLA's result tuple: 8 bytes of its index table per output leaf."""
    mesh = make_mesh((1, 1), ("data", "model"))
    count = dryrun.count_cell(arch, shape, smoke=True)
    got = dryrun.cell_record(arch, shape, count, mesh)["memory"]
    want = reference.get()["memory"][f"{arch}|{shape}"]
    pruned = 0
    if (arch, shape) == ("seamless-m4t-medium", "decode_32k"):
        # decode reads neither the encoder nor the cross-attention's K/V
        # projections (the cache holds the memory's K/V)
        p = count.args[0]

        def nbytes(*leaves):
            return sum(t.numel() * t.element_size() for t in leaves)

        pruned = nbytes(*tree_leaves([p["frontend_proj"], p["enc_norm"],
                                  p["enc_stack"], p["dec_stack"].cross_attn.wk,
                                  p["dec_stack"].cross_attn.wv]))
        assert pruned == 689_408
    elif (arch, shape) == ("mamba2-2.7b", "decode_32k"):
        pruned = 4      # no attention: the int32 index is never read
    assert got["argument_size_in_bytes"] - pruned == \
        want["argument_size_in_bytes"]
    assert got["temp_size_in_bytes"] is None
    leaves = len(tree_leaves(count.outs))
    assert got["output_size_in_bytes"] + 8 * leaves == \
        want["output_size_in_bytes"]
