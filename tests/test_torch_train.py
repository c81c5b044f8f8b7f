"""The port's training substrate, held to the reference.

Both packages step from the same state: the reference's parameters
(``init_params(jax.random.key(0))``) and its ``adamw_init`` state cross
through ``convert.params_from_reference``, and both take the same numpy
batch from the data pipeline. The port runs on the CPU.

Bounds:

* ``schedule``: equal to the reference's f32 values within 1e-7 relative.
* ``global_norm`` and ``adamw_update`` on identical gradients: 1e-6
  relative (to the largest magnitude of the leaf); bf16 parameters within
  one bf16 step (2^-8 of the value) where the two f32 results round to
  neighbouring bf16 values.
* One fp32 ``make_train_step`` step on every SMOKE config against
  ``jax.jit(make_train_step)``: loss 1e-5 relative, grad_norm 1e-4
  relative, every gradient within 1e-4 of the largest gradient (the
  packages differ in f32 summation order). Parameters: at step 1 Adam's
  ``m/(sqrt(v)+eps)`` is about sign(g), so where the two packages'
  gradients of an element near 0 differ in sign or sit near ``eps`` the
  parameter moves by up to ``2 * lr`` more in one package. Every element
  is held within that (plus 1e-6 for the f32 rounding of the parameter),
  and all but 1% of them within 1e-3 of ``lr``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as ref_configs  # noqa: E402
from repro.data.pipeline import DataConfig as RefDataConfig  # noqa: E402
from repro.data.pipeline import make_pipeline as ref_pipeline  # noqa: E402
from repro.models import registry as ref_registry  # noqa: E402
from repro.train import optimizer as ref_opt  # noqa: E402
from repro.train import train_step as ref_ts  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import (config_from_reference,  # noqa: E402
                                 params_from_reference)
from repro_torch.data.pipeline import DataConfig, make_pipeline  # noqa: E402
from repro_torch.ftx import CheckpointConfig, CheckpointManager  # noqa: E402
from repro_torch.ftx import StoreConfig  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models.common import make_generator  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import train_step as ts  # noqa: E402
from repro_torch.tree import (tree_leaves, tree_map,  # noqa: E402
                              tree_unflatten)

LOSS, GNORM, GRADS, UPDATE = 1e-5, 1e-4, 1e-4, 1e-6
LR = 1e-3


def _np(t) -> np.ndarray:
    return np.asarray(t.float().numpy() if isinstance(t, torch.Tensor)
                      else jnp.asarray(t, jnp.float32))


def _rel(want, got) -> float:
    want, got = _np(want), _np(got)
    assert want.shape == got.shape
    return float(np.max(np.abs(want - got), initial=0.0)
                 / (np.max(np.abs(want), initial=0.0) + 1e-30))


def _twin(arch: str, dtype: str = "float32"):
    rcfg = dataclasses.replace(ref_configs.get_config(arch, smoke=True),
                               param_dtype=getattr(jnp, dtype))
    rapi = ref_registry.build(rcfg)
    rparams = rapi.init_params(jax.random.key(0))
    papi = registry.build(config_from_reference(rcfg))
    return rapi, rparams, papi, params_from_reference(rparams, device="cpu")


def _batch(cfg, batch: int, seq: int, seed: int = 0) -> dict:
    """The reference pipeline's numpy batch for ``cfg`` (both packages take
    the same arrays)."""
    return ref_pipeline(RefDataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch,
        seed=seed, frontend=cfg.frontend,
        frontend_tokens=cfg.frontend_tokens, d_model=cfg.d_model)).batch_at(0)


def _jnp(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


# ---------------------------------------------------------------- optimizer
def test_schedule_matches_reference():
    cfg = opt.AdamWConfig(peak_lr=1e-3, warmup_steps=10, decay_steps=100)
    rcfg = ref_opt.AdamWConfig(peak_lr=1e-3, warmup_steps=10, decay_steps=100)
    steps = (0, 5, 10, 55, 100, 200)
    lrs = [float(opt.schedule(cfg, torch.tensor(s, dtype=torch.int32)))
           for s in steps]
    want = [float(ref_opt.schedule(rcfg, jnp.int32(s))) for s in steps]
    np.testing.assert_allclose(lrs, want, rtol=1e-7, atol=0)
    assert lrs[0] < lrs[1] < lrs[2]          # warmup
    assert lrs[2] >= lrs[3] >= lrs[4]        # decay
    assert lrs[4] >= cfg.peak_lr * cfg.min_lr_ratio - 1e-9


def _random_state(seed: int = 0):
    """A nest of bf16 matrices and f32 vectors and stacks, its gradients,
    and an AdamW state four steps in: numpy arrays."""
    rng = np.random.default_rng(seed)
    shapes = {"w": (12, 8), "stack": [(3, 6, 5), (7,)], "b": (9,)}

    def leaf(shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    params = {"w": leaf((12, 8), 1.0), "stack": [leaf((3, 6, 5), 0.5),
                                                 leaf((7,), 1.0)],
              "b": leaf((9,), 1.0)}
    grads = {"w": leaf((12, 8), 3.0), "stack": [leaf((3, 6, 5), 1e-3),
                                                leaf((7,), 0.2)],
             "b": leaf((9,), 0.5)}
    m = jax.tree.map(lambda s: leaf(s, 0.1), shapes,
                     is_leaf=lambda s: isinstance(s, tuple))
    v = jax.tree.map(lambda s: np.abs(leaf(s, 0.01)), shapes,
                     is_leaf=lambda s: isinstance(s, tuple))
    return params, grads, m, v


def _bf16_params(params):
    """bf16 matrices (the compute dtype), f32 vectors."""
    out = jax.tree.map(jnp.asarray, params)
    out["w"] = out["w"].astype(jnp.bfloat16)
    return out


def test_global_norm_matches_reference():
    params, grads, _, _ = _random_state(1)
    for tree in (grads, _bf16_params(params)):
        tree = jax.tree.map(jnp.asarray, tree)
        want = float(ref_opt.global_norm(tree))
        got = float(opt.global_norm(params_from_reference(tree,
                                                          device="cpu")))
        assert abs(got - want) <= UPDATE * want


def _within_one_bf16_step(want, got) -> bool:
    want, got = _np(want), _np(got)
    return bool(np.all(np.abs(want - got) <= 2.0 ** -8 * np.abs(want)))


@pytest.mark.parametrize("inplace", [False, True])
def test_adamw_update_on_identical_gradients(inplace):
    """The same gradients into both packages' ``adamw_update``, from a
    state four steps in, with clipping active (gnorm > clip_norm)."""
    params, grads, m, v = _random_state(2)
    rparams = _bf16_params(params)
    rstate = {"m": jax.tree.map(jnp.asarray, m),
              "v": jax.tree.map(jnp.asarray, v), "step": jnp.int32(4)}
    rgrads = jax.tree.map(jnp.asarray, grads)
    rcfg = ref_opt.AdamWConfig(peak_lr=1e-2, warmup_steps=3, decay_steps=10)
    want_p, want_s, want_m = ref_opt.adamw_update(rparams, rgrads, rstate,
                                                  rcfg)
    pparams = params_from_reference(rparams, device="cpu")
    pstate = params_from_reference(rstate, device="cpu")
    before = [t.clone() for t in tree_leaves((pparams, pstate))]
    cfg = opt.AdamWConfig(peak_lr=1e-2, warmup_steps=3, decay_steps=10)
    got_p, got_s, got_m = opt.adamw_update(
        pparams, params_from_reference(rgrads, device="cpu"), pstate, cfg,
        inplace=inplace)
    assert float(want_m["grad_norm"]) > cfg.clip_norm
    for key in ("grad_norm", "lr"):
        assert abs(float(got_m[key]) - float(want_m[key])) \
            <= UPDATE * abs(float(want_m[key]))
    assert int(got_s["step"]) == 5 and got_s["step"].dtype == torch.int32
    for want, got in zip(jax.tree.leaves((want_s["m"], want_s["v"])),
                         tree_leaves((got_s["m"], got_s["v"]))):
        assert got.dtype == torch.float32 and _rel(want, got) < UPDATE
    for want, got in zip(jax.tree.leaves(want_p), tree_leaves(got_p)):
        assert str(got.dtype) == "torch." + str(want.dtype)
        if got.dtype == torch.bfloat16:
            assert _within_one_bf16_step(want, got)
        else:
            assert _rel(want, got) < UPDATE
    after = tree_leaves((pparams, pstate))
    if inplace:
        # the given tensors hold the new values, and are what came back
        assert all(a is b for a, b in zip(tree_leaves((got_p, got_s)),
                                          after))
        assert not all(torch.equal(a, b) for a, b in zip(before, after))
    else:
        assert all(torch.equal(a, b) for a, b in zip(before, after))


# -------------------------------------------------------------- train step
@pytest.mark.parametrize("arch", ref_configs.ARCHS)
def test_train_step_matches_reference(arch):
    """One fp32 step on every SMOKE config, seamless included, from the
    reference's ``adamw_init`` state carried across."""
    rapi, rp, papi, pp = _twin(arch)
    batch = _batch(rapi.cfg, 2, 32)
    rtc = ref_ts.TrainConfig(opt=ref_opt.AdamWConfig(peak_lr=LR,
                                                     warmup_steps=1))
    rstate = ref_opt.adamw_init(rp)

    @jax.jit
    def ref(p, o, b):
        return (ref_ts.make_train_step(rapi, rtc)(p, o, b),
                jax.grad(rapi.train_loss)(p, b))

    (want_p, want_s, want_m), want_g = ref(rp, rstate, _jnp(batch))
    pstate = params_from_reference(rstate, device="cpu")
    assert [str(t.dtype) for t in tree_leaves(pstate)] == \
        [str(t.dtype) for t in tree_leaves(opt.adamw_init(pp))]
    tc = ts.TrainConfig(opt=opt.AdamWConfig(peak_lr=LR, warmup_steps=1))
    got_p, got_s, got_m = ts.make_train_step(papi, tc)(pp, pstate, batch)

    assert abs(float(got_m["loss"]) - float(want_m["loss"])) \
        <= LOSS * abs(float(want_m["loss"]))
    assert abs(float(got_m["grad_norm"]) - float(want_m["grad_norm"])) \
        <= GNORM * float(want_m["grad_norm"])
    leaves = [p.detach().requires_grad_() for p in tree_leaves(pp)]
    loss = papi.train_loss(
        tree_unflatten(pp, iter(leaves)),
        {k: torch.as_tensor(v) for k, v in batch.items()})
    got_g = torch.autograd.grad(loss, leaves)
    gmax = max(float(jnp.max(jnp.abs(g))) for g in jax.tree.leaves(want_g))
    for want, got in zip(jax.tree.leaves(want_g), got_g):
        assert float(np.max(np.abs(_np(want) - _np(got)))) <= GRADS * gmax
    lr = float(want_m["lr"])
    far = total = 0
    for want, got in zip(jax.tree.leaves(want_p), tree_leaves(got_p)):
        diff = np.abs(_np(want) - _np(got))
        assert float(diff.max()) <= 2 * lr + 1e-6
        far += int((diff > 1e-3 * lr).sum())
        total += diff.size
    assert far <= 0.01 * total, (far, total)
    assert int(got_s["step"]) == 1


@pytest.mark.parametrize("mb", [2, 4])
def test_microbatches_match_reference(mb):
    """qwen2.5 SMOKE: ``microbatches=mb`` against the reference's at the
    same count (fp32, the step's bounds), and against one batch in the
    port (bf16, the reference's own bounds: loss 2e-2, the first leaf
    3e-2)."""
    rapi, rp, papi, pp = _twin("qwen25_3b")
    batch = _batch(rapi.cfg, 8, 32, seed=1)
    rtc = ref_ts.TrainConfig(opt=ref_opt.AdamWConfig(peak_lr=LR),
                             microbatches=mb)
    want_p, _, want_m = jax.jit(ref_ts.make_train_step(rapi, rtc))(
        rp, ref_opt.adamw_init(rp), _jnp(batch))
    tc = ts.TrainConfig(opt=opt.AdamWConfig(peak_lr=LR), microbatches=mb)
    got_p, _, got_m = ts.make_train_step(papi, tc)(pp, opt.adamw_init(pp),
                                                   batch)
    assert abs(float(got_m["loss"]) - float(want_m["loss"])) \
        <= LOSS * abs(float(want_m["loss"]))
    assert abs(float(got_m["grad_norm"]) - float(want_m["grad_norm"])) \
        <= GNORM * float(want_m["grad_norm"])
    lr = float(want_m["lr"])
    for want, got in zip(jax.tree.leaves(want_p), tree_leaves(got_p)):
        assert float(np.max(np.abs(_np(want) - _np(got)))) <= 2 * lr + 1e-6

    api = configs.get_model("qwen2.5-3b", smoke=True)
    params = api.init_params(make_generator(0, "cpu"))
    state = opt.adamw_init(params)
    outs = {}
    for n in (1, mb):
        tc = ts.TrainConfig(opt=opt.AdamWConfig(peak_lr=LR), microbatches=n)
        p2, _, m = ts.make_train_step(api, tc)(params, state, batch)
        outs[n] = (float(m["loss"]), _np(tree_leaves(p2)[0]))
    assert abs(outs[mb][0] - outs[1][0]) < 2e-2
    np.testing.assert_allclose(outs[mb][1], outs[1][1], atol=3e-2)


def test_loss_decreases():
    """The reference's ``test_loss_decreases`` on the port, in place."""
    api = configs.get_model("qwen2.5-3b", smoke=True)
    cfg = api.cfg
    data = make_pipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                    global_batch=8, seed=0))
    tc = ts.TrainConfig(opt=opt.AdamWConfig(peak_lr=3e-3, warmup_steps=5,
                                            decay_steps=40))
    params = api.init_params(make_generator(0, "cpu"))
    state = opt.adamw_init(params)
    step = ts.make_train_step(api, tc, donate=True)
    losses = []
    for i in range(30):
        params, state, m = step(params, state, data.batch_at(i))
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.5, losses
    assert int(state["step"]) == 30


def test_donate_writes_into_the_given_tensors():
    """``donate=True`` updates the parameters and moments where they lie
    and returns those tensors; the default leaves its inputs as they were
    and returns new ones with the same values."""
    api = configs.get_model("qwen2.5-3b", smoke=True)
    batch = _batch(api.cfg, 2, 16)
    params = api.init_params(make_generator(0, "cpu"))
    state = opt.adamw_init(params)
    before = [t.clone() for t in tree_leaves((params, state))]
    new_p, new_s, m = ts.make_train_step(api)(params, state, batch)
    assert all(torch.equal(a, b) for a, b in
               zip(before, tree_leaves((params, state))))
    ptrs = [t.data_ptr() for t in tree_leaves((params, state))]
    don_p, don_s, dm = ts.make_train_step(api, donate=True)(params, state,
                                                            batch)
    assert [t.data_ptr() for t in tree_leaves((don_p, don_s))] == ptrs
    assert float(dm["loss"]) == float(m["loss"])
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves((new_p, new_s)), tree_leaves((don_p, don_s))))


def test_snapshot_for_checkpoint_copies(tmp_path):
    """The counterpart of ``tests/test_checkpoint.py::
    test_snapshot_for_checkpoint_copies``: the snapshot aliases nothing,
    and checkpoints and restores as it was taken."""
    state = {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
             "b": torch.ones(5, dtype=torch.bfloat16),
             "step": torch.tensor(7, dtype=torch.int32),
             "n": np.arange(3, dtype=np.int64)}
    snap = ts.snapshot_for_checkpoint(state)
    assert all(isinstance(t, torch.Tensor) and t.device.type == "cpu"
               for t in tree_leaves(snap))
    state["w"][:] = 0.0
    state["n"][:] = 0
    assert not torch.equal(snap["w"], state["w"])
    assert snap["n"].tolist() == [0, 1, 2]
    cm = CheckpointManager(tmp_path, CheckpointConfig(store=StoreConfig(
        k=4, r=2, p=1, block_size=256)), device="cpu")
    cm.save(1, snap)
    got, _ = cm.restore(1, snap)
    for a, b in zip(tree_leaves(got), tree_leaves(snap)):
        assert a.dtype == b.dtype and torch.equal(a, b)


# ------------------------------------------------------------------ specs
def _ref_spec(spec) -> tuple:
    """A reference PartitionSpec entry list in the port's form."""
    return tuple(() if e is None else (e,) if isinstance(e, str)
                 else tuple(e) for e in spec)


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("arch", ["qwen25_3b", "seamless_m4t_medium",
                                  "jamba_52b", "arctic_480b"])
def test_train_shardings_match_reference(arch, fsdp):
    """``train_shardings`` on a 1x1 host mesh of the production axes; the
    2x4 cases run in ``tests/test_torch_dist.py``."""
    from repro.dist.sharding import with_rules as ref_with_rules
    from repro_torch.dist import Mesh, with_rules

    rcfg = dataclasses.replace(ref_configs.get_config(arch, smoke=True),
                               fsdp_params=fsdp)
    rapi = ref_registry.build(rcfg)
    papi = registry.build(config_from_reference(rcfg))
    rspecs = ref_configs.input_specs(arch, "train_4k", smoke=True)["batch"]
    pspecs = configs.input_specs(arch, "train_4k", smoke=True)["batch"]
    with ref_with_rules(jax.make_mesh((1, 1), ("data", "model"))) as rmr:
        want = ref_ts.train_shardings(rapi, rmr, rspecs)
    with with_rules(Mesh({"data": 1, "model": 1})) as mr:
        got = ts.train_shardings(papi, mr, pspecs)
    got_specs = []
    tree_map(got_specs.append, got, is_leaf=ts._is_spec)
    assert got_specs == [_ref_spec(s.spec) for s in jax.tree.leaves(want)]


def test_meshes_name_the_reference_axes(monkeypatch):
    """``make_host_mesh`` is a (data=n, model=1) mesh of the machine's
    cards (one host position for ``device="cpu"``; without a card the
    default raises), and ``make_production_mesh`` names the reference's
    axes (``src/repro/launch/mesh.py``) and raises on a machine with fewer
    cards."""
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh

    assert dict(make_host_mesh("cpu").shape) == {"data": 1, "model": 1}
    if torch.cuda.is_available():
        assert dict(make_host_mesh().shape) == {
            "data": torch.cuda.device_count(), "model": 1}
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            make_host_mesh()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 255)
    with pytest.raises(ValueError, match="devices explicitly"):
        make_production_mesh()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 512)
    single, multi = make_production_mesh(), make_production_mesh(
        multi_pod=True)
    assert list(single.shape.items()) == [("data", 16), ("model", 16)]
    assert list(multi.shape.items()) == [("pod", 2), ("data", 16),
                                         ("model", 16)]
    assert multi.devices[-1] == torch.device("cuda", 511)
