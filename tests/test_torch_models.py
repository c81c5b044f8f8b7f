"""The model scaffold of the port, held to the reference.

For every decoder-only SMOKE architecture the reference's parameters
(``init_params(jax.random.key(0))``) cross through
``convert.params_from_reference``, and both packages run ``forward``,
``prefill`` and ``decode_step`` on the same numpy-seeded tokens.

Bounds, relative to the reference's largest magnitude:

* fp32 (``param_dtype`` float32 on both sides): logits 1e-4 (the
  packages differ only in f32 summation order). Decode logits 1e-3: the
  KV caches are bf16 in both packages, and an f32 key or value that
  differs in its last bits can round to the neighbouring bf16 value; that
  moves the next step's logits by far less than a bf16 step (3.9e-3),
  and the bound stays well below one. bf16 cache entries agree to one
  bf16 step each (2^-7 of the entry, past an absolute floor of 1e-4 for
  entries near 0); f32 cache entries to 1e-4.
* bf16: 2e-2, the reference's own prefill/decode bound
  (``tests/test_models.py``); 5e-2 where an SSD mixer runs, the
  reference's own SSD bound (``test_ssm_chunk_invariance``): the SSD's
  long chain of bf16 products carries more rounding noise in each
  package than attention does.
* bf16 with top-k routing (grok, arctic, jamba): a rounding difference
  upstream can flip a token's expert choice, and that token's logits then
  differ wholesale (even a whole layer on the reference's own input can
  flip). These are held sublayer by sublayer instead: every mixer and
  every FFN on the reference's own input to it, at the bounds above.

The rest are the reference's property tests run on the port, the
parameter counts and shapes of the full configurations on ``meta``, the
logical axis names and the configs as data. The port runs on the CPU
here."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as ref_configs  # noqa: E402
from repro.models import blocks as ref_blocks  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro.models import mlp as ref_mlp  # noqa: E402
from repro.models import registry as ref_registry  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import (config_from_reference,  # noqa: E402
                                 params_from_reference)
from repro_torch.models import (attention, blocks, lm, mlp,  # noqa: E402
                                registry, ssm)
from repro_torch.models.common import make_generator  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

DECODER_ARCHS = tuple(a for a in ref_configs.ARCHS
                      if a != "seamless_m4t_medium")
MOE_ARCHS = ("grok1_314b", "arctic_480b", "jamba_52b")
SSM_ARCHS = ("jamba_52b", "mamba2_27b")
# The reference's parameter counts of the full configurations
# (ModelApi.param_count / active_param_count).
PARAM_COUNTS = {
    "internlm2_20b": (19_292_559_360, 19_292_559_360),
    "qwen25_3b": (3_085_938_688, 3_085_938_688),
    "phi3_mini_38b": (3_722_578_944, 3_722_578_944),
    "gemma3_12b": (11_623_837_440, 11_623_837_440),
    "internvl2_1b": (494_583_808, 494_583_808),
    "grok1_314b": (315_684_034_560, 83_755_800_576),
    "arctic_480b": (476_620_899_328, 15_354_938_368),
    "jamba_52b": (51_217_050_112, 11_757_038_080),
    "mamba2_27b": (2_702_235_136, 2_702_235_136),
    "seamless_m4t_medium": (615_788_544, 615_788_544),
}
FP32_LOGITS = 1e-4
FP32_DECODE = 1e-3
BF16 = 2e-2
BF16_SSD = 5e-2
B, S = 2, 40


@functools.lru_cache(maxsize=None)
def _twin(arch: str, dtype: str = "float32", **over):
    """(reference cfg, api, params; port cfg, api, params) on the same
    weights, the reference's drawn from key 0."""
    rcfg = dataclasses.replace(ref_configs.get_config(arch, smoke=True),
                               param_dtype=getattr(jnp, dtype), **over)
    rapi = ref_registry.build(rcfg)
    rparams = rapi.init_params(jax.random.key(0))
    pcfg = config_from_reference(rcfg)
    return (rcfg, rapi, rparams, pcfg, registry.build(pcfg),
            params_from_reference(rparams, device="cpu"))


def _batches(cfg, seq: int, seed: int = 0):
    """The same numpy-seeded batch for the reference (jnp) and the port."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, seq)).astype(np.int32)
    rb, pb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if cfg.frontend != "none":
        pe = rng.standard_normal((B, cfg.frontend_tokens, cfg.d_model))
        pe = jnp.asarray(pe, jnp.float32).astype(jnp.bfloat16)
        rb["prefix_embeds"] = pe
        pb["prefix_embeds"] = _torch(pe)
    return rb, pb


def _torch(a) -> torch.Tensor:
    return tree_leaves(params_from_reference([a], device="cpu"))[0]


def _np(t) -> np.ndarray:
    return np.asarray(t.float().numpy() if isinstance(t, torch.Tensor)
                      else jnp.asarray(t, jnp.float32))


def _rel(ref, got) -> float:
    ref, got = _np(ref), _np(got)
    assert ref.shape == got.shape
    return float(np.max(np.abs(ref - got)) / (np.max(np.abs(ref)) + 1e-9))


def _head(batch, n):
    return {k: v[:, :n] if k == "tokens" else v for k, v in batch.items()}


def _run_both(arch, dtype):
    """forward, prefill (padded caches) and one decode step in both
    packages: ((ref logits...), (port logits...), ref caches, port caches)
    for forward, prefill, decode and the caches after prefill and after
    decode."""
    rcfg, rapi, rp, pcfg, papi, pp = _twin(arch, dtype)
    rb, pb = _batches(rcfg, S + 1)
    rf = jax.jit(lambda p, b: ref_lm.forward(p, b, rcfg, remat=False))(rp, rb)
    pf = lm.forward(pp, pb, pcfg)
    rl, rc = jax.jit(rapi.prefill)(rp, _head(rb, S))
    pl, pc = papi.prefill(pp, _head(pb, S))
    off = rcfg.frontend_tokens if rcfg.frontend != "none" else 0
    rc = ref_blocks.pad_caches(rc, rcfg, off + S + 8)
    pc = blocks.pad_caches(pc, pcfg, off + S + 8)
    rd, rc2 = jax.jit(rapi.decode_step)(rp, rc, rb["tokens"][:, S:S + 1],
                                        jnp.int32(off + S))
    pd, pc2 = papi.decode_step(pp, pc, pb["tokens"][:, S:S + 1], off + S)
    return (rf, rl, rd), (pf, pl, pd), (rc, rc2), (pc, pc2)


def _cache_pairs(ref, port):
    got = tree_leaves(port)
    want = jax.tree.leaves(ref)
    assert len(got) == len(want)
    return zip(want, got)


def _within_a_bf16_step(want, got) -> bool:
    """Each entry within one bf16 step of the reference's, past the f32
    bound's absolute floor (an entry near 0 by cancellation in f32)."""
    want, got = _np(want), _np(got)
    floor = FP32_LOGITS * np.max(np.abs(want))
    return bool(np.all(np.abs(want - got) <= floor + 2.0 ** -7
                       * np.maximum(np.abs(want), np.abs(got))))


@pytest.mark.parametrize("arch", DECODER_ARCHS)
def test_fp32_matches_reference(arch):
    (rf, rl, rd), (pf, pl, pd), rcs, pcs = _run_both(arch, "float32")
    assert _rel(rf, pf) < FP32_LOGITS
    assert _rel(rl, pl) < FP32_LOGITS
    assert _rel(rd, pd) < FP32_DECODE
    for rc, pc in zip(rcs, pcs):
        for want, got in _cache_pairs(rc, pc):
            assert str(want.dtype) == str(got.dtype).replace("torch.", "")
            if got.dtype == torch.bfloat16:
                assert _within_a_bf16_step(want, got)
            else:
                assert _rel(want, got) < FP32_LOGITS


@pytest.mark.parametrize("arch", [a for a in DECODER_ARCHS
                                  if a not in MOE_ARCHS])
def test_bf16_matches_reference(arch):
    bound = BF16_SSD if arch in SSM_ARCHS else BF16
    (rf, rl, rd), (pf, pl, pd), rcs, pcs = _run_both(arch, "bfloat16")
    assert _rel(rf, pf) < bound
    assert _rel(rl, pl) < bound
    assert _rel(rd, pd) < bound
    for rc, pc in zip(rcs, pcs):
        for want, got in _cache_pairs(rc, pc):
            assert _rel(want, got) < bound


def _sublayers(mods, spec, p, x, cfg):
    """A layer's two halves as ``mods`` (the reference's or the port's
    ``common``, ``attention``, ``ssm`` and ``mlp`` modules) compute them:
    (mixer output, mixer's residual sum, the FFN's normed input)."""
    common, attention, ssm_mod, mlp_mod = mods
    h = common.rms_norm(x, p.norm1, cfg.norm_eps)
    if spec.mixer == "ssm":
        mix = ssm_mod.ssm_forward(p.mixer, h, cfg)
    else:
        window = cfg.sliding_window if spec.mixer == "attn_local" else 0
        mix = attention.attention(p.mixer, h, cfg, window=window)
    mid = x + mix
    return mix, mid, common.rms_norm(mid, p.norm2, cfg.norm_eps)


def _ffn(mods, spec, p, h, cfg):
    mlp_mod = mods[3]
    return (mlp_mod.moe if spec.ffn == "moe" else mlp_mod.mlp)(p.ffn, h, cfg)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_bf16_routed_layers_match_reference(arch):
    """Every mixer and FFN of a routed model in bf16, each on the
    reference's own input to it: a rounding difference in the input of a
    router (even within one layer) can flip an expert choice."""
    from repro.models import attention as ref_attention
    from repro.models import common as ref_common
    from repro.models import ssm as ref_ssm
    from repro_torch.models import attention, common

    ref_mods = (ref_common, ref_attention, ref_ssm, ref_mlp)
    port_mods = (common, attention, ssm, mlp)
    rcfg, _, rp, pcfg, _, pp = _twin(arch, "bfloat16")
    rb, _ = _batches(rcfg, S)
    x = ref_common.embed_tokens(rp["embed"], rb["tokens"])
    specs = ref_blocks.build_period(rcfg)
    ref_sub = jax.jit(functools.partial(_sublayers, ref_mods),
                      static_argnums=(0, 3))
    ref_ffn = jax.jit(functools.partial(_ffn, ref_mods),
                      static_argnums=(0, 3))
    for r in range(rcfg.num_layers // len(specs)):
        for pos, spec in enumerate(specs):
            rlayer = jax.tree.map(lambda a: a[r], rp["stack"][pos])
            player = tree_map(lambda a: a[r], pp["stack"][pos])
            mix, mid, h2 = ref_sub(spec, rlayer, x, rcfg)
            got, _, _ = _sublayers(port_mods, spec, player, _torch(x), pcfg)
            bound = BF16_SSD if spec.mixer == "ssm" else BF16
            assert _rel(mix, got) < bound, (r, pos, spec)
            if spec.ffn == "none":
                x = mid
                continue
            ffn = ref_ffn(spec, rlayer, h2, rcfg)
            assert _rel(ffn, _ffn(port_mods, spec, player, _torch(h2),
                                  pcfg)) < BF16, (r, pos, spec)
            x = mid + ffn


def test_chunked_attention_matches_reference():
    """``attn_chunk=16`` (the flash-style tiled path) on qwen SMOKE."""
    rcfg, rapi, rp, pcfg, papi, pp = _twin("qwen25_3b", attn_chunk=16)
    rb, pb = _batches(rcfg, 64)
    rf = jax.jit(lambda p, b: ref_lm.forward(p, b, rcfg, remat=False))(rp, rb)
    assert _rel(rf, lm.forward(pp, pb, pcfg)) < FP32_LOGITS
    rl, rc = jax.jit(rapi.prefill)(rp, rb)
    pl, pc = papi.prefill(pp, pb)
    assert _rel(rl, pl) < FP32_LOGITS
    for want, got in _cache_pairs(rc, pc):
        assert _within_a_bf16_step(want, got)
    # and the tiled path agrees with the untiled one in the port
    plain = dataclasses.replace(pcfg, attn_chunk=0)
    assert _rel(lm.forward(pp, pb, plain), lm.forward(pp, pb, pcfg)) \
        < FP32_LOGITS


def test_moe_capacity_drops_match_reference():
    """capacity_factor 1.0 on grok SMOKE: choices past an expert's
    capacity drop, in both packages alike."""
    rcfg = dataclasses.replace(ref_configs.get_config("grok1_314b", True),
                               capacity_factor=1.0, param_dtype=jnp.float32)
    rp = ref_mlp.init_moe(jax.random.key(0), rcfg)
    pcfg = config_from_reference(rcfg)
    pp = params_from_reference(rp, device="cpu")
    x = np.random.default_rng(3).standard_normal((2, 64, rcfg.d_model))
    x = jnp.asarray(x, jnp.float32)
    want = jax.jit(lambda p, x: ref_mlp.moe(p, x, rcfg))(rp, x)
    got = mlp.moe(pp, _torch(x), pcfg)
    assert _rel(want, got) < FP32_LOGITS
    roomy = mlp.moe(pp, _torch(x), dataclasses.replace(pcfg,
                                                       capacity_factor=8.0))
    assert _rel(roomy, got) > 1e-3          # drops did happen


# ------------------------------------------- the reference's properties
@pytest.mark.parametrize("arch", DECODER_ARCHS)
def test_prefill_decode_consistency(arch):
    """prefill(S) + decode(S) logits == full forward logits at S (bf16,
    the port's own weights)."""
    api = configs.get_model(arch, smoke=True)
    cfg = api.cfg
    gen = make_generator(0, "cpu")
    params = api.init_params(gen)
    batch = api.sample_batch(B, 65, gen, with_labels=False)
    logits_full = lm.forward(params, batch, cfg)
    logits_pre, caches = api.prefill(params, _head(batch, 64))
    off = cfg.frontend_tokens if cfg.frontend != "none" else 0
    assert _rel(logits_full[:, off + 63], logits_pre[:, 0]) < 0.02
    caches = blocks.pad_caches(caches, cfg, off + 64 + 8)
    logits_dec, _ = api.decode_step(params, caches,
                                    batch["tokens"][:, 64:65], off + 64)
    assert _rel(logits_full[:, off + 64], logits_dec[:, 0]) < 0.02


def test_ssm_chunk_invariance():
    """SSD output must not depend on the chunk size (dual-form identity)."""
    cfg = configs.get_config("mamba2_27b", smoke=True)
    p = ssm.init_ssm(make_generator(0, "cpu"), cfg)
    x = torch.randn((2, 128, cfg.d_model),
                    generator=make_generator(1, "cpu")).to(torch.bfloat16)
    outs = [ssm.ssm_forward(p, x, dataclasses.replace(cfg, ssm_chunk=c))
            .float().numpy() for c in (16, 32, 64, 128)]
    for o in outs[1:]:
        np.testing.assert_allclose(outs[0], o, atol=5e-2, rtol=5e-2)


def test_ssm_decode_matches_forward():
    """Recurrent decode == chunked forward, token by token."""
    cfg = dataclasses.replace(configs.get_config("mamba2_27b", smoke=True),
                              ssm_chunk=16)
    p = ssm.init_ssm(make_generator(0, "cpu"), cfg)
    x = torch.randn((1, 32, cfg.d_model),
                    generator=make_generator(2, "cpu")).to(torch.bfloat16)
    full = ssm.ssm_forward(p, x, cfg).float().numpy()
    cache = ssm.init_ssm_cache(cfg, 1, device="cpu")
    outs = []
    for t in range(32):
        o, cache = ssm.ssm_decode_step(p, x[:, t:t + 1], cache, cfg)
        outs.append(o.float().numpy())
    np.testing.assert_allclose(full, np.concatenate(outs, axis=1),
                               atol=6e-2, rtol=6e-2)


def test_ssm_ragged_tail_matches_reference():
    """A length off the chunk size pads the tail (fp32, mamba2 SMOKE)."""
    rcfg, rapi, rp, pcfg, papi, pp = _twin("mamba2_27b", ssm_chunk=16)
    rb, pb = _batches(rcfg, 37)
    rl, rc = jax.jit(rapi.prefill)(rp, rb)
    pl, pc = papi.prefill(pp, pb)
    assert _rel(rl, pl) < FP32_LOGITS
    for want, got in _cache_pairs(rc, pc):
        assert _rel(want, got) < FP32_LOGITS


# ------------------------------------------------ full configs on meta
def _leaf_specs(tree) -> list:
    """(path, shape, dtype name) of every leaf of a reference (jax) or
    port (torch) nest, dict keys sorted."""
    out = []

    def walk(node, path):
        if node is None:
            return
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{path}/{k}")
        elif isinstance(node, tuple) and hasattr(node, "_fields"):
            for name, child in zip(node._fields, node):
                walk(child, f"{path}/{type(node).__name__}.{name}")
        elif isinstance(node, (list, tuple)):
            for i, child in enumerate(node):
                walk(child, f"{path}/{i}")
        else:
            out.append((path, tuple(int(s) for s in node.shape),
                        str(node.dtype).replace("torch.", "")))

    walk(tree, "")
    return out


@pytest.mark.parametrize("arch", ref_configs.ARCHS)
def test_full_config_params_match_reference(arch):
    api = configs.get_model(arch)
    ref_api = ref_configs.get_model(arch)
    params = api.abstract_params()
    assert all(t.device.type == "meta" for t in tree_leaves(params))
    assert _leaf_specs(params) == _leaf_specs(ref_api.abstract_params())
    assert (api.param_count(), api.active_param_count()) \
        == (ref_api.param_count(), ref_api.active_param_count()) \
        == PARAM_COUNTS[arch]
    caches = api.abstract_caches(4, 128)
    assert _leaf_specs(caches) == _leaf_specs(ref_api.abstract_caches(4, 128))


def _plain(node):
    """A logical-names nest as plain Python data, named tuples by name."""
    if isinstance(node, dict):
        return {k: _plain(v) for k, v in node.items()}
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return (type(node).__name__, [_plain(c) for c in node])
    if isinstance(node, list):
        return [_plain(c) for c in node]
    return node


@pytest.mark.parametrize("smoke", [False, True])
def test_param_logical_matches_reference(smoke):
    for arch in ref_configs.ARCHS:
        got = configs.get_model(arch, smoke).param_logical()
        want = ref_configs.get_model(arch, smoke).param_logical()
        assert _plain(got) == _plain(want), arch


def test_configs_match_reference():
    assert configs.ARCHS == ref_configs.ARCHS
    assert configs.ALIASES == ref_configs.ALIASES
    assert configs.LONG_OK == ref_configs.LONG_OK
    assert {k: dataclasses.astuple(v) for k, v in configs.SHAPES.items()} \
        == {k: dataclasses.astuple(v) for k, v in ref_configs.SHAPES.items()}
    for arch in ref_configs.ARCHS:
        for smoke in (False, True):
            assert configs.get_config(arch, smoke) == config_from_reference(
                ref_configs.get_config(arch, smoke))
        for shape in ref_configs.SHAPES:
            assert configs.cell_valid(arch, shape) \
                == ref_configs.cell_valid(arch, shape)
    for alias in ref_configs.ALIASES:
        assert configs.resolve(alias) == ref_configs.resolve(alias)
    with pytest.raises(KeyError):
        configs.resolve("gpt-17")


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", ["qwen25_3b", "internvl2_1b", "jamba_52b",
                                  "seamless_m4t_medium"])
def test_input_specs_match_reference(arch, shape):
    got = configs.input_specs(arch, shape, smoke=True)
    want = ref_configs.input_specs(arch, shape, smoke=True)
    assert _leaf_specs(got) == _leaf_specs(want)
    assert all(t.device.type == "meta" for t in tree_leaves(got))


# ------------------------------------------------------ encoder-decoder
def _encdec_batches(cfg, seq: int, seed: int = 0):
    """The same numpy-seeded tokens, labels and bf16 frames for both
    packages."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, seq)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, seq)).astype(np.int32)
    frames = jnp.asarray(rng.standard_normal((B, seq, cfg.d_model)),
                         jnp.float32).astype(jnp.bfloat16)
    rb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
          "frames": frames}
    pb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels),
          "frames": _torch(frames)}
    return rb, pb


def _pad_self_kv(caches, pad):
    """Grow the self-attention KV (axis 2: length) by ``pad`` zeros."""
    self_kv, mem = caches
    if isinstance(self_kv.k, torch.Tensor):
        grow = lambda a: torch.nn.functional.pad(a, (0, 0, 0, 0, 0, pad))
        return attention.KVCache(grow(self_kv.k), grow(self_kv.v)), mem
    return jax.tree.map(lambda a: jnp.pad(
        a, [(0, 0), (0, 0), (0, pad), (0, 0), (0, 0)]), self_kv), mem


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encdec_matches_reference(dtype):
    """seamless SMOKE: train_loss, prefill (logits and both caches) and a
    decode step on the padded caches, in both packages on the same
    weights; fp32 and bf16 at the decoder-only bounds."""
    rcfg, rapi, rp, pcfg, papi, pp = _twin("seamless_m4t_medium", dtype)
    fp32 = dtype == "float32"
    rb, pb = _encdec_batches(rcfg, S + 1)
    rloss = float(jax.jit(rapi.train_loss)(rp, rb))
    ploss = float(papi.train_loss(pp, pb))
    assert abs(rloss - ploss) <= (FP32_LOGITS if fp32 else BF16) * rloss
    pre = lambda b: {"tokens": b["tokens"][:, :S], "frames": b["frames"]}
    rl, rc = jax.jit(rapi.prefill)(rp, pre(rb))
    pl, pc = papi.prefill(pp, pre(pb))
    assert _rel(rl, pl) < (FP32_LOGITS if fp32 else BF16)
    for want, got in _cache_pairs(rc, pc):
        assert got.dtype == torch.bfloat16
        assert _within_a_bf16_step(want, got) if fp32 \
            else _rel(want, got) < BF16
    rc, pc = _pad_self_kv(rc, 8), _pad_self_kv(pc, 8)
    rd, rc2 = jax.jit(rapi.decode_step)(rp, rc, rb["tokens"][:, S:S + 1],
                                        jnp.int32(S))
    pd, pc2 = papi.decode_step(pp, pc, pb["tokens"][:, S:S + 1], S)
    assert _rel(rd, pd) < (FP32_DECODE if fp32 else BF16)
    for want, got in _cache_pairs(rc2, pc2):
        assert _within_a_bf16_step(want, got) if fp32 \
            else _rel(want, got) < BF16


def test_encdec_consistency():
    """The reference's ``test_encdec_consistency`` on the port's own
    weights (bf16): prefill(S) and decode(S) against the full decoder."""
    from repro_torch.models import encdec
    from repro_torch.models.common import embed_tokens, lm_logits, rms_norm

    api = configs.get_model("seamless_m4t_medium", smoke=True)
    cfg = api.cfg
    gen = make_generator(0, "cpu")
    params = api.init_params(gen)
    batch = api.sample_batch(B, 49, gen)
    mem = encdec._encode(params, batch["frames"], cfg)
    x = embed_tokens(params["embed"], batch["tokens"])
    x = encdec._decode_stack(params, x, mem, cfg)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits_full = lm_logits(x, params["embed"], None)
    pre = {"tokens": batch["tokens"][:, :48], "frames": batch["frames"]}
    logits_pre, caches = api.prefill(params, pre)
    assert _rel(logits_full[:, 47], logits_pre[:, 0]) < 0.02
    logits_dec, _ = api.decode_step(params, _pad_self_kv(caches, 8),
                                    batch["tokens"][:, 48:49], 48)
    assert _rel(logits_full[:, 48], logits_dec[:, 0]) < 0.02


def test_encdec_builds_and_its_caches_default_to_the_card():
    api = configs.get_model("seamless-m4t-medium")
    assert api.cfg.family == "encdec"
    caches = api.abstract_caches(2, 16)
    assert {t.device.type for t in tree_leaves(caches)} == {"meta"}
    smoke = configs.get_model("seamless-m4t-medium", smoke=True)
    got = smoke.init_caches(smoke.cfg, 1, 8, 4, device="cpu")
    assert [tuple(t.shape) for t in tree_leaves(got)] == [
        (2, 1, 8, 4, 32)] * 2 + [(2, 1, 4, 4, 32)] * 2
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        smoke.init_caches(smoke.cfg, 1, 8, 4)


# ------------------------------------------------------------ gradients
def _count(monkeypatch, module, name) -> list:
    """Count the calls of ``module.name`` from here on."""
    calls = []
    fn = getattr(module, name)

    def counted(*args, **kwargs):
        calls.append(torch.is_grad_enabled())
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, counted)
    return calls


@pytest.mark.parametrize("remat", [True, False])
def test_stacks_rematerialise_under_remat(monkeypatch, remat):
    """With ``remat`` every layer of a period runs again in the backward
    (the reference's ``jax.checkpoint``); without it, once. The gradients
    are the same either way. Under ``no_grad`` nothing is recomputed."""
    api = configs.get_model("gemma3_12b", smoke=True)
    cfg = dataclasses.replace(api.cfg, param_dtype=torch.float32)
    api = registry.build(cfg)
    params = api.init_params(make_generator(0, "cpu"))
    batch = api.sample_batch(B, 40, make_generator(1, "cpu"))
    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    calls = _count(monkeypatch, blocks, "apply_layer")
    loss = torch.nn.functional.cross_entropy(
        lm.forward(params, batch, cfg, remat=remat).flatten(0, 1),
        batch["labels"].flatten().long())
    assert len(calls) == cfg.num_layers
    grads = torch.autograd.grad(loss, leaves)
    assert len(calls) == cfg.num_layers * (2 if remat else 1)
    monkeypatch.undo()
    loss_plain = torch.nn.functional.cross_entropy(
        lm.forward(params, batch, cfg, remat=not remat).flatten(0, 1),
        batch["labels"].flatten().long())
    for g, h in zip(grads, torch.autograd.grad(loss_plain, leaves)):
        assert torch.allclose(g, h, rtol=1e-5, atol=1e-7)
    # prefill: recomputed in a backward with remat, never under no_grad
    calls = _count(monkeypatch, attention, "prefill_attention")
    x = torch.randn(B, 16, cfg.d_model, requires_grad=True)
    out, _ = blocks.prefill_stack(params["stack"], x, cfg, remat=remat)
    torch.autograd.grad(out.sum(), x)
    assert len(calls) == cfg.num_layers * (2 if remat else 1)
    with torch.no_grad():
        blocks.prefill_stack(params["stack"], torch.randn(B, 16, cfg.d_model),
                             cfg, remat=remat)
    assert len(calls) == cfg.num_layers * (3 if remat else 2)


def test_encdec_stacks_rematerialise(monkeypatch):
    """``train_loss`` of the encoder-decoder recomputes every encoder and
    decoder layer in the backward, as the reference's ``jax.checkpoint``
    of both scans does."""
    from repro_torch.models import encdec

    api = configs.get_model("seamless_m4t_medium", smoke=True)
    cfg = api.cfg
    params = api.init_params(make_generator(0, "cpu"))
    batch = api.sample_batch(B, 24, make_generator(1, "cpu"))
    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    enc = _count(monkeypatch, encdec, "_bidir_attention")
    dec = _count(monkeypatch, attention, "cross_attention")
    loss = api.train_loss(params, batch)
    assert (len(enc), len(dec)) == (cfg.encoder_layers, cfg.num_layers)
    grads = torch.autograd.grad(loss, leaves)
    assert (len(enc), len(dec)) == (2 * cfg.encoder_layers,
                                    2 * cfg.num_layers)
    assert all(bool(torch.isfinite(g).all()) for g in grads)


@pytest.mark.parametrize("arch", ref_configs.ARCHS)
def test_smoke_train_loss_reaches_every_parameter(arch):
    """The reference's ``test_smoke_train_loss`` on the port (a finite
    loss on every SMOKE config), and a gradient on every leaf."""
    api = configs.get_model(arch, smoke=True)
    gen = make_generator(0, "cpu")
    params = api.init_params(gen)
    batch = api.sample_batch(2, 64, gen)
    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    loss = api.train_loss(params, batch)
    assert np.isfinite(float(loss.detach()))
    grads = torch.autograd.grad(loss, leaves)
    assert all(g.shape == p.shape and bool(torch.isfinite(g).all())
               for g, p in zip(grads, leaves))


def test_init_params_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_generator(0)


@pytest.mark.parametrize("entry", ["api", "attention", "ssm"])
def test_init_caches_defaults_to_the_card(entry):
    """Caches land on the card unless asked for elsewhere: without CUDA the
    default raises, while ``cpu`` and ``meta`` allocate where asked."""
    cfg = configs.get_config("jamba_52b", smoke=True)
    make = {"api": lambda **kw: configs.get_model("jamba_52b", smoke=True)
            .init_caches(cfg, 1, 8, **kw),
            "attention": lambda **kw: attention.init_cache(cfg, 1, 8, **kw),
            "ssm": lambda **kw: ssm.init_ssm_cache(cfg, 1, **kw)}[entry]
    for dev in ("cpu", "meta"):
        assert {t.device.type for t in tree_leaves(make(device=dev))} == {dev}
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        make()


def test_nest_leaves_pair_with_the_reference():
    """The walker orders a nest's leaves as JAX's pytrees do (a dict by
    sorted key, named tuples and lists in order), and ``tree_map`` refuses
    nests that differ."""
    _, _, rparams, _, _, pparams = _twin("jamba_52b")
    want = jax.tree.leaves(rparams)
    got = tree_leaves(pparams)
    assert len(want) == len(got)
    assert all(tuple(w.shape) == tuple(g.shape)
               and np.array_equal(_np(w), _np(g)) for w, g in zip(want, got))
    nest = {"b": [1, (2, 3)], "a": {"z": 4, "y": None, "x": 5}}
    assert tree_leaves(nest) == jax.tree.leaves(nest)
    assert tree_map(lambda a, b: a + b, nest, nest) == {
        "a": {"x": 10, "y": None, "z": 8}, "b": [2, (4, 6)]}
    with pytest.raises(ValueError):
        tree_map(lambda a, b: a, nest, {"b": [1, (2, 3)], "a": {"z": 4}})
