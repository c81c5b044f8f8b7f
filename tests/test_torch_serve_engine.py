"""The continuous-batching model engine of the port, held to the reference.

Twin engines — the reference's and the port's — serve the same requests
on the same fp32 weights (the reference's, from key 0, carried across by
``convert.params_from_reference``) with ``max_batch=3`` and ``max_len=96``:
five requests pass through three slots, so slots are reused, and every
request's tokens and the order in which requests finish must be the same.
Greedy tokens are discrete, so the comparison is exact: f32 summation
order would have to move a logit across its nearest rival to change one.

gemma3's local layers keep a ring cache of the window (32 positions in
SMOKE). The reference's engine cannot take a prompt shorter than the
window (its ``pad_caches`` grows only global caches, and the short ring
cache does not fit the slot); the port's grows the ring too, and its tokens
then equal a greedy loop over the port's own ``forward``.

The rest: the ``serve_model`` command line against the reference's, the
default device, and a CPU rehearsal of ``chip_smoke.py``'s phases 8a and
8c (serving, then serving again from an erasure-coded checkpoint restored
after losing two hosts). The port runs on the CPU here."""
import argparse
import contextlib
import dataclasses
import io
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.launch import serve as ref_serve_cli  # noqa: E402
from repro.models import registry as ref_registry  # noqa: E402
from repro.serve.engine import ServeEngine as RefEngine  # noqa: E402
from repro_torch.configs import get_model  # noqa: E402
from repro_torch.convert import (config_from_reference,  # noqa: E402
                                 params_from_reference)
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import lm, registry  # noqa: E402
from repro_torch.models.common import make_generator  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
MAX_BATCH, MAX_LEN, MAX_NEW = 3, 96, 6
LINE = re.compile(r"^(\d+) requests -> (\d+) tokens in \d+\.\ds "
                  r"\(p50 \d+ms p99 \d+ms\)$")


def _twin_engines(arch: str):
    rcfg = dataclasses.replace(ref_get_config(arch, smoke=True),
                               param_dtype=jnp.float32)
    rapi = ref_registry.build(rcfg)
    rparams = rapi.init_params(jax.random.key(0))
    ref = RefEngine(rapi, max_batch=MAX_BATCH, max_len=MAX_LEN)
    ref.load(rparams)
    papi = registry.build(config_from_reference(rcfg))
    port = ServeEngine(papi, max_batch=MAX_BATCH, max_len=MAX_LEN,
                       device="cpu")
    port.load(params_from_reference(rparams, device="cpu"))
    return ref, port


def _prompts(vocab: int, lengths, seed: int = 0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lengths]


def _serve(engine, prompts, max_new=MAX_NEW):
    """Submit every prompt, step to the end; (tokens per request, request
    ids in the order they finished)."""
    reqs = [engine.submit(p, max_new=max_new) for p in prompts]
    order = []
    while engine.queue or any(s is not None for s in engine.slots):
        engine.step()
        order += [r.rid for r in reqs if r.done and r.rid not in order]
    assert all(r.done for r in reqs)
    return [r.out_tokens for r in reqs], order


@pytest.mark.parametrize("arch,lengths", [
    ("qwen25_3b", (12, 4, 31, 9, 20)),
    ("jamba_52b", (7, 30, 16, 5, 24)),
    ("internvl2_1b", (10, 22, 4, 17, 28)),
])
def test_twin_engines_serve_the_same_tokens(arch, lengths):
    ref, port = _twin_engines(arch)
    prompts = _prompts(ref.cfg.vocab_size, lengths)
    want_tokens, want_order = _serve(ref, prompts)
    got_tokens, got_order = _serve(port, prompts)
    assert got_tokens == want_tokens
    assert got_order == want_order
    assert all(len(t) == MAX_NEW for t in got_tokens)
    # a second pass through the reused slots gives the same tokens again
    assert _serve(port, prompts)[0] == want_tokens
    assert port.latency_stats()["count"] == 2 * len(prompts)


def test_gemma3_window_length_prompts_match_reference():
    """Prompts of at least the window (32) serve alike in both packages:
    the prefill's ring cache is then the window's size."""
    ref, port = _twin_engines("gemma3_12b")
    prompts = _prompts(ref.cfg.vocab_size, (32, 45, 38, 60, 33), seed=1)
    want = _serve(ref, prompts)
    assert _serve(port, prompts) == want


def test_gemma3_short_prompt_the_reference_cannot_serve():
    ref, port = _twin_engines("gemma3_12b")
    prompts = _prompts(ref.cfg.vocab_size, (12, 40, 5), seed=2)
    with pytest.raises(ValueError, match="Incompatible shapes"):
        _serve(ref, prompts[:1])
    got, _ = _serve(port, prompts)
    cfg = port.cfg
    for prompt, tokens in zip(prompts, got):
        seq = torch.from_numpy(prompt.astype(np.int64))
        greedy = []
        for _ in range(MAX_NEW):
            logits = lm.forward(port.params, {"tokens": seq[None]}, cfg)
            greedy.append(int(torch.argmax(logits[0, -1])))
            seq = torch.cat([seq, torch.tensor(greedy[-1:])])
        assert tokens == greedy


def _run_cli(fn) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn()
    return out.getvalue().strip()


def test_cli_serves_a_model_like_the_reference():
    args = dict(arch="qwen2.5-3b", requests=4, max_new=8, max_batch=4,
                max_len=128)
    want = LINE.match(_run_cli(
        lambda: ref_serve_cli.serve_model(argparse.Namespace(**args))))
    got = LINE.match(_run_cli(
        lambda: serve_cli.main(["--device", "cpu", "--requests", "4"])))
    assert want and got
    assert got.groups() == want.groups() == ("4", "32")


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(get_model("qwen2.5-3b", smoke=True))
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_cli.main(["--requests", "1"])


def test_load_refuses_parameters_on_another_device():
    api = get_model("qwen2.5-3b", smoke=True)
    engine = ServeEngine(api, device="cpu")
    meta = api.abstract_params()
    with pytest.raises(ValueError, match="meta"):
        engine.load(meta)
    assert engine.params is None


def test_engine_keeps_a_time_per_call():
    """``call_ms`` holds one time per prefill (one a request) and one per
    decode step."""
    api = get_model("qwen2.5-3b", smoke=True)
    engine = ServeEngine(api, max_batch=2, max_len=32, device="cpu")
    engine.load(api.init_params(make_generator(0, "cpu")))
    prompts = _prompts(api.cfg.vocab_size, (5, 9, 7))
    reqs = [engine.submit(p, max_new=3) for p in prompts]
    steps = 0
    while engine.step():
        steps += 1
    assert all(r.done for r in reqs)
    ms = engine.call_ms()
    assert len(ms["prefill"]) == len(prompts)
    assert len(ms["decode"]) == steps > 0
    assert all(isinstance(t, float) and t >= 0 for t in
               ms["prefill"] + ms["decode"])


@pytest.fixture
def smoke_module(monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT))
    sys.modules.pop("chip_smoke", None)
    import chip_smoke
    yield chip_smoke
    sys.modules.pop("chip_smoke", None)


def test_chip_smoke_model_phases_rehearse_on_the_cpu(smoke_module, tmp_path):
    """Phases 8a and 8c at SMOKE size on the CPU: consistency, the engine's
    repeatable tokens, then the same tokens from the parameters restored
    out of an erasure-coded checkpoint after losing hosts 1 and 2."""
    cs = smoke_module
    dev = torch.device("cpu")
    wrappers = cs.gf_wrappers()
    by_path = {fn.__name__: {} for fn in wrappers}
    served = cs.serve_model_phase(np, torch, dev, "test host", smoke=True)
    assert served["param_count"] == served["api"].param_count()
    assert all(len(t) == cs.MODEL_MAX_NEW for t in served["tokens"])
    out = cs.checkpoint_serve_phase(np, torch, dev, tmp_path, served,
                                    wrappers, by_path)
    assert out["tokens_equal"]
    assert out["restore"]["degraded_blocks"] > 0
    assert set(by_path["gf256_matmul_batched"]) == {"serve_model"}
