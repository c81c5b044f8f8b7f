"""End-to-end training in the port: train -> erasure-coded checkpoint ->
lose hosts -> restore through the repair path -> training continues
bit-exactly (the counterpart of ``tests/test_system.py``), and the train
command line on the CPU beside the reference's."""
import contextlib
import io
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_model  # noqa: E402
from repro_torch.data.pipeline import DataConfig, make_pipeline  # noqa: E402
from repro_torch.ftx import CheckpointConfig, CheckpointManager  # noqa: E402
from repro_torch.ftx import StoreConfig  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models.common import make_generator  # noqa: E402
from repro_torch.train.optimizer import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.train.train_step import (TrainConfig,  # noqa: E402
                                          make_train_step)
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402


@pytest.mark.parametrize("donate", [False, True])
def test_train_checkpoint_kill_restore_continue(tmp_path, donate):
    api = get_model("qwen2.5-3b", smoke=True)
    cfg = api.cfg
    data = make_pipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                    global_batch=4, seed=0))
    tc = TrainConfig(opt=AdamWConfig(peak_lr=1e-3, warmup_steps=2,
                                     decay_steps=20))
    step = make_train_step(api, tc, donate=donate)
    params = api.init_params(make_generator(0, "cpu"))
    opt = adamw_init(params)
    for i in range(5):
        params, opt, _ = step(params, opt, data.batch_at(i))

    cm = CheckpointManager(tmp_path, CheckpointConfig(store=StoreConfig(
        scheme="cp-azure", k=8, r=2, p=2, block_size=1 << 16)),
        device="cpu")
    fut = cm.save_async(5, {"params": params, "opt": opt})

    # continue two more steps (the reference trajectory); with donation
    # the first overwrites the saved tensors while the encode may still run
    ref_params, ref_opt = params, opt
    for i in (5, 6):
        ref_params, ref_opt, ref_m = step(ref_params, ref_opt,
                                          data.batch_at(i))
    fut.result()

    # catastrophic: two hosts die; restore through CP-LRC repair
    cm.fail_hosts(5, [0, 3])
    state, tele = cm.restore(5, {"params": params, "opt": opt})
    assert tele["blocks_read"] > 0 and tele["degraded_blocks"] > 0
    assert all(t.device.type == "cpu" for t in tree_leaves(state))
    assert state["opt"]["step"].dtype == torch.int32
    assert int(state["opt"]["step"]) == 5
    re_params = tree_map(lambda t: t.clone(), state["params"])
    re_opt = tree_map(lambda t: t.clone(), state["opt"])
    for i in (5, 6):
        re_params, re_opt, re_m = step(re_params, re_opt, data.batch_at(i))

    # recovered trajectory is bit-identical (deterministic pipeline + exact
    # byte-level restore)
    for a, b in zip(tree_leaves((ref_params, ref_opt)),
                    tree_leaves((re_params, re_opt))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert float(ref_m["loss"]) == float(re_m["loss"])


CLI_ARGS = ["--steps", "30", "--batch", "4", "--seq", "64", "--ckpt-every",
            "10", "--ckpt-async", "--kill-host", "2"]
STEP = re.compile(r"^step +(\d+) loss=([0-9.]+) gnorm=([0-9.]+) "
                  r"lr=([0-9.e+-]+) \([0-9.]+s\)$")
CKPT = re.compile(r"^  \[ckpt\] step (\d+): [0-9.]+ MB encoded async in "
                  r"[0-9.]+s \(train stalled [0-9.]+ms for the snapshot, "
                  r"encode overlap \d+%, \d+ steps ran during encode\)$")


def test_cli_on_the_cpu_prints_the_reference_lines(tmp_path):
    """``--device cpu``: the reference command's lines (its format strings,
    ``src/repro/launch/train.py``; that command itself stops at its first
    sharding constraint under the installed JAX, ROADMAP §3): a step line
    every 10 steps and at the last, the learning rates of the reference's
    ``schedule``, both async saves, host 2 lost and restored after the
    first, losses falling, then ``done:``."""
    from repro.train.optimizer import AdamWConfig as RefAdamW
    from repro.train.optimizer import schedule as ref_schedule

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train_cli.main(CLI_ARGS + ["--device", "cpu", "--ckpt-dir",
                                   str(tmp_path)])
    lines = buf.getvalue().splitlines()
    rows = [STEP.match(line).groups() for line in lines if STEP.match(line)]
    assert [int(r[0]) for r in rows] == [0, 10, 20, 29]
    rcfg = RefAdamW(peak_lr=3e-3, warmup_steps=10, decay_steps=30)
    assert [r[3] for r in rows] == [
        f"{float(ref_schedule(rcfg, np.int32(int(r[0]) + 1))):.2e}"
        for r in rows]
    losses = [float(r[1]) for r in rows]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] - 0.5, losses

    def at(pred):
        return next(i for i, line in enumerate(lines) if pred(line))

    saves = [int(CKPT.match(line).group(1)) for line in lines
             if CKPT.match(line)]
    assert saves == [10, 20]
    kill = at(lambda line: line == "  [ftx ] killing host 2, restoring via "
              "CP-LRC repair")
    assert at(lambda line: line.startswith("  [ckpt] step 10")) < kill \
        < at(lambda line: line.startswith("  [ftx ] restored: {")) \
        < at(lambda line: line.startswith("step   20"))
    assert at(lambda line: line.startswith("  [ckpt] step 20")) \
        > at(lambda line: line.startswith("step   20"))
    assert re.match(r"^done: 30 steps in [0-9.]+s$", lines[-1])


def test_cli_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.main(["--steps", "1"])


ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("example, argv, want", [
    ("torch_train_lm.py", ["--steps", "45"], "done: 45 steps"),
    ("torch_serve_lm.py", [], "10 requests, 80 tokens")])
def test_examples_run_on_the_cpu(example, argv, want):
    run = subprocess.run(
        [sys.executable, str(ROOT / "examples" / example), "--device", "cpu",
         *argv], cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert run.returncode == 0, run.stderr[-2000:]
    assert want in run.stdout


@pytest.fixture
def smoke_module(monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT))
    sys.modules.pop("chip_smoke", None)
    import chip_smoke
    yield chip_smoke
    sys.modules.pop("chip_smoke", None)


def test_chip_smoke_train_phases_rehearse_on_the_cpu(smoke_module, tmp_path):
    """Phase 9 at SMOKE size on the CPU, with the smoke's own checks: 9a's
    steps and first loss, 9b's card-against-host loop (host against host
    here) and microbatches, 9c's bit-identical restored trajectory, and
    9d's command line with ``--device cpu``."""
    cs = smoke_module
    dev = torch.device("cpu")
    full = cs.train_full_phase(np, torch, dev, "test host", smoke=True)
    assert len(full["losses"]) == cs.TRAIN_STEPS
    assert full["flops"]["total"] == full["flops"]["bf16"] \
        + full["flops"]["f32"] > 0
    host = cs.host_card_train_phase(np, torch, dev)
    assert len(host["archs"]) == 10
    wrappers = cs.gf_wrappers()
    by_path = {fn.__name__: {} for fn in wrappers}
    out = cs.checkpoint_train_phase(np, torch, dev, tmp_path, wrappers,
                                    by_path, smoke=True)
    assert out["bit_identical"] and out["restore"]["degraded_blocks"] > 0
    assert set(by_path["gf256_matmul_batched"]) == {"train"}
    cli = cs.train_cli_phase(np, torch, dev, tmp_path)
    assert cli["losses"][-1] < cli["losses"][0]


def test_train_flops_at_full_width(smoke_module):
    """9a's reckoning for qwen2.5-3b at B=1, T=4096: 8 N T with the
    attention's square on top, and the bound of its f32 and bf16 parts."""
    from repro_torch.configs import get_model

    api = get_model("qwen2.5-3b")
    f = smoke_module.train_flops(api.cfg, api.param_count(), 4096, 4096)
    assert 8 * api.param_count() * 4096 == 101_120_038_928_384
    attn = 16 * 36 * 4096 * 4096 * 16 * 128
    assert f["total"] == 101_120_038_928_384 + attn - 8 * 4096 * 151936 \
        * 2048 + 6 * 4096 * 151936 * 2048
    assert 0.49e3 < f["bound_ms"] < 0.51e3
