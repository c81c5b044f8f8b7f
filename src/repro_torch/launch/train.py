"""End-to-end training command of the port.

Synthetic data, AdamW, CP-LRC erasure-coded checkpoints and a
failure-injected restore, on ``--device`` (the card by default; without a
card it raises unless given ``--device cpu``). It prints the reference
command's lines (``step ... loss= gnorm= lr=``, ``[ckpt]``, ``[ftx ]``,
``done:``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \
      --steps 50 --batch 8 --seq 128 --ckpt-every 20 [--kill-host 2]
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 30 \
      --batch 4 --seq 64 --ckpt-every 10 --ckpt-async --kill-host 2

The train step updates the state in place (``donate=True``). ``restore``
returns CPU tensors, which go back to the device before training
continues.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

from repro_torch.configs import get_model
from repro_torch.data.pipeline import DataConfig, make_pipeline
from repro_torch.device import resolve_device
from repro_torch.dist.sharding import with_rules
from repro_torch.ftx.checkpoint import CheckpointConfig, CheckpointManager
from repro_torch.ftx.stripestore import StoreConfig
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.common import make_generator
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.train_step import TrainConfig, make_train_step
from repro_torch.tree import tree_map


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--ckpt-async", action="store_true",
                    help="asynchronous checkpointing: snapshot the state "
                         "(one host copy), then encode + persist in the "
                         "background while training continues")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-scheme", default="cp-azure")
    ap.add_argument("--kill-host", type=int, default=-1,
                    help="fail this checkpoint host mid-run and restore "
                         "through the CP-LRC repair path")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help='where the model, the optimizer and the checkpoint '
                         'codec run: "cuda" (default) or "cpu"')
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    api = get_model(args.arch, smoke=args.smoke)
    cfg = api.cfg
    mesh = make_host_mesh(dev)
    data = make_pipeline(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq, global_batch=args.batch,
        seed=args.seed, frontend=cfg.frontend,
        frontend_tokens=cfg.frontend_tokens, d_model=cfg.d_model,
    ))
    tc = TrainConfig(opt=AdamWConfig(peak_lr=args.lr, warmup_steps=10,
                                     decay_steps=max(args.steps, 20)),
                     microbatches=args.microbatches)
    cm = None
    if args.ckpt_every:
        cm = CheckpointManager(args.ckpt_dir, CheckpointConfig(
            store=StoreConfig(scheme=args.ckpt_scheme, k=8, r=2, p=2,
                              block_size=1 << 18)), device=dev)

    with with_rules(mesh):
        params = api.init_params(make_generator(args.seed, dev))
        opt_state = adamw_init(params)
        step_fn = make_train_step(api, tc, donate=True)
        t0 = time.time()
        pending = None                    # (CheckpointFuture, submit step)

        def collect(at_step: int) -> None:
            """Join the in-flight async save and report what it overlapped."""
            nonlocal pending
            if pending is None:
                return
            fut, submit_step = pending
            pending = None
            info = fut.result()
            enc = info["encode"]
            print(f"  [ckpt] step {fut.step}: {info['bytes']/1e6:.1f} MB "
                  f"encoded async in {info['encode_seconds']:.2f}s "
                  f"(train stalled {fut.snapshot_seconds*1e3:.1f}ms for the "
                  f"snapshot, encode overlap {enc['overlap_fraction']:.0%}, "
                  f"{at_step - submit_step} steps ran during encode)",
                  flush=True)

        for step in range(args.steps):
            params, opt_state, metrics = step_fn(params, opt_state,
                                                 data.batch_at(step))
            if pending and pending[0].done():
                collect(step)
            if step % 10 == 0 or step == args.steps - 1:
                print(f"step {step:4d} loss={float(metrics['loss']):.4f} "
                      f"gnorm={float(metrics['grad_norm']):.3f} "
                      f"lr={float(metrics['lr']):.2e} "
                      f"({(time.time() - t0):.1f}s)", flush=True)
            if cm and step and step % args.ckpt_every == 0:
                if args.ckpt_async:
                    collect(step)         # at most one save in flight
                    pending = (cm.save_async(
                        step, {"params": params, "opt": opt_state}), step)
                else:
                    info = cm.save(step, {"params": params, "opt": opt_state})
                    print(f"  [ckpt] step {step}: {info['bytes']/1e6:.1f} MB "
                          f"encoded in {info['encode_seconds']:.2f}s",
                          flush=True)
                if args.kill_host >= 0:
                    collect(step)         # seal before failing its hosts
                    print(f"  [ftx ] killing host {args.kill_host}, "
                          f"restoring via CP-LRC repair", flush=True)
                    cm.fail_hosts(step, [args.kill_host])
                    state, tele = cm.restore(
                        step, {"params": params, "opt": opt_state})
                    params = tree_map(lambda t: t.to(dev), state["params"])
                    opt_state = tree_map(lambda t: t.to(dev), state["opt"])
                    print(f"  [ftx ] restored: {tele}", flush=True)
                    args.kill_host = -1  # once
        collect(args.steps)
        print(f"done: {args.steps} steps in {time.time() - t0:.1f}s")


if __name__ == "__main__":
    main()
