"""End-to-end example of the PyTorch port: train a reduced qwen2.5 for a few
hundred steps with CP-LRC erasure-coded checkpoints and a mid-run host
failure + restore, on the card (``--device cpu`` runs it on the host).

PYTHONPATH=src python examples/torch_train_lm.py [--steps 200] [--device cpu]
"""
import argparse

from repro_torch.launch.train import main

if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", default="120")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(["--arch", "qwen2.5-3b", "--steps", args.steps, "--batch", "8",
          "--seq", "128", "--ckpt-every", "40", "--kill-host", "2",
          "--lr", "3e-3", "--device", args.device])
