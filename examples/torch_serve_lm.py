"""Batched serving demo of the PyTorch port: continuous batching over a
shared KV cache, on the card (``--device cpu`` runs it on the host).

PYTHONPATH=src python examples/torch_serve_lm.py [--device cpu]
"""
import argparse
import time

import numpy as np

from repro_torch.configs import get_model
from repro_torch.models.common import make_generator
from repro_torch.serve.engine import ServeEngine

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
args = ap.parse_args()

api = get_model("qwen2.5-3b", smoke=True)
engine = ServeEngine(api, max_batch=4, max_len=128, device=args.device)
engine.load(api.init_params(make_generator(0, engine.device)))

rng = np.random.default_rng(0)
reqs = [engine.submit(rng.integers(0, 500, int(rng.integers(4, 24))),
                      max_new=8) for _ in range(10)]
t0 = time.time()
steps = 0
while any(not r.done for r in reqs):
    live = engine.step()
    steps += 1
dt = time.time() - t0
toks = sum(len(r.out_tokens) for r in reqs)
print(f"{len(reqs)} requests, {toks} tokens in {steps} engine steps "
      f"({dt:.1f}s, {toks / dt:.1f} tok/s on the SMOKE config, "
      f"{engine.device})")
for r in reqs[:3]:
    print(f"  req{r.rid}: prompt[{len(r.prompt)}] -> {r.out_tokens}")
