"""Quickstart on the PyTorch port: build CP-LRCs, inspect repair plans, run
a real repair through the codec's GF(2^8) kernel on the card
(``--device cpu`` runs its plain PyTorch version on the host).

The port of ``examples/quickstart.py``; it prints the same lines.

PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.core import make_scheme, metrics
from repro_torch.core.codec import StripeCodec
from repro_torch.core.repair import multi_repair_plan, single_repair_plan

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
args = ap.parse_args()

print("== CP-Azure (24,2,2) vs Azure LRC (24,2,2) ==")
cp = make_scheme("cp-azure", 24, 2, 2)
az = make_scheme("azure", 24, 2, 2)

gr = cp.n - 1  # the last global parity, G_r
for name, s in (("azure", az), ("cp-azure", cp)):
    plan = single_repair_plan(s, gr)
    print(f"{name:9s} repair G_r: read {plan.cost} blocks via {plan.method}")

d1, l1 = 0, cp.k
plan = multi_repair_plan(cp, [d1, l1])
print(f"cp-azure  repair D1+L1: {plan.cost} blocks, all_local={plan.all_local}"
      f" (paper: 13 vs 24 for Azure)")

print("\n== metrics (paper Table III, P5 column) ==")
for name, s in (("azure", az), ("cp-azure", cp)):
    print(f"{name:9s} ADRC={metrics.adrc(s):6.2f} ARC1={metrics.arc1(s):6.2f}")

print("\n== bytes-level repair through the PyTorch/CUDA codec ==")
codec = StripeCodec(make_scheme("cp-azure", 6, 2, 2), device=args.device)
rng = np.random.default_rng(0)
data = rng.integers(0, 256, (6, 1024), dtype=np.uint8)
stripe = codec.encode(data).cpu().numpy()
lost = {0, 7}  # D1 and L2
avail = {i: stripe[i] for i in range(codec.scheme.n) if i not in lost}
rebuilt, plan = codec.repair_multi(lost, avail)
ok = all((rebuilt[b].cpu().numpy() == stripe[b]).all() for b in lost)
print(f"lost D1+L2 -> read {plan.cost} blocks, bit-exact={ok}")
