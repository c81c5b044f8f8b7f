"""Placement-policy demo on the PyTorch port: how block placement + stripe
scheduling change repair locality.

Builds one store per block-placement policy (repro_torch.dist.topology)
on an 80-node / 8-domain fleet, fails a node, and repairs twice on a mesh
of eight positions of one device (the card; ``--device cpu``: the host):
once with the locality-aware stripe scheduler and once with the
contiguous stripe->device-shard assignment. The table shows the realized
shard-local read fraction per (policy, schedule): identical rebuilt
bytes, very different traffic.

The port of ``examples/placement_demo.py``; it prints the same lines.

PYTHONPATH=src python examples/torch_placement_demo.py [--device cpu]
"""
import argparse
import shutil
import tempfile

import numpy as np

from repro_torch.device import resolve_device
from repro_torch.dist.sharding import make_mesh, with_rules
from repro_torch.dist.topology import POLICIES, Topology
from repro_torch.ftx import StoreConfig, StripeStore, repair_failed_nodes

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
args = ap.parse_args()
dev = resolve_device(args.device)

S, B, NODES, DOMAINS = 640, 1024, 80, 8
topo = Topology(num_nodes=NODES, num_domains=DOMAINS, spread_width=2, seed=7)
mesh = make_mesh((8, 1), ("data", "model"), devices=(dev,) * 8)
payload = np.random.default_rng(0).integers(0, 256, S * 6 * B,
                                            dtype=np.uint8).tobytes()

print(f"{NODES} nodes / {DOMAINS} domains, {S} stripes, 8-device mesh")
print(f"{'policy':12s} {'scheduled':>10s} {'contiguous':>11s} {'uplift':>7s}")
for policy in POLICIES:
    fracs = {}
    for schedule in ("locality", "none"):
        tmp = tempfile.mkdtemp()
        cfg = StoreConfig(scheme="cp-azure", k=6, r=2, p=2, block_size=B,
                          batch_stripes=8, pipeline_window=8,
                          placement_policy=policy, stripe_schedule=schedule)
        store = StripeStore(tmp, cfg, num_nodes=NODES, topology=topo,
                            device=dev)
        store.put("blob", payload)
        store.seal()
        node = store.stripes[0].node_of_block[0]
        with with_rules(mesh):
            report = repair_failed_nodes(store, [node], device=dev)
        fracs[schedule] = report.local_read_fraction
        shutil.rmtree(tmp, ignore_errors=True)
    uplift = fracs["locality"] / max(fracs["none"], 1e-9)
    print(f"{policy:12s} {fracs['locality']:10.3f} {fracs['none']:11.3f} "
          f"{uplift:6.2f}x")
