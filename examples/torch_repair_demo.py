"""Cluster repair demo on the PyTorch port (mini Experiment 1/3): fail nodes
against a live store, watch CP-LRC repair bandwidth vs Azure LRC. Repairs
run through the GF(2^8) kernel on the card (``--device cpu`` runs its
plain PyTorch version on the host).

The port of ``examples/repair_demo.py``; it prints the same lines.

PYTHONPATH=src python examples/torch_repair_demo.py [--device cpu]
"""
import argparse
import shutil
import tempfile

import numpy as np

from repro_torch.ftx.stripestore import StoreConfig, StripeStore

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
args = ap.parse_args()

rng = np.random.default_rng(0)
for scheme in ("azure", "cp-azure", "cp-uniform"):
    tmp = tempfile.mkdtemp()
    cfg = StoreConfig(scheme=scheme, k=12, r=2, p=2, block_size=64 * 1024)
    store = StripeStore(tmp, cfg, device=args.device)
    for i in range(12):
        store.put(f"o{i}", rng.integers(0, 256, cfg.block_size - 64,
                                        dtype=np.uint8).tobytes())
    store.seal()
    results = {}
    # single failures: a data node, a local-parity node, the G_r node
    for label, block in (("data", 0), ("local-parity", store.scheme.k),
                         ("G_r", store.scheme.n - 1)):
        node = store.stripes[0].node_of_block[block]
        store.fail_node(node)
        tele = store.repair_all()
        store.revive_node(node)
        results[label] = tele["blocks_read"]
    # the cascading two-failure case: D1 + L1
    st = store.stripes[0]
    for b in (0, store.scheme.k):
        store.fail_node(st.node_of_block[b])
    tele = store.repair_all()
    for b in (0, store.scheme.k):
        store.revive_node(st.node_of_block[b])
    results["D1+L1"] = tele["blocks_read"]
    print(f"{scheme:11s} blocks read -> {results}")
    shutil.rmtree(tmp, ignore_errors=True)
