"""Serving CLI of the port: degraded block reads from a stripe store.

PYTHONPATH=src python -m repro_torch.launch.serve --blocks --requests 400
PYTHONPATH=src python -m repro_torch.launch.serve --blocks --device cpu

``--blocks`` serves a Zipfian multi-client read load from a demo stripe
store with one failed node: live blocks stream straight from disk, lost
blocks reconstruct inline through the planner (local group first) in the
backend's batched kernel on ``--device`` (the card by default), with
request coalescing and the hot-block cache on — then prints the
degraded-read report (p50/p99, coalescing ratio, cache hit rate).
Serving a model waits for the port's model scaffold, so without
``--blocks`` the command exits non-zero.
"""
from __future__ import annotations

import argparse
import tempfile
import time
from pathlib import Path

import numpy as np


def serve_blocks(args) -> None:
    from repro_torch.ftx import StoreConfig, StripeStore, read_report
    from repro_torch.serve.blocks import BlockServer, zipf_requests

    cfg = StoreConfig(scheme="cp-azure", k=6, r=2, p=2,
                      block_size=args.block_size, pipeline_window=0)
    with tempfile.TemporaryDirectory() as tmp:
        store = StripeStore(Path(tmp) / "store", cfg, device=args.device)
        payload = np.random.default_rng(0).integers(
            0, 256, args.stripes * cfg.k * cfg.block_size, dtype=np.uint8)
        store.put("blob", payload.tobytes())
        store.seal()
        requests = zipf_requests(store, args.requests, seed=1)
        store.fail_node(store.stripes[0].node_of_block[0])
        server = BlockServer(store, clients=args.clients)
        t0 = time.time()
        server.run(requests)
        dt = time.time() - t0
        rep = read_report(store)
        print(f"{len(requests)} reads ({args.clients} clients, "
              f"{store.device}, backend {cfg.backend}) in {dt:.2f}s: "
              f"{rep.direct_reads} direct, {rep.degraded_reads} degraded")
        print(f"decode launches {rep.decode_launches} "
              f"(coalescing ratio {rep.coalescing_ratio:.1f}x, "
              f"coalesced {rep.coalesced_reads}, "
              f"cache hit rate {rep.cache_hit_rate:.2f}, "
              f"local fraction {rep.local_decode_fraction:.2f})")
        print(f"latency p50 {rep.p50_ms:.2f}ms p99 {rep.p99_ms:.2f}ms "
              f"({rep.served_bytes} bytes served)")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--blocks", action="store_true",
                    help="serve degraded block reads from a demo stripe "
                         "store (the only mode of this port so far)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--stripes", type=int, default=32,
                    help="demo store size for --blocks")
    ap.add_argument("--block-size", type=int, default=4096)
    ap.add_argument("--clients", type=int, default=8,
                    help="front-end reader threads for --blocks")
    ap.add_argument("--device", default="cuda",
                    help='where decodes run: "cuda" (default) or "cpu"')
    args = ap.parse_args(argv)
    if not args.blocks:
        ap.exit(2, "repro_torch.launch.serve: serving a model waits for "
                   "the port's model scaffold (ROADMAP queue 1), which is "
                   "not ported yet; pass --blocks to serve degraded block "
                   "reads\n")
    serve_blocks(args)


if __name__ == "__main__":
    main()
