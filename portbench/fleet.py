"""Set-up shared by the drivers: a stripe store of the cell's
configuration, filled with data made from the seed and sealed, and the
reference's view of it for the check after the window.

The data are made on the run's device by one ``torch.Generator`` seeded
with ``--seed``, a few stripes a call, and handed to the store as host
arrays; the benchmark keeps its own copy for the check. After sealing,
every block file is hard-linked under ``sealed/`` (no bytes written), so
the check reads the sealed bytes even where the window replaced a file.
"""
from __future__ import annotations

import dataclasses
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

from portbench.reference import lrc

# Stripes made in one call of the generator (24 MiB each at P5).
_CHUNK = 8


@dataclasses.dataclass
class Fleet:
    store: object
    data: torch.Tensor                 # (S, k, B) uint8, on the host
    gen: np.ndarray                    # the reference's (n, k) generator
    nodes_of: list                     # reference placement: sid -> nodes
    root: Path                         # the store's root
    sealed: Path                       # hard links of the sealed files

    @property
    def k(self) -> int:
        return self.gen.shape[1]

    @property
    def n(self) -> int:
        return self.gen.shape[0]

    def block_on(self, sid: int, node: int) -> int:
        return self.nodes_of[sid].index(node)

    def path(self, sid: int, block: int) -> Path:
        node = self.nodes_of[sid][block]
        return self.root / f"node{node}" / f"s{sid}_b{block}.blk"


def make_data(cfg: dict, seed: int, device) -> torch.Tensor:
    """(stripes, k, block_size) bytes from ``seed``, made on ``device``."""
    shape = (cfg["stripes"], cfg["k"], cfg["block_size"])
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out = torch.empty(shape, dtype=torch.uint8)
    for lo in range(0, shape[0], _CHUNK):
        hi = min(lo + _CHUNK, shape[0])
        out[lo:hi] = torch.randint(0, 256, (hi - lo, *shape[1:]),
                                   dtype=torch.uint8, device=device,
                                   generator=gen).cpu()
    return out


def build(ctx) -> Fleet:
    """Make the data, put one object of k blocks per stripe, seal."""
    from repro_torch.ftx import StoreConfig, StripeStore

    cfg = ctx.cell.config
    scfg = StoreConfig(scheme=cfg["scheme"], k=cfg["k"], r=cfg["r"],
                       p=cfg["p"], block_size=cfg["block_size"],
                       backend=cfg["backend"],
                       placement_policy=cfg["placement"],
                       bandwidth_gbps=float(cfg["link_gbps"]),
                       io_stall_scale=float(cfg["io_stall_scale"]))
    root = ctx.workdir / "store"
    store = StripeStore(root, scfg, num_nodes=cfg["nodes"],
                        device=ctx.device)
    t0 = time.perf_counter()
    data = make_data(cfg, ctx.seed, ctx.device)
    t1 = time.perf_counter()
    for sid in range(cfg["stripes"]):
        store.put(f"s{sid}", data[sid].numpy())
    store.seal()
    t2 = time.perf_counter()
    # The sealed fleet goes to disk before anything is measured, so that
    # its write-back does not run inside the window.
    os.sync()
    print(f"portbench: set-up: {t0 - ctx.t_process} s to the store, "
          f"{t1 - t0} s making the data, {t2 - t1} s putting and sealing "
          f"{cfg['stripes']} stripes, {time.perf_counter() - t2} s syncing",
          file=sys.stderr)
    gen = lrc.generator(cfg["scheme"], cfg["k"], cfg["r"], cfg["p"])
    nodes_of = [lrc.placement(cfg["placement"], cfg["nodes"], sid,
                              gen.shape[0], cfg["placement_stride"])
                for sid in range(cfg["stripes"])]
    fleet = Fleet(store=store, data=data, gen=gen, nodes_of=nodes_of,
                  root=root, sealed=ctx.workdir / "sealed")
    fleet.sealed.mkdir()
    for path in root.glob("node*/*.blk"):
        os.link(path, fleet.sealed / path.name)
    return fleet


def read_file(path: Path) -> torch.Tensor:
    try:
        return torch.from_numpy(np.fromfile(path, dtype=np.uint8))
    except OSError:
        return torch.empty(0, dtype=torch.uint8)


class Reference:
    """The blocks every stripe should hold: the data as made, and the
    parities the reference encodes from them on ``device``, in chunks."""

    def __init__(self, fleet: Fleet, device):
        self.fleet = fleet
        parts = []
        for lo in range(0, fleet.data.shape[0], _CHUNK):
            chunk = fleet.data[lo:lo + _CHUNK].to(device)
            parts.append(lrc.encode(fleet.gen, chunk).cpu())
            del chunk
        self.parity = torch.cat(parts)

    def block(self, sid: int, block: int) -> torch.Tensor:
        k = self.fleet.k
        return (self.fleet.data[sid, block] if block < k
                else self.parity[sid, block - k])

    def wrong(self, sid: int, block: int, got: torch.Tensor) -> bool:
        want = self.block(sid, block)
        return got.shape != want.shape or not torch.equal(got, want)


def common_checks(fleet: Fleet, ref: Reference, placed: dict) -> dict:
    """Placement (``placed``: the store's, sid -> nodes) and the sealed
    parity blocks, for every stripe."""
    placement = sum(placed.get(sid) != nodes
                    for sid, nodes in enumerate(fleet.nodes_of))
    placement += abs(len(placed) - len(fleet.nodes_of))
    parity = sum(ref.wrong(sid, b, read_file(fleet.sealed / f"s{sid}_b{b}.blk"))
                 for sid in range(len(fleet.nodes_of))
                 for b in range(fleet.k, fleet.n))
    return {"placement_stripes_wrong": (placement, 0),
            "sealed_parity_blocks_wrong": (parity, 0)}


def release(fleet: Fleet) -> dict:
    """Drop the program's state before the reference runs; returns the
    store's placement (sid -> nodes) for the check."""
    placed = {sid: list(st.node_of_block)
              for sid, st in fleet.store.stripes.items()}
    fleet.store = None
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return placed


def device_record(ctx, tracer, t0: float, t1: float) -> dict:
    """The device readings of a run: peak memory, and with a trace the
    busy seconds, the window and the breakdown."""
    peak = (torch.cuda.max_memory_allocated(ctx.device)
            if ctx.device.type == "cuda" else 0)
    out = {"memory_peak_bytes": peak, "window_s": t1 - t0,
           "setup_s": t0 - ctx.t_process, "trace": None}
    if tracer.enabled:
        summary = tracer.summary()
        out.update(trace=summary, busy_s=summary["busy_us"] / 1e6,
                   breakdown={"device_ops": summary["device_ops"],
                              "idle_gaps": summary["idle_gaps"]})
    return out
