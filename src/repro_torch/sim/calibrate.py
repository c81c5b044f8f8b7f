"""Close the loop: measured repair-pipeline throughput -> simulator rates.

The closed-form chain and the simulator both turn a repair plan's
block-read cost into a vulnerability window through
:func:`repro_torch.core.reliability.repair_hours`, whose ``bandwidth_gbps`` is a
*assumed* constant. This module replaces the assumption with a
measurement: run the real repair pipeline (reads -> batched decode ->
write-back, with whatever pipelining/scheduling the store is configured
for) on real data, take the store's byte/latency telemetry, and hand the
*effective* repair bandwidth back to :class:`ReliabilityParams`. Faster
pipelines then shrink every simulated vulnerability window — the
repair-bandwidth feedback the paper's reliability argument rests on.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.core.reliability import ReliabilityParams
from repro_torch.ftx.options import RepairOptions
from repro_torch.ftx.stripestore import StoreConfig, StripeStore

Telemetry = Union[dict, object]


def _field(tele: Telemetry, name: str):
    return tele[name] if isinstance(tele, dict) else getattr(tele, name)


def measured_bandwidth(tele: Telemetry) -> float:
    """Effective repair throughput (Gbps) from repair telemetry — the
    ``bytes_read``/``sim_seconds`` pair every repair path reports
    (``StripeStore.repair_all``'s diff dict, a ``FleetRepairReport``, or a
    ``RepairDoneEvent``)."""
    bytes_read = float(_field(tele, "bytes_read"))
    sim_seconds = float(_field(tele, "sim_seconds"))
    if sim_seconds <= 0:
        raise ValueError("telemetry has no simulated transfer time "
                         "(sim_seconds <= 0); run a repair first")
    return bytes_read * 8.0 / 1e9 / sim_seconds


def calibrated(params: Optional[ReliabilityParams],
               tele_or_gbps: Union[Telemetry, float]) -> ReliabilityParams:
    """``ReliabilityParams`` with ``bandwidth_gbps`` replaced by a measured
    value (a float) or by :func:`measured_bandwidth` of repair telemetry."""
    base = params or ReliabilityParams()
    gbps = (float(tele_or_gbps) if isinstance(tele_or_gbps, (int, float))
            else measured_bandwidth(tele_or_gbps))
    return dataclasses.replace(base, bandwidth_gbps=gbps)


def measure_repair_bandwidth(root: Path, cfg: StoreConfig, *,
                             objects: int = 4, object_bytes: int = 1 << 14,
                             seed: int = 0,
                             options: Optional[RepairOptions] = None,
                             device: str | torch.device = "cuda") -> dict:
    """Run one real single-node repair and report its effective bandwidth.

    Builds a store under ``root``, fills it with ``objects`` random
    objects, fails the node holding stripe 0's first data block, repairs
    through the store's batched engine (``options`` selects pipelining /
    scheduling), and returns the repair telemetry diff augmented with
    ``gbps`` — ready for :func:`calibrated`. The store runs on ``device``:
    on the card its seal and repair launch the backend's kernels.
    ``sim_seconds`` is the link model's, so ``gbps`` depends on the
    store's geometry and bytes, not on the device.
    """
    store = StripeStore(Path(root) / "calib", cfg, device=device)
    rng = np.random.default_rng(seed)
    for i in range(objects):
        store.put(f"calib{i}", rng.integers(0, 256, object_bytes,
                                            dtype=np.uint8).tobytes())
    store.seal()
    store.fail_node(store.stripes[0].node_of_block[0])
    tele = store.repair_all(options=options or RepairOptions())
    tele = dict(tele)
    tele["gbps"] = measured_bandwidth(tele)
    return tele
