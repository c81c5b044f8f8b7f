"""Stripe codec: the per-stripe encode/repair/decode data path on torch.

Planning (which blocks to read, with which GF coefficients) happens on the
host in numpy — mirroring the paper's coordinator — and the byte crunching
runs through the GF(2^8) kernel in ``repro_torch.kernels`` on the codec's
device.

The reconstruction rule is fully general: to rebuild block ``b`` from a
read-set ``R`` we solve ``gen[R].T @ x = gen[b]`` over GF(2^8) and combine
``x @ stack(R-blocks)`` on device. This covers local-group repair, cascaded
repair and global decode with one code path, and works for every scheme.
Every GF solve goes through a :class:`~repro_torch.core.planner.
RepairPlanner`, so repeated repairs of one ``(scheme, pattern, policy)``
reuse the compiled coefficient matrix; multi-node cascades execute as a
single flattened kernel launch. For many stripes sharing a failure
pattern, prefer :class:`~repro_torch.core.engine.BatchedCodecEngine`.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Iterable, Mapping, Optional, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.ops import (as_u8, default_backend, encode_op,
                                     gf_matmul_op, require_backend)

from .planner import RepairPlanner
from .repair import MultiRepairPlan, RepairPlan
from .schemes import LRCScheme


@dataclasses.dataclass
class StripeCodec:
    scheme: LRCScheme
    # see repro_torch.kernels.ops.BACKENDS; default honours REPRO_BACKEND
    backend: str = dataclasses.field(default_factory=default_backend)
    planner: Optional[RepairPlanner] = None
    # Where the byte crunching runs: the card unless the caller asks for
    # the CPU (resolved to a torch.device at construction).
    device: str | torch.device = "cuda"

    def __post_init__(self):
        require_backend(self.backend)
        self.device = resolve_device(self.device)
        if self.planner is None:
            self.planner = RepairPlanner(self.scheme)

    def _stack(self, blocks) -> torch.Tensor:
        return torch.stack([as_u8(b, self.device) for b in blocks], dim=0)

    # ------------------------------------------------------------- encoding
    def encode(self, data) -> torch.Tensor:
        """(k, B) data blocks -> (n, B) full stripe (systematic layout)."""
        data = as_u8(data, self.device)
        if data.shape[0] != self.scheme.k:
            raise ValueError(f"expected {self.scheme.k} data blocks, got "
                             f"{tuple(data.shape)}")
        parity = encode_op(self.scheme.parity_matrix(), data,
                           backend=self.backend)
        return torch.cat([data, parity], dim=0)

    # ----------------------------------------------------- reconstruction
    def reconstruction_coeffs(self, target: int, reads: Sequence[int],
                              free: Mapping[int, np.ndarray] | None = None
                              ) -> Optional[np.ndarray]:
        """GF coefficients x with block[target] = sum_i x_i * block[reads[i]]."""
        return self.planner.coeffs_for(target, tuple(reads))

    def combine(self, coeffs: np.ndarray, blocks: Sequence) -> torch.Tensor:
        """x (|R|,) . blocks (|R|, B) -> (B,) on device via the GF kernel."""
        out = gf_matmul_op(np.asarray(coeffs, np.uint8).reshape(1, -1),
                           self._stack(blocks), backend=self.backend)
        return out[0]

    def repair_single(self, failed: int, available: Mapping,
                      policy: str = "paper"
                      ) -> tuple[torch.Tensor, RepairPlan]:
        compiled = self.planner.single_plan(failed, policy)
        block = self.combine(compiled.coeffs[0],
                             [available[b] for b in compiled.reads])
        return block, compiled.meta

    def repair_multi(self, failed: Iterable[int], available: Mapping
                     ) -> tuple[dict[int, torch.Tensor], MultiRepairPlan]:
        """Execute the min-read multi-node plan; returns rebuilt blocks.

        ``available`` must contain every surviving block the plan reads.
        The planner pre-flattens the cascade, so the whole pattern repairs
        in one kernel launch.
        """
        compiled = self.planner.multi_plan(failed)
        out = gf_matmul_op(compiled.coeffs,
                           self._stack(available[b] for b in compiled.reads),
                           backend=self.backend)
        rebuilt = {b: out[i] for i, b in enumerate(compiled.targets)}
        return rebuilt, compiled.meta

    def decode_all(self, available: Mapping) -> torch.Tensor:
        """Rebuild the k data blocks from any rank-k subset of blocks."""
        compiled = self.planner.decode_plan(available.keys())
        return gf_matmul_op(compiled.coeffs,
                            self._stack(available[b] for b in compiled.reads),
                            backend=self.backend)


def cached_codec(scheme_key: tuple, backend: str | None = None,
                 device: str | torch.device = "cuda") -> StripeCodec:
    """Codec cache keyed by (name, k, r, p, resolved backend, device)."""
    return _cached_codec(scheme_key, backend or default_backend(),
                         resolve_device(device))


@functools.lru_cache(maxsize=64)
def _cached_codec(scheme_key: tuple, backend: str,
                  device: torch.device) -> StripeCodec:
    from .schemes import make_scheme

    name, k, r, p = scheme_key
    return StripeCodec(make_scheme(name, k, r, p), backend=backend,
                       device=device)
