"""Batched multi-stripe codec engine.

The planner/executor split: :class:`~repro_torch.core.planner.
RepairPlanner` compiles and caches the host-side GF algebra; this module's
:class:`BatchedCodecEngine` executes a compiled plan over a whole *batch*
of stripes at once — ``(S, k, B)`` in, ``(S, n, B)`` out — as a single
launch of the backend's stripe-batched CUDA kernel (the GF(2^8) table
product for gf, the bit-plane products for crs/mxu, which take the plan's
cached GF(2) expansion).

Batches are homogeneous in the failure pattern, not in S: callers group
stripes by pattern (``ftx.stripestore`` does this per fleet repair) and may
pass ragged last batches of any size, including S=1.

Availability can be given either as a dense ``(S, n, B)`` tensor/array or
as a mapping ``block-id -> (S, B)`` holding only surviving blocks; both
gather to the plan's read order on the engine's device before the launch.

Passing :class:`~repro_torch.dist.sharding.MeshRules` (at construction or
per call) shards the stripe axis over the mesh's data axes — one launch
per device slice via ``repro_torch.dist.stripes`` — with bit-identical
results; ``last_span`` reports how many devices the most recent launch
spread over.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Iterable, Mapping, Optional, Union

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.dist.sharding import MeshRules
from repro_torch.dist.stripes import ShardedBatch, stripe_span
from repro_torch.kernels.gf256_matmul import table_chunks
from repro_torch.kernels.ops import (BIT_BACKENDS, as_u8, default_backend,
                                     effective_backend, encode_batch_op,
                                     gf_matmul_batch_op, require_backend)

from .planner import CompiledPlan, RepairPlanner
from .schemes import LRCScheme

Blocks = Union[torch.Tensor, np.ndarray, Mapping[int, "torch.Tensor | np.ndarray"]]


@dataclasses.dataclass
class BatchedCodecEngine:
    scheme: LRCScheme
    # REPRO_BACKEND > gf (kernels.ops.default_backend), resolved once at
    # construction.
    backend: str = dataclasses.field(default_factory=default_backend)
    planner: RepairPlanner | None = None
    mesh_rules: MeshRules | None = None
    # Where launches run: the card unless the caller asks for the CPU.
    device: str | torch.device = "cuda"
    last_span: int = dataclasses.field(default=1, init=False)
    # Wall-clock of the most recent execute() launch, taken after
    # torch.cuda.synchronize() so span accounting upstream sees real
    # compute time rather than the enqueue.
    last_exec_seconds: float = dataclasses.field(default=0.0, init=False)
    # Coefficient table chunks the most recent execute() launch's GF(2^8)
    # kernels built: one launch per device slice, each
    # table_chunks(|reads|); 0 when the kernel did not run.
    last_table_chunks: int = dataclasses.field(default=0, init=False)
    # Formulation the most recent launch actually ran (kernels.ops.
    # effective_backend): equals ``backend`` except that a "gf" batch on
    # the CPU runs the plain table path and reports "ref".
    effective_backend: str = dataclasses.field(default="", init=False)

    def __post_init__(self):
        require_backend(self.backend)
        self.device = resolve_device(self.device)
        if self.planner is None:
            self.planner = RepairPlanner(self.scheme)
        elif self.planner.scheme is not self.scheme:
            raise ValueError("planner is bound to a different scheme")

    def _rules(self, mesh_rules: Optional[MeshRules]) -> Optional[MeshRules]:
        return self.mesh_rules if mesh_rules is None else mesh_rules

    def _bits(self, plan: CompiledPlan) -> Optional[np.ndarray]:
        """The plan's cached GF(2) expansion when the backend needs one."""
        return plan.bit_coeffs() if self.backend in BIT_BACKENDS else None

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # --------------------------------------------------------------- helpers
    def _gather(self, available: Blocks, reads: tuple[int, ...]) -> torch.Tensor:
        """Stack the read blocks into (S, |reads|, B) in plan column order."""
        if isinstance(available, Mapping):
            cols = []
            for b in reads:
                try:
                    cols.append(as_u8(available[b], self.device))
                except KeyError:
                    raise KeyError(f"plan reads block {b} but it was not "
                                   f"provided") from None
            return torch.stack(cols, dim=1)
        arr = as_u8(available, self.device)
        if arr.ndim != 3:
            raise ValueError(f"expected (S, n, B) availability, got "
                             f"{tuple(arr.shape)}")
        return arr[:, list(reads), :].contiguous()

    def execute(self, plan: CompiledPlan, stacked,
                mesh_rules: Optional[MeshRules] = None) -> torch.Tensor:
        """Run a compiled plan on an already-gathered (S, |reads|, B) stack.

        The zero-copy entry point for callers that materialize the read
        stack themselves. ``stacked`` may be a host numpy array (the stripe
        store's single-shard gather), a tensor, or a
        :class:`~repro_torch.dist.stripes.ShardedBatch` built per device
        shard (``repro_torch.dist.placement.assemble_shards``), which is
        consumed where its shards lie — never bounced through one device.
        A batch the mesh does not split moves to the engine's device
        before the timer starts; a split one is scattered slice by slice
        by the launch. Returns the ``(S, |targets|, B)`` result on the
        engine's device.
        """
        if not isinstance(stacked, (torch.Tensor, ShardedBatch)):
            stacked = np.ascontiguousarray(stacked, np.uint8)
        if stacked.ndim != 3 or stacked.shape[1] != len(plan.reads):
            raise ValueError(f"expected (S, {len(plan.reads)}, B) stack for "
                             f"plan reads {plan.reads}, got "
                             f"{tuple(stacked.shape)}")
        mr = self._rules(mesh_rules)
        self.last_span = stripe_span(stacked.shape, mr)
        stacked = self.place(stacked, mesh_rules)
        self.effective_backend = effective_backend(self.backend, self.device)
        self.last_table_chunks = (
            self.last_span * table_chunks(len(plan.reads))
            if self.effective_backend == "gf" else 0)
        bitmatrix = self._bits(plan)
        t0 = time.perf_counter()
        out = gf_matmul_batch_op(plan.coeffs, stacked, backend=self.backend,
                                 device=self.device, bitmatrix=bitmatrix,
                                 mesh_rules=mr)
        self._sync()
        self.last_exec_seconds = time.perf_counter() - t0
        return out

    def place(self, stacked, mesh_rules: Optional[MeshRules] = None):
        """``stacked`` where :meth:`execute` launches it: a batch the mesh
        does not split on the engine's device (from the host, one copy), a
        split or :class:`~repro_torch.dist.stripes.ShardedBatch` one as it
        is (the launch scatters it slice by slice). Callers that time the
        copy apart from the launch call this first; ``execute`` then finds
        the stack where it belongs."""
        if isinstance(stacked, ShardedBatch) or stripe_span(
                stacked.shape, self._rules(mesh_rules)) > 1:
            return stacked
        return as_u8(stacked, self.device)

    def _execute(self, plan: CompiledPlan, available: Blocks,
                 mesh_rules: Optional[MeshRules] = None) -> torch.Tensor:
        return self.execute(plan, self._gather(available, plan.reads),
                            mesh_rules)

    # ------------------------------------------------------------- encoding
    def encode(self, data, mesh_rules: Optional[MeshRules] = None
               ) -> torch.Tensor:
        """(S, k, B) data -> (S, n, B) systematic stripes, one launch (one
        per device slice under a mesh)."""
        data = as_u8(data, self.device)
        if data.ndim != 3 or data.shape[1] != self.scheme.k:
            raise ValueError(f"expected (S, {self.scheme.k}, B) data, got "
                             f"{tuple(data.shape)}")
        mr = self._rules(mesh_rules)
        self.last_span = stripe_span(data.shape, mr)
        self.effective_backend = effective_backend(self.backend, self.device)
        plan = self.planner.encode_plan()
        parity = encode_batch_op(plan.coeffs, data, backend=self.backend,
                                 mesh_rules=mr, bitmatrix=self._bits(plan))
        return torch.cat([data, parity], dim=1)

    # ------------------------------------------------------------- repair
    def repair_single(self, failed: int, available: Blocks,
                      policy: str = "paper",
                      mesh_rules: Optional[MeshRules] = None
                      ) -> tuple[torch.Tensor, CompiledPlan]:
        """Rebuild one block across S stripes: (S, B) plus the cached plan."""
        plan = self.planner.single_plan(failed, policy)
        return self._execute(plan, available, mesh_rules)[:, 0, :], plan

    def repair_multi(self, failed: Iterable[int], available: Blocks,
                     mesh_rules: Optional[MeshRules] = None
                     ) -> tuple[dict[int, torch.Tensor], CompiledPlan]:
        """Rebuild a failure pattern across S stripes in one launch.

        Returns ``{block -> (S, B)}``; the cascade is pre-flattened by the
        planner so there is exactly one kernel launch regardless of how many
        blocks the pattern repairs — one per device when sharded.
        """
        plan = self.planner.multi_plan(failed)
        out = self._execute(plan, available, mesh_rules)
        return {b: out[:, i, :] for i, b in enumerate(plan.targets)}, plan

    # ------------------------------------------------------------- decode
    def decode(self, available: Blocks, ids: Iterable[int] | None = None,
               mesh_rules: Optional[MeshRules] = None) -> torch.Tensor:
        """(S, k, B) data blocks from any rank-k subset of surviving blocks.

        ``ids`` names the surviving blocks; it may be omitted for a Mapping
        availability (its keys are used).
        """
        if ids is None:
            if not isinstance(available, Mapping):
                raise ValueError("ids is required for dense availability")
            ids = available.keys()
        plan = self.planner.decode_plan(ids)
        return self._execute(plan, available, mesh_rules)
