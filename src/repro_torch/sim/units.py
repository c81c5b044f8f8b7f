"""Unit hierarchy + failure/repair model shared by both simulator paths.

The simulator models one stripe's ``n`` blocks as ``n`` *disks* — the
stateful failure unit — placed onto storage nodes by the same
block-placement machinery the stripe store uses
(:func:`repro_torch.dist.topology.place_stripe`), with racks given by the
topology's failure domains. Node and rack failures are *correlated bursts*:
every disk the unit holds goes down at once, which is exactly the
correlated-failure effect placement policies exist to bound (XORing
Elephants' copyset argument) and closed-form per-disk chains cannot see.

:class:`StripeModel` packages what both the batched engine and the oracle
need to agree on, bit for bit:

* ``decodable(mask)`` — memoized rank check over the erased-block pattern
  (down disks plus latent-error blocks), through the same
  ``LRCScheme.decodable`` the repair planner trusts;
* ``cost_blocks(mask)`` — blocks read to repair the pattern, either the
  closed-form chain's per-count average profile
  (:func:`repro_torch.core.reliability.repair_cost_profile`, making the
  simulator comparable to the chain *by construction*) or the actual
  ``RepairPlanner``/``multi_repair_plan`` cost of the concrete pattern
  (the real repair pipeline in the loop: cheaper CP-LRC plans directly
  shrink the vulnerability window);
* ``tau_hours(mask)`` — mean repair duration via the *shared*
  :func:`repro_torch.core.reliability.repair_hours` model, with the
  ``ReliabilityParams`` bandwidth optionally replaced by the measured
  pipeline throughput (:func:`repro_torch.sim.calibrate.measured_bandwidth`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.reliability import (ReliabilityParams,
                                          repair_cost_profile, repair_hours)
from repro_torch.core.repair import multi_repair_plan
from repro_torch.core.schemes import LRCScheme
from repro_torch.dist.topology import Topology, place_stripe

from .rng import weibull_scale

COST_MODELS = ("average", "planner")
MODELS = ("paper", "strict")


@dataclasses.dataclass(frozen=True)
class UnitHierarchy:
    """disk -> node -> rack geometry, plus the RNG stream-id layout.

    Streams (see ``repro_torch.sim.rng``): disk-``d`` lifetimes are stream
    ``d``, node bursts ``D + i``, rack bursts ``D + N + j``, per-disk latent-error
    arrivals ``D + N + R + d``, and the repair channel is the single last
    stream ``2D + N + R``. Both simulator paths draw from these ids, so a
    draw's identity never depends on event order.
    """
    node_of_disk: tuple[int, ...]
    rack_of_node: tuple[int, ...]

    @classmethod
    def from_topology(cls, n: int, topo: Optional[Topology] = None,
                      policy: str = "contiguous", sid: int = 0
                      ) -> "UnitHierarchy":
        """Place ``n`` disks (stripe blocks) onto ``topo``'s nodes under a
        block-placement policy; racks are the topology's failure domains.
        Default: one node per disk, one rack (no correlated bursts)."""
        topo = topo or Topology(num_nodes=n)
        placed = place_stripe(policy, topo, sid, n)
        # Renumber to the nodes actually used, keeping topology order, so
        # burst streams stay dense no matter how wide the fleet is.
        used = sorted(set(placed))
        node_id = {node: i for i, node in enumerate(used)}
        return cls(node_of_disk=tuple(node_id[node] for node in placed),
                   rack_of_node=tuple(topo.rack_of(node) for node in used))

    @property
    def num_disks(self) -> int:
        return len(self.node_of_disk)

    @property
    def num_nodes(self) -> int:
        return len(self.rack_of_node)

    @property
    def num_racks(self) -> int:
        return max(self.rack_of_node) + 1 if self.rack_of_node else 0

    def disks_of_node(self, node: int) -> tuple[int, ...]:
        return tuple(d for d, nd in enumerate(self.node_of_disk)
                     if nd == node)

    def disks_of_rack(self, rack: int) -> tuple[int, ...]:
        return tuple(d for d, nd in enumerate(self.node_of_disk)
                     if self.rack_of_node[nd] == rack)

    # ------------------------------------------------------ stream layout
    def stream_disk_fail(self, disk: int) -> int:
        return disk

    def stream_node_fail(self, node: int) -> int:
        return self.num_disks + node

    def stream_rack_fail(self, rack: int) -> int:
        return self.num_disks + self.num_nodes + rack

    def stream_lse(self, disk: int) -> int:
        return self.num_disks + self.num_nodes + self.num_racks + disk

    @property
    def stream_repair(self) -> int:
        return 2 * self.num_disks + self.num_nodes + self.num_racks


@dataclasses.dataclass(frozen=True)
class SimParams:
    """Failure/repair processes of one simulated fleet.

    All rates are per the *simulated* clock (hours). ``0`` disables a
    process. With ``weibull_shape=1``, bursts/LSE off, and
    ``cost_model="average"``, the simulator is distribution-identical to
    ``core/reliability.py``'s Markov chain — the cross-validation
    configuration the property tests pin.
    """
    disk_mttf_hours: float = 4.0 * 24 * 365.25   # mean life per disk
    weibull_shape: float = 1.0                   # 1 = exponential (CTMC)
    node_burst_hours: float = 0.0                # mean between node bursts
    rack_burst_hours: float = 0.0                # mean between rack bursts
    lse_hours: float = 0.0                       # mean between latent
    #                                              sector errors, per disk
    scrub_hours: float = 0.0                     # fleet scrub period
    model: str = "paper"                         # "paper" | "strict"
    cost_model: str = "average"                  # "average" | "planner"
    reliability: ReliabilityParams = ReliabilityParams()

    def __post_init__(self):
        if self.model not in MODELS:
            raise ValueError(f"unknown model {self.model!r} "
                             f"(choose from {', '.join(MODELS)})")
        if self.cost_model not in COST_MODELS:
            raise ValueError(f"unknown cost_model {self.cost_model!r} "
                             f"(choose from {', '.join(COST_MODELS)})")
        if self.disk_mttf_hours <= 0:
            raise ValueError("disk_mttf_hours must be positive")
        if self.weibull_shape <= 0:
            raise ValueError("weibull_shape must be positive")

    @property
    def weibull_scale_hours(self) -> float:
        return weibull_scale(self.disk_mttf_hours, self.weibull_shape)


class StripeModel:
    """Decodability + repair-cost oracle over erased-block masks.

    Masks are frozensets of block indices (down disks plus latent-error
    blocks); every query is memoized, so each distinct pattern pays for one
    rank check / one planner solve no matter how many trials hit it.
    """

    def __init__(self, scheme: LRCScheme, params: SimParams):
        self.scheme = scheme
        self.params = params
        self.fmax = scheme.p + scheme.r    # beyond this, loss is certain
        self._decodable: dict[frozenset[int], bool] = {frozenset(): True}
        self._cost: dict[frozenset[int], float] = {}
        self._profile = (repair_cost_profile(scheme, self.fmax)
                         if params.cost_model == "average" else None)

    def decodable(self, mask: frozenset[int]) -> bool:
        got = self._decodable.get(mask)
        if got is None:
            got = self._decodable[mask] = (len(mask) <= self.fmax
                                           and self.scheme.decodable(mask))
        return got

    def cost_blocks(self, down: frozenset[int]) -> float:
        """Blocks read to repair the ``down`` pattern (the repair channel's
        bandwidth demand). ``"average"`` reproduces the Markov chain's
        per-count profile; ``"planner"`` prices the concrete pattern
        through the real multi-failure planner."""
        got = self._cost.get(down)
        if got is None:
            if self._profile is not None:
                got = float(self._profile[len(down)])
            else:
                plan = multi_repair_plan(self.scheme, down)
                if not plan.feasible:
                    raise ValueError(f"cost of unrecoverable {sorted(down)}")
                got = float(plan.cost)
            self._cost[down] = got
        return got

    def tau_hours(self, down: frozenset[int]) -> float:
        """Mean repair duration of the ``down`` pattern — the *same*
        detection + transfer model the closed-form chain uses."""
        return repair_hours(self.cost_blocks(down), len(down),
                            self.params.reliability)
