"""Options objects for the repair and serving paths (PR 8 API collapse).

``StripeStore.repair_all`` grew one keyword per PR — ``batched=``,
``mesh_rules=``, ``pipeline=``, ``window=``, ``pipeline_hook=``,
``placement=``, ``schedule=`` — and every layer above it
(``RepairPipeline``, ``repair_failed_nodes``, ``FailureInjector``, the
benchmarks) re-declared the same sprawl to forward it. This module
collapses the knobs into two frozen dataclasses:

* :class:`RepairOptions` — how to execute a repair. ``None`` fields mean
  "the store's configured default", exactly the semantics the old kwargs
  had, so ``RepairOptions()`` is always safe.
* :class:`ServeOptions` — how to serve a (possibly degraded) read:
  per-request overrides of the store-config coalescing/cache knobs.

All entry points take ``options=`` exclusively. The pre-PR-8 loose kwargs
were accepted (with a ``DeprecationWarning``) for the one promised cycle
and deleted in PR 9; passing them now raises ``TypeError`` like any other
unknown keyword.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional


@dataclasses.dataclass(frozen=True)
class RepairOptions:
    """How to execute a repair (``StripeStore.repair_all`` and friends).

    Every field defaults to "whatever the store is configured to do":
    ``None`` means the store-config default for that knob (``pipeline`` ->
    ``cfg.pipeline_window > 0``, ``window`` -> ``cfg.pipeline_window``,
    ``schedule`` -> ``cfg.stripe_schedule``, ``placement`` -> the store's
    map, ``mesh_rules`` -> the ambient ``with_rules`` context).
    """
    batched: bool = True                 # pattern-batched engine vs seed loop
    mesh_rules: Any = None               # device sharding of the stripe axis
    pipeline: Optional[bool] = None      # async double-buffered windows
    window: Optional[int] = None         # stripes per window/launch chunk
    pipeline_hook: Optional[Callable[[str, int], None]] = None
    placement: Any = None                # PlacementMap for the sharded gather
    schedule: Optional[str] = None       # "none" | "locality" | "global"
    destinations: Optional[str] = None   # rebuild write-back placement:
    #                                      "in_place" | "topology" (None ->
    #                                      cfg.rebuild_destinations)


@dataclasses.dataclass(frozen=True)
class ServeOptions:
    """How to serve one read (``StripeStore.read``/``read_range``).

    Per-request overrides of the store-config serving knobs; ``None``
    keeps the configured behavior. ``coalesce=False`` opts this request
    out of in-flight decode sharing (it always leads its own decode);
    ``use_cache=False`` bypasses the hot-block cache both ways — no probe,
    and the reconstruction is not inserted (sibling targets of a multi-
    block plan are still cached: they belong to other requests).
    """
    coalesce: Optional[bool] = None
    use_cache: Optional[bool] = None

    def coalesce_for(self, cfg) -> bool:
        return cfg.coalesce_reads if self.coalesce is None else self.coalesce

    def cache_for(self, cfg) -> bool:
        return (cfg.read_cache_blocks > 0 if self.use_cache is None
                else self.use_cache)
