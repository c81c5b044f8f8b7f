"""Distribution layer: placement, topology, stripe scheduling and spans.

``sharding`` names device meshes and resolves logical axes onto them;
``stripes`` shards the stripe axis ``S`` of ``(S, k, B)`` batches over the
mesh's data-parallel axes, one launch per device slice; ``placement`` maps
(stripe, block) -> (node, shard) with a local/remote read cost model and
owns the per-shard gather geometry (``plan_gather``/``assemble_shards``);
``topology`` generates placements from failure domains and policies;
``schedule`` assigns a repair chunk's stripes to device shards.
"""
from .placement import (  # noqa: F401
    GatherShard,
    PlacementMap,
    ShardSlice,
    assemble_shards,
    block_loads,
    plan_gather,
    shard_layout,
)
from .schedule import (  # noqa: F401
    ChunkSchedule,
    chunk_affinity,
    schedule_chunk,
    schedule_group,
)
from .sharding import (  # noqa: F401
    DATA_AXES,
    DEFAULT_RULES,
    Mesh,
    MeshRules,
    current_rules,
    make_mesh,
    opt_state_sharding,
    shard_activation,
    with_rules,
)
from .stripes import (  # noqa: F401
    ShardedBatch,
    align_stripe_window,
    sharded_launch,
    stripe_axis_span,
    stripe_sharding,
    stripe_span,
    stripe_spec,
)
from .topology import (  # noqa: F401
    POLICIES,
    Topology,
    place_stripe,
    placement_from_topology,
)
