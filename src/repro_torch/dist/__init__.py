"""Distribution layer: placement, topology, stripe scheduling and spans.

``placement`` maps (stripe, block) -> (node, shard) with a local/remote
read cost model and owns the gather geometry; ``topology`` generates
placements from failure domains and policies; ``schedule`` assigns a
repair chunk's stripes to device shards; ``sharding``/``stripes`` resolve
the stripe axis onto a mesh. This slice runs on one card: multi-device
meshes raise ``NotImplementedError``.
"""
from .placement import (  # noqa: F401
    GatherShard,
    PlacementMap,
    ShardSlice,
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
    Mesh,
    MeshRules,
    current_rules,
    with_rules,
)
from .stripes import (  # noqa: F401
    align_stripe_window,
    sharded_launch,
    stripe_axis_span,
    stripe_span,
)
from .topology import (  # noqa: F401
    POLICIES,
    Topology,
    place_stripe,
    placement_from_topology,
)
