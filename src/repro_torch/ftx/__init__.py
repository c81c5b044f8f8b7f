"""Fault-tolerance layer of the port: the erasure-coded stripe store, its
windowed repair and encode pipelines, erasure-coded checkpointing, fleet
repair orchestration and durability sizing, the fleet-event schema,
failure injection and trace replay, and the background rebalancer."""
from .options import RepairOptions, ServeOptions  # noqa: F401
from .stripestore import (NodeState, StoreConfig, StripeStore,  # noqa: F401
                          StripeStreamWriter, Telemetry, launch_step)
from .checkpoint import (CheckpointConfig, CheckpointFuture,  # noqa: F401
                         CheckpointManager)
from .events import (DataLossEvent, DiskFailEvent, FleetEvent,  # noqa: F401
                     NodeFailEvent, RackFailEvent, RepairDoneEvent,
                     ScrubEvent, SectorErrorEvent)
from .failures import FailureInjector, replay_trace, restripe  # noqa: F401
from .fleet import (Candidate, DegradedReadReport,  # noqa: F401
                    FleetRepairReport, FleetSpec, evaluate, read_report,
                    repair_failed_nodes, size_fleet)
from .pipeline import (EncodePipeline, PipelineResult,  # noqa: F401
                       RepairPipeline, run_double_buffered)
from .rebalance import (Move, RebalanceReport, Rebalancer,  # noqa: F401
                        plan_moves, rebalance)
