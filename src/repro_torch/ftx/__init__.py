"""Fault-tolerance layer of the port: the erasure-coded stripe store, its
windowed repair and encode pipelines, erasure-coded checkpointing and
fleet repair orchestration."""
from .options import RepairOptions, ServeOptions  # noqa: F401
from .stripestore import (NodeState, StoreConfig, StripeStore,  # noqa: F401
                          StripeStreamWriter, Telemetry, launch_step)
from .checkpoint import (CheckpointConfig, CheckpointFuture,  # noqa: F401
                         CheckpointManager)
from .fleet import (DegradedReadReport, FleetRepairReport,  # noqa: F401
                    read_report, repair_failed_nodes)
from .pipeline import (EncodePipeline, PipelineResult,  # noqa: F401
                       RepairPipeline, run_double_buffered)
