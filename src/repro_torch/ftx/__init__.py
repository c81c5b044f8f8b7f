"""Fault-tolerance layer of the port: the erasure-coded stripe store, its
windowed repair pipeline and fleet repair orchestration."""
from .options import RepairOptions, ServeOptions  # noqa: F401
from .stripestore import (NodeState, StoreConfig, StripeStore,  # noqa: F401
                          Telemetry, launch_step)
from .fleet import (DegradedReadReport, FleetRepairReport,  # noqa: F401
                    read_report, repair_failed_nodes)
from .pipeline import (PipelineResult, RepairPipeline,  # noqa: F401
                       run_double_buffered)
