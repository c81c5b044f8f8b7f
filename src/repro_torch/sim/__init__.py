"""Event-driven fleet reliability simulator (DESIGN.md §12).

``simulate`` is the batched trials-in-lockstep engine (event selection
and counter-based RNG in torch on the card); ``simulate_oracle`` is the
bit-identical pure-Python reference loop; ``units``/``rng`` hold the
shared geometry and randomness; ``calibrate`` feeds measured
repair-pipeline throughput back into the failure model.
"""
from .calibrate import calibrated, measure_repair_bandwidth, \
    measured_bandwidth
from .engine import SimResult, simulate
from .oracle import simulate_oracle
from .rng import BitSource, later, weibull_scale
from .units import SimParams, StripeModel, UnitHierarchy

__all__ = [
    "BitSource", "SimParams", "SimResult", "StripeModel", "UnitHierarchy",
    "calibrated", "later", "measure_repair_bandwidth", "measured_bandwidth",
    "simulate", "simulate_oracle", "weibull_scale",
]
