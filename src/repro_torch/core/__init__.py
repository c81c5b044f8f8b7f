"""repro_torch.core — CP-LRC codes, repair planning and the codec engine.

Layers:
  gf          GF(2^8) arithmetic (numpy planning tier)
  cauchy      base MDS stripes + Appendix Theorem 1 coefficients
  schemes     the six LRC constructions (4 baselines + CP-Azure/CP-Uniform)
  repair      single-/multi-node repair planning (local-first, cascading)
  planner     compiled + LRU-cached GF plans per (scheme, pattern, policy)
  codec       per-stripe encode/decode data path on torch tensors
  engine      batched multi-stripe executor (one launch per failure pattern)
"""
from .schemes import (  # noqa: F401
    LRCScheme,
    PAPER_PARAMS,
    SCHEMES,
    SCHEME_DISPLAY,
    azure_lrc,
    azure_lrc_plus1,
    cp_azure_lrc,
    cp_uniform_lrc,
    make_scheme,
    optimal_cauchy_lrc,
    uniform_cauchy_lrc,
)
from .repair import (  # noqa: F401
    MultiRepairPlan,
    RepairPlan,
    multi_repair_plan,
    single_repair_plan,
)
