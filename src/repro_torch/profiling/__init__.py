"""Profile-then-plan support for dispatch planning (counterpart of
`repro.profiling`).

- `cost_table`: a persisted, schema-versioned table of warm per-variant
  sweep wall times, keyed by ``(s_bucket, capacity, backend,
  interpolation, quantized)``; the schema is the reference's.
- `cost_model`: the cost models the planner consumes: a null model, an
  affine per-backend fit (dispatch overhead + per-segment-row cost), and a
  measured-table lookup that falls back to the affine fit.
- `recorder`: an opt-in online recorder wired into ``SweepDispatcher``
  that feeds the table from live traffic and captures the dispatch trace.
"""

from repro_torch.profiling.cost_table import (
    COST_TABLE_SCHEMA_VERSION,
    CostTable,
    CostTableError,
    VariantKey,
)
from repro_torch.profiling.cost_model import (
    AffineCostModel,
    NullCostModel,
    TableCostModel,
    fit_affine_model,
)
from repro_torch.profiling.recorder import SweepProfiler, TraceArrival, TraceDispatch

__all__ = [
    "COST_TABLE_SCHEMA_VERSION",
    "CostTable",
    "CostTableError",
    "VariantKey",
    "AffineCostModel",
    "NullCostModel",
    "TableCostModel",
    "fit_affine_model",
    "SweepProfiler",
    "TraceArrival",
    "TraceDispatch",
]
