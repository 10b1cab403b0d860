"""Cost models consumed by the dispatch planner (counterpart of
`repro.profiling.cost_model`).

A cost model is anything with a ``predict_sweep_s(key) -> float | None``
method (duck-typed so :mod:`repro_torch.core.pipeline` never imports this
package).  ``None`` means "no prediction" — the planner then falls back
to the pre-cost-model heuristics, which is exactly how the null model
preserves bitwise-identical schedules.

The affine model is per-backend: a sweep's wall time is modeled as a
fixed dispatch overhead plus a per-segment-row rate,

    cost(key) ~= overhead[backend] + rate[backend] * s_bucket * capacity

which matches how a padded bucket sweep scales
(every padded row back-projects the same number of planes regardless of
real occupancy).  The table model prefers the measured mean when the
exact variant was profiled and falls back to the affine fit otherwise.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.profiling.cost_table import CostTable, VariantKey


class NullCostModel:
    """Predicts nothing: the planner keeps its pre-cost-model behavior."""

    def predict_sweep_s(self, key: VariantKey) -> float | None:
        return None

    def to_json(self) -> dict:
        return {"kind": "null"}


@dataclass(frozen=True)
class AffineCostModel:
    """Per-backend affine fit: ``overhead_b + rate_b * rows``."""

    # backend -> (overhead_s, rate_s_per_row)
    params: dict[str, tuple[float, float]] = field(default_factory=dict)

    def predict_sweep_s(self, key: VariantKey) -> float | None:
        fit = self.params.get(key.backend)
        if fit is None:
            return None
        overhead, rate = fit
        # parameters given by hand can extrapolate below zero (a fit's
        # cannot: `_lstsq_affine`); a sweep can never take negative time
        return max(0.0, overhead + rate * key.rows)

    def to_json(self) -> dict:
        return {
            "kind": "affine",
            "params": {
                backend: {"overhead_s": overhead, "rate_s_per_row": rate}
                for backend, (overhead, rate) in sorted(self.params.items())
            },
        }


@dataclass(frozen=True)
class TableCostModel:
    """Measured lookup with affine fallback for out-of-distribution keys."""

    table: CostTable
    fallback: AffineCostModel

    def predict_sweep_s(self, key: VariantKey) -> float | None:
        measured = self.table.mean_s(key)
        if measured is not None:
            return measured
        return self.fallback.predict_sweep_s(key)

    def to_json(self) -> dict:
        return {
            "kind": "table",
            "entries": len(self.table),
            "fallback": self.fallback.to_json(),
        }


def _lstsq_affine(points: list[tuple[float, float]]) -> tuple[float, float]:
    """Least-squares fit of ``y = a + b*x`` with ``a, b >= 0``, without
    importing numpy.

    The normal equations for a 2-parameter fit are closed-form, so the
    fit needs no array library. A sweep's cost cannot fall as its rows
    grow, nor fall below nothing: where the unconstrained fit has a
    negative rate or overhead (timing noise over a narrow span of rows),
    the constrained optimum lies on an edge of the quadrant, pure
    overhead or pure rate, and the better of the two is taken. Otherwise
    an extrapolation to groups several times the measured rows can
    predict zero-cost sweeps. (The reference keeps the unconstrained fit.)
    """
    n = len(points)
    sx = sum(x for x, _ in points)
    sy = sum(y for _, y in points)
    sxx = sum(x * x for x, _ in points)
    sxy = sum(x * y for x, y in points)
    denom = n * sxx - sx * sx
    if denom == 0:
        # all rows equal: degenerate — model it as pure overhead
        return (max(0.0, sy / n), 0.0)
    b = (n * sxy - sx * sy) / denom
    a = (sy - b * sx) / n
    if a >= 0 and b >= 0:
        return (a, b)
    edges = [(max(0.0, sy / n), 0.0), (0.0, max(0.0, sxy / sxx))]
    return min(edges, key=lambda ab: sum((ab[0] + ab[1] * x - y) ** 2
                                         for x, y in points))


def fit_affine_model(table: CostTable) -> tuple[AffineCostModel, dict]:
    """Fit the per-backend affine model and report calibration error.

    Returns ``(model, report)`` where ``report`` carries, per backend,
    the fitted parameters, sample count, and the mean / max relative
    error of the fit against the measured means it was fitted on.
    """
    by_backend: dict[str, list[tuple[VariantKey, float]]] = {}
    for key in table.keys():
        mean = table.mean_s(key)
        if mean is not None:
            by_backend.setdefault(key.backend, []).append((key, mean))

    params: dict[str, tuple[float, float]] = {}
    report: dict = {"backends": {}}
    for backend, samples in sorted(by_backend.items()):
        points = [(float(key.rows), mean) for key, mean in samples]
        overhead, rate = _lstsq_affine(points)
        params[backend] = (overhead, rate)
        rel_errors = []
        for key, mean in samples:
            pred = max(0.0, overhead + rate * key.rows)
            if mean > 0:
                rel_errors.append(abs(pred - mean) / mean)
        report["backends"][backend] = {
            "overhead_s": overhead,
            "rate_s_per_row": rate,
            "variants": len(samples),
            "mean_rel_error": (
                sum(rel_errors) / len(rel_errors) if rel_errors else 0.0
            ),
            "max_rel_error": max(rel_errors) if rel_errors else 0.0,
        }
    model = AffineCostModel(params=params)
    report["model"] = model.to_json()
    return model, report


def model_from_table(table: CostTable) -> TableCostModel:
    """Convenience: measured-table model with a freshly fitted fallback."""
    fallback, _ = fit_affine_model(table)
    return TableCostModel(table=table, fallback=fallback)
