"""Fit the affine sweep cost model from a measured cost table (counterpart
of `repro.profiling.calibrate`).

    python -m repro_torch.profiling.calibrate results/cost_table_h100.json
    python -m repro_torch.profiling.calibrate --dry-run

Reads a schema-validated cost table (recorded on the card by
``python -m repro_torch.benchmarks.streaming_latency``), fits the
per-backend affine model (dispatch overhead + per-segment-row rate), and
prints the calibration report — fitted parameters plus mean/max relative
error of the fit against the measured means. `--json` persists the report.

`--dry-run` synthesizes a small deterministic table from a known affine
ground truth, runs the identical fit path, and fails if the fit does not
recover the ground truth, without a single timed sweep.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Sequence

from repro_torch.profiling.cost_model import fit_affine_model
from repro_torch.profiling.cost_table import CostTable, VariantKey

# --dry-run ground truth: per-backend (overhead_s, rate_s_per_row). The
# synthetic table is exact affine data, so the lstsq fit must recover
# these to float precision — any drift is a fit-path bug.
_DRY_RUN_TRUTH = {"batched": (0.004, 2.5e-4), "sharded": (0.009, 8.0e-5)}
_DRY_RUN_TOL = 1e-9


def synthesize_table() -> CostTable:
    """A deterministic table drawn from `_DRY_RUN_TRUTH` (no clocks)."""
    table = CostTable()
    for backend, (overhead, rate) in _DRY_RUN_TRUTH.items():
        for s_bucket in (1, 2, 4):
            for capacity in (4, 8, 12):
                key = VariantKey(s_bucket=s_bucket, capacity=capacity,
                                 backend=backend, interpolation="nearest",
                                 quantized=False)
                table.record(key, overhead + rate * key.rows)
    return table


def main(argv: Sequence[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        description="Fit the affine sweep cost model and report "
                    "calibration error")
    parser.add_argument("table", nargs="?", default="cost_table.json",
                        help="path to cost_table.json (default: "
                             "./cost_table.json)")
    parser.add_argument("--dry-run", action="store_true",
                        help="fit a synthetic ground-truth table instead of "
                             "reading one — a check of the fit path")
    parser.add_argument("--json", default=None,
                        help="write the calibration report to this path")
    args = parser.parse_args(argv)

    if args.dry_run:
        table = synthesize_table()
        print(f"dry run: synthetic table, {len(table)} variant(s)")
    else:
        try:
            table = CostTable.load(args.table)
        except FileNotFoundError:
            print(f"no cost table at {args.table}: run "
                  f"`python -m repro_torch.benchmarks.streaming_latency` on the card "
                  f"to record one")
            return 1
        except Exception as exc:  # noqa: BLE001 — the CLI's whole job
            print(f"cost table INVALID: {exc}")
            return 1
        print(f"loaded {args.table}: {len(table)} variant(s)")

    model, report = fit_affine_model(table)
    for backend, rec in report["backends"].items():
        print(f"[{backend}] overhead {rec['overhead_s'] * 1e3:.3f} ms + "
              f"{rec['rate_s_per_row'] * 1e6:.2f} us/row over "
              f"{rec['variants']} variant(s); rel error mean "
              f"{100 * rec['mean_rel_error']:.2f}% max "
              f"{100 * rec['max_rel_error']:.2f}%")

    if args.json is not None:
        with open(args.json, "w") as fh:
            json.dump(report, fh, indent=2, sort_keys=True)
        print(f"report written to {args.json}")

    if args.dry_run:
        for backend, (overhead, rate) in _DRY_RUN_TRUTH.items():
            got = model.params.get(backend)
            if got is None:
                print(f"DRY-RUN FAILURE: no fit for backend {backend!r}")
                return 1
            if (abs(got[0] - overhead) > _DRY_RUN_TOL
                    or abs(got[1] - rate) > _DRY_RUN_TOL):
                print(f"DRY-RUN FAILURE: fit {got} does not recover "
                      f"ground truth ({overhead}, {rate}) for {backend!r}")
                return 1
        print("dry run OK: fit recovers the synthetic ground truth")
    return 0


if __name__ == "__main__":
    sys.exit(main())
