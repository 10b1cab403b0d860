"""The float32 DAVIS346 cell on the CPU at small sizes: a run comes out
correct with its end-to-end metrics, the control and the planted faults
come out not correct under its limits, and the band counter's reader."""
import collections

import pytest

from bench.harness.cli import metric_reader, run_cell
from small import tweak
from test_benchcell_runs import altered_answer, half_batch

CELL = "davis346.offline"


def run_small(seed=11):
    return run_cell(CELL, seed, 1.0, False, device="cpu", tweak=tweak)


def test_result_line():
    result, lines = run_small()
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    assert sorted(result["metrics"]) == ["recon_mev_s", "setup_s"]
    assert all(m["value"] > 0 for m in result["metrics"].values())
    assert result["checks"]["frames"]["value"] == 0 and result["checks"]["plan"]["value"] == 0
    assert len(lines) == len(result["checks"]) + 1


def test_control_fails():
    from bench.tools import control

    r = control.readings(CELL, 2**31 + 99, 1.0, "cpu", tweak)
    assert r["passes_limits"] is False, r


@pytest.mark.parametrize("fault", [altered_answer, half_batch])
def test_planted_fault_is_not_correct(fault, monkeypatch):
    from repro_torch.core import pipeline

    monkeypatch.setattr(pipeline, "sweep_segment_batch", fault(pipeline.sweep_segment_batch))
    result, _ = run_small()
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("counts,want", [
    ({}, None),
    ({"backproject_vote": 5}, None),  # a program without the band counter
    ({"backproject_vote": 0, "backproject_vote_bands": 0}, None),
    ({"backproject_vote": 5, "backproject_vote_bands": 10}, 2.0),
    ({"backproject_vote": 5, "backproject_vote_bands": 5}, 1.0),
])
def test_bands_per_launch_reader(counts, want, monkeypatch):
    from repro_torch.kernels import cuda

    monkeypatch.setattr(cuda, "launch_counts", collections.Counter(counts))
    assert metric_reader("b1.bands_per_launch.offline")({}) == want
