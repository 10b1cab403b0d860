"""Whole runs on the CPU at small sizes: the result line's shape, the
control and the planted faults coming out not correct, and the entry
point refusing to run without a card."""
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from bench.harness.cli import run_cell
from small import tweak

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT / "bench" / "tools"))


def two_cameras(cfg, traffic):
    """The live mix on a two-camera rig: the `MultiStreamEngine` path."""
    traffic["cameras"] = 2
    tweak(cfg, traffic)


# (workload, small sizes): every cell, and the live driver on several cameras
CASES = {"davis240.offline": ("davis240.offline", tweak),
         "davis240.live": ("davis240.live", tweak),
         "davis240.live-2cam": ("davis240.live", two_cameras)}
CELLS = list(CASES)


def run_small(case, seed=11):
    workload, small = CASES[case]
    return run_cell(workload, seed, 1.0, False, device="cpu", tweak=small)


@pytest.mark.parametrize("case", CELLS)
def test_result_line(case):
    workload = CASES[case][0]
    result, lines = run_small(case)
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    e2e = [m["name"] for m in spec["end_to_end"] if workload in m.get("workloads", [workload])]
    assert sorted(result["metrics"]) == sorted(e2e) and "setup_s" in e2e
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(set(c) == {"value", "limit"} for c in result["checks"].values())
    assert len(lines) == len(result["checks"]) + 1
    json.dumps(result)


@pytest.mark.parametrize("workload", ["davis240.offline", "davis240.live"])
def test_control_fails(workload):
    import control

    r = control.readings(workload, 2**31 + 99, 1.0, "cpu", tweak)
    assert r["passes_limits"] is False, r


def altered_answer(orig):
    """The sweep returns a depth map and DSI altered where they are made."""
    def sweep(*args, **kw):
        from repro_torch.core.detection import DepthMap

        dsi, dm = orig(*args, **kw)
        dsi = dsi.clone()
        dsi[..., 5, 40:60, 40:60] += 3
        return dsi, DepthMap(dm.depth * 1.01, dm.mask, dm.confidence)
    return sweep


def half_batch(orig):
    """Half of every frame's events left out of the sweep."""
    def sweep(cam, dsi_cfg, batch, opts):
        valid = batch.valid.clone()
        valid[..., valid.shape[-1] // 2:] = False
        return orig(cam, dsi_cfg, batch._replace(valid=valid), opts)
    return sweep


@pytest.mark.parametrize("case", CELLS)
@pytest.mark.parametrize("fault", [altered_answer, half_batch])
def test_planted_fault_is_not_correct(case, fault, monkeypatch):
    from repro_torch.core import pipeline

    monkeypatch.setattr(pipeline, "sweep_segment_batch", fault(pipeline.sweep_segment_batch))
    result, _ = run_small(case)
    assert result["correct"] is False, result["checks"]


def last_line(out: str):
    lines = out.strip().splitlines()
    return lines[-1] if lines else ""


def test_entry_point_refuses_without_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for machines without one")
    p = subprocess.run([sys.executable, "bench/run.py", "--workload", "davis240.offline",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and not last_line(p.stdout).startswith("{")


def test_bare_checkout_refuses(tmp_path):
    """A directory with only BENCHMARK.json and bench/ holds no program."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "bench/run.py", "--workload", "davis240.offline",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and not last_line(p.stdout).startswith("{")


@pytest.mark.gpu
def test_short_cell_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    result, _ = run_cell("davis240.offline", 2**31 + 5, 2.0, False)
    assert result["correct"] is True and result["device"]["platform"] == "gpu"
