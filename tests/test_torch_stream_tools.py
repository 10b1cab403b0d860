"""The port's streaming example and stream/batching/sharding benchmarks on
the CPU, at their smoke sizes (`--dry-run`, or the smallest form).

Each runs with `--device cpu` and must pass its own bitwise checks: every
streamed result equals the offline reconstruction over host-aggregated
frames (dsi, depth, mask), looped equals batched, sharded equals batched.
`streaming_latency` and `stream_hygiene` are driven section by section
with their structural gates (coalescing, cross-stream groups, the
adversarial grid, the burst replay on the recorded cost table); their
timing gates compare host clocks, which on a shared test worker measure
the neighbours, and run where the benchmarks are run on the card.
"""
from __future__ import annotations

import json

import pytest
import torch

from repro.quant.policies import memory_report as j_memory_report
from repro.core.camera import CameraModel as JCamera
from repro_torch.benchmarks import (
    memory_footprint,
    record_kernel_costs,
    segment_batching,
    sharded_sweep,
    stream_hygiene,
    streaming_latency,
)
from repro_torch.events.stream_hygiene import StreamOverlapError
from repro_torch.examples import emvs_streaming
from repro_torch.profiling import CostTable


SMALL = ["--device", "cpu", "--steps", "24", "--points", "150", "--planes", "16"]


@pytest.mark.parametrize("extra", [
    [], ["--chunk-frames", "3", "--policy", "throughput"],
    ["--sessions", "2", "--sweep", "sharded", "--policy", "throughput"],
    ["--pose-lag", "0.1", "--max-stall", "40", "--target-latency-ms", "50"],
    ["--budget-frames", "24", "--budget-policy", "reject"],
], ids=["adaptive", "throughput", "two-sessions-sharded", "pose-gated-slo", "budget"])
def test_emvs_streaming_example(tmp_path, extra):
    out = emvs_streaming.main(SMALL + extra + ["--out", str(tmp_path / "s.npz")])
    deltas = out["max_dsi_delta"]
    if isinstance(deltas, dict):
        assert len(deltas) == 2 and all(v == 0.0 for v in deltas.values())
    else:
        assert deltas == 0.0
        assert (tmp_path / "s.npz").exists()
    stats = out["stats"]
    assert (stats["dispatcher"] if "dispatcher" in stats else stats)["dispatches"] >= 1


def test_emvs_streaming_example_rejects_a_corrupt_stream(tmp_path):
    out = emvs_streaming.main(SMALL + ["--corrupt", "swap_chunks",
                                       "--out", str(tmp_path / "s.npz")])
    assert isinstance(out["rejected"], StreamOverlapError)


@pytest.fixture(scope="module")
def dry():
    """The smoke sequence and its offline reconstruction."""
    seq = streaming_latency.build_sequence("dry", "cpu")
    frames = streaming_latency.host_frames(seq)
    return seq, frames, streaming_latency.offline(seq)


def test_streaming_latency_headline_and_pose_lag(dry):
    seq, frames, ref = dry
    from repro_torch.serving.emvs_stream import StreamConfig

    scfg = StreamConfig(events_per_frame=seq.e_frame)
    res, t_total, timeline, stats = streaming_latency._stream_once(seq, scfg, seq.e_frame)
    streaming_latency._assert_bitwise(res, ref, "stream")
    assert len(timeline) == len(res.segments) == stats["segments"] >= 2
    lag_res, first, total, stats = streaming_latency.stream_with_pose_lag(
        seq, scfg, 0.1, seq.e_frame)
    streaming_latency._assert_bitwise(lag_res, ref, "pose lag")
    assert stats["max_stalled"] > 0 and first <= total


def test_streaming_latency_policy_multi_churn_and_cost_model(dry, tmp_path):
    seq, frames, ref = dry
    table = CostTable()
    rows = streaming_latency.dispatch_policy_sweep(seq, frames, ref, repeats=1, table=table)
    burst = {r["policy"]: r for r in rows if r["profile"] == "burst"}
    assert burst["adaptive"]["coalesced_dispatches"] >= 1
    assert burst["adaptive"]["dispatches"] < len(ref.segments) == burst["latency"]["dispatches"]
    multi = streaming_latency.multi_stream_sweep(seq, frames, ref, n_sessions=3)
    assert multi["multi"]["cross_stream_dispatches"] >= 1
    assert multi["multi"]["dispatches"] < multi["dedicated"]["dispatches"]
    churn = streaming_latency.session_churn_sweep(seq, frames, ref, n_stayers=2, table=table)
    assert churn["pending_segments"] == 0 and churn["dispatches"] < churn["segments"]
    assert churn["cross_stream_before_leave"] >= 1 and churn["cross_stream_after_join"] >= 1
    path = tmp_path / "cost_table.json"
    cost = streaming_latency.cost_model_section(table, str(path))
    assert cost["measured_variants"] == len(CostTable.load(str(path))) >= 1
    assert cost["slo_burst_gates"] and not any("failure" in g for g in cost["slo_burst_gates"])
    assert {g["backend"] for g in cost["slo_burst_gates"]} == {"batched+kernel"}


def test_stream_hygiene_grid_storm_and_overhead(dry):
    seq, frames, ref = dry
    grid = stream_hygiene.adversarial_grid(seq, ref)
    assert len(grid) == len(stream_hygiene.GRID_EXPECT) and all(r["ok"] for r in grid)
    storm = stream_hygiene.storm_survival(seq, ref)
    assert storm["segments"] == storm["clean_segments"] and storm["dropped_hot_pixel"] > 0
    overhead = stream_hygiene.clean_overhead(seq, frames, ref, repeats=1)
    assert overhead["chunks"] > 1 and overhead["scrub_mevents_per_s"] > 0


def test_segment_batching(tmp_path):
    out = segment_batching.main(["--device", "cpu", "--dry-run",
                                 "--json-out", str(tmp_path / "b.json")])
    assert out["bitwise_match"] and out["segments"] >= 2
    assert json.loads((tmp_path / "b.json").read_text())["segment_batching"]["device"] == "cpu"


@pytest.mark.parametrize("devices", [1, 2])
def test_sharded_sweep(tmp_path, devices):
    """One gloo rank in this process, or two spawned ranks: sharded ==
    batched bitwise (asserted on every rank)."""
    path = tmp_path / "b.json"
    sharded_sweep.main(["--device", "cpu", "--dry-run", "--devices", str(devices),
                        "--json-out", str(path)])
    rec = json.loads(path.read_text())["sharded_sweep"]
    assert rec["bitwise_match"] and rec["ranks"] == devices and rec["segments"] >= 2
    assert not torch.distributed.is_initialized()


def test_sharded_sweep_refuses_cpu_ranks_for_an_explicit_card(tmp_path):
    """--devices N > 1 spawns CPU ranks: an explicit --device cuda is not
    silently moved there."""
    with pytest.raises(ValueError, match="spawns gloo ranks on the CPU"):
        sharded_sweep.main(["--device", "cuda", "--dry-run", "--devices", "2",
                            "--json-out", str(tmp_path / "b.json")])
    assert not (tmp_path / "b.json").exists()
    assert not torch.distributed.is_initialized()


def test_memory_footprint(tmp_path):
    out = memory_footprint.main(["--device", "cpu", "--json-out", str(tmp_path / "b.json")])
    want = j_memory_report(JCamera(), num_planes=128, events_per_frame=1024)
    assert out["detail"] == want and out["claim_ok"]
    assert out["table1_bytes_per_frame"] == sum(want["table1"].values())
    win = out["streaming_window"]
    assert win["window_ok"] and win["live_bytes_after_flush"] == 0


def test_record_kernel_costs(tmp_path):
    table = record_kernel_costs.main(["--device", "cpu", "--dry-run"])
    assert len(table) == 2
    path = tmp_path / "table.json"
    merged = record_kernel_costs.main(["--device", "cpu", "--events", "64", "--repeats", "1",
                                       "--table", str(path)])
    assert len(merged) == len(record_kernel_costs.GRID) + 3 == len(CostTable.load(str(path)))
    assert {k.backend for k in merged.keys()} == {"batched+kernel"}
