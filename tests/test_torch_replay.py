"""The port's dispatch replayer and cost-model calibration against the
reference's, on the CPU (both are host-only).

The reference's `tests/test_dispatch_planning.py` replay cases run through
both packages on the same arrivals and tables (tables cross over as their
JSON): the replayed schedules must be the same, dispatch by dispatch —
virtual issue time, the tagged segments of each group, S bucket,
capacity, predicted, start and done times — with the same per-segment
latencies and `predicted_p99_s`. The SLO monotonicity on burst traces is
checked on seeded traces (no hypothesis needed). The burst gate holds on
a narrow, noisy table like the main path's, where the reference's
unconstrained fit prices groups at zero and its gate raises.
`calibrate --dry-run`
must recover its ground truth within 1e-9, and both CLIs must print what
the reference's print.
"""
from __future__ import annotations

import numpy as np
import pytest

from repro.profiling import AffineCostModel as JAffine
from repro.profiling import CostTable as JCostTable
from repro.profiling import VariantKey as JVariantKey
from repro.profiling import calibrate as j_cal
from repro.serving import dispatch_replay as j_rep
from repro_torch.core.pipeline import DispatchPlanner
from repro_torch.profiling import AffineCostModel, CostTable, VariantKey, fit_affine_model
from repro_torch.profiling import calibrate as t_cal
from repro_torch.serving import dispatch_replay as t_rep


def _schedule(res) -> list:
    return [(d.t, d.segs, d.s_bucket, d.capacity, d.predicted_s, d.start_s, d.done_s)
            for d in res.dispatches]


def _replay_both(arrivals, params, s_buckets, **cfg):
    """Replay one trace under one configuration in both packages; assert
    the same schedule and return the port's result."""
    got = t_rep.replay_schedule(
        [t_rep.Arrival(*a) for a in arrivals],
        t_rep.planner_for(AffineCostModel(params=params), s_buckets, backend="batched"),
        t_rep.ReplayConfig(**cfg))
    want = j_rep.replay_schedule(
        [j_rep.Arrival(*a) for a in arrivals],
        j_rep.planner_for(JAffine(params=params), s_buckets, backend="batched"),
        j_rep.ReplayConfig(**cfg))
    assert _schedule(got) == _schedule(want)
    assert got.latencies == want.latencies
    assert got.predicted_p99_s() == want.predicted_p99_s()
    assert got.to_json() == want.to_json()
    return got


def _burst(n: int, cap: int, *, tag=0, t: float = 0.0) -> list[tuple]:
    return [(t, tag, (k * cap, (k + 1) * cap)) for k in range(n)]


def test_replay_latency_vs_throughput_schedules():
    params = {"batched": (0.01, 1e-4)}
    arrivals = _burst(8, 4)
    lat = _replay_both(arrivals, params, (1, 2, 4), policy="latency")
    tp = _replay_both(arrivals, params, (1, 2, 4), policy="throughput")
    assert lat.dispatch_count == 8
    assert tp.dispatch_count == 2  # two full 4-buckets
    assert tp.makespan_s < lat.makespan_s
    again = _replay_both(arrivals, params, (1, 2, 4), policy="throughput")
    assert again.to_json() == tp.to_json()


def _trace(seed: int, tags: int) -> list[tuple]:
    """Seeded arrivals over time from `tags` streams: runs of segments of a
    few capacities, each stream's segments consecutive in frames."""
    rng = np.random.default_rng(seed)
    frame = {tag: 0 for tag in range(tags)}
    out = []
    t = 0.0
    for _ in range(int(rng.integers(6, 20))):
        tag = int(rng.integers(0, tags))
        n = int(rng.choice([3, 4, 7, 8, 12]))
        out.append((t, tag, (frame[tag], frame[tag] + n)))
        frame[tag] += n
        t += float(rng.choice([0.0, 0.002, 0.01, 0.03]))
    return out


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("policy,fairness,max_inflight,target", [
    ("latency", "fifo", 2, None), ("throughput", "fifo", 2, None),
    ("adaptive", "fifo", 1, None), ("adaptive", "round_robin", 2, None),
    ("adaptive", "fifo", 2, 0.02), ("adaptive", "round_robin", 3, 0.05),
    ("throughput", "round_robin", 1, None)])
def test_replay_matches_reference_on_seeded_traces(seed, policy, fairness, max_inflight,
                                                   target):
    params = {"batched": (0.004, 2.5e-4)}
    arrivals = _trace(seed, tags=3 if fairness == "round_robin" else 1)
    res = _replay_both(arrivals, params, (1, 2, 4), policy=policy, fairness=fairness,
                       max_inflight=max_inflight, target_latency_s=target,
                       flush_t=arrivals[-1][0] + 0.01)
    assert sum(len(d.segs) for d in res.dispatches) == len(arrivals)


def test_replay_rejects_unpredictable_variants():
    planner = t_rep.planner_for(AffineCostModel(params={"sharded": (0.01, 1e-4)}),
                                (1, 2, 4), backend="batched")
    jplanner = j_rep.planner_for(JAffine(params={"sharded": (0.01, 1e-4)}),
                                 (1, 2, 4), backend="batched")
    arrivals = [t_rep.Arrival(*a) for a in _burst(2, 4)]
    with pytest.raises(ValueError, match="cannot predict") as got:
        t_rep.replay_schedule(arrivals, planner, t_rep.ReplayConfig(policy="latency"))
    with pytest.raises(ValueError) as want:
        j_rep.replay_schedule([j_rep.Arrival(*a) for a in _burst(2, 4)], jplanner,
                              j_rep.ReplayConfig(policy="latency"))
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="cost model"):
        t_rep.replay_schedule(arrivals[:1], DispatchPlanner((1, 2, 4)),
                              t_rep.ReplayConfig(policy="latency"))
    for kwargs in (dict(policy="eager"), dict(fairness="lottery"), dict(max_inflight=0),
                   dict(target_latency_s=0.0)):
        with pytest.raises(ValueError) as got:
            t_rep.ReplayConfig(**kwargs)
        with pytest.raises(ValueError) as want:
            j_rep.ReplayConfig(**kwargs)
        assert str(got.value) == str(want.value)


def test_percentile_nearest_rank():
    assert t_rep.percentile([], 0.99) == 0.0
    assert t_rep.percentile([3.0, 1.0, 2.0], 0.5) == 2.0
    assert t_rep.percentile([3.0, 1.0, 2.0], 0.99) == 3.0
    with pytest.raises(ValueError):
        t_rep.percentile([1.0], 0.0)
    rng = np.random.default_rng(0)
    for n in (1, 2, 7, 100):
        values = list(rng.random(n))
        for q in (0.01, 0.5, 0.9, 0.99, 1.0):
            assert t_rep.percentile(values, q) == j_rep.percentile(values, q)


@pytest.mark.parametrize("seed", range(12))
def test_slo_monotone_on_burst_traces(seed):
    """Burst-scoped SLO monotonicity (the reference's property, on seeded
    draws of its strategy): all segments arrive at t=0, so tightening
    `target_latency_s` can only dispatch earlier and the replayed
    predicted p99 never increases."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 25))
    flush_after = float(rng.uniform(0.0, 2.0))
    d_lo, d_hi = (float(x) for x in rng.uniform(1e-3, 5.0, 2))
    params = {backend: (float(rng.uniform(1e-4, 2e-2)), float(rng.uniform(1e-6, 1e-3)))
              for backend in ("batched", "sharded")}
    arrivals, frame = [], 0
    for seg_len in rng.integers(1, 14, size=n):
        arrivals.append((0.0, 0, (frame, frame + int(seg_len))))
        frame += int(seg_len)
    tight, loose = sorted((d_lo, d_hi))
    p99 = {}
    for d in (tight, loose):
        res = _replay_both(arrivals, params, (1, 2, 4), policy="adaptive",
                           target_latency_s=d, flush_t=flush_after)
        p99[d] = res.predicted_p99_s()
    assert p99[tight] <= p99[loose] + 1e-12


def _tables():
    table = t_cal.synthesize_table()
    jtable = j_cal.synthesize_table()
    assert table.to_json() == jtable.to_json()
    return table, jtable


@pytest.mark.parametrize("backend", ["batched", "sharded"])
def test_check_slo_burst_gate_passes_on_synthetic_table(backend):
    table, jtable = _tables()
    record = t_rep.check_slo_burst(table, backend=backend)
    assert record == j_rep.check_slo_burst(jtable, backend=backend)
    slo, tp = record["slo_adaptive"], record["throughput"]
    assert slo["dispatch_count"] <= tp["dispatch_count"]
    assert slo["predicted_p99_s"] <= record["target_latency_s"] + 1e-12
    assert tp["dispatch_count"] < record["segments"]
    assert [a.__dict__ for a in t_rep.burst_arrivals(table, backend=backend)] == \
        [a.__dict__ for a in j_rep.burst_arrivals(jtable, backend=backend)]


def test_check_slo_burst_gate_on_a_narrow_noisy_table():
    """The table the streaming benchmark measures at the EMVS main path:
    only single-segment sweeps at 20, 32 and 40 rows, two of them from one
    sample. One slow sample at 20 rows gives the unconstrained fit a
    negative rate, and the burst replay's 4-segment groups (80-160 rows)
    then extrapolate to zero-cost sweeps: the reference's gate raises on
    a zero deadline. The port's fit keeps its rate >= 0 (pure overhead
    here), so every group costs the mean sweep and the gate holds."""
    table, jtable = CostTable(), JCostTable()
    for cap, walls in ((20, [9e-3]), (32, [6e-3]), (40, [6e-3] * 28)):
        for wall in walls:
            table.record(VariantKey(1, cap, "batched+kernel", "nearest", True), wall)
            jtable.record(JVariantKey(1, cap, "batched+kernel", "nearest", True), wall)
    with pytest.raises(ValueError, match="target_latency_s"):
        j_rep.check_slo_burst(jtable, backend="batched+kernel")
    record = t_rep.check_slo_burst(table, backend="batched+kernel")
    mean = (9e-3 + 6e-3 + 6e-3) / 3  # the fit weighs each variant's mean once
    overhead, rate = fit_affine_model(table)[0].params["batched+kernel"]
    assert overhead == pytest.approx(mean, rel=1e-12) and rate == 0.0
    tp, slo = record["throughput"], record["slo_adaptive"]
    assert [d["predicted_s"] for d in tp["dispatches"]] == \
        pytest.approx([mean] * tp["dispatch_count"], rel=1e-12)
    assert record["target_latency_s"] > 0
    assert slo["dispatch_count"] <= tp["dispatch_count"]
    assert slo["predicted_p99_s"] <= record["target_latency_s"] + 1e-12


def test_arrivals_from_trace_and_table_crossing():
    trace = {"arrivals": [{"t": 0.5, "tag": "cam0", "seg": [0, 7]},
                          {"t": "0.75", "tag": "cam1", "seg": ["7", 15]}]}
    got = t_rep.arrivals_from_trace(trace)
    assert [(a.t, a.tag, a.seg) for a in got] == \
        [(a.t, a.tag, a.seg) for a in j_rep.arrivals_from_trace(trace)]
    table, _ = _tables()
    assert CostTable.from_json(JCostTable.from_json(table.to_json()).to_json()).to_json() \
        == table.to_json()


def test_calibrate_dry_run(capsys):
    assert t_cal.main(["--dry-run"]) == 0
    out = capsys.readouterr().out
    assert "dry run OK" in out
    assert j_cal.main(["--dry-run"]) == 0
    assert capsys.readouterr().out == out
    from repro_torch.profiling import fit_affine_model

    model, _ = fit_affine_model(t_cal.synthesize_table())
    for backend, (overhead, rate) in t_cal._DRY_RUN_TRUTH.items():
        assert abs(model.params[backend][0] - overhead) <= 1e-9
        assert abs(model.params[backend][1] - rate) <= 1e-9


def test_clis_print_what_the_reference_prints(tmp_path, capsys):
    path = str(tmp_path / "table.json")
    t_cal.synthesize_table().save(path)
    report = str(tmp_path / "report.json")
    for argv in ([path], [path, "--json", report]):
        assert t_cal.main(argv) == 0
        got = capsys.readouterr().out
        assert j_cal.main(argv) == 0
        assert capsys.readouterr().out == got
    for argv in ([path, "--validate"], [path, "--check-slo-burst"],
                 [path, "--check-slo-burst", "--backend", "sharded", "--segments", "10"]):
        assert t_rep.main(argv) == 0
        got = capsys.readouterr().out
        assert j_rep.main(argv) == 0
        assert capsys.readouterr().out == got
    assert t_rep.main([str(tmp_path / "missing.json")]) == 1
    assert "INVALID" in capsys.readouterr().out
