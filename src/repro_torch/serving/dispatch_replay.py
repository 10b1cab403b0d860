"""Deterministic replay of dispatch schedules against a cost model
(counterpart of `repro.serving.dispatch_replay`; host-only).

`replay_schedule` re-simulates the `SweepDispatcher` scheduling rules —
policy, fairness anchoring, in-flight depth, the SLO deadline — over a
recorded (or synthetic) arrival trace in VIRTUAL time: every sweep takes
exactly what the cost model predicts, the device is a serial queue, and
the host reacts at arrival/flush events (the points where the real
engine pumps). Nothing here touches a clock or a device, so a test can
assert scheduling decisions ("SLO-aware dispatches no more groups than
'throughput' and its predicted p99 meets the deadline on the burst
profile") with zero timing-sensitive assertions — the profile-then-plan
replay loop of byteprofile-analysis, specialized to the sweep
dispatcher.

Fidelity notes (deliberate simplifications, matched by the dispatcher's
own predictor `SweepDispatcher.predict_drain_s`):

- in-flight sweeps count at FULL predicted cost when the adaptive SLO
  rule prices the queue (their progress is unobservable without a
  device sync);
- host-side staging time is zero: dispatches within one pump happen at
  the same virtual instant, and the `_dispatch` back-pressure block
  (which paces the HOST, not the device) is not modeled — on a serial
  device it cannot change completion times;
- "round_robin" fairness rotates over tags in first-appearance order
  (the dispatcher rotates over registration order; identical whenever
  sessions first enqueue in registration order, which every benchmark
  rig here does).

The CLI is the gate:

    python -m repro_torch.serving.dispatch_replay --validate cost_table.json
    python -m repro_torch.serving.dispatch_replay --check-slo-burst cost_table.json

`--validate` only schema-checks the table. `--check-slo-burst` builds a
deterministic burst profile from the table's own in-distribution
variants, replays "throughput" to fix the deadline, then asserts the
SLO-aware adaptive replay dispatches no more groups and meets the
predicted-p99 deadline.
"""

from __future__ import annotations

import argparse
import heapq
import json
import math
import sys
from dataclasses import dataclass, field
from typing import Any, Sequence

from repro_torch.core.pipeline import (
    FAIRNESS_POLICIES,
    DispatchPlanner,
    bucket_capacity,
)
from repro_torch.profiling.cost_model import model_from_table
from repro_torch.profiling.cost_table import CostTable, VariantKey


@dataclass(frozen=True)
class Arrival:
    """One segment joining the tagged queue at virtual time `t`."""

    t: float
    tag: Any
    seg: tuple[int, int]


@dataclass(frozen=True)
class ReplayConfig:
    """The scheduling knobs the replay honors (a `StreamConfig` subset)."""

    policy: str = "adaptive"
    fairness: str = "fifo"
    max_inflight: int = 2
    target_latency_s: float | None = None
    # Virtual time of the end-of-stream flush (`final=True` drain).
    # None = the last arrival's time.
    flush_t: float | None = None

    def __post_init__(self):
        if self.policy not in ("latency", "throughput", "adaptive"):
            raise ValueError(f"unknown policy {self.policy!r}")
        if self.fairness not in FAIRNESS_POLICIES:
            raise ValueError(f"unknown fairness {self.fairness!r}")
        if self.max_inflight < 1:
            raise ValueError("max_inflight must be >= 1")
        if (self.target_latency_s is not None
                and not self.target_latency_s > 0):
            raise ValueError("target_latency_s must be > 0 or None")


@dataclass(frozen=True)
class ReplayDispatch:
    """One dispatched group in the replayed schedule."""

    t: float  # virtual time the scheduler issued the group
    segs: tuple[tuple[Any, tuple[int, int]], ...]
    s_bucket: int
    capacity: int
    predicted_s: float
    start_s: float  # device start (serial queue)
    done_s: float  # device completion


@dataclass
class ReplayResult:
    dispatches: list[ReplayDispatch] = field(default_factory=list)
    # (tag, seg) -> predicted first-result latency (group done - arrival)
    latencies: dict = field(default_factory=dict)

    @property
    def dispatch_count(self) -> int:
        return len(self.dispatches)

    @property
    def makespan_s(self) -> float:
        return max((d.done_s for d in self.dispatches), default=0.0)

    def predicted_p99_s(self) -> float:
        return percentile(list(self.latencies.values()), 0.99)

    def to_json(self) -> dict:
        return {
            "dispatch_count": self.dispatch_count,
            "makespan_s": self.makespan_s,
            "predicted_p99_s": self.predicted_p99_s(),
            "dispatches": [
                {"t": d.t, "s_bucket": d.s_bucket, "capacity": d.capacity,
                 "predicted_s": d.predicted_s, "start_s": d.start_s,
                 "done_s": d.done_s, "segments": len(d.segs)}
                for d in self.dispatches
            ],
        }


def percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank percentile (deterministic, no interpolation)."""
    if not values:
        return 0.0
    if not 0.0 < q <= 1.0:
        raise ValueError(f"q must be in (0, 1], got {q}")
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q * len(ordered)) - 1)]


class _VirtualDispatcher:
    """The `SweepDispatcher._pop_group` rules over a virtual clock."""

    def __init__(self, planner: DispatchPlanner, cfg: ReplayConfig):
        if planner.cost_model is None or planner.variant_of is None:
            raise ValueError(
                "replay needs a planner with a cost model and variant "
                "factory: every sweep's duration must be predictable")
        self.planner = planner
        self.cfg = cfg
        self.pending: list[tuple[Any, tuple[int, int]]] = []
        self.busy_until = 0.0
        self.inflight_done: list[float] = []  # heap of completion times
        self.result = ReplayResult()
        self.arrival_t: dict = {}
        self._tag_order: list[Any] = []
        self._rr_cursor = 0

    # --- the policy rules, in virtual time --------------------------------

    def _inflight_at(self, t: float) -> int:
        while self.inflight_done and self.inflight_done[0] <= t:
            heapq.heappop(self.inflight_done)
        return len(self.inflight_done)

    def _predict_drain_s(self, t: float) -> float | None:
        # in-flight sweeps at full predicted cost — the live
        # predictor's conservatism, reproduced exactly
        total = sum(d.predicted_s for d in self.result.dispatches
                    if d.done_s > t)
        pending = self.planner.predict_drain_s(
            self.pending, fairness=self.cfg.fairness)
        if pending is None:
            return None
        return total + pending

    def _anchor_candidates(self, t: float) -> list[int]:
        """Anchor queue-indices to try, per the fairness rule."""
        if self.cfg.fairness == "fifo" or len(self._tag_order) <= 1:
            return [0]
        present = {tag for tag, _ in self.pending}
        anchors = []
        n = len(self._tag_order)
        for k in range(n):
            tag = self._tag_order[(self._rr_cursor + k) % n]
            if tag in present:
                anchors.append(next(i for i, (tg, _)
                                    in enumerate(self.pending) if tg == tag))
        return anchors

    def _pop_group(self, t: float, final: bool):
        if not self.pending:
            return None
        policy = self.cfg.policy
        slo_urgent = None
        if policy == "adaptive" and not final:
            if self.cfg.target_latency_s is not None:
                drain = self._predict_drain_s(t)
                if drain is not None:
                    slo_urgent = drain > self.cfg.target_latency_s
            if (slo_urgent is None
                    and self._inflight_at(t) >= self.cfg.max_inflight):
                return None
        for anchor in self._anchor_candidates(t):
            idx, cap, sealed = self.planner.head_tagged(
                self.pending, anchor=anchor)
            if policy == "latency":
                idx = idx[:1]
            elif policy == "throughput" and not (final or sealed):
                continue
            elif slo_urgent is not None and not (slo_urgent or sealed):
                continue
            group = [self.pending[i] for i in idx]
            for i in reversed(idx):
                self.pending.pop(i)
            tag0 = group[0][0]
            try:
                self._rr_cursor = ((self._tag_order.index(tag0) + 1)
                                   % len(self._tag_order))
            except ValueError:
                pass
            return group, cap
        return None

    def _dispatch(self, group, cap: int, t: float) -> None:
        s_bucket = self.planner.s_bucket(len(group))
        predicted = self.planner.predict_group_s(len(group), cap)
        if predicted is None:
            raise ValueError(
                f"cost model cannot predict variant "
                f"(s_bucket={s_bucket}, capacity={cap}): replay needs "
                f"full coverage of the schedule's variants")
        start = max(t, self.busy_until)
        done = start + predicted
        self.busy_until = done
        heapq.heappush(self.inflight_done, done)
        self.result.dispatches.append(ReplayDispatch(
            t=t, segs=tuple(group), s_bucket=s_bucket, capacity=cap,
            predicted_s=predicted, start_s=start, done_s=done))
        for tag, seg in group:
            self.result.latencies[(tag, seg)] = (
                done - self.arrival_t[(tag, seg)])

    def _drain(self, t: float, final: bool) -> None:
        while self.pending:
            group = self._pop_group(t, final)
            if group is None:
                break
            self._dispatch(*group, t)

    # --- the event loop ---------------------------------------------------

    def run(self, arrivals: Sequence[Arrival]) -> ReplayResult:
        ordered = sorted(arrivals, key=lambda a: a.t)
        flush_t = self.cfg.flush_t
        if flush_t is None:
            flush_t = ordered[-1].t if ordered else 0.0
        if ordered and flush_t < ordered[-1].t:
            raise ValueError(
                f"flush_t={flush_t} precedes the last arrival "
                f"at t={ordered[-1].t}")
        i = 0
        while i < len(ordered):
            t = ordered[i].t
            while i < len(ordered) and ordered[i].t == t:
                a = ordered[i]
                if a.tag not in self._tag_order:
                    self._tag_order.append(a.tag)
                if (a.tag, a.seg) in self.arrival_t:
                    raise ValueError(f"duplicate arrival {(a.tag, a.seg)}")
                self.arrival_t[(a.tag, a.seg)] = a.t
                self.pending.append((a.tag, a.seg))
                i += 1
            self._drain(t, final=False)
        self._drain(flush_t, final=True)
        assert not self.pending, "final drain must empty the queue"
        return self.result


def replay_schedule(arrivals: Sequence[Arrival], planner: DispatchPlanner,
                    cfg: ReplayConfig) -> ReplayResult:
    """Replay one arrival trace under one scheduling configuration."""
    return _VirtualDispatcher(planner, cfg).run(arrivals)


def planner_for(table_or_model, s_buckets: Sequence[int], *, backend: str,
                interpolation: str = "nearest",
                quantized: bool = False) -> DispatchPlanner:
    """A cost-aware planner for replays: fixes the non-shape variant axes
    so the replayer can key the model from `(s_bucket, capacity)` alone."""
    model = (model_from_table(table_or_model)
             if isinstance(table_or_model, CostTable) else table_or_model)

    def variant_of(s_bucket: int, capacity: int) -> VariantKey:
        return VariantKey(s_bucket=s_bucket, capacity=capacity,
                          backend=backend, interpolation=interpolation,
                          quantized=quantized)

    return DispatchPlanner(s_buckets, cost_model=model,
                           variant_of=variant_of)


def arrivals_from_trace(trace: dict) -> list[Arrival]:
    """Arrivals from a recorded `SweepProfiler.trace_json()` payload."""
    return [Arrival(t=float(a["t"]), tag=a["tag"],
                    seg=(int(a["seg"][0]), int(a["seg"][1])))
            for a in trace["arrivals"]]


def burst_arrivals(table: CostTable, *, backend: str,
                   segments: int = 24) -> list[Arrival]:
    """A deterministic burst profile drawn from the table's own support.

    All segments arrive at t=0 (the benchmark burst profile's shape) as
    consecutive RUNS of each capacity the table measured for `backend` —
    runs, not an interleave, because per-stream FIFO seals a group at
    the first capacity change: an interleaved burst cannot coalesce at
    all and the check would compare two identical per-segment schedules.
    Every replayed variant is in-distribution by construction.
    """
    caps = sorted({key.capacity for key in table.keys()
                   if key.backend == backend})
    if not caps:
        raise ValueError(f"cost table has no entries for backend "
                         f"{backend!r}")
    arrivals = []
    frame = 0
    run = -(-segments // len(caps))
    for cap in caps:
        assert bucket_capacity(cap) == cap, "capacities are bucket-aligned"
        for _ in range(run):
            if len(arrivals) == segments:
                break
            arrivals.append(Arrival(t=0.0, tag=0, seg=(frame, frame + cap)))
            frame += cap
    return arrivals


def check_slo_burst(table: CostTable, *, backend: str,
                    s_buckets: Sequence[int] = (1, 2, 4),
                    interpolation: str = "nearest", quantized: bool = False,
                    segments: int = 24, max_inflight: int = 2) -> dict:
    """The gate: on the burst profile, the SLO-aware adaptive policy
    must dispatch no more groups than "throughput" and its predicted
    p99 must meet the deadline (set to throughput's predicted p99 — the
    best any coalescing schedule can promise on a full burst).

    Returns the gate record; raises `AssertionError` on regression.
    """
    planner = planner_for(table, s_buckets, backend=backend,
                          interpolation=interpolation, quantized=quantized)
    arrivals = burst_arrivals(table, backend=backend, segments=segments)
    tp = replay_schedule(arrivals, planner, ReplayConfig(
        policy="throughput", max_inflight=max_inflight))
    deadline = tp.predicted_p99_s()
    slo = replay_schedule(arrivals, planner, ReplayConfig(
        policy="adaptive", max_inflight=max_inflight,
        target_latency_s=deadline))
    record = {
        "backend": backend,
        "segments": segments,
        "target_latency_s": deadline,
        "throughput": tp.to_json(),
        "slo_adaptive": slo.to_json(),
    }
    assert slo.dispatch_count <= tp.dispatch_count, (
        f"SLO-aware adaptive dispatched {slo.dispatch_count} groups vs "
        f"throughput's {tp.dispatch_count} on the burst profile")
    assert slo.predicted_p99_s() <= deadline + 1e-12, (
        f"SLO-aware adaptive predicted p99 {slo.predicted_p99_s():.6f}s "
        f"misses its own deadline {deadline:.6f}s")
    return record


def main(argv: Sequence[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        description="Validate a sweep cost table and replay-check the "
                    "SLO-aware dispatch schedule")
    parser.add_argument("table", help="path to cost_table.json")
    parser.add_argument("--validate", action="store_true",
                        help="schema-validate the table and exit")
    parser.add_argument("--check-slo-burst", action="store_true",
                        help="replay the burst profile: SLO-aware adaptive "
                             "must dispatch <= throughput's groups and meet "
                             "its predicted p99 deadline")
    parser.add_argument("--backend", default=None,
                        help="sweep backend to replay (default: every "
                             "backend present in the table)")
    parser.add_argument("--segments", type=int, default=24)
    args = parser.parse_args(argv)

    try:
        table = CostTable.load(args.table)
    except Exception as exc:  # noqa: BLE001 — the CLI's whole job
        print(f"cost table INVALID: {exc}")
        return 1
    print(f"cost table OK: {len(table)} variant(s), schema v1")
    if args.validate and not args.check_slo_burst:
        return 0

    backends = ([args.backend] if args.backend
                else sorted({key.backend for key in table.keys()}))
    failures = 0
    for backend in backends:
        try:
            record = check_slo_burst(table, backend=backend,
                                     segments=args.segments)
        except AssertionError as exc:
            print(f"[{backend}] REGRESSION: {exc}")
            failures += 1
            continue
        tp, slo = record["throughput"], record["slo_adaptive"]
        print(f"[{backend}] burst x{record['segments']}: throughput "
              f"{tp['dispatch_count']} dispatches p99 "
              f"{tp['predicted_p99_s']:.4f}s; SLO-adaptive "
              f"{slo['dispatch_count']} dispatches p99 "
              f"{slo['predicted_p99_s']:.4f}s (deadline "
              f"{record['target_latency_s']:.4f}s)")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
