"""Opt-in online profiler for `SweepDispatcher` (counterpart of
`repro.profiling.recorder`).

The dispatcher calls three hooks — enqueue, dispatch, harvest — and the
profiler turns them into (a) warm per-variant wall-time samples for the
cost table and (b) a deterministic dispatch trace
(:class:`TraceArrival` / :class:`TraceDispatch`) that
the reference's :mod:`repro.serving.dispatch_replay` re-simulates against a
cost model.

Wall times are harvested-minus-dispatched host timestamps, which is the
honest observable for an async sweep: it includes device queueing, so
the profiler only records a sample when the sweep was at the head of
the in-flight queue with the device otherwise idle ("unshadowed"), and
skips the first observation of each variant (a cold start: kernel loads,
fresh allocations).
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.profiling.cost_table import CostTable, VariantKey


@dataclass(frozen=True)
class TraceArrival:
    """One segment joining the tagged queue, in virtual arrival order."""

    t: float            # host timestamp (perf_counter) of enqueue
    tag: int            # stable session index
    seg: tuple[int, int]


@dataclass(frozen=True)
class TraceDispatch:
    """One dispatched group as the scheduler formed it."""

    t: float                      # host timestamp of dispatch
    segs: tuple[tuple[int, tuple[int, int]], ...]  # (tag, seg) rows
    key: VariantKey


class SweepProfiler:
    """Collects cost-table samples and the dispatch trace.

    Attach one to a dispatcher via ``dispatcher.profiler = profiler``
    (or ``MultiStreamEngine(..., profiler=)``); detached operation is
    zero-cost — the dispatcher's hook sites guard on ``profiler is
    None``.
    """

    def __init__(self, table: CostTable | None = None):
        self.table = table if table is not None else CostTable()
        self.arrivals: list[TraceArrival] = []
        self.dispatches: list[TraceDispatch] = []
        self._seen_variants: set[VariantKey] = set()
        self._tags: dict[int, int] = {}  # id(session) -> stable index
        self.skipped_cold = 0
        self.skipped_shadowed = 0

    def _tag(self, session) -> int:
        return self._tags.setdefault(id(session), len(self._tags))

    # --- dispatcher hooks -------------------------------------------------

    def note_enqueue(self, t: float, session, seg: tuple[int, int]) -> None:
        self.arrivals.append(TraceArrival(t=t, tag=self._tag(session), seg=seg))

    def note_dispatch(self, t: float, group, key: VariantKey) -> None:
        self.dispatches.append(TraceDispatch(
            t=t,
            segs=tuple((self._tag(sess), seg) for sess, seg in group),
            key=key,
        ))

    def note_harvest(self, key: VariantKey, dispatched_t: float,
                     harvested_t: float, *, unshadowed: bool) -> None:
        """Record one completed sweep's wall time.

        `unshadowed` means the sweep ran with no older sweep occupying
        the device (it was the in-flight head for its whole life), so
        harvest - dispatch measures the sweep itself rather than queue
        wait. The first observation per variant is the cold start and
        is skipped.
        """
        if not unshadowed:
            self.skipped_shadowed += 1
            return
        if key not in self._seen_variants:
            self._seen_variants.add(key)
            self.skipped_cold += 1
            return
        self.table.record(key, max(0.0, harvested_t - dispatched_t))

    # --- export -----------------------------------------------------------

    def trace_json(self) -> dict:
        """The recorded trace in the replayer's input format."""
        t0 = self.arrivals[0].t if self.arrivals else 0.0
        return {
            "arrivals": [
                {"t": a.t - t0, "tag": a.tag, "seg": list(a.seg)}
                for a in self.arrivals
            ],
            "dispatches": [
                {
                    "t": d.t - t0,
                    "key": d.key.to_str(),
                    "segs": [[tag, list(seg)] for tag, seg in d.segs],
                }
                for d in self.dispatches
            ],
        }
