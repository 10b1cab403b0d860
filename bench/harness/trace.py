"""Spans around the calls into the program, and the reduction of a
torch.profiler trace to what the per-layer metrics read.

`Tracer.span(name)` marks what the host is doing (`aggregate`, `run_emvs`,
`push`, `push_poses`, `poll`, `sleep`, ...). With tracing off a span costs
nothing; with tracing on it is a pair of host-clock readings. The profiler
records the card's activity alone (no CPU operator trace, which would
about double the program's host cost). `Tracer.window()` brackets the
traced window with two marker kernels: their device start times bound the
window, and the first one's gives the offset from the host clock to the
trace's, which places the host spans on the device's timeline.
"""
from __future__ import annotations

import contextlib
import sys
import time
from typing import NamedTuple

import torch

MARKER = "spin_kernel"  # the kernel of torch.cuda._sleep
MARKER_CYCLES = 1000


class DeviceOp(NamedTuple):
    name: str
    start_ns: int
    end_ns: int


class TraceSummary(NamedTuple):
    window_s: float
    busy_s: float
    ops: list[DeviceOp]  # device operations inside the window
    spans: list[tuple[str, int, int]]  # host spans inside the window, trace clock
    breakdown: dict


class Tracer:
    def __init__(self, enabled: bool):
        self.enabled = enabled
        self._spans: list[tuple[str, int, int]] | None = None
        self.summary: TraceSummary | None = None

    def span(self, name: str):
        if self._spans is None:
            return contextlib.nullcontext()
        return self._span(name)

    @contextlib.contextmanager
    def _span(self, name: str):
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            self._spans.append((name, t0, time.perf_counter_ns()))

    @contextlib.contextmanager
    def window(self):
        """Trace the enclosed work (when enabled); the device is synchronised
        at both ends so that the window holds exactly its own work."""
        if not self.enabled:
            yield
            return
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA],
                                      record_shapes=False, profile_memory=False,
                                      with_stack=False)
        torch.cuda.synchronize()
        prof.start()
        torch.cuda.synchronize()
        spans: list[tuple[str, int, int]] = []
        try:
            host_start = time.perf_counter_ns()
            torch.cuda._sleep(MARKER_CYCLES)
            self._spans = spans
            yield
            torch.cuda.synchronize()
            self._spans = None
            torch.cuda._sleep(MARKER_CYCLES)
            torch.cuda.synchronize()
        finally:
            self._spans = None
            t_stop = time.perf_counter()
            prof.stop()
        self.summary = reduce_events(prof.profiler.kineto_results.events(), spans,
                                     host_start)
        print(f"trace: {len(self.summary.ops)} device operations and "
              f"{len(self.summary.spans)} host spans in {self.summary.window_s:.3f} s, "
              f"read in {time.perf_counter() - t_stop:.2f} s", file=sys.stderr)


def reduce_events(events, host_spans, host_start_ns: int) -> TraceSummary:
    """The window between the first and last marker kernel, the union of the
    device operations inside it, and the host spans moved onto the trace's
    clock (the first marker started at `host_start_ns` on the host's)."""
    dev_type = torch.autograd.DeviceType.CUDA
    ops = []
    for e in events:
        if e.device_type() == dev_type:
            s = int(e.start_ns())
            ops.append(DeviceOp(e.name(), s, s + int(e.duration_ns())))
    marks = sorted(o.start_ns for o in ops if MARKER in o.name)
    if len(marks) < 2:
        raise RuntimeError(f"trace holds {len(marks)} window markers, not 2")
    w0, w1 = marks[0], marks[-1]
    offset = w0 - host_start_ns
    ops = sorted((o for o in ops if MARKER not in o.name and o.end_ns > w0
                  and o.start_ns < w1), key=lambda o: o.start_ns)
    busy, gaps, cur = 0, [], None
    for o in ops:
        s, t = max(o.start_ns, w0), min(o.end_ns, w1)
        if cur is None or s > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
                gaps.append((cur[1], s))
            else:
                gaps.append((w0, s))
            cur = [s, t]
        else:
            cur[1] = max(cur[1], t)
    if cur is not None:
        busy += cur[1] - cur[0]
        gaps.append((cur[1], w1))
    else:
        gaps.append((w0, w1))
    spans = [(n, s + offset, t + offset) for n, s, t in host_spans]
    spans = [sp for sp in spans if sp[2] > w0 and sp[1] < w1]
    return TraceSummary(window_s=(w1 - w0) / 1e9, busy_s=busy / 1e9, ops=ops,
                        spans=spans, breakdown=breakdown(ops, gaps, spans))


def breakdown(ops: list[DeviceOp], gaps, spans, top: int = 10) -> dict:
    """The device operations that took most time (summed by name) and the
    longest idle gaps, each named by the kind of host span that covers most
    of it in all (many short `sleep`s can outweigh one `push`)."""
    per_name: dict[str, int] = {}
    for o in ops:
        per_name[o.name] = per_name.get(o.name, 0) + (o.end_ns - o.start_ns)
    dev = sorted(per_name.items(), key=lambda kv: -kv[1])[:top]
    spans_by_start = sorted(spans, key=lambda sp: sp[1])
    named = []
    for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        cover: dict[str, int] = {}
        for name, s, t in spans_by_start:
            if s >= g1:
                break
            if t > g0:
                cover[name] = cover.get(name, 0) + min(t, g1) - max(s, g0)
        label = max(cover, key=cover.get) if cover else "host"
        named.append([label, (g1 - g0) / 1e9])
    return {"device_ops": [[_short(n), t / 1e9] for n, t in dev], "idle_gaps": named}


def _short(name: str, limit: int = 96) -> str:
    return name if len(name) <= limit else name[:limit - 3] + "..."


def kernel_seconds(summary: TraceSummary, fragment: str) -> float:
    """Summed device time of the operations whose name holds `fragment`."""
    return sum(o.end_ns - o.start_ns for o in summary.ops if fragment in o.name) / 1e9
