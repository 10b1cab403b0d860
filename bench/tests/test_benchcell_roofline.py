"""The frozen roofline arithmetic against counts worked out by hand, and
the per-layer readers on a hand-made trace."""
import pytest

from bench.harness import roofline
from bench.harness.cli import metric_reader
from bench.harness.trace import DeviceOp, reduce_events

NZ, H, W = 128, 180, 240


def test_b1_work_one_segment_by_hand():
    # 28 real frames of 1024 events, 27,000 of them valid, Table 1 (int16)
    nbytes, ops = roofline.b1_work(28, 1024, 27000, NZ, H, W, True)
    assert nbytes == 28 * 1024 * (4 + 4 + 1) + 28 * NZ * 3 * 4 + NZ * H * W * 2
    assert nbytes == 258048 + 43008 + 11059200
    assert ops == 9 * 27000 * 128 == 31104000
    # bytes bound: 11,360,256 B at 3.35 TB/s = 3.391 us; ops 0.464 us
    assert roofline.least_seconds(nbytes, ops) == pytest.approx(11360256 / 3.35e12)


def test_b2_work_by_hand():
    nbytes, ops = roofline.b2_work(NZ, H, W, True)
    assert nbytes == NZ * H * W * 2 + H * W * 8 == 11404800
    assert ops == 2 * NZ * H * W
    nbytes32, _ = roofline.b2_work(NZ, H, W, False)
    assert nbytes32 == NZ * H * W * 4 + H * W * 8


class FakeEvent:
    def __init__(self, name, device, start_ns, dur_ns):
        self._n, self._d, self._s, self._t = name, device, start_ns, dur_ns

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._t


def test_trace_reduction_and_readers():
    import torch

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = [
        FakeEvent("spin_kernel(long)", cuda, 0, 500),  # the window's markers
        FakeEvent("spin_kernel(long)", cuda, 1_000_000, 500),
        FakeEvent("cudaLaunchKernel", cpu, 90_000, 5_000),  # a host-side record
        FakeEvent("void backproject_vote_kernel<false, true>", cuda, 100_000, 50_000),
        FakeEvent("depth_argmax_kernel", cuda, 120_000, 50_000),  # overlaps the first
        FakeEvent("Memcpy HtoD", cuda, 700_000, 100_000),
        FakeEvent("after_the_window", cuda, 1_200_000, 100_000),
    ]
    # host spans on the host's clock, where the first marker started at 5e6
    spans = [("run_emvs", 5_000_000, 5_600_000), ("aggregate", 5_600_000, 5_700_000)]
    # the gap 800..1000 us: one sleep of 60 us loses to 120 us of short polls
    spans += [("sleep", 5_820_000, 5_880_000)]
    spans += [("poll", 5_000_000 + t, 5_000_000 + t + 30_000) for t in range(880_000, 1_000_000, 30_000)]
    s = reduce_events(events, spans, 5_000_000)
    assert s.window_s == pytest.approx(1e-3)
    assert s.busy_s == pytest.approx(170e-6)  # 100..170 us and 700..800 us
    assert s.breakdown["idle_gaps"][0] == ["run_emvs", pytest.approx(530e-6)]
    assert s.breakdown["idle_gaps"][1] == ["poll", pytest.approx(200e-6)]
    ctx = {"summary": s, "sequences": 2, "b1_work": (3.35e12 * 25e-6, 0),
           "b2_work": (0, 67e12 * 5e-6)}
    assert metric_reader("pipeline.launches_per_seq.offline")(ctx) == 1.0
    assert metric_reader("device.idle_share.offline")(ctx) == pytest.approx(83.0)
    assert metric_reader("b1_roofline")(ctx) == pytest.approx(50.0)
    assert metric_reader("b2_roofline")(ctx) == pytest.approx(10.0)
    assert metric_reader("b1_roofline")({"summary": s}) is None
    assert all(isinstance(op, DeviceOp) for op in s.ops)
    assert len(s.ops) == 3  # no marker, host record or operation outside the window
    with pytest.raises(RuntimeError, match="markers"):
        reduce_events(events[2:], spans, 5_000_000)
    live = {"summary": s, "dispatches": 4, "segments": 6, "push_calls": 10, "push_s": 0.02}
    assert metric_reader("dispatcher.segments_per_dispatch.stream")(live) == 1.5
    assert metric_reader("session.push_ms.stream")(live) == pytest.approx(2.0)
    assert metric_reader("dispatcher.segments_per_dispatch.stream")({"dispatches": 0}) is None
    assert metric_reader("session.depth_p95_ms.stream")({"depth_p95_ms": 41.5}) == 41.5
    assert metric_reader("session.depth_p95_ms.stream")({}) is None
