"""The frozen generator: the same seed gives the same streams, another seed
other streams of the same sizes, and every stream is sorted and posed."""
import json
from pathlib import Path

import numpy as np
import pytest

from bench.harness import sim

BENCH = Path(__file__).resolve().parents[1]
CFG = json.loads((BENCH / "configs/davis240-3planes.json").read_text())
OFFLINE = json.loads((BENCH / "traffic/offline-seq.json").read_text())
LIVE = {**json.loads((BENCH / "traffic/live-1cam.json").read_text()), "cameras": 4}


def same(a: sim.Stream, b: sim.Stream) -> bool:
    return all(np.array_equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("make", [
    lambda seed: sim.offline_sequence(CFG, OFFLINE, seed),
    lambda seed: sim.live_stream(CFG, LIVE, seed, 2, 0.05),
], ids=["offline", "live"])
def test_deterministic_per_seed(make):
    big = 2**31 + 12345
    a, b, c = make(big), make(big), make(big + 1)
    assert same(a, b)
    assert not same(a, c)
    assert [x.shape for x in a] == [x.shape for x in c]  # the same work from every seed


def test_stream_shape_and_order():
    s = sim.offline_sequence(CFG, OFFLINE, 7)
    n_pts = 3 * CFG["scene"]["points_per_plane"]
    assert s.t.shape == (OFFLINE["steps"] * n_pts,)
    assert s.t.dtype == np.float32 and s.xy.dtype == np.float32
    assert np.all(np.diff(s.t) >= 0)
    assert s.pose_t[0] <= s.t[0] and s.t[-1] < s.pose_t[-1]
    assert np.all(np.diff(s.pose_t) > 0)
    assert np.all(s.xy[~s.valid] == sim.PARKED)
    inside = s.xy[s.valid]
    assert inside.min() >= 0 and inside[:, 0].max() <= 239 and inside[:, 1].max() <= 179
    assert 0.8 < s.valid.mean() <= 1.0
    R = s.pose_R.astype(np.float64)
    assert np.allclose(R @ R.transpose(0, 2, 1), np.eye(3), atol=1e-5)


def test_live_rate_and_cameras():
    rate = LIVE["rate_events_per_s"] / LIVE["cameras"]
    s = sim.live_stream(CFG, LIVE, 3, 0, 0.2)
    span = float(s.t[-1] - s.t[0])
    assert abs(s.t.shape[0] / span - rate) / rate < 0.1
    other = sim.live_stream(CFG, LIVE, 3, 1, 0.2)
    assert not np.array_equal(s.xy[:1000], other.xy[:1000])


def test_sweep_parameter_is_a_triangle_wave():
    s = sim.sweep_parameter(np.arange(0, 400), 96)
    assert s.min() == 0.0 and s.max() == 1.0
    assert np.all(np.abs(np.diff(s)) <= 1 / 95 + 1e-12)
