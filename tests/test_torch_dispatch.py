"""The port's dispatch planning and profiling against the JAX reference, on
the CPU.

The same inputs go to both packages and every output must be equal:

* the planners on seeded random queues: `dispatch_group_head[_tagged]`
  (every legal anchor), `plan_dispatch_groups[_tagged]` and
  `DispatchPlanner.plan_tagged` under "fifo" and "round_robin", each with
  no cost model, a null one and a seeded affine one (whose predictions
  must match too);
* the cost table's JSON (records, save/load, merge) and its schema errors,
  `VariantKey`, `fit_affine_model` and `TableCostModel` predictions (the
  port's fit keeps its overhead and rate >= 0: where the reference's does
  not, the port's is held to scipy's NNLS instead);
* `SweepProfiler` fed the same hook calls; `_LatencyHist` snapshots;
  `enumerate_variant_space` on the batched backend;
* `pad_segment_rows` row k equals the port's `pad_segments(frames_k,
  [seg_k], C)`, bool masks included;
* N camera sessions on one shared dispatcher (`MultiStreamEngine`) under
  the balanced, bursty and starved schedules: each session equals its
  dedicated engine and the reference's offline `run_emvs` bitwise (on the
  scene and terms of `test_torch_streaming.py`), and the dispatcher's and
  sessions' counters equal the reference `MultiStreamEngine`'s.
"""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from repro.core import pipeline as jp
from repro.profiling import cost_model as j_cm
from repro.profiling import cost_table as j_ct
from repro.profiling import recorder as j_rec
from repro.serving import emvs_stream as j_stream
from repro.serving import sweep_dispatcher as j_disp
from repro_torch.core import pipeline as tp
from repro_torch.core.geometry import SE3
from repro_torch.events.aggregation import EventFrames
from repro_torch.profiling import cost_model as t_cm
from repro_torch.profiling import cost_table as t_ct
from repro_torch.profiling import recorder as t_rec
from repro_torch.serving import emvs_stream as t_stream
from repro_torch.serving import sweep_dispatcher as t_disp
from test_torch_streaming import (  # noqa: F401 - `scene` and `_one_torch_thread` are fixtures
    EVENTS_PER_FRAME,
    POLICIES,
    _assert_bitwise,
    _assert_stats_equal,
    _chunks,
    _cut,
    _drive,
    _engine,
    _j_chunks,
    _j_traj,
    _one_torch_thread,
    _opts,
    _reference,
    _reference_sweeps_stubbed,
    _t_traj,
    scene,
)

SCHEDULES = ("balanced", "bursty", "starved")

SEEDS = range(8)


def _random_tagged(rng: np.random.Generator, n: int, n_tags: int):
    """A tagged arrival order as each session's planner emits it: per tag
    abutting ascending segments, interleaved at random."""
    tags = [f"s{k}" for k in range(n_tags)]
    cursor = {t: 0 for t in tags}
    items = []
    for _ in range(n):
        owner = tags[int(rng.integers(n_tags))]
        length = int(rng.integers(1, 14))
        start = cursor[owner]
        cursor[owner] = start + length
        items.append((owner, (start, start + length)))
    return items


def _models(rng: np.random.Generator):
    """(reference model, port model) pairs: none, null and one affine."""
    params = {b: (float(rng.uniform(1e-4, 2e-2)), float(rng.uniform(1e-6, 1e-3)))
              for b in ("batched", "batched+kernel")}
    return [(None, None), (j_cm.NullCostModel(), t_cm.NullCostModel()),
            (j_cm.AffineCostModel(params=dict(params)), t_cm.AffineCostModel(params=dict(params)))]


def _variant_of(mod):
    def of(s_bucket: int, capacity: int):
        return mod.VariantKey(s_bucket=s_bucket, capacity=capacity, backend="batched+kernel",
                              interpolation="nearest", quantized=True)
    return of


def _untag(groups):
    return [([(tag, tuple(seg)) for tag, seg in g], cap) for g, cap in groups]


@pytest.mark.parametrize("seed", SEEDS)
def test_head_groups_match_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(6):
        items = _random_tagged(rng, int(rng.integers(1, 30)), int(rng.integers(1, 5)))
        max_group = int(rng.integers(1, 6))
        segs = [seg for _, seg in items]
        assert tp.dispatch_group_head(segs, max_group) == jp.dispatch_group_head(segs, max_group)
        seen = set()
        for anchor, (tag, _) in enumerate(items):
            if tag in seen:  # only a tag's oldest segment may anchor
                for mod in (jp, tp):
                    with pytest.raises(ValueError, match="oldest queued segment"):
                        mod.dispatch_group_head_tagged(items, max_group, anchor=anchor)
                continue
            seen.add(tag)
            assert (tp.dispatch_group_head_tagged(items, max_group, anchor=anchor)
                    == jp.dispatch_group_head_tagged(items, max_group, anchor=anchor))
    for mod in (jp, tp):
        with pytest.raises(ValueError, match="non-empty"):
            mod.dispatch_group_head_tagged([], 2)
        with pytest.raises(ValueError, match="max_group"):
            mod.dispatch_group_head_tagged([("a", (0, 2))], 0)


@pytest.mark.parametrize("fairness", ["fifo", "round_robin"])
@pytest.mark.parametrize("seed", SEEDS)
def test_plans_match_reference(seed, fairness):
    rng = np.random.default_rng(100 + seed)
    for _ in range(4):
        items = _random_tagged(rng, int(rng.integers(1, 40)), int(rng.integers(1, 5)))
        max_group = int(rng.integers(1, 6))
        segs = [seg for _, seg in items]
        assert tp.plan_dispatch_groups(segs, max_group) == jp.plan_dispatch_groups(segs, max_group)
        assert (_untag(tp.plan_dispatch_groups_tagged(items, max_group, fairness=fairness))
                == _untag(jp.plan_dispatch_groups_tagged(items, max_group, fairness=fairness)))
        buckets = tuple(sorted({1, max_group, int(rng.integers(1, max_group + 1))}))
        for jm, tm in _models(rng):
            jplan = jp.DispatchPlanner(buckets, cost_model=jm, variant_of=_variant_of(j_ct))
            tplan = tp.DispatchPlanner(buckets, cost_model=tm, variant_of=_variant_of(t_ct))
            assert (_untag(tplan.plan_tagged(items, fairness=fairness))
                    == _untag(jplan.plan_tagged(items, fairness=fairness)))
            assert tplan.plan(segs) == jplan.plan(segs)
            assert (tplan.predict_drain_s(items, fairness=fairness)
                    == jplan.predict_drain_s(items, fairness=fairness))
            for n in range(1, buckets[-1] + 1):
                assert tplan.predict_group_s(n, 8) == jplan.predict_group_s(n, 8)
    for mod in (jp, tp):
        with pytest.raises(ValueError, match="fairness"):
            mod.plan_dispatch_groups_tagged([("a", (0, 2))], 2, fairness="lottery")
        with pytest.raises(ValueError, match="ascending"):
            mod.DispatchPlanner((4, 2))
    assert tp.FAIRNESS_POLICIES == jp.FAIRNESS_POLICIES


def _table_pair(rng: np.random.Generator):
    jt, tt = j_ct.CostTable(), t_ct.CostTable()
    for _ in range(30):
        s, c = int(rng.choice([1, 2, 4])), int(rng.choice([4, 8, 12, 16]))
        backend = str(rng.choice(["batched", "batched+kernel", "batched+scatter"]))
        interp, q = str(rng.choice(["nearest", "bilinear"])), bool(rng.integers(2))
        wall = float(rng.uniform(1e-4, 5e-2))
        jt.record(j_ct.VariantKey(s, c, backend, interp, q), wall)
        tt.record(t_ct.VariantKey(s, c, backend, interp, q), wall)
    return jt, tt


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cost_table_json_matches_reference(seed, tmp_path):
    rng = np.random.default_rng(seed)
    jt, tt = _table_pair(rng)
    assert tt.to_json() == jt.to_json()
    tt.save(str(tmp_path / "port.json"))
    jt.save(str(tmp_path / "ref.json"))
    assert (tmp_path / "port.json").read_text() == (tmp_path / "ref.json").read_text()
    assert t_ct.CostTable.load(str(tmp_path / "ref.json")).to_json() == jt.to_json()
    jo, to = _table_pair(rng)
    jt.merge(jo)
    tt.merge(to)
    assert tt.to_json() == jt.to_json()
    jm, jrep = j_cm.fit_affine_model(jt)
    tm, trep = t_cm.fit_affine_model(tt)
    physical = _assert_fit_follows_reference(tt, jm, jrep, tm, trep)
    jtab, ttab = j_cm.model_from_table(jt), t_cm.model_from_table(tt)
    assert ttab.to_json() == {**jtab.to_json(), "fallback": tm.to_json()}
    for s in (1, 2, 4, 8):
        for c in (4, 8, 20):
            for backend in ("batched", "batched+kernel", "sharded"):
                args = (s, c, backend, "nearest", True)
                jk, tk = j_ct.VariantKey(*args), t_ct.VariantKey(*args)
                if backend in physical or backend not in tm.params:
                    assert ttab.predict_sweep_s(tk) == jtab.predict_sweep_s(jk)
                    assert tm.predict_sweep_s(tk) == jm.predict_sweep_s(jk)
                else:
                    a, b = tm.params[backend]
                    assert tm.predict_sweep_s(tk) == a + b * tk.rows > 0
                    measured = tt.mean_s(tk)
                    assert ttab.predict_sweep_s(tk) == (
                        measured if measured is not None else tm.predict_sweep_s(tk))
                assert tk.to_str() == jk.to_str() and tk.rows == jk.rows


def _assert_fit_follows_reference(table, jm, jrep, tm, trep) -> set:
    """The port's affine fit is the reference's wherever the reference's
    overhead and rate are both >= 0; elsewhere (the reference's fit
    extrapolates to zero-cost sweeps) it is the least-squares optimum with
    both >= 0, held to scipy's NNLS within 1e-9 of the largest mean, and
    its report is computed from those parameters. Returns the backends
    where the two fits are the same."""
    from scipy.optimize import nnls

    assert set(tm.params) == set(jm.params) and set(trep) == set(jrep)
    assert trep["model"] == tm.to_json()
    physical = set()
    for backend, (ja, jb) in jm.params.items():
        got, want = trep["backends"][backend], jrep["backends"][backend]
        if ja >= 0 and jb >= 0:
            physical.add(backend)
            assert tm.params[backend] == (ja, jb) and got == want
            continue
        samples = [(key.rows, table.mean_s(key)) for key in table.keys()
                   if key.backend == backend]
        rows = np.array([r for r, _ in samples], np.float64)
        means = np.array([m for _, m in samples], np.float64)
        (na, nb), _ = nnls(np.stack([np.ones_like(rows), rows], 1), means)
        a, b = tm.params[backend]
        assert a >= 0 and b >= 0
        assert abs(a - na) <= 1e-9 * means.max() and abs(b - nb) <= 1e-9 * means.max()
        rel = np.abs(a + b * rows - means) / means
        assert got == {**want, "overhead_s": a, "rate_s_per_row": b,
                       "mean_rel_error": got["mean_rel_error"],
                       "max_rel_error": got["max_rel_error"]}
        assert got["mean_rel_error"] == pytest.approx(rel.mean(), rel=1e-12)
        assert got["max_rel_error"] == pytest.approx(rel.max(), rel=1e-12)
    return physical


@pytest.mark.parametrize("mutate", [
    lambda p: p.update(schema_version=99),
    lambda p: p.update(entries="nope"),
    lambda p: p["entries"].update({"bad-key": {"count": 1, "mean_s": 1.0, "min_s": 1.0,
                                               "max_s": 1.0}}),
    lambda p: next(iter(p["entries"].values())).pop("mean_s"),
    lambda p: next(iter(p["entries"].values())).update(count=0),
    lambda p: next(iter(p["entries"].values())).update(min_s=9.0),
    lambda p: p["entries"].update({"s1/c4/gpu/nearest/q0": {"count": 1, "mean_s": 1.0,
                                                             "min_s": 1.0, "max_s": 1.0}}),
])
def test_cost_table_schema_errors_match_reference(mutate):
    jt, tt = j_ct.CostTable(), t_ct.CostTable()
    jt.record(j_ct.VariantKey(1, 4, "batched", "nearest", False), 0.01)
    tt.record(t_ct.VariantKey(1, 4, "batched", "nearest", False), 0.01)
    payload = json.loads(json.dumps(jt.to_json()))
    mutate(payload)
    with pytest.raises(j_ct.CostTableError) as want:
        j_ct.CostTable.from_json(payload)
    with pytest.raises(t_ct.CostTableError) as got:
        t_ct.CostTable.from_json(payload)
    assert str(got.value) == str(want.value)


def test_variant_keys_and_backend_names_match_reference():
    for args in ((1, 4, "gpu", "nearest", False), (1, 4, "batched", "cubic", False),
                 (0, 4, "batched", "nearest", False), (1, 0, "batched", "nearest", False)):
        with pytest.raises(j_ct.CostTableError) as want:
            j_ct.VariantKey(*args)
        with pytest.raises(t_ct.CostTableError) as got:
            t_ct.VariantKey(*args)
        assert str(got.value) == str(want.value)
    for text in ("s2/c8/sharded/bilinear/q1", "s4/c12/batched+kernel/nearest/q0"):
        assert t_ct.VariantKey.from_str(text).to_str() == j_ct.VariantKey.from_str(text).to_str()
    for bad in ("s2/c8/sharded/bilinear", "x2/c8/batched/nearest/q0", "s2/c8/batched/nearest/q2"):
        with pytest.raises(t_ct.CostTableError, match="malformed"):
            t_ct.VariantKey.from_str(bad)
    for sweep, form in (("batched", "matmul"), ("batched", "kernel"), ("sharded", "scatter")):
        assert t_ct.backend_name(sweep, form) == j_ct.backend_name(sweep, form)


def test_profiler_matches_reference():
    """The same enqueue/dispatch/harvest hook calls give the same trace and
    the same warm-sample table (cold and shadowed sweeps skipped)."""
    rng = np.random.default_rng(4)
    jprof, tprof = j_rec.SweepProfiler(), t_rec.SweepProfiler()
    sessions = [object(), object()]
    t = 0.0
    for step in range(40):
        t += float(rng.uniform(1e-4, 1e-2))
        sess = sessions[int(rng.integers(2))]
        seg = (step, step + int(rng.integers(2, 9)))
        args = (int(rng.choice([1, 2, 4])), int(rng.choice([4, 8])), "batched+kernel",
                "nearest", True)
        for prof, mod in ((jprof, j_ct), (tprof, t_ct)):
            prof.note_enqueue(t, sess, seg)
            prof.note_dispatch(t + 1e-3, [(sess, seg)], mod.VariantKey(*args))
            prof.note_harvest(mod.VariantKey(*args), t + 1e-3, t + 5e-3,
                              unshadowed=bool(step % 3))
    assert tprof.trace_json() == jprof.trace_json()
    assert tprof.table.to_json() == jprof.table.to_json()
    assert (tprof.skipped_cold, tprof.skipped_shadowed) == (jprof.skipped_cold,
                                                            jprof.skipped_shadowed)


def test_latency_hist_and_variant_space_match_reference():
    jh, th = j_disp._LatencyHist(), t_disp._LatencyHist()
    rng = np.random.default_rng(9)
    for _ in range(50):
        t_in = float(rng.uniform(0, 10))
        t_out = t_in + float(10.0 ** rng.uniform(-5, 1.5))
        jh.observe(t_in, t_out)
        th.observe(t_in, t_out)
    assert th.snapshot() == jh.snapshot()
    for buckets in ((1, 2, 4), (2, 8)):
        for form in ("matmul", "kernel"):
            got = t_disp.enumerate_variant_space(
                t_stream.StreamConfig(segment_buckets=buckets), 23, formulation=form)
            want = j_disp.enumerate_variant_space(
                j_stream.StreamConfig(segment_buckets=buckets), 23, formulation=form)
            assert got == want
    with pytest.raises(ValueError, match="positive"):
        t_disp.enumerate_variant_space(t_stream.StreamConfig(), 0)


def _frames(n: int, events: int = 48, seed: int = 3, bool_valid: bool = True) -> EventFrames:
    r = np.random.default_rng(seed)
    xy = np.stack([r.uniform(0, 239, (n, events)), r.uniform(0, 179, (n, events))],
                  -1).astype(np.float32)
    valid = r.random((n, events)) > 0.2
    t = np.zeros((n, 3), np.float32)
    t[:, 0] = np.linspace(0, 0.5, n)
    R = np.broadcast_to(np.eye(3, dtype=np.float32), (n, 3, 3)).copy()
    return EventFrames(torch.from_numpy(xy),
                       torch.from_numpy(valid if bool_valid else valid.astype(np.float32)),
                       torch.arange(n, dtype=torch.float32),
                       SE3(torch.from_numpy(R), torch.from_numpy(t)))


@pytest.mark.parametrize("bool_valid", [True, False])
@pytest.mark.parametrize("as_numpy", [False, True])
def test_pad_segment_rows_matches_pad_segments(bool_valid, as_numpy):
    """Each row brings its own window with indices relative to it (the
    multi-session gather); row k is bitwise `pad_segments(frames_k,
    [seg_k], C)`, masks bool where the frames' are, on the host."""
    frames = _frames(8, bool_valid=bool_valid)
    segs, cap = [(0, 3), (3, 5), (5, 8)], 4
    want = tp.pad_segments(frames, segs, cap)

    def window(a, lo, hi):
        return a[lo:hi].numpy() if as_numpy else a[lo:hi]

    rows = [(EventFrames(window(frames.xy, s, e), window(frames.valid, s, e),
                         window(frames.t_mid, s, e),
                         SE3(window(frames.poses.R, s, e), window(frames.poses.t, s, e))),
             (0, e - s)) for s, e in segs]
    got = tp.pad_segment_rows(rows, cap)
    for name in want._fields:
        a, b = getattr(got, name), getattr(want, name)
        assert a.device.type == "cpu" and a.dtype == b.dtype, name
        assert torch.equal(a, b), name
    assert got.valid.dtype == (torch.bool if bool_valid else torch.float32)
    assert got.frame_valid.dtype == torch.bool
    for k, (s, e) in enumerate(segs):
        one = tp.pad_segments(frames, [(s, e)], cap)
        for name in one._fields:
            assert torch.equal(getattr(got, name)[k], getattr(one, name)[0]), (k, name)
    with pytest.raises(ValueError, match="at least one segment row"):
        tp.pad_segment_rows([], cap)
    with pytest.raises(ValueError, match="does not fit capacity"):
        tp.pad_segment_rows([(frames, (0, 5))], cap)
    with pytest.raises(ValueError, match="outside its window"):
        tp.pad_segment_rows([(EventFrames(*(a[:2] for a in frames[:3]),
                                          SE3(frames.poses.R[:2], frames.poses.t[:2])),
                              (0, 3))], cap)


def test_segment_planner_properties_match_reference():
    rng = np.random.default_rng(0)
    t = np.cumsum(rng.uniform(-0.08, 0.08, (40, 3)).astype(np.float32), axis=0)
    jpl, tpl = jp.SegmentPlanner(0.1, min_frames=2), tp.SegmentPlanner(0.1, min_frames=2)
    for i in range(40):
        assert tpl.push(t[i]) == jpl.push(t[i])
        assert (tpl.num_frames, tpl.open_start) == (jpl.num_frames, jpl.open_start)
    assert tpl.flush() == jpl.flush()
    assert (tpl.num_frames, tpl.open_start) == (jpl.num_frames, jpl.open_start)


# --- N sessions on one dispatcher ----------------------------------------------


def _drive_rig(engine, scene, evs, schedule, jax_side=False):
    """Two sessions through one schedule; returns per-session results."""
    chunks = _j_chunks if jax_side else _chunks
    traj = (_j_traj if jax_side else _t_traj)(scene["traj"])
    if schedule == "balanced":
        a, b = engine.add_session("a", traj=traj), engine.add_session("b", traj=traj)
        ca, cb = list(chunks(evs[0], EVENTS_PER_FRAME)), list(chunks(evs[1], EVENTS_PER_FRAME))
        for k in range(max(len(ca), len(cb))):
            if k < len(ca):
                a.push(ca[k])
            if k < len(cb):
                b.push(cb[k])
        return {"a": a.flush(), "b": b.flush()}
    if schedule == "bursty":
        a, b = engine.add_session("a", traj=traj), engine.add_session("b", traj=traj)
        a.push(next(chunks(evs[0], evs[0][1].shape[0])))
        for c in chunks(evs[1], EVENTS_PER_FRAME):
            b.push(c)
        return {"b": b.flush(), "a": a.flush()}
    a, b = engine.add_session("a", traj=traj), engine.add_session("b", traj=None)
    for c in chunks(evs[1], 997):
        b.push(c)  # every frame of B stalls: no poses yet
    for c in chunks(evs[0], EVENTS_PER_FRAME):
        a.push(c)
    res_a = a.flush()
    b.push_poses(traj)
    b.finalize_poses()
    return {"a": res_a, "b": b.flush()}


def _rig(scene):
    """Two sessions cut from the scene with different lengths (13 and 9 full
    frames plus tails), so same-capacity segments of both exist."""
    return (_cut(scene["ev"], 13 * EVENTS_PER_FRAME + 32),
            _cut(scene["ev"], 9 * EVENTS_PER_FRAME + 17))


def _dedicated(scene, ev, policy):
    key = ("dedicated", ev[1].shape[0], policy)
    if key not in scene["refs"]:
        scene["refs"][key] = _drive(_engine(scene, dispatch_policy=policy), scene, ev,
                                    EVENTS_PER_FRAME)
    return scene["refs"][key]


def _multi(scene, evs, schedule, **cfg):
    engine = t_stream.MultiStreamEngine(
        scene["cam"], scene["cfg"], _opts(tp),
        t_stream.StreamConfig(events_per_frame=EVENTS_PER_FRAME, **cfg), device="cpu")
    results = _drive_rig(engine, scene, evs, schedule)
    for sid, ev in zip("ab", evs):
        _assert_bitwise(results[sid], _reference(scene, ev))
        want = _dedicated(scene, ev, cfg["dispatch_policy"])
        for x, y in zip(results[sid].segments, want.segments):
            assert torch.equal(x.dsi, y.dsi) and torch.equal(x.depth_map.depth, y.depth_map.depth)
    d = engine.stats["dispatcher"]
    assert d["pending_segments"] == 0
    assert d["segments"] == d["coalesced_segments"] + d["dispatches"] - d["coalesced_dispatches"]
    assert d["segments"] == sum(s["segments"] for s in engine.stats["sessions"].values())
    return engine


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_multi_stream_matches_dedicated_engines(scene, schedule, policy):
    """Each session of a shared engine equals its dedicated engine and the
    reference's offline run bitwise, under every policy and schedule."""
    _multi(scene, _rig(scene), schedule, dispatch_policy=policy, fairness="fifo")


@pytest.mark.parametrize("fairness", ["fifo", "round_robin"])
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_multi_stream_stats_match_reference(scene, schedule, fairness):
    """Under either fairness rule the shared dispatcher's and each
    session's counters equal the reference `MultiStreamEngine`'s on the
    same schedule (adaptive policy), and results stay bitwise."""
    evs = _rig(scene)
    cfg = dict(dispatch_policy="adaptive", fairness=fairness)
    engine = _multi(scene, evs, schedule, **cfg)
    with _reference_sweeps_stubbed():
        jengine = j_stream.MultiStreamEngine(
            scene["jcam"], scene["jcfg"], _opts(j_stream, formulation="matmul"),
            j_stream.StreamConfig(events_per_frame=EVENTS_PER_FRAME, **cfg))
        _drive_rig(jengine, scene, evs, schedule, jax_side=True)
    got, want = engine.stats, jengine.stats
    _assert_stats_equal(got["dispatcher"], want["dispatcher"])
    for sid in "ab":
        _assert_stats_equal(got["sessions"][sid], want["sessions"][sid])


def test_cross_stream_coalescing(scene):
    """Two lockstep trickle sessions under "throughput" fill S buckets across
    streams: fewer dispatches than two dedicated engines, as the reference."""
    ev = _rig(scene)[0]
    cfg = t_stream.StreamConfig(events_per_frame=EVENTS_PER_FRAME, dispatch_policy="throughput")
    dedicated = _engine(scene, dispatch_policy="throughput")
    _drive(dedicated, scene, ev, EVENTS_PER_FRAME)
    multi = t_stream.MultiStreamEngine(scene["cam"], scene["cfg"], _opts(tp), cfg, device="cpu")
    a, b = multi.add_session("a", _t_traj(scene["traj"])), multi.add_session(
        "b", _t_traj(scene["traj"]))
    for c in _chunks(ev, EVENTS_PER_FRAME):
        a.push(c)
        b.push(c)
    a.flush()
    b.flush()
    d = multi.stats["dispatcher"]
    assert d["cross_stream_dispatches"] >= 1
    assert d["dispatches"] < 2 * dedicated.stats["dispatches"]


def test_session_admission_errors(scene):
    engine = t_stream.MultiStreamEngine(scene["cam"], scene["cfg"], _opts(tp), device="cpu")
    engine.add_session("left", traj=_t_traj(scene["traj"]))
    with pytest.raises(ValueError, match="duplicate session id"):
        engine.add_session("left", traj=_t_traj(scene["traj"]))
    with pytest.raises(KeyError, match="unknown session"):
        engine.session("right")
    assert engine.add_session(traj=_t_traj(scene["traj"])).session_id == "cam1"
    assert sorted(engine.sessions) == ["cam1", "left"]
