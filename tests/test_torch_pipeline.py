"""The port's offline EMVS pipeline end to end against the JAX reference.

Seeded frames are made once; both packages then run `run_emvs` on the
same numpy frames (the port's arrive through `interop`). The
reference runs its one-hot matmul formulation, which its own tests hold
bitwise to its fused-kernel path. On the CPU the port's "kernel"
formulation takes the kernels' plain versions.

Tolerances: nearest voting (float and Table-1 quantized) and quantized
bilinear voting are bitwise on dsi, depth and mask for every formulation.
Float bilinear voting is held to allclose, as ROADMAP's north star says:
its weights pass through products that both packages contract to fused
multiply-adds only where the host has FMA (XLA:CPU by its instruction
set, the port's `torch.addcmul` by PyTorch's CPU kernel dispatch). On one
frame set, the kernel and matmul formulations keep every DSI element and
confidence within 2 float32 ulps of the reference's with FMA (AVX-512
host) and within 2 with both packages kept from it (`XLA_FLAGS=
--xla_cpu_max_isa=AVX`, `ATEN_CPU_CAPABILITY=default`, as on an x86 host
without FMA3; `test_host_rounding_cases_hold_without_fma` reruns these
cases so). Only mixed settings, which no single host gives, move them further
(9.6e-5, the reference's own move under the XLA flag alone). They are
held to BILINEAR_ULPS; the scatter formulation, whose float scatter-add
also sums in another order than XLA's scatter, within BILINEAR_ATOL.
Depth is within BILINEAR_ATOL of its value in planes for both; masks,
frame ranges, dtypes and valid-point counts stay equal.
"""
from __future__ import annotations

import ast
import dataclasses
import os
import pathlib
import platform
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core.camera import CameraModel as JCamera
from repro.core.dsi import DSIConfig as JDSIConfig
from repro.core.pipeline import EMVSOptions as JOptions
from repro.core.pipeline import run_emvs as j_run_emvs
from repro.core.geometry import SE3 as JSE3
from repro.events.aggregation import EventFrames as JEventFrames
from repro_torch import interop
from repro_torch.core import pipeline as tp
from repro_torch.events import aggregation as t_agg
from repro_torch.events import simulator as t_sim

ROOT = pathlib.Path(__file__).resolve().parents[1]
BILINEAR_ATOL = 1e-4
BILINEAR_ULPS = 4


@pytest.fixture(scope="module")
def setup():
    """Seeded numpy frames (made by the port's simulator, which matches the
    reference's event for event) handed to both packages."""
    cam = JCamera()
    port_cam = interop.camera_from_dict(dataclasses.asdict(cam))
    traj = t_sim.make_trajectory("simulation_3planes", 24, device="cpu")
    ev = t_sim.simulate_events(port_cam, t_sim.make_scene(t_sim.SceneConfig(points_per_plane=80)),
                               traj, device="cpu")
    tf = t_agg.aggregate(port_cam, ev, traj, events_per_frame=256,
                         pose_extrapolation="clamp", device="cpu")
    xy, valid, t_mid, R, t = (a.numpy() for a in (tf.xy, tf.valid, tf.t_mid, *tf.poses))
    frames = JEventFrames(xy=xy, valid=valid, t_mid=t_mid, poses=JSE3(R, t))
    cfg = JDSIConfig.for_camera(cam, num_planes=16, z_min=0.6, z_max=4.5)
    port_frames = interop.event_frames_from_numpy(xy, valid, t_mid, R, t, device="cpu")
    return {
        "cam": cam, "cfg": cfg, "frames": frames, "port_frames": port_frames,
        "port_cam": port_cam,
        "port_cfg": interop.dsi_config_from_dict(dataclasses.asdict(cfg)),
        "ref": {},
    }


def _reference(setup, voting: str, quantized: bool):
    key = (voting, quantized)
    if key not in setup["ref"]:
        opts = JOptions(formulation="matmul", voting=voting, quantized=quantized,
                        keyframe_dist_frac=0.05)
        setup["ref"][key] = j_run_emvs(setup["cam"], setup["cfg"], setup["frames"], opts)
    return setup["ref"][key]


def _within_ulps(got: np.ndarray, want: np.ndarray, ulps: int, what: str) -> None:
    """Every element within `ulps` float32 ulps of the larger magnitude."""
    want = want.astype(np.float32)
    scale = np.spacing(np.maximum(np.abs(got), np.abs(want)))
    worst = float(np.max(np.abs(got - want) / scale))
    assert worst <= ulps, f"{what}: {worst} ulps"


@pytest.mark.parametrize("formulation", ["kernel", "scatter", "matmul"])
@pytest.mark.parametrize("voting,quantized", [
    ("nearest", False), ("nearest", True), ("bilinear", False), ("bilinear", True)])
def test_run_emvs_matches_reference(setup, formulation, voting, quantized):
    ref = _reference(setup, voting, quantized)
    jopts = dataclasses.asdict(JOptions(voting=voting, quantized=quantized,
                                        keyframe_dist_frac=0.05))
    jopts["formulation"] = formulation
    opts = interop.options_from_dict(jopts)
    got = tp.run_emvs(setup["port_cam"], setup["port_cfg"], setup["port_frames"],
                      opts, device="cpu")
    assert len(ref.segments) >= 2
    assert [s.frame_range for s in got.segments] == [s.frame_range for s in ref.segments]
    loose = voting == "bilinear" and not quantized
    for sr, sg in zip(ref.segments, got.segments):
        dsi_r = np.asarray(sr.dsi)
        # the reference keeps float32 for the float kernel path, int32 for
        # the integer accumulators: the port keeps the same dtype per path
        if formulation == "kernel" and not quantized:
            assert sg.dsi.dtype == torch.float32
        else:
            assert str(sg.dsi.dtype) == f"torch.{dsi_r.dtype}"
        dsi_g = sg.dsi.float().numpy()
        depth_r, depth_g = np.asarray(sr.depth_map.depth), sg.depth_map.depth.numpy()
        mask_r, mask_g = np.asarray(sr.depth_map.mask), sg.depth_map.mask.numpy()
        np.testing.assert_array_equal(mask_r, mask_g)
        if loose and formulation == "scatter":
            np.testing.assert_allclose(dsi_g, dsi_r.astype(np.float32), atol=BILINEAR_ATOL)
            np.testing.assert_allclose(depth_g, depth_r, atol=BILINEAR_ATOL)
        elif loose:
            _within_ulps(dsi_g, dsi_r, BILINEAR_ULPS, "dsi")
            _within_ulps(sg.depth_map.confidence.numpy(),
                         np.asarray(sr.depth_map.confidence), BILINEAR_ULPS, "confidence")
            np.testing.assert_allclose(depth_g, depth_r, atol=BILINEAR_ATOL)
        else:
            np.testing.assert_array_equal(dsi_g, dsi_r.astype(np.float32))
            np.testing.assert_array_equal(depth_g, depth_r)
            np.testing.assert_array_equal(sg.depth_map.confidence.numpy(),
                                          np.asarray(sr.depth_map.confidence))
    for cr, cg, sg in zip(ref.clouds, got.clouds, got.segments):
        np.testing.assert_array_equal(np.asarray(cr.valid), cg.valid.numpy())
        assert int(cg.valid.sum()) == int(sg.depth_map.mask.sum())
        np.testing.assert_allclose(cg.points.numpy(), np.asarray(cr.points),
                                   rtol=1e-5, atol=1e-5)


# run in a child process kept from fused multiply-adds: a witness that
# neither package fuses (x * y - z is 0, not the product's rounding
# error, and PyTorch dispatches its kernels built without FMA), then the
# parity cases that depend on the host's rounding
NO_FMA_CHILD = """
import sys
import jax
import numpy as np
import pytest
import torch
x = np.full(8, 1 + 2 ** -12, np.float32)
print("witness", float(jax.jit(lambda a, b, c: a * b - c)(x, x, x * x)[0]),
      torch.backends.cpu.get_cpu_capability())
sys.exit(pytest.main(["-q", "-p", "no:cacheprovider", *sys.argv[1:]]))
"""
HOST_ROUNDING_CASES = [
    "tests/test_torch_pipeline.py::test_run_emvs_matches_reference[bilinear-False-kernel]",
    "tests/test_torch_pipeline.py::test_run_emvs_matches_reference[bilinear-False-matmul]",
    "tests/test_torch_offline_helpers.py::test_pose_helpers",
    "tests/test_torch_lm.py::test_families_match_reference[jamba-1.5-large-398b-float32]",
]


@pytest.mark.skipif(platform.machine().lower() not in ("x86_64", "amd64"),
                    reason="the flags name x86 instruction sets")
def test_host_rounding_cases_hold_without_fma():
    """The host-dependent parity cases (bilinear float voting,
    `pose_distance`, the hybrid's SSM states) pass with both packages
    kept from FMA, as on an x86 host without FMA3, as they do here."""
    env = {**os.environ, "XLA_FLAGS": "--xla_cpu_max_isa=AVX",
           "ATEN_CPU_CAPABILITY": "default", "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join([str(ROOT / "src"), os.environ.get("PYTHONPATH", "")])}
    run = subprocess.run([sys.executable, "-c", NO_FMA_CHILD, *HOST_ROUNDING_CASES],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=360)
    assert "witness 0.0 DEFAULT" in run.stdout, run.stdout[-2000:] + run.stderr[-2000:]
    assert run.returncode == 0 and f"{len(HOST_ROUNDING_CASES)} passed" in run.stdout, \
        run.stdout[-4000:]


@pytest.mark.parametrize("quantized", [False, True])
def test_sweep_segment_batch_matches_reference(setup, quantized):
    """One padded bucket (two segments, a padded frame slot each) fed to both
    sweeps through `interop.segment_batch_from_numpy`."""
    from repro.core.pipeline import pad_segments as j_pad
    from repro.core.pipeline import process_segments_batched as j_sweep

    batch = j_pad(setup["frames"], [(0, 7), (7, 14)], 8)
    opts = JOptions(formulation="matmul", quantized=quantized)
    dsi_r, dm_r = j_sweep(setup["cam"], setup["cfg"], batch, opts)
    port_batch = interop.segment_batch_from_numpy(*(np.asarray(a) for a in batch),
                                                  device="cpu")
    dsi_g, dm_g = tp.sweep_segment_batch(
        setup["port_cam"], setup["port_cfg"], port_batch,
        tp.EMVSOptions(formulation="kernel", quantized=quantized))
    np.testing.assert_array_equal(np.asarray(dsi_r, np.float32), dsi_g.float().numpy())
    np.testing.assert_array_equal(np.asarray(dm_r.depth), dm_g.depth.numpy())
    np.testing.assert_array_equal(np.asarray(dm_r.mask), dm_g.mask.numpy())


def test_run_emvs_looped_matches_batched(setup):
    opts = tp.EMVSOptions(formulation="kernel", quantized=True, keyframe_dist_frac=0.05)
    a = tp.run_emvs(setup["port_cam"], setup["port_cfg"], setup["port_frames"], opts,
                    device="cpu")
    b = tp.run_emvs_looped(setup["port_cam"], setup["port_cfg"], setup["port_frames"],
                           opts, device="cpu")
    for sa, sb in zip(a.segments, b.segments):
        assert torch.equal(sa.dsi, sb.dsi)
        assert torch.equal(sa.depth_map.depth, sb.depth_map.depth)
        assert torch.equal(sa.depth_map.mask, sb.depth_map.mask)


def test_segmentation_edge_cases():
    assert tp.bucket_capacity(1) == 4 and tp.bucket_capacity(5) == 8
    with pytest.raises(ValueError):
        tp.bucket_capacity(0)
    frames = t_agg.empty_event_frames(8, device="cpu")
    with pytest.raises(ValueError, match="at least one segment"):
        tp.pad_segments(frames, [], 4)
    with pytest.raises(ValueError, match="kernel_interpret"):
        interop.options_from_dict({"kernel_interpret": True})
    # the reference's checks and messages; "sharded" needs a process group
    with pytest.raises(ValueError) as want:
        j_run_emvs(JCamera(), JDSIConfig(), None, sweep="tiled")
    with pytest.raises(ValueError) as got:
        tp.run_emvs(tp.CameraModel(), tp.DSIConfig(), frames, sweep="tiled", device="cpu")
    assert str(got.value) == str(want.value)
    with pytest.raises(RuntimeError, match="init_process_group"):
        tp.run_emvs(tp.CameraModel(), tp.DSIConfig(), frames, sweep="sharded",
                    device="cpu")


def test_entry_points_need_cuda_unless_cpu_is_asked(setup):
    """Entry points default to the card; without one they raise rather than
    fall back, and run on the CPU only when asked."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cam, cfg, frames = setup["port_cam"], setup["port_cfg"], setup["port_frames"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tp.run_emvs(cam, cfg, frames, tp.EMVSOptions(formulation="kernel"))
    traj = t_sim.make_trajectory("simulation_3planes", 8, device="cpu")
    ev = t_sim.simulate_events(cam, t_sim.make_scene(t_sim.SceneConfig(points_per_plane=20)),
                               traj, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_agg.aggregate(cam, ev, traj, events_per_frame=64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_sim.simulate_events(cam, np.zeros((4, 3), np.float32), traj)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_sim.make_trajectory("simulation_3planes", 8)
    frames_cpu = t_agg.aggregate(cam, ev, traj, events_per_frame=64, device="cpu")
    assert frames_cpu.xy.device.type == "cpu"


def _imports(path: pathlib.Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module)
    return names


def test_port_imports_neither_jax_nor_the_reference():
    """Nor ml_dtypes, which the card's machine lacks: bfloat16 crosses
    through int16 views (checkpoints) or float32 (interop)."""
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "bench_sweep.py"]
    assert len(files) > 10
    for path in files:
        for name in _imports(path):
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "repro", "benchmarks", "ml_dtypes"), \
                f"{path} imports {name}"
