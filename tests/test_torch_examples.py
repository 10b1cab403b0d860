"""The port's DAVIS346 sweep and examples on the CPU.

* DAVIS346 (346x260, two row bands in the CUDA kernel): the same numpy
  frames through both packages' `run_emvs`, the port's kernel formulation
  (on the CPU, its kernels' plain versions) against the reference's
  one-hot matmul formulation, which its own tests hold bitwise to its
  fused kernel; float and Table-1 quantized: DSI, depth and mask bitwise.
* The examples' `main()` with `--device cpu` at small sizes; the merged
  map's outlier filter keeps exactly the reference filter's points.
* The LM examples and the training launcher on the CPU: `train_lm --tiny`
  lowers the loss and resumes from its checkpoint, `serve_lm` serves the
  same traffic with bf16 and int8 caches, `launch.train --reduced`
  resumes at the step counter.
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.camera import CameraModel as JCamera
from repro.core.dsi import DSIConfig as JDSIConfig
from repro.core.geometry import SE3 as JSE3
from repro.core.pipeline import EMVSOptions as JOptions
from repro.core.pipeline import run_emvs as j_run_emvs
from repro.core.pointcloud import PointCloud as JPointCloud
from repro.core.pointcloud import radius_outlier_filter as j_filter
from repro.events.aggregation import EventFrames as JEventFrames
from repro_torch import interop
from repro_torch.core import pipeline as tp
from repro_torch.core.camera import CAMERAS
from repro_torch.events import aggregation as t_agg
from repro_torch.events import simulator as t_sim
from repro_torch.examples import emvs_reconstruction, quickstart, serve_lm, train_lm
from repro_torch.launch import train as launch_train


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread leaves the other cores to the
    test workers running beside this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def davis346_frames():
    """16 trajectory steps seen by a DAVIS346, 1024-event frames, as numpy."""
    cam = CAMERAS["davis346"]
    traj = t_sim.make_trajectory("simulation_3planes", 16, device="cpu")
    ev = t_sim.simulate_events(cam, t_sim.make_scene(t_sim.SceneConfig(points_per_plane=400)),
                               traj, device="cpu")
    tf = t_agg.aggregate(cam, ev, traj, events_per_frame=1024, pose_extrapolation="clamp",
                         device="cpu")
    return tuple(a.numpy() for a in (tf.xy, tf.valid, tf.t_mid, *tf.poses))


@pytest.mark.parametrize("quantized", [False, True])
def test_davis346_kernel_formulation_matches_the_reference(davis346_frames, quantized):
    cam = JCamera(**dataclasses.asdict(CAMERAS["davis346"]))
    cfg = JDSIConfig.for_camera(cam, num_planes=16, z_min=0.6, z_max=4.5)
    xy, valid, t_mid, R, t = davis346_frames
    want = j_run_emvs(cam, cfg, JEventFrames(xy, valid, t_mid, JSE3(R, t)),
                      JOptions(formulation="matmul", quantized=quantized,
                               keyframe_dist_frac=0.08))
    got = tp.run_emvs(CAMERAS["davis346"], interop.dsi_config_from_dict(dataclasses.asdict(cfg)),
                      interop.event_frames_from_numpy(*davis346_frames, device="cpu"),
                      tp.EMVSOptions(formulation="kernel", quantized=quantized,
                                     keyframe_dist_frac=0.08), device="cpu")
    assert len(got.segments) == len(want.segments) == 3
    for a, b in zip(got.segments, want.segments):
        assert a.frame_range == b.frame_range
        np.testing.assert_array_equal(a.dsi.numpy(), np.asarray(b.dsi))
        np.testing.assert_array_equal(a.depth_map.depth.numpy(), np.asarray(b.depth_map.depth))
        np.testing.assert_array_equal(a.depth_map.mask.numpy(), np.asarray(b.depth_map.mask))
    assert all(int(s.depth_map.mask.sum()) > 0 for s in got.segments)


def test_quickstart_runs_on_the_cpu():
    errs = quickstart.main(["--device", "cpu"])
    assert len(errs) >= 1 and all(0 < e < 0.25 for e in errs)


@pytest.mark.parametrize("camera", ["davis240", "davis346"])
def test_emvs_reconstruction_runs_on_the_cpu(tmp_path, camera):
    """The kernel variant equals the matmul variant it stands beside, and
    the merged map's outlier filter keeps the reference filter's points."""
    out = tmp_path / "recon.npz"
    res = emvs_reconstruction.main(["--device", "cpu", "--camera", camera, "--steps", "28",
                                    "--points", "250", "--planes", "24", "--out", str(out)])
    absrel = res["absrel"]
    kernel = next(k for k in absrel if k.startswith("B1+B2 plain versions"))
    assert absrel[kernel] == absrel[emvs_reconstruction.MERGED_VARIANT]
    merged, filtered = res["merged"], res["filtered"]
    cam = CAMERAS[camera]
    assert merged.valid.shape[0] == len(res["results"][kernel].clouds) * cam.width * cam.height
    keep = j_filter(JPointCloud(*(jnp.asarray(a.numpy()) for a in merged)),
                    radius=0.08, min_neighbors=2).valid
    np.testing.assert_array_equal(filtered.valid.numpy(), np.asarray(keep))
    saved = np.load(out)
    assert saved["points"].shape == (int(filtered.valid.sum()), 3)
    assert 0 < saved["points"].shape[0] < int(merged.valid.sum())


class _NoStragglers:
    """A watchdog that never fires: step times on a loaded test host are
    no signal (tests/test_torch_checkpoint.py holds the real one)."""

    def observe(self, dt: float) -> None:
        return None


def test_train_lm_tiny_trains_and_resumes_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(train_lm, "StragglerMonitor", _NoStragglers)
    ck = str(tmp_path / "ck")
    first = train_lm.main(["--tiny", "--device", "cpu", "--steps", "20", "--ckpt-dir", ck,
                           "--ckpt-every", "10"])
    assert first["start_step"] == 0 and len(first["losses"]) == 20
    assert first["losses"][-1] < first["losses"][0] - 0.5, first["losses"]
    assert int(first["state"].opt.step) == 20
    again = train_lm.main(["--tiny", "--device", "cpu", "--steps", "24", "--ckpt-dir", ck])
    assert again["start_step"] == 20 and len(again["losses"]) == 4
    assert int(again["state"].opt.step) == 24
    assert all(np.isfinite(again["losses"]))


def test_serve_lm_runs_on_the_cpu():
    out = serve_lm.main(["--device", "cpu", "--requests", "3"])
    assert out["generated"] == [24] * 6
    assert 0.0 <= out["agreement"] <= 1.0
    assert 0 < out["int8"]["kv_bytes"] < out["bf16"]["kv_bytes"]


def test_launch_train_resumes_on_the_cpu(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    args = ["--arch", "mamba2-2.7b", "--reduced", "--device", "cpu", "--batch", "2",
            "--seq", "16", "--ckpt-dir", ck, "--log-every", "2"]
    run = launch_train.main(args + ["--steps", "4", "--ckpt-every", "2"])
    assert run["start_step"] == 0 and sorted(run["losses"]) == [1, 2, 4]
    run = launch_train.main(args + ["--steps", "6"])
    assert run["start_step"] == 4 and int(run["state"].opt.step) == 6
    out = capsys.readouterr().out
    assert "[restore] resuming from step 4" in out and "[ckpt] step 2" in out


def test_lm_entry_points_need_cpu_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.main(["--arch", "qwen3-8b", "--reduced"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_lm.main(["--tiny"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_lm.main([])
