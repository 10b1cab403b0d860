"""Paper Table 3 on the port: per-frame runtime breakdown and event rate.

    PYTHONPATH=src python -m repro_torch.benchmarks.table3_runtime [--device cpu]

The paper's columns are an Intel i5 (software EMVS) against Eventor (the
FPGA). The port's analogue, on frame 0 of the reference's
simulation_3planes sequence (1024 events, 64 planes, 240x180):

  * P(Z0): the canonical homography (`apply_homography`);
  * P(Z0->Zi)&R by scatter ("software path") and by one-hot matmul, one
    frame into a fresh DSI, as the reference's script times them;
  * B1, the sweep kernel, as the Eventor analogue: one launch over the
    segment's 24 frames (projection, nearest votes and the f32 store of the
    64-plane DSI), divided by 24 frames. On the CPU, its plain version.

On the card each stage is device time (`_emvs_common.stage_ms`: a CUDA
graph of 20 calls between `torch.cuda.Event`s) and the record carries the
card's name and power limit; with `--device cpu` it is host-clock time on
the CPU, recorded as such. As in the paper's Fig 6, a normal frame takes
max(P(Z0), P(Z0->Zi)&R) when the two stages overlap and a key frame their
sum; Mev/s is 1024 events over that time.

The reference's TPU v5e roofline projection is not carried over: its H100
counterpart waits for the port's `launch/roofline.py` (ROADMAP A6).
Writes the `table3_runtime` section of `BENCH_emvs_torch.json`.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.benchmarks._emvs_common import (
    MAX_FRAMES,
    device_label,
    sequence,
    stage_ms,
    update_bench_json,
)
from repro_torch.core.geometry import (
    SE3,
    PlaneSweepCoeffs,
    apply_homography,
    propagate_to_planes,
)
from repro_torch.core.pipeline import precompute_segment_geometry
from repro_torch.core.voting import vote_onehot_matmul, vote_scatter
from repro_torch.events.aggregation import EventFrames
from repro_torch.kernels.backproject_vote.kernel import backproject_vote_cuda
from repro_torch.kernels.backproject_vote.ops import canonical_inputs
from repro_torch.kernels.backproject_vote.ref import backproject_vote_ref

EVENTS_PER_FRAME = 1024
PAPER = {"cpu_normal_Mev/s": 1.76, "eventor_normal_Mev/s": 1.86,
         "eventor_power_W": 1.86, "cpu_power_W": 45.0}


def run(device: str = "cuda") -> dict:
    cam, _, frames, dsi_cfg = sequence("simulation_3planes", device)
    seg = EventFrames(*(t[:MAX_FRAMES] for t in frames[:3]),
                      SE3(frames.poses.R[:MAX_FRAMES], frames.poses.t[:MAX_FRAMES]))
    dev = seg.xy.device
    planes = dsi_cfg.planes(device=dev)
    z0 = planes[dsi_cfg.num_planes // 2]
    T_w_ref = SE3(seg.poses.R[0], seg.poses.t[0])
    geoms = precompute_segment_geometry(cam, seg, T_w_ref, planes, z0)
    xy, valid, H = seg.xy[0], seg.valid[0], geoms.H[0]
    phi0 = PlaneSweepCoeffs(*(a[0] for a in geoms.phi))
    weights = valid.to(torch.float32)[None, :].expand(dsi_cfg.num_planes, -1)
    xy0 = apply_homography(H, xy)

    def scatter():
        x_i, y_i = propagate_to_planes(cam, xy0, phi0)
        dsi = torch.zeros(dsi_cfg.shape, dtype=torch.int32, device=dev)
        return vote_scatter(dsi, x_i, y_i, w=cam.width, h=cam.height, mode="nearest",
                            weights=weights)

    def matmul():
        x_i, y_i = propagate_to_planes(cam, xy0, phi0)
        dsi = torch.zeros(dsi_cfg.shape, dtype=torch.float32, device=dev)
        return vote_onehot_matmul(dsi, x_i, y_i, w=cam.width, h=cam.height,
                                  mode="nearest", weights=weights)

    # B1's inputs for the whole segment, as the kernel formulation builds them
    phi = torch.stack([geoms.phi.alpha, geoms.phi.beta_x, geoms.phi.beta_y], -1)
    sxy0, svalid, sphi = canonical_inputs(seg.xy[None], seg.valid[None], geoms.H[None],
                                          phi[None])
    x0, y0 = sxy0[..., 0].contiguous(), sxy0[..., 1].contiguous()

    def b1():
        if dev.type == "cuda":
            return backproject_vote_cuda(x0, y0, svalid, sphi, cx=cam.cx, cy=cam.cy,
                                         w=cam.width, h=cam.height)
        return backproject_vote_ref(sxy0, svalid, sphi, cx=cam.cx, cy=cam.cy,
                                    w=cam.width, h=cam.height)

    n_frames = seg.xy.shape[0]
    t_pz0 = stage_ms(lambda: apply_homography(H, xy), device) / 1e3
    stage2 = {"software_scatter": stage_ms(scatter, device) / 1e3,
              "matmul": stage_ms(matmul, device) / 1e3,
              "b1_eventor_analogue": stage_ms(b1, device) / 1e3 / n_frames}

    def pack(t_stage2: float) -> dict:
        normal = max(t_pz0, t_stage2)  # pipelined (paper Fig 6, upper)
        key = t_pz0 + t_stage2  # serial (Fig 6, lower)
        return {
            "P(Z0) us": t_pz0 * 1e6,
            "P(Z0->Zi)&R us": t_stage2 * 1e6,
            "normal frame us": normal * 1e6,
            "key frame us": key * 1e6,
            "normal Mev/s": EVENTS_PER_FRAME / normal / 1e6,
            "key Mev/s": EVENTS_PER_FRAME / key / 1e6,
        }

    label = device_label(device)
    timer = ("device time, CUDA graph of 20 calls between torch.cuda.Events"
             if dev.type == "cuda" else "host clock on the CPU")
    return {**{k: pack(v) for k, v in stage2.items()}, **label, "timer": timer,
            "b1_frames": n_frames, "paper": PAPER}


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    out = run(ap.parse_args(argv).device)
    print(f"== Table 3: runtime per 1024-event frame on {out['device']} "
          f"({out['card'] or 'no card'}; {out['timer']}) ==")
    for name in ("software_scatter", "matmul", "b1_eventor_analogue"):
        print(f"-- {name} --")
        for k, v in out[name].items():
            print(f"   {k:18s} {v:12.3f}")
    p = out["paper"]
    print(f"paper reference: CPU {p['cpu_normal_Mev/s']} Mev/s @ {p['cpu_power_W']} W; "
          f"Eventor {p['eventor_normal_Mev/s']} Mev/s @ {p['eventor_power_W']} W")
    print(f"wrote {update_bench_json('table3_runtime', out)}")
    return out


if __name__ == "__main__":
    main()
