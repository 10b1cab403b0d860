"""Dry run: trace every (arch x cell) step on fake tensors and record its
memory, FLOPs, bytes and roofline, without allocating or launching.

    python -m repro_torch.launch.dryrun --arch qwen3-8b --cell prefill_32k [--device cpu]
    python -m repro_torch.launch.dryrun --all [--mesh both] [--out results/dryrun_torch]

Counterpart of `repro.launch.dryrun`, which lowers and compiles each cell
for a 256- or 512-chip TPU mesh. The port's "single" mesh is one card:
the step is traced on fake tensors of the chosen device (`FakeTensorMode`;
the card unless `--device cpu`) under `launch/graph_analysis.py`, whose
counts feed `launch/roofline.py`. On the card the step reaches the
hand-written kernels as one operation each (their fake implementations),
on the CPU their plain versions. The record keeps the reference's keys:
arch, cell, mesh, devices, memory (argument, output and peak temporary
bytes), roofline and, for EMVS, `emvs_votes`; `trace_s` takes the place
of the lowering and compile times, and `kernels` lists each hand-written
kernel's call with its declared bytes and FLOPs.

Cells: `eventor-davis240` runs `emvs_rt` and `emvs_seg` through the
batched sweep (the main path's options, 256 planes); every LM arch runs
`prefill_32k` and `decode_32k`, and the SSM and hybrid archs `long_500k`
(a decode step at 524,288 tokens of context). Every other cell is
skipped with its reason: the reference's own skip rule, or what the port
has not got yet (the training step, the multi-card mesh; ROADMAP A7). A
cell whose step reaches an operation that fake tensors cannot run (no
meta kernel) is recorded as skipped, naming the operation.

`--all` writes one JSON per cell into `--out`, tracing each cell in a
subprocess of its own (a skipped cell's record is written directly).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch
from torch._subclasses.fake_tensor import UnsupportedOperatorException

from repro_torch.configs import ArchConfig, get_config
from repro_torch.configs.shapes import (
    EMVS_CELL_PLANES,
    EMVS_CELLS,
    LM_CELLS,
    ShapeCell,
    cell_skipped,
    input_specs,
)
from repro_torch.device import resolve_device
from repro_torch.launch import graph_analysis as ga
from repro_torch.launch import roofline as rf

ARCHS = [
    "kimi-k2-1t-a32b", "deepseek-moe-16b", "musicgen-large", "stablelm-3b",
    "qwen3-8b", "starcoder2-15b", "qwen1.5-4b", "jamba-1.5-large-398b",
    "llava-next-mistral-7b", "mamba2-2.7b", "eventor-davis240",
]
MESHES = ("single", "multi")
DEFAULT_OUT = "results/dryrun_torch"


def port_skip(cell: ShapeCell, mesh_kind: str) -> str | None:
    """Why the port cannot trace this cell yet, or None."""
    if mesh_kind == "multi":
        return ("multi-card mesh not ported yet: ROADMAP A7 "
                "(distributed/sharding.py)")
    if cell.kind == "train":
        return ("training step not ported yet: ROADMAP A7 (training/*, "
                "launch/train.py)")
    return None


def _tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in ga.tensors_of(tree))


def _emvs_step(cell: ShapeCell, dev: torch.device, fake):
    """The batched sweep of one segment of the cell's frames, and its inputs."""
    from repro_torch.core.camera import CameraModel
    from repro_torch.core.dsi import DSIConfig
    from repro_torch.core.pipeline import EMVSOptions, SegmentBatch, sweep_segment_batch

    cam = CameraModel()
    dsi_cfg = DSIConfig.for_camera(cam, num_planes=EMVS_CELL_PLANES)
    opts = EMVSOptions(formulation="kernel", voting="nearest", quantized=True)
    s, c, e = 1, cell.global_batch, cell.seq_len
    f32 = torch.float32
    with fake:
        batch = SegmentBatch(
            xy=torch.empty((s, c, e, 2), dtype=f32, device=dev),
            valid=torch.empty((s, c, e), dtype=torch.bool, device=dev),
            frame_valid=torch.empty((s, c), dtype=torch.bool, device=dev),
            poses_R=torch.empty((s, c, 3, 3), dtype=f32, device=dev),
            poses_t=torch.empty((s, c, 3), dtype=f32, device=dev),
            ref_R=torch.empty((s, 3, 3), dtype=f32, device=dev),
            ref_t=torch.empty((s, 3), dtype=f32, device=dev))

    def step(b):
        dsi, dm = sweep_segment_batch(cam, dsi_cfg, b, opts)
        return dsi, dm.depth, dm.mask, dm.confidence

    n_votes = s * c * e * dsi_cfg.num_planes
    return step, (batch,), {"emvs_votes": n_votes, "model_flops": 5.0 * n_votes}


def _lm_step(cfg: ArchConfig, cell: ShapeCell, dev: torch.device, fake):
    """Prefill or one decode step of the cell's batch, and its inputs."""
    from repro_torch.models import model as M

    specs = input_specs(cfg, cell, device=dev, fake_mode=fake)
    with fake:
        params = M.init_params(cfg, generator=None, dtype=torch.bfloat16, device=dev)
    front = specs.get("frontend_embed")
    if cell.kind == "prefill":
        def step(params, tokens, front):
            logits, _ = M.prefill(params, tokens, cfg, cell.seq_len, frontend_embed=front)
            return logits

        return step, (params, specs["tokens"], front), {}
    with fake:
        state = M.init_decode_state(cfg, cell.global_batch, cell.seq_len, device=dev)

    def step(params, state, tokens, front):
        logits, _ = M.decode_step(params, state, tokens, cell.seq_len - 1, cfg,
                                  frontend_embed=front)
        return logits

    return step, (params, state, specs["tokens"], front), {}


def run_cell(arch: str, cell_name: str, mesh_kind: str = "single", *,
             device=None) -> dict:
    """Trace one cell on fake tensors of `device` (the card unless "cpu")
    and return its record (see the module docstring)."""
    cfg = get_config(arch)
    table = EMVS_CELLS if cfg.family == "emvs" else LM_CELLS
    cell = table[cell_name]
    rec: dict = {"arch": arch, "cell": cell_name, "mesh": mesh_kind}
    skip = cell_skipped(cfg, cell) or port_skip(cell, mesh_kind)
    if skip:
        rec["skipped"] = skip
        return rec
    dev = resolve_device(device)
    fake = ga.fake_mode()
    t0 = time.time()
    if cfg.family == "emvs":
        step, args, extra = _emvs_step(cell, dev, fake)
    else:
        step, args, extra = _lm_step(cfg, cell, dev, fake)
    try:
        out, stats, mode = ga.analyze(step, *args, fake=fake)
    except UnsupportedOperatorException as exc:
        rec["skipped"] = (f"fake tensors cannot trace {exc.func}: the operation "
                          "has no meta kernel")
        return rec
    t1 = time.time()
    mf = extra.pop("model_flops", None)
    if mf is None:
        mf = rf.model_flops_for_cell(cfg, cell)
    roof = rf.analyze(stats, n_devices=1, model_flops_global=mf)
    rec.update({
        "devices": 1,
        "device": dev.type,
        "trace_s": round(t1 - t0, 2),
        "memory": {"argument_bytes": _tree_bytes(args), "output_bytes": _tree_bytes(out),
                   "peak_temp_bytes": stats.peak_temp_bytes},
        "roofline": roof.to_json(),
        "kernels": [{"op": o.name, "bytes": o.bytes_read + o.bytes_written,
                     "flops": o.flops, "outputs": o.outputs}
                    for o in mode.ops if o.name.startswith("repro_torch.")],
        **extra,
    })
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch")
    ap.add_argument("--cell")
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--json", help="write the single cell's record here")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    if args.all:
        os.makedirs(args.out, exist_ok=True)
        meshes = list(MESHES) if args.mesh == "both" else [args.mesh]
        failures = 0
        for arch in ARCHS:
            cfg = get_config(arch)
            table = EMVS_CELLS if cfg.family == "emvs" else LM_CELLS
            for cell_name in table:
                for mk in meshes:
                    tag = f"{arch}__{cell_name}__{mk}".replace("/", "_")
                    out_json = os.path.join(args.out, tag + ".json")
                    if os.path.exists(out_json):
                        print(f"[skip-cached] {tag}")
                        continue
                    skip = (cell_skipped(cfg, table[cell_name])
                            or port_skip(table[cell_name], mk))
                    if skip:  # no trace to isolate: the record, in process
                        with open(out_json, "w") as f:
                            json.dump({"arch": arch, "cell": cell_name, "mesh": mk,
                                       "skipped": skip}, f, indent=1)
                        print(f"[skip] {tag}: {skip}")
                        continue
                    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                           "--arch", arch, "--cell", cell_name, "--mesh", mk,
                           "--json", out_json]
                    if args.device:
                        cmd += ["--device", args.device]
                    print(f"[run] {tag}", flush=True)
                    r = subprocess.run(cmd, capture_output=True, text=True, timeout=3600)
                    if r.returncode != 0:
                        failures += 1
                        with open(out_json + ".err", "w") as f:
                            f.write(r.stdout[-4000:] + "\n" + r.stderr[-8000:])
                        print(f"[FAIL] {tag}: see {out_json}.err")
        print(f"done; {failures} failures")
        return 1 if failures else 0

    rec = run_cell(args.arch, args.cell, args.mesh, device=args.device)
    out = json.dumps(rec, indent=1, default=str)
    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as f:
            f.write(out)
    print(out)
    if "skipped" not in rec:
        print(f"\nmemory: {rec['memory']}")
        print(f"roofline: flops={rec['roofline']['flops']:.3e} "
              f"bytes={rec['roofline']['bytes_hbm']:.3e} "
              f"dominant={rec['roofline']['dominant']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
