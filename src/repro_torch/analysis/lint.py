"""`python -m repro_torch.analysis.lint` — the quantization-contract linter CLI.

Counterpart of `repro.analysis.lint`. Traces every sweep program of the
formulation x backend x voting x quantization grid (plus, on the full
grid, the kernel-level entry points) on fake tensors of the chosen device
at tiny shapes, runs the dtype-flow and host-sync rules over each recorded
aten graph, audits the streaming dispatcher's variant space, and reports
findings against the port's own baseline
(`src/repro_torch/analysis/baseline.json`).

    python -m repro_torch.analysis.lint [--grid quick|full] [--device cpu|meta]
        [--json findings.json] [--baseline PATH] [--write-baseline]

`--device`: the card (the default; fake CUDA tensors, nothing launched,
the kernels as single operations), `cpu` (the plain versions the CPU
runs) or `meta` (the card's program, traced without a card). The sharded
backend runs over a one-rank gloo group (`distributed.emvs.
local_process_group`) when no process group is up.

Exit status is 0 iff no *new* (non-suppressed) findings; suppressed
findings are listed but do not fail the lint. `--write-baseline`
regenerates the baseline from the current findings. `--json` dumps the
findings, the summaries and the overflow proofs.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
from typing import Any, Sequence

import torch

from repro_torch.analysis.dtype_flow import analyze_program, contract
from repro_torch.analysis.findings import (
    Finding,
    load_baseline,
    split_by_baseline,
    write_baseline,
)
from repro_torch.analysis.rules import audit_variant_space, default_rules
from repro_torch.launch.graph_analysis import fake_mode

FORMULATIONS = ("scatter", "matmul", "kernel")
BACKENDS = ("batched", "sharded")
VOTINGS = ("nearest", "bilinear")
QUANTIZED = (False, True)

# tiny trace shapes: static analysis cost is per-program, not per-element.
# The proof target is the paper-scale worst case the int32 accumulator
# must survive: a full segment capacity of frames with every event
# landing in one voxel, so the frame capacity is traced at the real
# streaming bound (the loop is unrolled: 64 frames of operations).
TRACE_W, TRACE_H, TRACE_NZ = 32, 24, 8
PROOF_CAPACITY_FRAMES = 64
TRACE_SEGMENTS, TRACE_CAPACITY, TRACE_EVENTS = 2, PROOF_CAPACITY_FRAMES, 64

BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "baseline.json")

# worst-case input bounds the analyzer may assume, per SegmentBatch field:
# the reference's `pipeline.SWEEP_INPUT_CONTRACTS`; the masks are bool here
SWEEP_INPUT_CONTRACTS = {
    "xy": (-4096.0, 4096.0, False),
    "valid": (0.0, 1.0, True),
    "frame_valid": (0.0, 1.0, True),
    "poses_R": (-1.0, 1.0, False),
    "poses_t": (-1e3, 1e3, False),
    "ref_R": (-1.0, 1.0, False),
    "ref_t": (-1e3, 1e3, False),
}
# the same over the kernel entry's (xy, valid, H, phi, frame_valid)
KERNEL_INPUT_CONTRACTS = {
    "xy": (-4096.0, 4096.0, False),
    "valid": (0.0, 1.0, True),
    "H": (-1e4, 1e4, False),
    "phi": (-1e4, 1e4, False),
    "frame_valid": (0.0, 1.0, True),
}


def _trace_camera():
    from repro_torch.core.camera import CameraModel
    from repro_torch.core.dsi import DSIConfig

    cam = CameraModel(width=TRACE_W, height=TRACE_H, cx=TRACE_W / 2 - 0.5,
                      cy=TRACE_H / 2 - 0.5)
    return cam, DSIConfig.for_camera(cam, num_planes=TRACE_NZ)


def _segment_batch(fake, device, s: int, c: int, e: int):
    from repro_torch.core.pipeline import SegmentBatch

    f32, b = torch.float32, torch.bool
    with fake:
        return SegmentBatch(
            xy=torch.empty((s, c, e, 2), dtype=f32, device=device),
            valid=torch.empty((s, c, e), dtype=b, device=device),
            frame_valid=torch.empty((s, c), dtype=b, device=device),
            poses_R=torch.empty((s, c, 3, 3), dtype=f32, device=device),
            poses_t=torch.empty((s, c, 3), dtype=f32, device=device),
            ref_R=torch.empty((s, 3, 3), dtype=f32, device=device),
            ref_t=torch.empty((s, 3), dtype=f32, device=device))


def build_entries(grid: str = "full", device="cpu", mesh=None) -> list[dict[str, Any]]:
    """The lint grid: one dict per traced program, with `fn`, its fake
    `args`, the `fake` mode they were made under, `contracts` (one AbsVal
    per tensor argument) and the quant `policy` whose clamps sanction a
    store. The sharded entries need `mesh` (a segment mesh)."""
    from repro_torch.core.pipeline import EMVSOptions, SegmentBatch, sweep_segment_batch
    from repro_torch.kernels.backproject_vote.ops import backproject_vote_frames
    from repro_torch.quant.policies import TABLE1

    device = torch.device(device)
    cam, dsi_cfg = _trace_camera()
    entries: list[dict[str, Any]] = []
    formulations = FORMULATIONS if grid == "full" else ("matmul",)
    backends = BACKENDS if grid == "full" else ("batched",)
    for formulation in formulations:
        for backend in backends:
            for voting in VOTINGS:
                for quantized in QUANTIZED:
                    opts = EMVSOptions(voting=voting, formulation=formulation,
                                       quantized=quantized)
                    name = (f"sweep[{formulation},{backend},{voting},"
                            f"{'quant' if quantized else 'float'}]")
                    fake = fake_mode()
                    batch = _segment_batch(fake, device, TRACE_SEGMENTS, TRACE_CAPACITY,
                                           TRACE_EVENTS)
                    if backend == "sharded":
                        from repro_torch.distributed.emvs import process_segments_sharded

                        def fn(b, opts=opts):
                            return process_segments_sharded(cam, dsi_cfg, b, opts,
                                                            mesh=mesh)
                    else:
                        def fn(b, opts=opts):
                            return sweep_segment_batch(cam, dsi_cfg, b, opts)
                    entries.append({
                        "name": name, "fn": fn, "args": (batch,), "fake": fake,
                        "contracts": [contract(t, *SWEEP_INPUT_CONTRACTS[f])
                                      for f, t in zip(SegmentBatch._fields, batch)],
                        "policy": opts.policy})
    if grid == "full":
        # kernel-level entries: the wrapper's datapath (Table 1 on the
        # inputs, B1 and B2) outside the segment sweep
        f, e, nz = TRACE_CAPACITY, TRACE_EVENTS, dsi_cfg.num_planes
        for voting in VOTINGS:
            for quantized in QUANTIZED:
                fake = fake_mode()
                with fake:
                    args = (torch.empty((f, e, 2), device=device),
                            torch.empty((f, e), dtype=torch.bool, device=device),
                            torch.empty((f, 3, 3), device=device),
                            torch.empty((f, nz, 3), device=device),
                            torch.empty((f,), dtype=torch.bool, device=device))

                def fn(xy, valid, H, phi, frame_valid, voting=voting, quantized=quantized):
                    return backproject_vote_frames(
                        xy, valid, H, phi, cam=cam, dsi_cfg=dsi_cfg, mode=voting,
                        quantized=quantized, frame_valid=frame_valid)

                entries.append({
                    "name": f"kernel[{voting},{'quant' if quantized else 'float'}]",
                    "fn": fn, "args": args, "fake": fake,
                    "contracts": [contract(t, *c) for t, c in
                                  zip(args, KERNEL_INPUT_CONTRACTS.values())],
                    "policy": TABLE1})
    return entries


def lint_entry(entry: dict[str, Any]) -> tuple[list[Finding], dict[str, Any]]:
    ctx = analyze_program(
        entry["fn"], entry["args"], entry["contracts"], entry=entry["name"],
        rules=default_rules(), fake=entry["fake"],
        sanctioned_clips=entry["policy"].sanctioned_clip_bounds())
    return ctx.findings, dict(ctx.facts)


def lint_variant_space() -> tuple[list[Finding], dict[str, Any]]:
    """The recompilation audit across the supported StreamConfigs."""
    from repro_torch.serving.emvs_stream import StreamConfig

    findings: list[Finding] = []
    summaries: dict[str, Any] = {}
    for name, cfg, mesh_segments in (
        ("variant-space[batched]", StreamConfig(), 1),
        ("variant-space[sharded,x8]", StreamConfig(sweep="sharded"), 8),
    ):
        fs, summary = audit_variant_space(cfg, PROOF_CAPACITY_FRAMES,
                                          mesh_segments=mesh_segments, entry=name)
        findings.extend(fs)
        summaries[name] = summary
    return findings, summaries


def _dedupe(findings: list[Finding]) -> list[Finding]:
    seen: set[tuple[str, str, str]] = set()
    out = []
    for f in findings:
        key = (f.fingerprint, f.provenance.source, f.message)
        if key not in seen:
            seen.add(key)
            out.append(f)
    return out


@contextlib.contextmanager
def _segment_mesh(grid: str):
    """A segment mesh for the sharded entries (full grid): over the
    initialized process group, else a one-rank gloo group for the lint."""
    if grid != "full":
        yield None
        return
    import torch.distributed as dist

    from repro_torch.distributed.emvs import local_process_group, make_segment_mesh

    with contextlib.ExitStack() as stack:
        if not dist.is_initialized():
            stack.enter_context(local_process_group("cpu"))
        yield make_segment_mesh()


def run_lint(grid: str = "full", device="cpu") -> tuple[list[Finding], dict[str, Any]]:
    """Run every rule over every entry; returns (findings, report)."""
    findings: list[Finding] = []
    int_bounds: dict[str, tuple[float, float]] = {}
    entries_run: list[str] = []
    with _segment_mesh(grid) as mesh:
        for entry in build_entries(grid, device, mesh):
            fs, facts = lint_entry(entry)
            findings.extend(fs)
            entries_run.append(entry["name"])
            for dtype, (lo, hi) in facts.get("int_bounds", {}).items():
                plo, phi = int_bounds.get(dtype, (0.0, 0.0))
                int_bounds[dtype] = (min(plo, lo), max(phi, hi))
    vfindings, vsummaries = lint_variant_space()
    findings.extend(vfindings)
    proofs = {}
    for dtype, (lo, hi) in sorted(int_bounds.items()):
        info = torch.iinfo(getattr(torch, dtype))
        proofs[dtype] = {
            "worst_case_lo": lo,
            "worst_case_hi": hi,
            "dtype_min": float(info.min),
            "dtype_max": float(info.max),
            "headroom": min(lo - float(info.min), float(info.max) - hi),
        }
    report = {"entries": entries_run, "device": str(device),
              "int_bound_proofs": proofs, "variant_space": vsummaries}
    return _dedupe(findings), report


def main(argv: Sequence[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="quantization-contract linter over the sweep program grid")
    ap.add_argument("--baseline", default=BASELINE, help="suppression baseline JSON")
    ap.add_argument("--json", dest="json_out", default=None, help="findings JSON path")
    ap.add_argument("--write-baseline", action="store_true",
                    help="regenerate the baseline from current findings and exit 0")
    ap.add_argument("--grid", choices=("full", "quick"), default="full",
                    help="'quick' lints only the matmul/batched column (fast smoke)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default: fake CUDA tensors), cpu or meta")
    args = ap.parse_args(argv)

    device = args.device or "cuda"
    if device == "cuda":
        from repro_torch.device import resolve_device

        device = resolve_device(device)
    findings, report = run_lint(args.grid, device)

    if args.write_baseline:
        write_baseline(args.baseline, findings)
        print(f"wrote {len(findings)} fingerprint(s) to {args.baseline}")
        return 0

    baseline = load_baseline(args.baseline) if args.baseline else set()
    new, suppressed = split_by_baseline(findings, baseline)
    for f in suppressed:
        print(f"SUPPRESSED {f.render()}")
    for f in new:
        print(f"NEW {f.render()}")
    for dtype, proof in report["int_bound_proofs"].items():
        print(f"proof: worst-case {dtype} values in "
              f"[{proof['worst_case_lo']:.0f}, {proof['worst_case_hi']:.0f}] within "
              f"[{proof['dtype_min']:.0f}, {proof['dtype_max']:.0f}] "
              f"(headroom {proof['headroom']:.0f})")
    for name, summary in report["variant_space"].items():
        print(f"{name}: {summary['variants']} variants (S buckets "
              f"{summary['s_buckets']} x capacities {summary['capacities']}, bound "
              f"{summary['bound']}, {summary.get('planner_groups_checked', 0)} "
              "planner-emitted group(s) audited)")
    print(f"{len(report['entries'])} program(s) linted on {report['device']}: "
          f"{len(new)} new finding(s), {len(suppressed)} suppressed")

    if args.json_out:
        with open(args.json_out, "w") as fh:
            json.dump({"new": [f.to_json() for f in new],
                       "suppressed": [f.to_json() for f in suppressed],
                       "report": report}, fh, indent=2)
            fh.write("\n")
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
