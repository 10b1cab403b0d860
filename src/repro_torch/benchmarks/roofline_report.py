"""Roofline report: the EMVS fusion ladder on one H100 (analytic, always
available) plus the dry-run table when its records exist.

    PYTHONPATH=src python -m repro_torch.benchmarks.roofline_report [--dry-run]

Counterpart of the reference's `benchmarks/roofline_report.py`. The
ladder (`launch/roofline.py::emvs_fusion_ladder`) keeps the reference's
HBM traffic per rung and counts the card's work (B1's 9 float32
operations per event and plane, 6 per voxel for detection, at the
datasheet's 67 TFLOP/s). The gate: each fusion stage (unfused -> fused
int16 store -> fused detection) sits strictly closer to its roofline
bound than the one before. It runs at the reference's `FUSION_SHAPE` and
at the main path's largest bucket (`MAIN_BUCKET`: S=2 segments of 40
frames; the ladder models one segment, the totals are S times it).

`--dry-run` writes the ladders into the `"dry_run"` section of
`BENCH_emvs_torch.json` (beside other dry-run records, never at the top
level). The dry-run table needs the records first:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.launch.dryrun import DEFAULT_OUT
from repro_torch.launch.roofline import emvs_fusion_ladder

DEFAULT_DIR = DEFAULT_OUT

# Eventor operating point: DAVIS240 sensor, paper's 64-plane sweep
FUSION_SHAPE = dict(nz=64, h=180, w=240, events=1024, frames=8)
# the EMVS main path's largest capacity bucket: S segments of this shape
MAIN_BUCKET = dict(nz=128, h=180, w=240, events=1024, frames=40)
MAIN_BUCKET_SEGMENTS = 2


def fusion_report(shape: dict | None = None, segments: int = 1) -> dict:
    """The ladder of one segment at `shape`, the strictly-closer gate, and
    each rung's bytes and time over `segments` segments."""
    shape = dict(shape or FUSION_SHAPE)
    ladder = emvs_fusion_ladder(**shape)
    violations = []
    for prev, cur in zip(ladder, ladder[1:]):
        if not cur.bound_gap < prev.bound_gap:
            violations.append(
                f"{cur.name} (gap {cur.bound_gap:.3f}) is not strictly "
                f"closer to the roofline bound than {prev.name} "
                f"(gap {prev.bound_gap:.3f})")
    return {
        "shape": shape,
        "segments": segments,
        "stages": [r.to_json() for r in ladder],
        "bound_s": {r.name: segments * r.time_s for r in ladder},
        "hbm_bytes": {r.name: segments * r.hbm_bytes for r in ladder},
        "violations": violations,
        "fused_vs_unfused_bytes_ratio": ladder[-1].hbm_bytes / ladder[0].hbm_bytes,
    }


def _print_fusion(rep: dict) -> None:
    s = rep["shape"]
    print("== EMVS sweep fusion ladder on one H100 (analytic two-term roofline) ==")
    print(f"shape: nz={s['nz']} h={s['h']} w={s['w']} events={s['events']} "
          f"frames={s['frames']} quantized={s.get('quantized', True)}, "
          f"x{rep['segments']} segment(s)")
    print(f"{'stage':<14} {'HBM MiB':>9} {'intensity':>10} {'memory us':>10} "
          f"{'compute us':>11} {'bound gap':>10} {'bound us':>10}")
    for st in rep["stages"]:
        print(f"{st['name']:<14} {rep['hbm_bytes'][st['name']] / 2**20:>9.2f} "
              f"{st['intensity']:>10.2f} {st['memory_s'] * 1e6:>10.2f} "
              f"{st['compute_s'] * 1e6:>11.3f} {st['bound_gap']:>10.2f} "
              f"{rep['bound_s'][st['name']] * 1e6:>10.2f}")
    print(f"fused kernel moves {rep['fused_vs_unfused_bytes_ratio']:.2%} of the "
          f"unfused HBM traffic")
    for v in rep["violations"]:
        print(f"VIOLATION: {v}")


def run(out_dir: str = DEFAULT_DIR) -> dict:
    if not os.path.isdir(out_dir):
        return {"error": f"no dry-run records in {out_dir}; run the dry run first",
                "rows": []}
    from repro_torch.benchmarks.summarize_dryrun import load

    recs = load(out_dir)
    traced = [r for r in recs if "skipped" not in r]
    doms: dict[str, int] = {}
    for r in traced:
        doms[r["roofline"]["dominant"]] = doms.get(r["roofline"]["dominant"], 0) + 1
    return {"rows": recs, "n": len(recs), "n_traced": len(traced),
            "dominant_histogram": doms}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dry-run", action="store_true",
                    help="record the ladders into the dry_run section of "
                         "BENCH_emvs_torch.json")
    ap.add_argument("--out-dir", default=DEFAULT_DIR, help="dry-run record directory")
    ap.add_argument("--json-out", default=None, help="BENCH_emvs_torch.json path")
    args = ap.parse_args(argv)

    reps = [fusion_report(), fusion_report(MAIN_BUCKET, MAIN_BUCKET_SEGMENTS)]
    for rep in reps:
        _print_fusion(rep)
        print()

    if args.dry_run:
        from repro_torch.benchmarks._emvs_common import BENCH_JSON, update_bench_json

        path = args.json_out or BENCH_JSON
        section: dict = {}
        if os.path.exists(path):
            with open(path) as f:
                section = json.load(f).get("dry_run", {})
        section["roofline_report"] = {"dry_run": True, "fusion": reps[0],
                                      "fusion_main_bucket": reps[1]}
        print(f"wrote dry_run/roofline_report -> "
              f"{update_bench_json('dry_run', section, path=path)}")

    out = run(args.out_dir)
    if "error" in out:
        print(out["error"])
    else:
        from repro_torch.benchmarks.summarize_dryrun import HEADER, fmt_row

        print("== Roofline (from the dry-run records) ==")
        print(HEADER)
        for r in out["rows"]:
            print(fmt_row(r))
        print(f"\n{out['n']} cells ({out['n_traced']} traced); dominant-term "
              f"histogram: {out['dominant_histogram']}")

    return 1 if any(rep["violations"] for rep in reps) else 0


if __name__ == "__main__":
    raise SystemExit(main())
