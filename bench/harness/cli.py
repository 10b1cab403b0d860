"""One run of one cell: set-up, measured window, per-layer readings, the
comparison with the reference, and the result line.

Everything that belongs to one cell is found by name: the workload entry
in `BENCHMARK.json`, its configuration file, its traffic mix
`bench/traffic/<traffic>.json` (whose `mode` picks the mode module
`bench/harness/<mode>.py`), its limits `bench/limits/<workload>.json`, and
each per-layer metric's reader `bench/metrics/<metric>.py`.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Any

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Run:
    """What a driver gets: the cell's entries and the run's arguments."""

    spec: dict
    cell: dict
    cfg: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: Any  # torch.device
    t_start: float
    tracer: Any = None


@dataclasses.dataclass
class Outcome:
    """What a driver returns."""

    end_to_end: dict[str, float]  # every end-to-end metric it measured
    layer_ctx: dict  # what the per-layer readers read (trace runs)
    attempted: int
    failed: int
    memory_peak_bytes: int
    checks: dict[str, float]  # compared numbers, by name


def load_spec() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def resolve(spec: dict, workload: str) -> tuple[dict, dict, dict]:
    """(cell, configuration, traffic) of a workload, by name."""
    cells = {c["name"]: c for c in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}: have {sorted(cells)}")
    cell = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    cfg = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads((BENCH / "traffic" / f"{cell['traffic']}.json").read_text())
    return cell, cfg, traffic


def cell_metrics(spec: dict, cell: str) -> tuple[list[dict], list[dict]]:
    """(end-to-end, per-layer) metric entries that this cell reports."""
    e2e = [m for m in spec["end_to_end"] if cell in m.get("workloads", [cell])]
    layer = [m for m in spec["per_layer"] if cell in m["workloads"]]
    return e2e, layer


def metric_reader(name: str):
    path = BENCH / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def driver(mode: str):
    if not mode.isidentifier():
        raise SystemExit(f"bad traffic mode {mode!r}")
    return importlib.import_module(f"bench.harness.{mode}")


def forbidden_loaded() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN_MODULES))


def card_line(torch) -> str:
    name = torch.cuda.get_device_name(0)
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        limit = "not read"
    return f"card: {name}, power limit {limit}, cards {torch.cuda.device_count()}"


def set_cache_dirs() -> None:
    """Build and kernel caches at fixed places inside the checkout."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, str(ROOT / "build" / sub))


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device: str | None = None, t_start: float | None = None,
             spec: dict | None = None, tweak=None) -> tuple[dict, list[str]]:
    """Run one cell on `device` (default the first card). Returns the result
    object and the lines that state each compared number and its limit.
    `tweak(cfg, traffic)`, where given, edits the cell's entries in place
    first (the tests' small sizes)."""
    import torch

    from bench.harness import check
    from bench.harness.trace import Tracer

    t_start = time.perf_counter() if t_start is None else t_start
    spec = load_spec() if spec is None else spec
    cell, cfg, traffic = resolve(spec, workload)
    if tweak is not None:
        tweak(cfg, traffic)
    dev = torch.device(device or "cuda:0")
    r = Run(spec=spec, cell=cell, cfg=cfg, traffic=traffic, seed=seed,
            seconds=seconds, trace=trace, device=dev, t_start=t_start,
            tracer=Tracer(trace))
    out: Outcome = driver(traffic["mode"]).run(r)
    e2e, layer = cell_metrics(spec, workload)
    metrics = {}
    if trace:
        for m in layer:
            value = metric_reader(m["name"])(out.layer_ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in e2e:
            metrics[m["name"]] = {"value": out.end_to_end[m["name"]], "unit": m["unit"]}
    ok, checks = check.Tally.from_values(out.checks).report(check.load_limits(workload))
    correct = ok and out.failed == 0 and out.attempted > 0
    kind = torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"
    device_info = {"platform": "gpu" if dev.type == "cuda" else "cpu", "kind": kind,
                   "count": int(cell["chips"]),
                   "memory_peak_bytes": int(out.memory_peak_bytes)}
    result = {"correct": bool(correct), "attempted": int(out.attempted),
              "failed": int(out.failed), "metrics": metrics, "device": device_info}
    if trace and r.tracer.summary is not None:
        device_info["busy_s"] = r.tracer.summary.busy_s
        device_info["window_s"] = r.tracer.summary.window_s
        result["breakdown"] = r.tracer.summary.breakdown
    result["checks"] = checks
    lines = [f"check {n}: {c['value']} (limit {c['limit']})" for n, c in checks.items()]
    lines.append(f"check attempted {out.attempted}, failed {out.failed} (limit 0)")
    return result, lines


def main(argv: list[str], t_start: float) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_cache_dirs()
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("no CUDA card: the benchmark runs only on the card", file=sys.stderr)
        return 3
    spec = load_spec()
    cell, _, _ = resolve(spec, args.workload)
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} cards, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 3
    line = card_line(torch)
    print(line, flush=True)
    print(line, file=sys.stderr, flush=True)
    result, lines = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                             t_start=t_start, spec=spec)
    bad = forbidden_loaded()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 4
    for ln in lines:
        print(ln, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
