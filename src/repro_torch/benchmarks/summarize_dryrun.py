"""Summarize the port's dry-run records (`repro_torch.launch.dryrun`) as
one table.

    PYTHONPATH=src python -m repro_torch.benchmarks.summarize_dryrun [results/dryrun_torch]

Counterpart of the reference's `benchmarks/summarize_dryrun.py`. The
columns are the reference's, read from the port's records: traced FLOPs
per card, the three roofline terms (H100 SXM datasheet peaks), the
dominant term, the useful fraction, the compute term's share of the
largest one, the peak temporary bytes and the trace time.
"""
from __future__ import annotations

import glob
import json
import os
import sys

from repro_torch.launch.dryrun import DEFAULT_OUT


def load(out_dir: str) -> list[dict]:
    recs = []
    for p in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(p) as f:
            recs.append(json.load(f))
    return recs


def fmt_row(r: dict) -> str:
    tag = f"{r['arch']} × {r['cell']} × {r['mesh']}"
    if "skipped" in r:
        return f"| {tag} | SKIP: {r['skipped'][:60]} |||||||"
    rf = r["roofline"]
    mem = r["memory"].get("peak_temp_bytes")
    mem_gb = f"{mem/2**30:.1f}" if isinstance(mem, (int, float)) else "?"
    frac = max(rf["compute_s"], 1e-12) / max(
        rf["compute_s"], rf["memory_s"], rf["collective_s"], 1e-12)
    return (f"| {tag} | {rf['flops']:.2e} | {rf['compute_s']:.3f} "
            f"| {rf['memory_s']:.3f} | {rf['collective_s']:.3f} "
            f"| {rf['dominant']} | {rf['useful_fraction']:.2f} | {frac:.2f} "
            f"| {mem_gb} | {r['trace_s']:.0f}s |")


HEADER = ("| cell | traced flops/card | compute s | memory s | collective s "
          "| dominant | useful | roofline-frac | peak temp GiB | trace |\n"
          "|---|---|---|---|---|---|---|---|---|---|")


def main(argv: list[str] | None = None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    recs = load(argv[0] if argv else DEFAULT_OUT)
    print(HEADER)
    for r in recs:
        print(fmt_row(r))
    done = [r for r in recs if "skipped" not in r]
    print(f"\n{len(recs)} records, {len(done)} traced, "
          f"{len(recs) - len(done)} skipped")


if __name__ == "__main__":
    main()
