"""Benchmark driver: one section per paper table or figure the port has,
and the roofline.

    PYTHONPATH=src python -m repro_torch.benchmarks.run [--skip-slow] [--device cpu]

Counterpart of the reference's `benchmarks/run.py`: Table 3, segment
batching, Fig 4a, 4b and 7a, the memory footprint and the roofline
report, each section's failure caught, counted and printed, the exit
status 1 when any failed. `--skip-slow` leaves out the sections that
sweep the paper's four sequences (Fig 4a, 4b, 7a). Runs on the card
unless `--device cpu`.
"""
from __future__ import annotations

import argparse
import sys
import time
import traceback

SLOW = ("fig4a", "fig4b", "fig7a")


def sections(device: str | None):
    """`(key, title, thunk)` per section, in the reference's order."""
    from repro_torch.benchmarks import (
        fig4a_voting,
        fig4b_quant,
        fig7a_accuracy,
        memory_footprint,
        roofline_report,
        segment_batching,
        table3_runtime,
    )

    dev = ["--device", device] if device else []
    return [
        ("table3", "Table 3 (runtime per event frame)", lambda: table3_runtime.main(dev)),
        ("segment_batching", "Segment batching (looped vs batched sweep)",
         lambda: segment_batching.main(dev)),
        ("fig4a", "Fig 4a (nearest vs bilinear voting)", lambda: fig4a_voting.main(dev)),
        ("fig4b", "Fig 4b (hybrid quantization)", lambda: fig4b_quant.main(dev)),
        ("fig7a", "Fig 7a (original vs reformulated)", lambda: fig7a_accuracy.main(dev)),
        ("memory_footprint", "§2.3 (memory footprint)", lambda: memory_footprint.main(dev)),
        ("roofline", "Roofline (fusion ladder, dry-run records)",
         lambda: _check_rc(roofline_report.main([]))),
    ]


def _check_rc(rc: int) -> None:
    if rc:
        raise RuntimeError(f"section returned exit status {rc}")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--skip-slow", action="store_true",
                    help=f"leave out {', '.join(SLOW)}")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    failures = 0
    for key, title, fn in sections(args.device):
        if args.skip_slow and key in SLOW:
            continue
        print("\n" + "=" * 72)
        print(f"### {title}")
        print("=" * 72)
        t0 = time.time()
        try:
            fn()
        except Exception:
            failures += 1
            traceback.print_exc()
        print(f"[{time.time() - t0:.1f}s]")
    print("\n" + ("ALL BENCHMARKS OK" if failures == 0
                  else f"{failures} BENCHMARK SECTIONS FAILED"))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
