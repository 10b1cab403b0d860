"""Find the highest event rate a live cell's engine sustains.

    python3 bench/tools/knee.py --workload davis240.live --rates 3e5 4e5 5e5

Runs the cell's open loop once per offered rate (`rate_events_per_s`
replaced, all else as the traffic file states) and prints, per rate, the
latency median and 95th percentile, the medians of the window's first and
last quarter of segments, and whether the load held: the last quarter's
median within 1.5 times the first's plus 5 ms, no segment missing, and
the generator, which shares the host thread with the engine, offering 95%
of its items within 20 ms of their due time (a host that cannot offer
the load on time has a backlog of its own, even where coalescing keeps
the engine's latency flat). The cell's rate is set to about four fifths
of the highest rate that holds.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from bench.harness import cli, live  # noqa: E402
from bench.harness.trace import Tracer  # noqa: E402

LATE_LIMIT_MS = 20.0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=None,
                    help="window of each rate (default: BENCHMARK.json's run_seconds)")
    ap.add_argument("--seed", type=int, default=20261018)
    args = ap.parse_args()
    spec = cli.load_spec()
    seconds = float(spec["run_seconds"]) if args.seconds is None else args.seconds
    for rate in args.rates:
        cell, cfg, tr = cli.resolve(spec, args.workload)
        tr["rate_events_per_s"] = rate
        r = cli.Run(spec=spec, cell=cell, cfg=cfg, traffic=tr, seed=args.seed,
                    seconds=seconds, trace=False, device=torch.device("cuda:0"),
                    t_start=time.perf_counter(), tracer=Tracer(False))
        out = live.run(r)
        e = out.end_to_end
        first, last = e.get("first_quarter_p50_ms"), e.get("last_quarter_p50_ms")
        late = e["generator_late_p95_ms"]
        held = (out.failed == 0 and first is not None and last <= 1.5 * first + 5.0
                and late <= LATE_LIMIT_MS)
        print(json.dumps({"rate": rate, "attempted": out.attempted, "failed": out.failed,
                          "p50_ms": e["depth_p50_ms"], "p95_ms": e["depth_p95_ms"],
                          "first_q_ms": first, "last_q_ms": last,
                          "generator_late_p95_ms": late, "held": held,
                          "checks": out.checks}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
