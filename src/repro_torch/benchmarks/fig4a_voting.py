"""Paper Fig 4a on the port: depth-estimation AbsRel, bilinear vs nearest voting.

    PYTHONPATH=src python -m repro_torch.benchmarks.fig4a_voting [--device cpu]

Claim reproduced: "The maximum AbsRel difference between Nearest Voting
and original Bilinear Voting is about 1.18%." Same sequences, sizes,
options and `claim_ok` threshold as the reference's
`benchmarks/fig4a_voting.py`, plus a `nearest_kernel` row (B1 and B2 on
the card, their plain versions on the CPU) that must equal the matmul
row. Writes the `fig4a_voting` section of `BENCH_emvs_torch.json`.
"""
from __future__ import annotations

import argparse

from repro_torch.benchmarks._emvs_common import device_label, table_rows, update_bench_json
from repro_torch.core.pipeline import EMVSOptions

ROWS = {"bilinear": EMVSOptions(voting="bilinear"),
        "nearest": EMVSOptions(voting="nearest")}


def run(device: str = "cuda") -> dict:
    rows = table_rows(ROWS, device)
    for r in rows.values():
        r["gap"] = abs(r["nearest"] - r["bilinear"])
    worst_gap = max(r["gap"] for r in rows.values())
    return {"rows": rows, "max_gap": worst_gap, "paper_claim_max_gap": 0.0118,
            "claim_ok": bool(worst_gap < 0.025), **device_label(device)}


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    out = run(ap.parse_args(argv).device)
    print(f"== Fig 4a: nearest vs bilinear voting (AbsRel) on {out['device']} ==")
    print(f"{'sequence':22s} {'bilinear':>9s} {'nearest':>9s} {'kernel':>9s} {'gap':>8s}")
    for seq, r in out["rows"].items():
        print(f"{seq:22s} {r['bilinear']:9.4f} {r['nearest']:9.4f} "
              f"{r['nearest_kernel']:9.4f} {r['gap']:8.4f}")
    print(f"max gap {out['max_gap']:.4f} (paper: ~{out['paper_claim_max_gap']:.4f}; "
          f"{'OK' if out['claim_ok'] else 'VIOLATED'})")
    print(f"wrote {update_bench_json('fig4a_voting', out)}")
    return out


if __name__ == "__main__":
    main()
