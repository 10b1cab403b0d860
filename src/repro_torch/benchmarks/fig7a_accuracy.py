"""Paper Fig 7a on the port: AbsRel per sequence, original EMVS vs the
reformulated framework (rescheduled + nearest voting + Table-1 quantization).

    PYTHONPATH=src python -m repro_torch.benchmarks.fig7a_accuracy [--device cpu]

Claim reproduced: the simulated sequences favour the original slightly
(max diff < 1.78%); slider sequences can even favour the reformulation.
Same sequences, sizes, options and `claim_ok` threshold as the
reference's `benchmarks/fig7a_accuracy.py`, plus a `reformulated_kernel`
row that must equal the matmul row. Writes the `fig7a_accuracy` section
of `BENCH_emvs_torch.json`.
"""
from __future__ import annotations

import argparse

from repro_torch.benchmarks._emvs_common import device_label, table_rows, update_bench_json
from repro_torch.core.pipeline import EMVSOptions

ORIGINAL = EMVSOptions(voting="bilinear", quantized=False, formulation="scatter")
REFORMULATED = EMVSOptions(voting="nearest", quantized=True, formulation="matmul")
ROWS = {"original_emvs": ORIGINAL, "reformulated": REFORMULATED}


def run(device: str = "cuda") -> dict:
    rows = table_rows(ROWS, device)
    for r in rows.values():
        r["diff"] = r["reformulated"] - r["original_emvs"]
    worst = max(r["diff"] for r in rows.values())
    return {"rows": rows, "max_regression": worst, "paper_claim_max_diff": 0.0178,
            "claim_ok": bool(worst < 0.05), **device_label(device)}


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    out = run(ap.parse_args(argv).device)
    print(f"== Fig 7a: original EMVS vs reformulated (AbsRel) on {out['device']} ==")
    print(f"{'sequence':22s} {'original':>9s} {'reformed':>9s} {'kernel':>9s} {'diff':>8s}")
    for seq, r in out["rows"].items():
        print(f"{seq:22s} {r['original_emvs']:9.4f} {r['reformulated']:9.4f} "
              f"{r['reformulated_kernel']:9.4f} {r['diff']:+8.4f}")
    print(f"max regression {out['max_regression']:+.4f} "
          f"(paper: <{out['paper_claim_max_diff']:.4f}; "
          f"{'OK' if out['claim_ok'] else 'VIOLATED'})")
    print(f"wrote {update_bench_json('fig7a_accuracy', out)}")
    return out


if __name__ == "__main__":
    main()
