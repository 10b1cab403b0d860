"""Paper Fig 4b on the port: AbsRel with vs without Table-1 hybrid quantization.

    PYTHONPATH=src python -m repro_torch.benchmarks.fig4b_quant [--device cpu]

Claim reproduced: "The maximum AbsRel difference before and after
quantization is about 1.01%." Same sequences, sizes, options and
`claim_ok` threshold as the reference's `benchmarks/fig4b_quant.py`,
plus kernel rows beside both (nearest) rows that must equal them. Writes
the `fig4b_quant` section of `BENCH_emvs_torch.json`.
"""
from __future__ import annotations

import argparse

from repro_torch.benchmarks._emvs_common import device_label, table_rows, update_bench_json
from repro_torch.core.pipeline import EMVSOptions

ROWS = {"float32": EMVSOptions(quantized=False),
        "table1_quantized": EMVSOptions(quantized=True)}


def run(device: str = "cuda") -> dict:
    rows = table_rows(ROWS, device)
    for r in rows.values():
        r["gap"] = abs(r["table1_quantized"] - r["float32"])
    worst_gap = max(r["gap"] for r in rows.values())
    return {"rows": rows, "max_gap": worst_gap, "paper_claim_max_gap": 0.0101,
            "claim_ok": bool(worst_gap < 0.04), **device_label(device)}


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    out = run(ap.parse_args(argv).device)
    print(f"== Fig 4b: Table-1 quantization impact (AbsRel) on {out['device']} ==")
    print(f"{'sequence':22s} {'float32':>9s} {'quant':>9s} {'kernel f':>9s} "
          f"{'kernel q':>9s} {'gap':>8s}")
    for seq, r in out["rows"].items():
        print(f"{seq:22s} {r['float32']:9.4f} {r['table1_quantized']:9.4f} "
              f"{r['float32_kernel']:9.4f} {r['table1_quantized_kernel']:9.4f} "
              f"{r['gap']:8.4f}")
    print(f"max gap {out['max_gap']:.4f} (paper: ~{out['paper_claim_max_gap']:.4f}; "
          f"{'OK' if out['claim_ok'] else 'VIOLATED'})")
    print(f"wrote {update_bench_json('fig4b_quant', out)}")
    return out


if __name__ == "__main__":
    main()
