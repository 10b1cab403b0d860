"""Static analysis of the port's sweep datapaths.

Counterpart of `repro.analysis`: a linter that traces every sweep program
(formulation x backend x voting x quantization) on fake tensors, without
executing it, and enforces the quantization contracts of Table 1:

- ``dtype_flow``: abstract interpretation over the recorded aten graph —
  worst-case value intervals, fractional-value tracking and clamp
  provenance — proving the int32 accumulator / int16 saturating store
  cannot silently wrap, and flagging float->int casts that discard
  fractional bilinear votes, float->bool casts that turn fractional
  weights into whole votes (fault C1), f64 promotions and Python scalar
  outputs.
- ``rules``: the typed, suppressible rule set (dtype-flow/overflow,
  host-sync detection, the variant-space audit).
- ``lint``: the ``python -m repro_torch.analysis.lint`` CLI and the
  program grid it checks, gated against the port's baseline
  (``baseline.json`` beside this file).
"""
from repro_torch.analysis.dtype_flow import AbsVal, DtypeFlowAnalyzer, analyze_program
from repro_torch.analysis.findings import Finding, Provenance, load_baseline, write_baseline
from repro_torch.analysis.rules import (
    DtypeFlowRule,
    HostSyncRule,
    audit_variant_space,
    default_rules,
)

__all__ = [
    "AbsVal",
    "DtypeFlowAnalyzer",
    "DtypeFlowRule",
    "Finding",
    "HostSyncRule",
    "Provenance",
    "analyze_program",
    "audit_variant_space",
    "default_rules",
    "load_baseline",
    "write_baseline",
]
