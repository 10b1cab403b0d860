"""Finding / Provenance dataclasses and the suppression baseline.

Counterpart of `repro.analysis.findings`. A ``Finding`` is one rule
violation with its provenance in the traced aten graph: the operation,
the source line of the Python call that dispatched it, and the enclosing
Python functions of the traced program, outermost first.

Suppression is baseline-driven: every finding has a stable
``fingerprint`` (rule, kind, entry point, operation, source function —
deliberately *not* the line number, which churns under unrelated
edits).  Fingerprints listed in the checked-in baseline JSON are
reported as suppressed and do not fail the lint; anything new does.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Iterable


@dataclasses.dataclass(frozen=True)
class Provenance:
    """Where in the traced program a finding was raised."""

    primitive: str  # aten operation, e.g. "aten._to_copy.default"
    source: str  # e.g. "repro_torch/core/voting.py:155 (vote_scatter)"
    call_stack: tuple[str, ...] = ()  # enclosing functions of the program, outermost first
    eqn: str = ""  # the operation with its operands' shapes (truncated)

    def render(self) -> str:
        stack = " > ".join(self.call_stack) if self.call_stack else "<top>"
        return f"{self.primitive} @ {self.source} [{stack}]"


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation in one traced program."""

    rule: str  # rule id, e.g. "dtype-flow"
    kind: str  # finding class within the rule, e.g. "float-to-int-truncation"
    entry: str  # traced program name, e.g. "sweep[matmul,batched,bilinear,quant]"
    message: str
    provenance: Provenance
    severity: str = "error"  # "error" | "warning"

    @property
    def fingerprint(self) -> str:
        # Source *function* (file + defining function), not the line:
        # "voting.py:155 (vote_scatter)" -> "voting.py (vote_scatter)".
        src = self.provenance.source
        if ":" in src:
            head, _, tail = src.partition(":")
            fn = tail.partition(" ")[2] if " " in tail else ""
            src = f"{head.rsplit('/', 1)[-1]} {fn}".strip()
        return ":".join(
            (self.rule, self.kind, self.entry, self.provenance.primitive, src)
        )

    def render(self) -> str:
        return (
            f"[{self.severity}] {self.rule}/{self.kind} in {self.entry}: "
            f"{self.message}\n    at {self.provenance.render()}"
        )

    def to_json(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        d["provenance"]["call_stack"] = list(self.provenance.call_stack)
        d["fingerprint"] = self.fingerprint
        return d


def load_baseline(path: str) -> set[str]:
    """Read the suppression baseline: a set of finding fingerprints."""
    with open(path) as fh:
        data = json.load(fh)
    return set(data.get("suppressed", []))


def write_baseline(path: str, findings: Iterable[Finding]) -> None:
    fps = sorted({f.fingerprint for f in findings})
    with open(path, "w") as fh:
        json.dump({"suppressed": fps}, fh, indent=2)
        fh.write("\n")


def split_by_baseline(
    findings: Iterable[Finding], baseline: set[str]
) -> tuple[list[Finding], list[Finding]]:
    """Partition findings into (new, suppressed) against the baseline."""
    new: list[Finding] = []
    suppressed: list[Finding] = []
    for f in findings:
        (suppressed if f.fingerprint in baseline else new).append(f)
    return new, suppressed
