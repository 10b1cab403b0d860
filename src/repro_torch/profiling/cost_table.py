"""Persisted, schema-versioned table of measured sweep wall times
(counterpart of `repro.profiling.cost_table`; the JSON schema is the
reference's).

One table entry aggregates warm wall-time observations for one sweep
variant.  The key axes are the dispatcher's variant axes
(``enumerate_variant_space``): segment bucket, frame capacity, sweep
backend, plus the datapath flags that select a distinct program
(interpolation, quantized).  Writes are atomic (tempfile + ``os.replace``)
so a crashed recorder can never leave a torn table behind.
"""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass

COST_TABLE_SCHEMA_VERSION = 1

# The backend axis is "{sweep}" for the default matmul formulation and
# "{sweep}+{formulation}" otherwise — the voting formulation selects a
# distinct sweep (the CUDA kernels B1 and B2 most importantly),
# so it must be a cost-table key axis or the DispatchPlanner would price
# the fused kernel sweep with matmul-sweep timings.
_SWEEPS = ("batched", "sharded")
_FORMULATION_SUFFIXES = ("", "+scatter", "+kernel")
_BACKENDS = tuple(s + f for s in _SWEEPS for f in _FORMULATION_SUFFIXES)
_INTERPOLATIONS = ("nearest", "bilinear")


def backend_name(sweep: str, formulation: str = "matmul") -> str:
    """Canonical VariantKey.backend for a (sweep, formulation) pair."""
    if sweep not in _SWEEPS:
        raise CostTableError(f"sweep must be one of {_SWEEPS}, got {sweep!r}")
    if formulation == "matmul":
        return sweep
    name = f"{sweep}+{formulation}"
    if name not in _BACKENDS:
        raise CostTableError(
            f"unknown formulation {formulation!r} (no backend {name!r})")
    return name


class CostTableError(ValueError):
    """A cost-table payload violates the schema."""


@dataclass(frozen=True)
class VariantKey:
    """Identity of one sweep variant.

    The tuple of axes is the padded dispatch shape of a sweep plus the
    datapath flags: two dispatches with equal keys run the same kernels
    on the same shapes, so their warm wall times are samples of the same
    cost.
    """

    s_bucket: int
    capacity: int
    backend: str
    interpolation: str
    quantized: bool

    def __post_init__(self) -> None:
        if self.s_bucket < 1:
            raise CostTableError(f"s_bucket must be >= 1, got {self.s_bucket}")
        if self.capacity < 1:
            raise CostTableError(f"capacity must be >= 1, got {self.capacity}")
        if self.backend not in _BACKENDS:
            raise CostTableError(
                f"backend must be one of {_BACKENDS}, got {self.backend!r}"
            )
        if self.interpolation not in _INTERPOLATIONS:
            raise CostTableError(
                f"interpolation must be one of {_INTERPOLATIONS}, "
                f"got {self.interpolation!r}"
            )

    @property
    def rows(self) -> int:
        """Padded segment-rows of work this variant sweeps per dispatch."""
        return self.s_bucket * self.capacity

    def to_str(self) -> str:
        q = "q1" if self.quantized else "q0"
        return (
            f"s{self.s_bucket}/c{self.capacity}/{self.backend}/"
            f"{self.interpolation}/{q}"
        )

    @classmethod
    def from_str(cls, text: str) -> "VariantKey":
        parts = text.split("/")
        if len(parts) != 5 or not parts[0].startswith("s") or not parts[1].startswith("c"):
            raise CostTableError(f"malformed variant key {text!r}")
        s_part, c_part, backend, interpolation, q_part = parts
        if q_part not in ("q0", "q1"):
            raise CostTableError(f"malformed quantized flag in key {text!r}")
        try:
            s_bucket = int(s_part[1:])
            capacity = int(c_part[1:])
        except ValueError as exc:
            raise CostTableError(f"malformed variant key {text!r}") from exc
        return cls(
            s_bucket=s_bucket,
            capacity=capacity,
            backend=backend,
            interpolation=interpolation,
            quantized=(q_part == "q1"),
        )


@dataclass
class _Entry:
    """Aggregated warm wall-time samples for one variant."""

    count: int = 0
    mean_s: float = 0.0
    min_s: float = float("inf")
    max_s: float = 0.0

    def observe(self, wall_s: float) -> None:
        self.count += 1
        # running mean keeps the table append-only under merge
        self.mean_s += (wall_s - self.mean_s) / self.count
        self.min_s = min(self.min_s, wall_s)
        self.max_s = max(self.max_s, wall_s)

    def to_json(self) -> dict:
        return {
            "count": self.count,
            "mean_s": self.mean_s,
            "min_s": self.min_s,
            "max_s": self.max_s,
        }

    @classmethod
    def from_json(cls, payload: dict, *, key: str) -> "_Entry":
        if not isinstance(payload, dict):
            raise CostTableError(f"entry for {key!r} is not an object")
        missing = {"count", "mean_s", "min_s", "max_s"} - payload.keys()
        if missing:
            raise CostTableError(
                f"entry for {key!r} missing fields {sorted(missing)}"
            )
        count = payload["count"]
        if not isinstance(count, int) or count < 1:
            raise CostTableError(
                f"entry for {key!r} has invalid count {count!r}"
            )
        stats = {}
        for field in ("mean_s", "min_s", "max_s"):
            val = payload[field]
            if not isinstance(val, (int, float)) or isinstance(val, bool) or val < 0:
                raise CostTableError(
                    f"entry for {key!r} has invalid {field} {val!r}"
                )
            stats[field] = float(val)
        if not stats["min_s"] <= stats["mean_s"] <= stats["max_s"]:
            raise CostTableError(
                f"entry for {key!r} violates min <= mean <= max: {stats}"
            )
        return cls(count=count, mean_s=stats["mean_s"],
                   min_s=stats["min_s"], max_s=stats["max_s"])


class CostTable:
    """Warm sweep wall times keyed by :class:`VariantKey`.

    The table is a measurement artifact, not config: benchmarks and the
    opt-in :class:`~repro_torch.profiling.recorder.SweepProfiler` populate it,
    :func:`~repro_torch.profiling.cost_model.fit_affine_model` fits a model
    from it, and its schema is validated without executing a sweep.
    """

    def __init__(self) -> None:
        self._entries: dict[VariantKey, _Entry] = {}

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: VariantKey) -> bool:
        return key in self._entries

    def keys(self):
        return self._entries.keys()

    def record(self, key: VariantKey, wall_s: float) -> None:
        if wall_s < 0:
            raise CostTableError(f"negative wall time {wall_s!r}")
        self._entries.setdefault(key, _Entry()).observe(float(wall_s))

    def mean_s(self, key: VariantKey) -> float | None:
        entry = self._entries.get(key)
        return entry.mean_s if entry is not None else None

    def entry_stats(self, key: VariantKey) -> dict | None:
        entry = self._entries.get(key)
        return entry.to_json() if entry is not None else None

    def to_json(self) -> dict:
        return {
            "schema_version": COST_TABLE_SCHEMA_VERSION,
            "entries": {
                key.to_str(): entry.to_json()
                for key, entry in sorted(
                    self._entries.items(), key=lambda kv: kv[0].to_str()
                )
            },
        }

    @classmethod
    def from_json(cls, payload: dict) -> "CostTable":
        if not isinstance(payload, dict):
            raise CostTableError("cost table payload is not an object")
        version = payload.get("schema_version")
        if version != COST_TABLE_SCHEMA_VERSION:
            raise CostTableError(
                f"unsupported cost-table schema version {version!r} "
                f"(expected {COST_TABLE_SCHEMA_VERSION})"
            )
        entries = payload.get("entries")
        if not isinstance(entries, dict):
            raise CostTableError("cost table 'entries' is not an object")
        table = cls()
        for key_str, entry_payload in entries.items():
            key = VariantKey.from_str(key_str)
            table._entries[key] = _Entry.from_json(entry_payload, key=key_str)
        return table

    def save(self, path: str) -> None:
        """Atomically persist the table (tempfile + ``os.replace``)."""
        payload = self.to_json()
        directory = os.path.dirname(os.path.abspath(path)) or "."
        fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as fh:
                json.dump(payload, fh, indent=2, sort_keys=True)
                fh.write("\n")
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    @classmethod
    def load(cls, path: str) -> "CostTable":
        with open(path) as fh:
            return cls.from_json(json.load(fh))

    def merge(self, other: "CostTable") -> None:
        """Fold another table's samples into this one (count-weighted)."""
        for key, entry in other._entries.items():
            mine = self._entries.get(key)
            if mine is None:
                self._entries[key] = _Entry(
                    count=entry.count, mean_s=entry.mean_s,
                    min_s=entry.min_s, max_s=entry.max_s,
                )
            else:
                total = mine.count + entry.count
                mine.mean_s = (
                    mine.mean_s * mine.count + entry.mean_s * entry.count
                ) / total
                mine.count = total
                mine.min_s = min(mine.min_s, entry.min_s)
                mine.max_s = max(mine.max_s, entry.max_s)
