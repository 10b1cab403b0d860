"""The typed lint rules driven by the dtype-flow interpreter.

Counterpart of `repro.analysis.rules`. Three rule families, matching
docs/quantization_contracts.md:

- :class:`DtypeFlowRule` — quantization/overflow contracts over value
  flow: fractional float->int casts without a sanctioned clamp (the
  bilinear-truncation class), float->bool casts of possibly fractional
  weights (fault C1: a fractional vote turned into a whole one), proven
  integer overflow (accumulations and narrowing casts), f64 promotions,
  and Python scalars left as program outputs (torch's weak types).
- :class:`HostSyncRule` — host round trips inside a dispatched sweep:
  `.item()` and other values read back (`aten._local_scalar_dense`),
  device-to-host copies, data-dependent shapes (`nonzero`,
  `masked_select`) and `torch.cuda.synchronize`.
- :func:`audit_variant_space` — the recompilation audit over the port's
  `serving/sweep_dispatcher.py::enumerate_variant_space`: the
  |S buckets| x |capacities| bound and its coverage.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.analysis.dtype_flow import (
    CONVERSIONS,
    AbsVal,
    Context,
    Node,
    Rule,
    TRef,
    _is_bool,
    _is_float,
    _is_int,
    absval_from_literal,
    int_range,
)
from repro_torch.analysis.findings import Finding, Provenance

_INT_MAX_TRACKED = (torch.int8, torch.int16, torch.int32, torch.int64)


class DtypeFlowRule(Rule):
    """Quantization-contract checks on dtype and value flow."""

    rule_id = "dtype-flow"

    def on_node(self, ctx: Context, node: Node, ins: list[AbsVal],
                outs: list[AbsVal]) -> None:
        if node.name.rstrip("_") in CONVERSIONS and outs:
            a = _conversion_source(node, ins)
            if a is not None:
                self._check_convert(ctx, node, a, outs[0])
        else:
            self._check_int_growth(ctx, node, outs)
        for out in outs:
            if out.dtype in (torch.float64, torch.complex128):
                ctx.report(
                    node, self.rule_id, "f64-promotion",
                    f"{node.target} produces {str(out.dtype).replace('torch.', '')}; the "
                    "datapaths are f32/int — an f64 promotion doubles bandwidth and "
                    "breaks the fixed-point contracts")
                break
        self._track_int_bounds(ctx, outs)

    def _check_convert(self, ctx: Context, node: Node, a: AbsVal, out: AbsVal) -> None:
        src, dst = a.dtype, out.dtype
        if _is_float(src) and _is_bool(dst):
            # fault C1: a weight cast to a mask counts every nonzero weight as
            # a whole vote; only a value proven 0/1 may become a mask
            if not (a.known and a.integral and a.lo >= 0.0 and a.hi <= 1.0):
                ctx.report(
                    node, self.rule_id, "fractional-weight-to-mask",
                    f"cast {_name(src)}->bool of a possibly-fractional value "
                    f"(bounds [{a.lo}, {a.hi}], integral={a.integral}) turns every "
                    "nonzero weight into a whole vote; keep fractional weights "
                    "float, or prove them 0/1 first")
            return
        if not _is_int(dst) or not (_is_float(src) or _is_int(src)):
            return
        # (1) fractional truncation: a float->int cast of a possibly
        # fractional value is sanctioned only when the operand was just
        # clamped to a range a quant policy declares (clamp provenance):
        # the Table 1 saturating store
        if _is_float(src) and not a.integral and a.clip not in ctx.sanctioned_clips:
            ctx.report(
                node, self.rule_id, "float-to-int-truncation",
                f"cast {_name(src)}->{_name(dst)} of a possibly-fractional value "
                f"(bounds [{a.lo}, {a.hi}], clamp={a.clip}) discards the "
                "fractional part; either round-and-clamp to a declared "
                "fixed-point format first, or keep the accumulator float "
                "(bilinear votes carry fractional weights)")
        # (2) proven wrap: the operand's propagated interval exceeds the
        # target range (float->int, or int->narrower int); dtype defaults of
        # unconstrained inputs are not proofs
        rlo, rhi = int_range(dst)
        if (a.known and math.isfinite(a.lo) and math.isfinite(a.hi)
                and (math.floor(a.lo) < rlo or math.ceil(a.hi) > rhi)
                and a.clip not in ctx.sanctioned_clips):
            ctx.report(
                node, self.rule_id, "int-overflow",
                f"cast to {_name(dst)} can wrap: worst-case value in "
                f"[{a.lo}, {a.hi}] exceeds [{rlo:.0f}, {rhi:.0f}]; clamp to a "
                "declared format before the cast (saturating store)")

    def _check_int_growth(self, ctx: Context, node: Node, outs: list[AbsVal]) -> None:
        # integer arithmetic whose propagated worst case exceeds the dtype
        # range: the accumulate-side wrap (e.g. int16 += votes)
        for out in outs:
            if not _is_int(out.dtype):
                continue
            if not (out.known and math.isfinite(out.lo) and math.isfinite(out.hi)):
                continue
            rlo, rhi = int_range(out.dtype)
            if out.lo < rlo or out.hi > rhi:
                ctx.report(
                    node, self.rule_id, "int-overflow",
                    f"{node.target} on {_name(out.dtype)} can wrap: worst-case "
                    f"value in [{out.lo}, {out.hi}] exceeds [{rlo:.0f}, {rhi:.0f}] "
                    "(accumulate in a wider dtype, or lower the segment capacity)")
                return

    def _track_int_bounds(self, ctx: Context, outs: list[AbsVal]) -> None:
        # publish the proven worst-case [lo, hi] per integer dtype so the
        # CLI can print "int32 accumulator bounded within range" proofs
        for out in outs:
            if out.dtype not in _INT_MAX_TRACKED:
                continue
            if not (out.known and math.isfinite(out.lo) and math.isfinite(out.hi)):
                continue
            ctx.note_int_bound(out.dtype, out.lo, out.hi)

    def on_outputs(self, ctx: Context, outs: list[AbsVal]) -> None:
        for i, out in enumerate(outs):
            if out.weak_type:
                ctx.findings.append(Finding(
                    rule=self.rule_id, kind="weak-type-leak", entry=ctx.entry,
                    message=(f"program output {i} is a Python scalar, not a tensor: "
                             "it re-promotes downstream consumers by Python's rules "
                             "and leaves the device's dtype contract — return a "
                             "tensor of an explicit dtype"),
                    provenance=Provenance(primitive="<output>", source="<program outputs>"),
                    severity="warning"))


def _name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _conversion_source(node: Node, ins: list[AbsVal]) -> AbsVal | None:
    """The abstract value of a conversion's source operand (`ins` holds the
    node's tensor operands in order; `copy_`'s source is its second)."""
    k = CONVERSIONS[node.name.rstrip("_")]
    if k >= len(node.args):
        return None
    src = node.args[k]
    if isinstance(src, TRef):
        tensors = [a for a in node.args if isinstance(a, TRef)]
        j = next(j for j, t in enumerate(tensors) if t is src)
        return ins[j] if j < len(ins) else None
    return absval_from_literal(src) if isinstance(src, (int, float)) else None


# operations that make the host wait on the device, or read device data back
HOST_READBACK_OPS = frozenset({"_local_scalar_dense", "item", "equal", "is_nonzero"})
DYNAMIC_SHAPE_OPS = frozenset({"nonzero", "masked_select", "unique", "_unique2",
                               "unique_consecutive"})


class HostSyncRule(Rule):
    """No host round trips inside streaming-dispatched sweep programs."""

    rule_id = "host-sync"

    def on_node(self, ctx: Context, node: Node, ins: list[AbsVal],
                outs: list[AbsVal]) -> None:
        what = None
        on_device = node.extra.get("in_device", "cpu") != "cpu"
        if on_device and (node.name in HOST_READBACK_OPS or node.extra.get("host_readback")):
            what = "reads a device value back to the host"
        elif node.name in DYNAMIC_SHAPE_OPS:
            what = "has an output shape that depends on the data (the host waits for it)"
        elif node.name == "cuda_synchronize":
            what = "waits for every queued kernel"
        elif (node.name.rstrip("_") in CONVERSIONS and on_device
              and node.extra.get("out_device") == "cpu"):
            what = "copies device memory to the host"
        if what is not None:
            ctx.report(
                node, self.rule_id, "host-round-trip",
                f"{node.target} {what} inside a streaming-dispatched program; "
                "the dispatch layer relies on sweeps being enqueued "
                "asynchronously (no per-chunk device round trips) — move host "
                "I/O outside the dispatched sweep")


def default_rules() -> list[Rule]:
    return [DtypeFlowRule(), HostSyncRule()]


def audit_variant_space(
    stream_cfg: Any,
    max_segment_frames: int | None,
    *,
    mesh_segments: int = 1,
    entry: str = "variant-space",
) -> tuple[list[Finding], dict[str, Any]]:
    """Recompilation audit over the dispatcher's variant space.

    The port compiles nothing per shape, but the bound is what keeps a
    cost table (one row per variant) and the pool of staged batches
    finite. Enumerates every (S bucket, frame capacity) shape the
    dispatcher can stage for ``stream_cfg`` (via
    :func:`repro_torch.serving.sweep_dispatcher.enumerate_variant_space`)
    and checks:

    - the space is bounded at all (``max_segment_frames`` declared);
    - |variants| == |S buckets| x |capacities| and the shard-rounded S
      buckets never exceed the configured bucket count;
    - coverage: every dispatchable group size and frame count maps into
      an enumerated variant;
    - planner usage: the actual ``DispatchPlanner`` is driven over
      exhaustive single-capacity and mixed loads (every frame count up
      to ``max_segment_frames``, every queue depth up to one past the
      top S bucket, both fairness policies) and every group it emits
      must land on an enumerated (S bucket, capacity) variant.
    """
    from repro_torch.core.pipeline import DispatchPlanner, bucket_capacity
    from repro_torch.serving.sweep_dispatcher import enumerate_variant_space

    findings: list[Finding] = []

    def report(kind: str, message: str) -> None:
        findings.append(Finding(
            rule="recompilation", kind=kind, entry=entry, message=message,
            provenance=Provenance(
                primitive="<StreamConfig>",
                source=f"segment_buckets={tuple(stream_cfg.segment_buckets)} "
                f"sweep={stream_cfg.sweep} mesh_segments={mesh_segments}")))

    if not max_segment_frames or max_segment_frames <= 0:
        report("unbounded-variant-space",
               "no max_segment_frames declared: the capacity axis of the "
               "variant space is unbounded, so a long-running service can grow "
               "its cost table and staging pool without limit")
        return findings, {"s_buckets": (), "capacities": (), "variants": 0,
                          "bound": None}

    space = enumerate_variant_space(stream_cfg, max_segment_frames,
                                    mesh_segments=mesh_segments)
    s_buckets = space["s_buckets"]
    capacities = space["capacities"]
    variants = space["variants"]
    bound = len(stream_cfg.segment_buckets) * len(capacities)

    if len(variants) != len(s_buckets) * len(capacities):
        report("variant-bound-violated",
               f"enumerated {len(variants)} variants but |S buckets| x "
               f"|capacities| = {len(s_buckets) * len(capacities)}")
    if len(s_buckets) > len(stream_cfg.segment_buckets):
        report("variant-bound-violated",
               f"shard rounding produced {len(s_buckets)} S buckets from "
               f"{len(stream_cfg.segment_buckets)} configured — rounding must "
               "only merge buckets, never split them")

    top = max(s_buckets)
    for n in range(1, top + 1):
        b = next((x for x in s_buckets if x >= n), None)
        if b is None or b not in s_buckets:
            report("variant-coverage-gap",
                   f"group of {n} segments does not map to an enumerated S bucket")
            break
    for f in range(1, max_segment_frames + 1):
        if bucket_capacity(f) not in capacities:
            report("variant-coverage-gap",
                   f"{f} frames pads to capacity {bucket_capacity(f)}, which is "
                   "not in the enumerated capacity set")
            break

    planner = DispatchPlanner(tuple(s_buckets))
    variant_set = {(s, c) for s in s_buckets for c in capacities}
    groups_checked = 0

    def check_groups(groups) -> bool:
        nonlocal groups_checked
        for group, cap in groups:
            groups_checked += 1
            b = next((x for x in s_buckets if x >= len(group)), None)
            if b is None or (b, cap) not in variant_set:
                report("variant-coverage-gap",
                       f"planner emitted a group of {len(group)} segments at "
                       f"capacity {cap} -> variant ({b}, {cap}) outside the "
                       f"enumerated space")
                return False
        return True

    ok = True
    for f in range(1, max_segment_frames + 1):
        for n in range(1, top + 2):  # one past the top bucket: must split
            segs = [(k * f, (k + 1) * f) for k in range(n)]
            ok = ok and check_groups(planner.plan(segs))
        if not ok:
            break
    if ok:
        segs, frame = [], 0
        for f in range(1, max_segment_frames + 1):
            segs.append((frame, frame + f))
            frame += f
        items = [(k % 2, seg) for k, seg in enumerate(segs)]
        for fairness in ("fifo", "round_robin"):
            check_groups(planner.plan_tagged(items, fairness=fairness))

    summary = {
        "s_buckets": tuple(s_buckets),
        "capacities": tuple(capacities),
        "variants": len(variants),
        "bound": bound,
        "planner_groups_checked": groups_checked,
    }
    return findings, summary
