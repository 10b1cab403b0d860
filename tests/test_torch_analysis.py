"""The port's quantization-contract linter (`repro_torch.analysis`): the
dtype-flow interpreter over recorded aten graphs, the rule set, the
baseline mechanics and the CLI grid.

The fixtures are the reference's (`tests/test_analysis.py`) written in
torch, with the verdicts those tests assert: deliberately broken
programs that must be caught, and sanctioned ones that must lint clean.
Five of the reference's tests fail on jax 0.9.0 (the saturating store,
the host-sync callback, the f64 promotion, the quick grid, the full
grid); the port is held to the verdict each of them asserts, not to the
reference's current output. One fixture is the port's own: fault C1,
float weights cast to a bool mask before voting, must be caught. The
grid entries trace on the CPU (the plain versions) and on the meta device
(the card's program, its kernels as single operations).
"""
from __future__ import annotations

import json

import pytest
import torch
import torch.distributed as dist

from repro.quant.policies import TABLE1 as J_TABLE1
from repro_torch.analysis import lint as lint_cli
from repro_torch.analysis.dtype_flow import analyze_program, contract
from repro_torch.analysis.findings import (
    Finding,
    Provenance,
    load_baseline,
    split_by_baseline,
    write_baseline,
)
from repro_torch.analysis.rules import audit_variant_space, default_rules
from repro_torch.launch.graph_analysis import fake_mode
from repro_torch.quant.policies import TABLE1

SAT_INT16 = frozenset({(-32768.0, 32767.0)})


def _lint(fn, shapes, bounds=None, *, device="cpu", entry="fixture",
          clips=SAT_INT16):
    """Trace `fn` on fake tensors of `shapes` ((shape, dtype) pairs) and run
    the default rules; `bounds` gives each input's (lo, hi, integral)."""
    fm = fake_mode()
    with fm:
        args = [torch.empty(s, dtype=d, device=device) for s, d in shapes]
    contracts = None if bounds is None else [contract(t, *b) for t, b in zip(args, bounds)]
    return analyze_program(fn, args, contracts, entry=entry, rules=default_rules(),
                           fake=fm, sanctioned_clips=clips)


F32 = torch.float32


# ---------------------------------------------------------------------------
# fractional votes narrowed to integers: caught; the sanctioned store: clean
# ---------------------------------------------------------------------------


def test_int_allreduce_of_fractional_votes_is_caught():
    """The bilinear-truncation pattern: bilinear (fractional) votes narrowed to
    an integer dtype before an integer all-reduce across ranks."""
    import torch.distributed._functional_collectives as funcol

    from repro_torch.distributed.emvs import local_process_group

    def fixture(votes):  # (S, E) fractional bilinear weights in [0, 1]
        def local(v):
            dsi = v.sum(dim=0)
            # BUG (on purpose): narrows fractional votes to int before the sum
            return funcol.all_reduce(dsi.to(torch.int32), "sum", dist.group.WORLD)

        return local(votes)

    with local_process_group("cpu"):
        ctx = _lint(fixture, [((1, 8), F32)], [(0.0, 1.0, False)], entry="fixture-truncation")
    truncs = [f for f in ctx.findings if f.kind == "float-to-int-truncation"]
    assert truncs, "the bug pattern must be a dtype-flow finding"
    f = truncs[0]
    # provenance: the operation, the source line, the enclosing functions
    assert f.rule == "dtype-flow"
    assert f.provenance.primitive == "aten._to_copy.default"
    assert "test_torch_analysis" in f.provenance.source
    assert "(local)" in f.provenance.source and "fixture" in f.provenance.call_stack


def test_sanctioned_saturating_store_is_clean():
    """round + clamp to a declared format + cast is the Table 1 store."""

    def store(votes):
        return torch.clamp(torch.round(votes), -32768, 32767).to(torch.int16)

    ctx = _lint(store, [((8,), F32)], [(0.0, 1e6, False)], entry="store")
    assert ctx.findings == []


def test_unclamped_fractional_cast_is_caught_even_in_range():
    ctx = _lint(lambda v: v.to(torch.int16), [((8,), F32)], [(0.0, 0.75, False)])
    assert [f.kind for f in ctx.findings] == ["float-to-int-truncation"]


def test_clamp_to_undeclared_bounds_is_not_sanctioned():
    ctx = _lint(lambda v: torch.clamp(v, 0.0, 100.0).to(torch.int16), [((8,), F32)],
                [(0.0, 1e6, False)])
    assert [f.kind for f in ctx.findings] == ["float-to-int-truncation"]


@pytest.mark.parametrize("proven", [False, True], ids=["fractional", "proven-0-1"])
def test_fractional_weights_cast_to_mask_before_voting(proven):
    """Fault C1's class: float weights turned into a bool mask count every
    nonzero weight as a whole vote. Weights proven 0/1 may become a mask."""
    from repro_torch.core.voting import vote_scatter

    def fixture(x_i, y_i, weights):
        mask = weights.to(torch.bool)  # 0.5 -> True: a whole vote
        dsi = torch.zeros((2, 24, 32), dtype=torch.int32)
        return vote_scatter(dsi, x_i, y_i, w=32, h=24, weights=mask.to(F32))

    bounds = [(-10.0, 40.0, False), (-10.0, 40.0, False), (0.0, 1.0, proven)]
    ctx = _lint(fixture, [((2, 16), F32)] * 3, bounds, entry="fixture-c1")
    kinds = [f.kind for f in ctx.findings]
    if proven:
        assert kinds == []
    else:
        assert kinds == ["fractional-weight-to-mask"]
        assert "(fixture)" in ctx.findings[0].provenance.source


# ---------------------------------------------------------------------------
# overflow proofs
# ---------------------------------------------------------------------------


def _accumulate(dtype):
    def fixture(frames_votes):  # (600, 64) 0/1 vote mask
        acc = torch.zeros((), dtype=dtype)
        for k in range(frames_votes.shape[0]):
            acc = acc + frames_votes[k].sum().to(dtype)
        return acc

    return fixture


def test_int16_accumulator_overflow_is_proven():
    """600 frames x up to 64 votes cannot fit int16: the unrolled
    accumulation proves the wrap."""
    ctx = _lint(_accumulate(torch.int16), [((600, 64), F32)], [(0.0, 1.0, True)])
    kinds = {f.kind for f in ctx.findings}
    assert kinds == {"int-overflow"}
    prims = {f.provenance.primitive for f in ctx.findings}
    assert prims == {"aten.add.Tensor"}


def test_int32_accumulator_headroom_is_proven_not_flagged():
    ctx = _lint(_accumulate(torch.int32), [((600, 64), F32)], [(0.0, 1.0, True)])
    assert [f for f in ctx.findings if f.kind == "int-overflow"] == []
    lo, hi = ctx.facts["int_bounds"]["int32"]
    assert hi >= 600 * 64  # the bound actually propagated
    assert hi < torch.iinfo(torch.int32).max


def test_unknown_ranges_do_not_produce_noise_findings():
    ctx = _lint(lambda a, b: a + b, [((4,), torch.int32)] * 2)
    assert ctx.findings == []


def test_b1_contract_publishes_the_proof_capacity_bound():
    """B1 enters the card's program as one operation: its int32 accumulator
    holds every valid event of every frame on one voxel at worst."""
    from repro_torch.kernels.backproject_vote.kernel import backproject_vote_cuda

    cap, e = lint_cli.PROOF_CAPACITY_FRAMES, 1024

    def fixture(x0, y0, valid, phi):
        return backproject_vote_cuda(x0, y0, valid, phi, cx=15.5, cy=11.5, w=32, h=24,
                                     quantized=True)

    shapes = [((1, cap, e), F32), ((1, cap, e), F32), ((1, cap, e), torch.bool),
              ((1, cap, 8, 3), F32)]
    ctx = _lint(fixture, shapes, None, device="meta",
                clips=TABLE1.sanctioned_clip_bounds())
    assert ctx.findings == []
    assert ctx.facts["int_bounds"]["int32"] == (0.0, float(cap * e))
    assert cap * e > torch.iinfo(torch.int16).max  # so the store must saturate


# ---------------------------------------------------------------------------
# host sync / f64 / Python scalar outputs
# ---------------------------------------------------------------------------


def _item(x):
    x.sum().item()
    return x * 2


def _synchronize(x):
    torch.cuda.synchronize()
    return x * 2


def _to_host(x):
    return x.cpu() * 2


def _nonzero(x):
    return torch.nonzero(x > 0)


@pytest.mark.parametrize("fixture,prim", [
    (_item, "aten._local_scalar_dense.default"),
    (_synchronize, "torch.cuda.synchronize"),
    (_to_host, "aten._to_copy.default"),
    (_nonzero, "aten.nonzero.default"),
], ids=["item", "synchronize", "to-host", "nonzero"])
def test_host_sync_is_caught(fixture, prim):
    """On the card's program (meta tensors) a value read back, a device
    synchronize, a device-to-host copy or a shape that depends on the data
    is one host-sync finding each."""
    ctx = _lint(fixture, [((4,), F32)], device="meta", entry="fixture-hostsync")
    hs = [f for f in ctx.findings if f.rule == "host-sync"]
    assert len(hs) == 1
    assert hs[0].provenance.primitive == prim


def test_host_reads_of_host_tensors_are_not_syncs():
    ctx = _lint(_item, [((4,), F32)], device="cpu")
    assert [f for f in ctx.findings if f.rule == "host-sync"] == []


def test_f64_promotion_is_caught():
    ctx = _lint(lambda x: x.to(torch.float64) * 2.0, [((4,), F32)])
    assert "f64-promotion" in {f.kind for f in ctx.findings}


def test_python_scalar_output_is_warned():
    ctx = _lint(lambda x: (torch.sum(x), 6.0), [((4,), F32)])
    weak = [f for f in ctx.findings if f.kind == "weak-type-leak"]
    assert weak and all(f.severity == "warning" for f in weak)


# ---------------------------------------------------------------------------
# recompilation audit
# ---------------------------------------------------------------------------


def test_variant_space_bound_holds_for_default_config():
    from repro_torch.serving.emvs_stream import StreamConfig

    cfg = StreamConfig()
    findings, summary = audit_variant_space(cfg, 64)
    assert findings == []
    assert summary["variants"] <= summary["bound"]
    assert summary["s_buckets"] == tuple(cfg.segment_buckets)
    assert all(c % 4 == 0 for c in summary["capacities"])


def test_variant_space_shard_rounding_merges_buckets():
    from repro_torch.serving.emvs_stream import StreamConfig
    from repro_torch.serving.sweep_dispatcher import enumerate_variant_space

    cfg = StreamConfig(sweep="sharded")
    space = enumerate_variant_space(cfg, 16, mesh_segments=8)
    assert space["s_buckets"] == (8,)
    assert len(space["variants"]) == len(space["capacities"])
    findings, summary = audit_variant_space(cfg, 16, mesh_segments=8)
    assert findings == []
    assert summary["variants"] <= summary["bound"]


def test_unbounded_variant_space_is_a_finding():
    from repro_torch.serving.emvs_stream import StreamConfig

    findings, _ = audit_variant_space(StreamConfig(), None)
    assert [f.kind for f in findings] == ["unbounded-variant-space"]
    assert findings[0].rule == "recompilation"


# ---------------------------------------------------------------------------
# baseline / suppression mechanics
# ---------------------------------------------------------------------------


def _dummy_finding(kind="float-to-int-truncation", line=10):
    return Finding(
        rule="dtype-flow", kind=kind, entry="sweep[matmul,batched,bilinear,quant]",
        message="m",
        provenance=Provenance(primitive="aten._to_copy.default",
                              source=f"repro_torch/core/voting.py:{line} (vote_scatter)"))


def test_fingerprint_is_stable_across_line_churn():
    assert _dummy_finding(line=10).fingerprint == _dummy_finding(line=99).fingerprint


def test_fingerprint_and_baseline_format_equal_reference(tmp_path):
    from repro.analysis import findings as j_findings

    args = dict(rule="dtype-flow", kind="int-overflow", entry="kernel[nearest,quant]",
                message="m")
    prov = dict(primitive="aten.add.Tensor", source="repro_torch/core/dsi.py:60 (to_storage)")
    mine = Finding(**args, provenance=Provenance(**prov))
    ref = j_findings.Finding(**args, provenance=j_findings.Provenance(**prov))
    assert mine.fingerprint == ref.fingerprint
    write_baseline(str(tmp_path / "port.json"), [mine])
    j_findings.write_baseline(str(tmp_path / "ref.json"), [ref])
    assert (tmp_path / "port.json").read_text() == (tmp_path / "ref.json").read_text()
    assert j_findings.load_baseline(str(tmp_path / "port.json")) == {mine.fingerprint}


def test_baseline_roundtrip_and_suppression(tmp_path):
    f1 = _dummy_finding()
    f2 = _dummy_finding(kind="int-overflow")
    path = tmp_path / "baseline.json"
    write_baseline(str(path), [f1])
    new, suppressed = split_by_baseline([f1, f2], load_baseline(str(path)))
    assert suppressed == [f1]
    assert new == [f2]


def test_sanctioned_clips_equal_reference():
    assert TABLE1.sanctioned_clip_bounds() == J_TABLE1.sanctioned_clip_bounds()


# ---------------------------------------------------------------------------
# the shipped grid: every sweep program lints clean against the baseline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_quick_grid_lints_clean(tmp_path, device):
    out = tmp_path / "findings.json"
    rc = lint_cli.main(["--grid", "quick", "--device", device, "--json", str(out)])
    assert rc == 0
    data = json.loads(out.read_text())
    assert data["new"] == []
    assert data["report"]["entries"] == [
        f"sweep[matmul,batched,{v},{q}]" for v in ("nearest", "bilinear")
        for q in ("float", "quant")]


def test_full_grid_lints_clean_with_proofs():
    """The card's program (meta) over the whole grid: no finding outside
    the port's baseline (its suppressions are the float64 clamp of the
    saturating float->int32 conversion, `quant/fixed_point.py`)."""
    findings, report = lint_cli.run_lint("full", "meta")
    new, suppressed = split_by_baseline(findings, load_baseline(lint_cli.BASELINE))
    assert new == [], [f.render() for f in new]
    assert {f.kind for f in suppressed} <= {"f64-promotion"}
    assert len(report["entries"]) == 3 * 2 * 2 * 2 + 4
    proofs = report["int_bound_proofs"]
    assert proofs["int32"]["headroom"] >= 0
    assert proofs["int16"]["headroom"] >= 0
    for summary in report["variant_space"].values():
        assert summary["variants"] <= summary["bound"]


def test_broken_policy_would_be_caught_end_to_end():
    """Negative control for the gate: a quantized bilinear sweep with the
    sanctioned clamps emptied surfaces the int16 store as a truncation."""
    entry = next(e for e in lint_cli.build_entries("quick", "cpu")
                 if e["name"] == "sweep[matmul,batched,bilinear,quant]")

    class NoSanction:
        @staticmethod
        def sanctioned_clip_bounds():
            return frozenset()

    entry["policy"] = NoSanction()
    findings, _ = lint_cli.lint_entry(entry)
    assert "float-to-int-truncation" in {f.kind for f in findings}


# ---------------------------------------------------------------------------
# the boundary-inclusive saturation monitor
# ---------------------------------------------------------------------------


def test_store_saturation_fraction_sees_clipped_volumes():
    from repro_torch.core import dsi as dsi_lib

    info = torch.iinfo(torch.int16)
    hot = torch.full((4, 4), 10 * info.max, dtype=torch.int32)
    stored = dsi_lib.storage_roundtrip(hot)
    assert float(dsi_lib.saturation_fraction(stored)) == 0.0
    assert float(dsi_lib.store_saturation_fraction(stored)) == 1.0
    cold = torch.zeros((4, 4), dtype=torch.int32)
    assert float(dsi_lib.store_saturation_fraction(cold)) == 0.0
