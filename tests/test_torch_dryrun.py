"""The port's dry run (`repro_torch.launch.dryrun`), its summaries
(`benchmarks.summarize_dryrun`, `benchmarks.roofline_report`) and the
benchmark driver (`benchmarks.run`), on the CPU.

The dry run traces on fake tensors: the four one-card cells ("card") must
allocate nothing (the traced arguments alone are gigabytes); the EMVS
cells on the reference's meshes ("single", 256 fake ranks; "multi", 512)
trace its mesh step and count its useful FLOPs (`model_flops_override =
5 * n_votes`); an LM cell traces one rank of each production mesh; a
skipped cell carries only the reference's reason. The reference's
`repro.launch.dryrun` is not imported here: it sets a 512-device XLA flag
at import.
"""
from __future__ import annotations

import json
import math
import resource
import types

import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import shapes as j_shapes
from repro_torch.benchmarks import roofline_report, run as bench_run, summarize_dryrun
from repro_torch.launch import dryrun
from repro_torch.launch import roofline as rf

CELLS = [("eventor-davis240", "emvs_rt"), ("eventor-davis240", "emvs_seg"),
         ("qwen3-8b", "prefill_32k"), ("qwen3-8b", "decode_32k")]


def _max_rss_bytes() -> int:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("arch,cell", CELLS)
def test_run_cell_allocates_nothing(arch, cell, device):
    dryrun.run_cell(arch, cell, "card", device=device)  # imports, caches
    before = _max_rss_bytes()
    rec = dryrun.run_cell(arch, cell, "card", device=device)
    grown = _max_rss_bytes() - before
    assert "skipped" not in rec and rec["devices"] == 1 and rec["device"] == device
    mem = rec["memory"]
    assert mem["argument_bytes"] > 0 and mem["output_bytes"] > 0
    # the traced program holds far more than the process's peak grew by
    assert grown < 16 * 2**20 < mem["argument_bytes"] + mem["peak_temp_bytes"]
    roof = rec["roofline"]
    assert roof["flops"] > 0 and roof["bytes_hbm"] > 0 and roof["n_ops"] > 0
    assert roof["dominant"] in ("compute", "memory")
    kernels = {k["op"] for k in rec["kernels"]}
    if device == "meta":  # the card's program: its kernels as single operations
        want = ({"repro_torch.canonical_project.default", "repro_torch.backproject_vote.default",
                 "repro_torch.depth_argmax.default", "repro_torch.detect_filter.default"}
                if arch == "eventor-davis240" else
                ({"repro_torch.flash_attention.default"} if cell == "prefill_32k" else set()))
        assert kernels == want
    else:
        assert kernels == set()


def test_emvs_seg_b1_bytes_equal_sweep_bound():
    rec = dryrun.run_cell("eventor-davis240", "emvs_seg", "card", device="meta")
    (b1,) = [k for k in rec["kernels"] if "backproject_vote" in k["op"]]
    assert b1["bytes"] == rf.sweep_bytes(1, 256, 1024, 256, 240, 180)
    assert b1["flops"] == rf.sweep_ops(256, 256 * 1024)
    assert b1["outputs"] == (("int16", (1, 256, 180, 240)),)


@pytest.mark.parametrize("cell", ["emvs_rt", "emvs_seg"])
def test_emvs_model_flops_equal_reference(cell):
    """The reference's `_lower_emvs` on each production mesh, traced through
    the port's `make_emvs_step` over a fake group: 256 planes; emvs_rt
    splits its 1024-event packet into data=16 pose-identical slices of 64
    events; multi adds two segments over `pod`; `int16_votes` narrows the
    link. Devices, votes and FLOPs by the reference's formula; one all-reduce
    over `data`, gathers over `model` (and `pod`)."""
    jcell = j_shapes.EMVS_CELLS[cell]
    data, nz = 16, 256
    frames, events = ((data, jcell.seq_len // data) if cell == "emvs_rt"
                      else (jcell.global_batch, jcell.seq_len))
    for mesh, devices, segments in (("single", 256, 1), ("multi", 512, 2)):
        opts = frozenset({"int16_votes"}) if mesh == "multi" else frozenset()
        rec = dryrun.run_cell("eventor-davis240", cell, mesh, device="cpu", opt_flags=opts)
        assert rec["devices"] == devices and rec["opts"] == sorted(opts), rec
        n_votes = segments * frames * events * nz
        assert rec["emvs_votes"] == n_votes
        assert rec["roofline"]["model_flops"] == 5.0 * n_votes
        # each rank sweeps one segment: its votes all-reduced over `data`, its
        # planes gathered over `model`, and on multi the four outputs over `pod`
        assert rec["roofline"]["collectives"]["counts"] == {
            "all-reduce": 1.0, "all-gather": 1.0 + 4.0 * (segments == 2)}, rec["roofline"]
        assert rec["memory"]["argument_bytes"] == rec["memory"]["argument_bytes_global"] == (
            4 * segments * frames * (events * 3 + 1 + 9 + nz * 3))
        assert not torch.distributed.is_initialized()


def test_skip_reasons_name_what_is_missing():
    """The port traces every (arch, cell) the reference does not skip, on
    every mesh: a skipped cell carries only the reference's own reason."""
    for arch in dryrun.ARCHS:
        cfg = j_get_config(arch)
        table = j_shapes.EMVS_CELLS if cfg.family == "emvs" else j_shapes.LM_CELLS
        for cell in table.values():
            ref_reason = j_shapes.cell_skipped(cfg, cell)
            assert dryrun.cell_skipped(dryrun.get_config(arch), cell) == ref_reason
            if ref_reason:
                for mesh in dryrun.MESHES:
                    rec = dryrun.run_cell(arch, cell.name, mesh)
                    assert rec["skipped"] == ref_reason and rec["mesh"] == mesh
    assert not hasattr(dryrun, "port_skip")
    assert "sub-quadratic" in dryrun.run_cell("qwen3-8b", "long_500k")["skipped"]
    assert "sub-quadratic" in dryrun.run_cell("deepseek-moe-16b", "long_500k", "multi")["skipped"]
    with pytest.raises(ValueError, match="mesh"):
        dryrun.run_cell("qwen3-8b", "decode_32k", "pod")


def test_single_mesh_lm_cell_traces_256_ranks():
    """qwen3-8b decode_32k on the reference's single mesh (data=16,
    model=16) over a fake group of 256 ranks, on fake CPU tensors: one
    rank's argument and parameter bytes a share of the global, collectives
    counted, the process's peak RSS unmoved."""
    before = _max_rss_bytes()
    rec = dryrun.run_cell("qwen3-8b", "decode_32k", "single", device="cpu")
    assert "skipped" not in rec, rec.get("skipped")
    assert rec["devices"] == 256 and rec["mesh"] == "single" and rec["opts"] == []
    mem = rec["memory"]
    assert 0 < mem["argument_bytes"] < mem["argument_bytes_global"] / 64
    assert 0 < mem["param_bytes"] < mem["param_bytes_global"] / 8
    assert _max_rss_bytes() - before < 64 * 2**20 < mem["argument_bytes"]
    roof = rec["roofline"]
    assert roof["flops"] > 0 and roof["collectives"]["counts"].get("all-reduce", 0) > 0
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
def test_stacked_fsdp_rank_bytes_match_reference(mesh_kind):
    """mamba2-2.7b's train state on the production mesh, placed as
    `lower_train_step` places it (FSDP on: the mesh layout), on fake
    tensors over the fake group: one rank's parameter bytes are the sum,
    over the reference's leaves, of each leaf's bytes over the sizes of the
    mesh axes in its spec (the dry-run record's `param_bytes`)."""
    import jax
    import jax.numpy as jnp

    from repro.distributed import sharding as jshd
    from repro.models import model as JM
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import graph_analysis as ga
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import model as TM

    axes = ({"data": 16, "model": 16} if mesh_kind == "single"
            else {"pod": 2, "data": 16, "model": 16})
    jcfg = j_get_config("mamba2-2.7b")
    shapes = jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0), jcfg,
                                                   dtype=jnp.bfloat16))
    jmesh = types.SimpleNamespace(axis_names=tuple(axes), shape=dict(axes))
    jspecs = jshd.param_specs(jcfg, shapes, jmesh, jshd.ShardingPlan.for_mesh(jmesh))
    want = 0
    for leaf, spec in zip(jax.tree.leaves(shapes), jax.tree.leaves(
            jspecs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))):
        split = math.prod(axes[a] for e in spec if e is not None
                          for a in ((e,) if isinstance(e, str) else e))
        want += math.prod(leaf.shape) * leaf.dtype.itemsize // split
    cfg = dryrun.get_config("mamba2-2.7b")
    with dryrun.fake_process_group(dryrun.PRODUCTION_RANKS[mesh_kind]):
        mesh = make_production_mesh(multi_pod=mesh_kind == "multi", device_type="cpu")
        plan = shd.ShardingPlan.for_mesh(mesh)
        with ga.fake_mode():
            params = TM.init_params(cfg, generator=None, dtype=torch.bfloat16, device="cpu")
            placed = shd.distribute(params, shd.param_specs(cfg, params, mesh, plan), mesh)
        assert [len(p) for p in shd.layout_of(placed)] == [3]
        got = sum(t.to_local().numel() * t.element_size() for t in ga.tensors_of(placed))
    assert got == want, (got, want)
    assert dryrun._tree_bytes(placed) == got


@pytest.mark.parametrize("arch,cell,seq_shard", [("qwen3-8b", "decode_32k", False),
                                                 ("jamba-1.5-large-398b", "long_500k", True)])
def test_multi_mesh_cells_trace_one_rank(arch, cell, seq_shard, monkeypatch):
    """Two serving cells on the (pod=2, data=16, model=16) mesh over a fake
    group of 512 ranks, on fake CPU tensors: devices 512, one rank's
    argument bytes a small share of the global ones, collectives counted,
    the process's peak RSS unmoved, each traced in under 30 s. The hybrid's
    long_500k decode goes through `SeqShard`."""
    from repro_torch.distributed import flash_decode

    calls = []
    real = flash_decode.SeqShard.decode_attention
    monkeypatch.setattr(flash_decode.SeqShard, "decode_attention",
                        lambda self, *a: calls.append(self.seq_axis) or real(self, *a))
    before = _max_rss_bytes()
    rec = dryrun.run_cell(arch, cell, "multi", device="cpu")
    assert "skipped" not in rec, rec.get("skipped")
    assert rec["devices"] == 512 and rec["mesh"] == "multi" and rec["trace_s"] < 30
    mem = rec["memory"]
    assert 0 < mem["argument_bytes"] < mem["argument_bytes_global"] / 64
    assert _max_rss_bytes() - before < 64 * 2**20 < mem["argument_bytes"]
    roof = rec["roofline"]
    assert roof["flops"] > 0 and roof["collectives"]["counts"].get("all-reduce", 0) > 0
    assert bool(calls) == seq_shard and set(calls) <= {"data"}
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("arch,cell", [("deepseek-moe-16b", "prefill_32k"),
                                       ("jamba-1.5-large-398b", "decode_32k"),
                                       ("mamba2-2.7b", "long_500k")])
def test_moe_and_ssm_cells_trace_on_meta(arch, cell):
    """MoE, hybrid and SSM serving cells at full width, on meta tensors:
    B3 once per attention layer of a prefill, the decode state's float32
    SSM states among the arguments."""
    rec = dryrun.run_cell(arch, cell, "card", device="meta")
    assert "skipped" not in rec and rec["roofline"]["flops"] > 0
    cfg = dryrun.get_config(arch)
    n_attn = cfg.pattern().count("attn") * cfg.n_superblocks()
    assert len(rec["kernels"]) == (n_attn if cell.startswith("prefill") else 0)
    if cfg.ssm is not None:
        sc = cfg.ssm
        ssd = (sc.num_heads(cfg.d_model) * sc.d_state * sc.head_dim * 4
               * cfg.pattern().count("mamba") * cfg.n_superblocks())
        assert rec["memory"]["argument_bytes"] > ssd * dryrun.LM_CELLS[cell].global_batch


def test_an_operation_without_meta_kernel_skips_its_cell(monkeypatch):
    """A step that reaches an operation fake tensors cannot run is recorded
    as skipped, naming the operation."""
    from torch._subclasses.fake_tensor import UnsupportedOperatorException

    def analyze(step, *args, fake=None):
        raise UnsupportedOperatorException(torch.ops.aten.searchsorted.Tensor)

    monkeypatch.setattr(dryrun.ga, "analyze", analyze)
    rec = dryrun.run_cell("deepseek-moe-16b", "decode_32k", "card", device="meta")
    assert "aten.searchsorted.Tensor" in rec["skipped"] and "meta kernel" in rec["skipped"]


def test_records_summarize_and_report(tmp_path, capsys):
    out = tmp_path / "dryrun"
    for arch, cell in CELLS[:2] + [("qwen3-8b", "long_500k")]:
        assert dryrun.main(["--arch", arch, "--cell", cell, "--device", "cpu", "--mesh", "card",
                            "--json", str(out / f"{arch}__{cell}__card.json")]) == 0
    recs = summarize_dryrun.load(str(out))
    assert len(recs) == 3
    rows = [summarize_dryrun.fmt_row(r) for r in recs]
    assert sum("SKIP" in r for r in rows) == 1
    assert all(r.startswith("| ") and r.count("|") >= 8 for r in rows)
    summarize_dryrun.main([str(out)])
    assert "3 records, 2 traced, 1 skipped" in capsys.readouterr().out
    bench = tmp_path / "BENCH_emvs_torch.json"
    assert roofline_report.main(["--out-dir", str(out), "--dry-run",
                                 "--json-out", str(bench)]) == 0
    text = capsys.readouterr().out
    assert "fused-store" in text and "3 cells (2 traced)" in text
    data = json.loads(bench.read_text())
    rep = data["dry_run"]["roofline_report"]
    assert rep["fusion"]["violations"] == [] and rep["fusion_main_bucket"]["segments"] == 2


def test_run_skip_slow_counts_section_failures(monkeypatch, capsys):
    calls = []

    def ok(name):
        def main(argv=None):
            calls.append((name, argv))
            return {}
        return main

    def broken(argv=None):
        calls.append(("table3", argv))
        raise RuntimeError("section broke")

    from repro_torch.benchmarks import (
        fig4a_voting,
        fig4b_quant,
        fig7a_accuracy,
        memory_footprint,
        segment_batching,
        table3_runtime,
    )

    monkeypatch.setattr(table3_runtime, "main", broken)
    for mod, name in ((segment_batching, "segment_batching"), (fig4a_voting, "fig4a"),
                      (fig4b_quant, "fig4b"), (fig7a_accuracy, "fig7a"),
                      (memory_footprint, "memory_footprint")):
        monkeypatch.setattr(mod, "main", ok(name))
    monkeypatch.setattr(roofline_report, "main", lambda argv=None: calls.append(
        ("roofline", argv)) or 0)
    assert bench_run.main(["--skip-slow", "--device", "cpu"]) == 1
    names = [c[0] for c in calls]
    assert names == ["table3", "segment_batching", "memory_footprint", "roofline"]
    assert all(argv == ["--device", "cpu"] for name, argv in calls if name != "roofline")
    assert "1 BENCHMARK SECTIONS FAILED" in capsys.readouterr().out
    calls.clear()
    monkeypatch.setattr(table3_runtime, "main", ok("table3"))
    assert bench_run.main([]) == 0
    assert [c[0] for c in calls] == ["table3", "segment_batching", "fig4a", "fig4b",
                                     "fig7a", "memory_footprint", "roofline"]
    assert "ALL BENCHMARKS OK" in capsys.readouterr().out


def test_meshes_over_the_default_group():
    from repro_torch.distributed.emvs import local_process_group
    from repro_torch.launch import mesh

    for build in (mesh.make_host_mesh, mesh.make_production_mesh):
        with pytest.raises(RuntimeError, match="init_process_group"):
            build()
    with local_process_group("cpu"):
        m = mesh.make_host_mesh(data=4, model=1)  # data cut to the one rank
        assert m.device_type == "cpu"
        assert tuple(m.shape) == (1, 1) and m.mesh_dim_names == ("data", "model")
        with pytest.raises(ValueError, match="needs 256 ranks"):
            mesh.make_production_mesh()
        with pytest.raises(ValueError, match="needs 512 ranks"):
            mesh.make_production_mesh(multi_pod=True)
