"""The port's dry run (`repro_torch.launch.dryrun`), its summaries
(`benchmarks.summarize_dryrun`, `benchmarks.roofline_report`) and the
benchmark driver (`benchmarks.run`), on the CPU.

The dry run traces on fake tensors: the four single-card cells must
allocate nothing (the traced arguments alone are gigabytes), the EMVS
cells must count the reference's useful FLOPs (`model_flops_override =
5 * n_votes` for its single mesh), and the cells the port cannot trace
yet must say why. The reference's `repro.launch.dryrun` is not imported
here: it sets a 512-device XLA flag at import.
"""
from __future__ import annotations

import json
import resource

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
    dryrun.run_cell(arch, cell, "single", device=device)  # imports, caches
    before = _max_rss_bytes()
    rec = dryrun.run_cell(arch, cell, "single", device=device)
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
        want = ({"repro_torch.backproject_vote.default", "repro_torch.depth_argmax.default"}
                if arch == "eventor-davis240" else
                ({"repro_torch.flash_attention.default"} if cell == "prefill_32k" else set()))
        assert kernels == want
    else:
        assert kernels == set()


def test_emvs_seg_b1_bytes_equal_sweep_bound():
    rec = dryrun.run_cell("eventor-davis240", "emvs_seg", device="meta")
    (b1,) = [k for k in rec["kernels"] if "backproject_vote" in k["op"]]
    assert b1["bytes"] == rf.sweep_bytes(1, 256, 1024, 256, 240, 180)
    assert b1["flops"] == rf.sweep_ops(256, 256 * 1024)
    assert b1["outputs"] == (("int16", (1, 256, 180, 240)),)


@pytest.mark.parametrize("cell", ["emvs_rt", "emvs_seg"])
def test_emvs_model_flops_equal_reference(cell):
    rec = dryrun.run_cell("eventor-davis240", cell, device="cpu")
    # the reference's single mesh (data=16, model=16): emvs_rt splits its
    # 1024-event packet into 16 pose-identical slices of 64 events
    jcell = j_shapes.EMVS_CELLS[cell]
    data, nz = 16, 256
    frames, events = ((data, jcell.seq_len // data) if cell == "emvs_rt"
                      else (jcell.global_batch, jcell.seq_len))
    n_votes = frames * events * nz
    assert rec["emvs_votes"] == n_votes
    assert rec["roofline"]["model_flops"] == 5.0 * n_votes


def test_skip_reasons_name_what_is_missing():
    for arch in dryrun.ARCHS:
        cfg = j_get_config(arch)
        table = j_shapes.EMVS_CELLS if cfg.family == "emvs" else j_shapes.LM_CELLS
        for cell in table.values():
            rec = dryrun.run_cell(arch, cell.name, "multi")
            assert rec["skipped"], (arch, cell.name)
            ref_reason = j_shapes.cell_skipped(cfg, cell)
            if ref_reason:
                assert rec["skipped"] == ref_reason
            else:
                assert "A7" in rec["skipped"] and "distributed/sharding.py" in rec["skipped"]
    assert "A7" in dryrun.run_cell("qwen3-8b", "train_4k")["skipped"]
    for arch in ("deepseek-moe-16b", "kimi-k2-1t-a32b", "mamba2-2.7b",
                 "jamba-1.5-large-398b"):
        assert "A7" in dryrun.run_cell(arch, "train_4k")["skipped"]
        for cell in ("prefill_32k", "decode_32k", "long_500k"):
            # the serving cells trace, where the reference runs them
            assert dryrun.port_skip(dryrun.LM_CELLS[cell], "single") is None
    assert "sub-quadratic" in dryrun.run_cell("qwen3-8b", "long_500k")["skipped"]
    assert "sub-quadratic" in dryrun.run_cell("deepseek-moe-16b", "long_500k")["skipped"]


@pytest.mark.parametrize("arch,cell", [("deepseek-moe-16b", "prefill_32k"),
                                       ("jamba-1.5-large-398b", "decode_32k"),
                                       ("mamba2-2.7b", "long_500k")])
def test_moe_and_ssm_cells_trace_on_meta(arch, cell):
    """MoE, hybrid and SSM serving cells at full width, on meta tensors:
    B3 once per attention layer of a prefill, the decode state's float32
    SSM states among the arguments."""
    rec = dryrun.run_cell(arch, cell, "single", device="meta")
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
    rec = dryrun.run_cell("deepseek-moe-16b", "decode_32k", device="meta")
    assert "aten.searchsorted.Tensor" in rec["skipped"] and "meta kernel" in rec["skipped"]


def test_records_summarize_and_report(tmp_path, capsys):
    out = tmp_path / "dryrun"
    for arch, cell in CELLS[:2] + [("qwen3-8b", "train_4k")]:
        assert dryrun.main(["--arch", arch, "--cell", cell, "--device", "cpu",
                            "--json", str(out / f"{arch}__{cell}__single.json")]) == 0
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
