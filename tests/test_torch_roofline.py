"""The port's roofline, fusion ladder and shape cells against the reference.

`repro_torch.launch.roofline` keeps the reference's HBM traffic per rung
of the EMVS fusion ladder and its FLOP count (as `flops_reference`),
bitwise; its compute term counts the card's work instead, and the
strictly-closer gate must hold. `model_flops_for_cell`, the shape cells,
their input specs and skip reasons carry over from
`repro.launch.roofline` and `repro.configs.shapes` exactly.
"""
from __future__ import annotations

import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import shapes as j_shapes
from repro.launch import roofline as j_rf
from repro_torch.benchmarks.roofline_report import (
    FUSION_SHAPE,
    MAIN_BUCKET,
    MAIN_BUCKET_SEGMENTS,
    fusion_report,
)
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs import shapes
from repro_torch.launch import roofline as rf

ARCHS = ARCH_IDS + ["eventor-davis240"]
SHAPES = {"fusion": FUSION_SHAPE, "main_bucket": MAIN_BUCKET}


@pytest.mark.parametrize("quantized", [True, False], ids=["quant", "float"])
@pytest.mark.parametrize("where", list(SHAPES))
def test_ladder_traffic_and_reference_flops_bitwise(where, quantized):
    shape = SHAPES[where]
    got = rf.emvs_fusion_ladder(**shape, quantized=quantized)
    want = j_rf.emvs_fusion_ladder(**shape, quantized=quantized)
    assert [r.name for r in got] == [r.name for r in want]
    for g, w in zip(got, want):
        assert g.hbm_bytes == w.hbm_bytes
        assert g.flops_reference == w.flops
        assert g.memory_s == g.hbm_bytes / rf.HBM_BW
        # the card's work: B1's 9 operations per event and plane, 6 per voxel
        nz, h, wd = shape["nz"], shape["h"], shape["w"]
        assert g.flops == (shape["frames"] * shape["events"] * nz * 9.0
                           + float(nz) * h * wd * 6.0)


@pytest.mark.parametrize("where", list(SHAPES))
def test_ladder_gate_holds_on_the_card(where):
    segments = MAIN_BUCKET_SEGMENTS if where == "main_bucket" else 1
    rep = fusion_report(SHAPES[where], segments)
    assert rep["violations"] == []
    gaps = [st["bound_gap"] for st in rep["stages"]]
    assert gaps[0] > gaps[1] > gaps[2] > 1.0  # every rung bound by bytes
    assert rep["hbm_bytes"]["fused-store"] == segments * rep["stages"][1]["hbm_bytes"]


def test_ladder_at_fusion_shape_matches_the_worked_numbers():
    ladder = rf.emvs_fusion_ladder(**FUSION_SHAPE)
    # 21.3 MFLOP of the card's work, and gaps of about 32, 11 and 6
    assert ladder[0].flops == pytest.approx(21.3e6, rel=0.01)
    assert [round(r.bound_gap) for r in ladder] == [32, 11, 6]
    # the reference's TPU FLOPs would put the last two rungs on the roof
    assert ladder[0].flops_reference / rf.PEAK_FLOPS_F32 > ladder[1].memory_s


def test_main_bucket_fused_store_bound():
    rep = fusion_report(MAIN_BUCKET, MAIN_BUCKET_SEGMENTS)
    assert rep["hbm_bytes"]["fused-store"] == pytest.approx(46.0e6, rel=0.01)
    assert 1e6 * rep["bound_s"]["fused-store"] == pytest.approx(13.74, abs=0.01)


def test_kernel_bounds():
    # B1 at the main bucket: bytes as the kernel moves them
    assert rf.sweep_bytes(2, 40, 1024, 128, 240, 180) == (
        9 * 2 * 40 * 1024 + 12 * 2 * 40 * 128 + 2 * 2 * 128 * 180 * 240)
    assert rf.sweep_bytes(1, 4, 16, 8, 32, 24, quantized=False) == (
        9 * 4 * 16 + 12 * 4 * 8 + 4 * 8 * 24 * 32)
    ms, by = rf.sweep_bound(2, 40, 1024, 128, 240, 180, 60000)
    assert by == "bytes" and ms == pytest.approx(
        1e3 * rf.sweep_bytes(2, 40, 1024, 128, 240, 180) / rf.HBM_BW)
    ms, by = rf.depth_argmax_bound(2, 128, 180, 240)
    assert by == "bytes" and ms == pytest.approx(1e3 * (2 * 2 * 128 * 43200 + 8 * 2 * 43200)
                                                 / rf.HBM_BW)
    # B3: bf16 S=512 bound by bytes, S=2048 by the tensor cores' operations,
    # float32 by the CUDA cores'
    ms, by = rf.flash_bound(512, torch.bfloat16)
    assert by == "bytes" and ms == pytest.approx(0.00313, abs=1e-5)
    ms, by = rf.flash_bound(2048, torch.bfloat16)
    assert by == "operations" and ms == pytest.approx(0.0348, abs=1e-4)
    assert rf.flash_bound(512, torch.float32) == pytest.approx((0.0321, "operations"),
                                                               abs=1e-4)


def test_train_step_bound():
    """stablelm-3b's step on 8 x 512 tokens: 8·N·T FLOPs with remat at the
    bf16 peak bind; the optimizer's traffic (bf16 params and grads, float32
    m and v) is the bytes term."""
    n = get_config("stablelm-3b").total_params()
    assert n == 2_795_274_240
    ms, by = rf.train_step_bound(n, 8 * 512)
    assert by == "operations" and ms == pytest.approx(1e3 * 8 * n * 4096 / 989e12)
    assert ms == pytest.approx(92.61, abs=0.01)
    assert rf.train_step_bound(n, 4096, remat=False)[0] == pytest.approx(0.75 * ms)
    ms, by = rf.train_step_bound(n, 1)
    assert by == "bytes" and ms == pytest.approx(1e3 * n * 22 / rf.HBM_BW)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_for_cell_equals_reference(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    table = shapes.EMVS_CELLS if cfg.family == "emvs" else shapes.LM_CELLS
    jtable = j_shapes.EMVS_CELLS if jcfg.family == "emvs" else j_shapes.LM_CELLS
    assert list(table) == list(jtable)
    for name in table:
        assert rf.model_flops_for_cell(cfg, table[name]) == \
            j_rf.model_flops_for_cell(jcfg, jtable[name]), name


@pytest.mark.parametrize("arch", ARCHS)
def test_cells_skip_reasons_and_input_specs_equal_reference(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    assert [c.name for c in shapes.cells_for(cfg)] == [c.name for c in j_shapes.cells_for(jcfg)]
    for table, jtable in ((shapes.LM_CELLS, j_shapes.LM_CELLS),
                          (shapes.EMVS_CELLS, j_shapes.EMVS_CELLS)):
        for name, cell in table.items():
            jcell = jtable[name]
            assert (cell.name, cell.kind, cell.seq_len, cell.global_batch) == \
                (jcell.name, jcell.kind, jcell.seq_len, jcell.global_batch)
            assert shapes.cell_skipped(cfg, cell) == j_shapes.cell_skipped(jcfg, jcell)
            if shapes.cell_skipped(cfg, cell) is not None:
                continue
            got = shapes.input_specs(cfg, cell)
            want = j_shapes.input_specs(jcfg, jcell)
            assert list(got) == list(want)
            for k, t in got.items():
                assert t.device.type == "meta"
                assert tuple(t.shape) == tuple(want[k].shape), k
                assert str(t.dtype).replace("torch.", "") == str(want[k].dtype), k


def test_input_specs_fake_on_a_device_allocate_nothing():
    cfg = get_config("qwen3-8b")
    specs = shapes.input_specs(cfg, shapes.LM_CELLS["prefill_32k"], device="cpu")
    from torch._subclasses.fake_tensor import FakeTensor

    assert all(isinstance(t, FakeTensor) and t.device.type == "cpu" for t in specs.values())
    assert tuple(specs["tokens"].shape) == (32, 32768)
