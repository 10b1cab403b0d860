"""The graph analysis (`repro_torch.launch.graph_analysis`): FLOPs, bytes and
live memory of programs traced on fake tensors, held against the
reference's HLO analyzer (`repro.launch.hlo_analysis`) on the same shapes.

Counterparts of `tests/test_hlo_analysis.py`. The port's loop is a Python
loop, unrolled as it runs, so the reference's scanned programs are
compared with their eager loops: the counts must already be multiplied.
The card's EMVS program is traced on the meta device (the kernels' path,
nothing runs), the CPU's on fake CPU tensors.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.launch.hlo_analysis import analyze_text
from repro_torch.core.camera import CameraModel
from repro_torch.core.dsi import DSIConfig
from repro_torch.core.pipeline import EMVSOptions, SegmentBatch, sweep_segment_batch
from repro_torch.launch import graph_analysis as ga
from repro_torch.quant.policies import TABLE1


def _fake(*shapes, dtype=torch.float32, requires_grad=False, device="cpu"):
    fm = ga.fake_mode()
    with fm:
        ts = [torch.empty(s, dtype=dtype, device=device, requires_grad=requires_grad)
              for s in shapes]
    return fm, ts


def _ref_flops(fn, *shapes):
    c = jax.jit(fn).lower(*(jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes)).compile()
    return analyze_text(c.as_text()).flops


def test_plain_matmul_flops_exact_and_equal_reference():
    fm, (a, b) = _fake((256, 512), (512, 128))
    _, st, _ = ga.analyze(lambda a, b: a @ b, a, b, fake=fm)
    assert st.flops == 2 * 256 * 512 * 128
    assert st.flops == _ref_flops(lambda a, b: a @ b, (256, 512), (512, 128))
    assert st.flops_by_dtype == {"float32": st.flops}
    # one materializing operation: both operands read, the result written
    assert st.hbm_bytes == 4 * (256 * 512 + 512 * 128 + 256 * 128)


def _loop(x, ws):
    for i in range(ws.shape[0]):
        x = torch.tanh(x @ ws[i])
    return x


def test_looped_matmul_counts_every_iteration():
    fm, (x, ws) = _fake((64, 64), (9, 64, 64))
    _, st, _ = ga.analyze(_loop, x, ws, fake=fm)

    def body(cr, w):
        return jnp.tanh(cr @ w), None

    ref = _ref_flops(lambda cr, ws: jax.lax.scan(body, cr, ws)[0], (64, 64), (9, 64, 64))
    assert st.flops == 9 * 2 * 64 ** 3 == ref
    assert st.by_op["aten.mm.default"]["count"] == 9


def test_backward_pass_counts_both_passes():
    fm = ga.fake_mode()
    with fm:
        x = torch.empty((32, 32), requires_grad=True)
        ws = torch.empty((5, 32, 32))

    def fwd_bwd(x, ws):
        _loop(x, ws).sum().backward()

    _, st, _ = ga.analyze(fwd_bwd, x, ws, fake=fm)

    def body(cr, w):
        return jnp.tanh(cr @ w), None

    c = jax.jit(jax.grad(lambda cr, ws: jax.lax.scan(body, cr, ws)[0].sum())).lower(
        jax.ShapeDtypeStruct((32, 32), jnp.float32),
        jax.ShapeDtypeStruct((5, 32, 32), jnp.float32)).compile()
    assert st.flops == 2 * 5 * 2 * 32 ** 3 == analyze_text(c.as_text()).flops


def test_views_move_nothing_and_peak_memory_follows_lifetimes():
    fm, (x,) = _fake((1024,))

    def prog(x):
        v = x.view(32, 32).t()[1:]  # views: no traffic, no allocation
        a = x * 2
        b = a + 1
        del a
        c = b * 3  # b and c live, a freed
        return v, c

    _, st, mode = ga.analyze(prog, x, fake=fm)
    views = [o for o in mode.ops if not o.materializes]
    assert len(views) == 3 and all(o.bytes_read == o.bytes_written == 0 for o in views)
    assert st.n_materializing == 3
    assert st.hbm_bytes == 3 * 2 * 4096
    assert st.peak_temp_bytes == 2 * 4096


def _sweep_stats(formulation: str, device: str, quantized: bool = True):
    cam = CameraModel(width=32, height=24, cx=15.5, cy=11.5)
    dsi_cfg = DSIConfig.for_camera(cam, num_planes=8)
    opts = EMVSOptions(voting="nearest", formulation=formulation, quantized=quantized)
    s, c, e = 2, 4, 16
    fm = ga.fake_mode()
    f32 = torch.float32
    with fm:
        batch = SegmentBatch(
            torch.empty((s, c, e, 2), device=device),
            torch.empty((s, c, e), dtype=torch.bool, device=device),
            torch.empty((s, c), dtype=torch.bool, device=device),
            torch.empty((s, c, 3, 3), dtype=f32, device=device),
            torch.empty((s, c, 3), dtype=f32, device=device),
            torch.empty((s, 3, 3), dtype=f32, device=device),
            torch.empty((s, 3), dtype=f32, device=device))
    _, st, mode = ga.analyze(lambda b: sweep_segment_batch(cam, dsi_cfg, b, opts), batch,
                             fake=fm)
    return (s, *dsi_cfg.shape), st, mode


def test_kernel_sweep_materializes_no_float32_volume_matmul_does():
    vol, st_k, mode_k = _sweep_stats("kernel", "meta")
    # the card's program: the front end hands B1 its inputs, B1 writes the
    # int16 store, B2 reads it; no operation writes a float32 (S, Nz, h, w)
    # volume
    f32_vols = [o for o in mode_k.ops if o.materializes and
                ("float32", vol) in o.outputs]
    assert f32_vols == []
    names = [o.name for o in mode_k.ops if o.name.startswith("repro_torch.")]
    assert names == ["repro_torch.canonical_project.default",
                     "repro_torch.backproject_vote.default", "repro_torch.depth_argmax.default",
                     "repro_torch.detect_filter.default"]
    _, _, mode_m = _sweep_stats("matmul", "meta")
    f32_m = [o for o in mode_m.ops if o.materializes and
             any(dt == "float32" and len(sh) >= 3 and sh[-3:] == vol[-3:]
                 for dt, sh in o.outputs)]
    assert f32_m, "the matmul formulation's one-hot products write float32 volumes"


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_stored_dsi_bytes_follow_quant_policy(device):
    vol, _, mode = _sweep_stats("kernel", device)
    fmt = TABLE1.declared_formats()["dsi"]
    assert fmt.total_bits % 8 == 0 and fmt.signed
    n = 1
    for d in vol:
        n *= d
    predicted = n * (fmt.total_bits // 8)
    stores = [o for o in mode.ops if ("int16", vol) in o.outputs]
    assert stores, "no int16 DSI store in the trace"
    assert max(o.bytes_written for o in stores) == predicted
