"""The port's paper tables (Fig 4a, 4b, 7a) against the reference, on the CPU.

The reference's own simulated sequence, made and aggregated by the
reference, is handed as numpy frames to the port's `segment_absrel`, on a
segment of REDUCED_FRAMES frames. Nearest rows, and the kernel rows beside
them, give the reference's AbsRel exactly; bilinear rows are held to
BILINEAR_ABSREL_ATOL = 1e-3, since float sums of fractional votes may
round otherwise. Measured on the CPU: 0 at 8 frames on both bilinear
rows, 2.2e-8 at the paper's 24 frames.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from benchmarks import _emvs_common as j_common
from repro.core.pipeline import EMVSOptions as JOptions
from repro_torch import interop
from repro_torch.benchmarks import _emvs_common as t_common
from repro_torch.benchmarks import fig4a_voting, fig4b_quant, fig7a_accuracy
from repro_torch.core import pipeline as tp

REDUCED_FRAMES = 8
BILINEAR_ABSREL_ATOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One thread whatever the worker's budget: the exact rows of
    `test_paper_rows_match_the_reference` hold only there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reference_sequence():
    """The reference's simulation_3planes sequence, as the port's types."""
    cam, scene, frames, dsi_cfg = j_common.sequence("simulation_3planes")
    port_frames = interop.event_frames_from_numpy(
        *(np.asarray(a) for a in (frames.xy, frames.valid, frames.t_mid, *frames.poses)),
        device="cpu")
    return {"scene": np.asarray(scene), "frames": port_frames,
            "cam": interop.camera_from_dict(dataclasses.asdict(cam)),
            "cfg": interop.dsi_config_from_dict(dataclasses.asdict(dsi_cfg))}


ROWS = [(fig, name, opts) for fig, mod in (("4a", fig4a_voting), ("4b", fig4b_quant),
                                           ("7a", fig7a_accuracy))
        for name, opts in mod.ROWS.items()]


@pytest.mark.parametrize("fig,name,opts", ROWS, ids=[f"{f}-{n}" for f, n, _ in ROWS])
def test_paper_rows_match_the_reference(reference_sequence, fig, name, opts):
    """Each row's AbsRel against the reference's, the nearest rows exactly.
    That equality depends on torch's thread count: on 8 intra-op threads
    the 4a-nearest and 4b-float32 rows differ in the last bits
    (0.10214976221323013 against 0.10214976966381073)."""
    seq = reference_sequence
    want = j_common.absrel_for("simulation_3planes",
                               JOptions(**{f.name: getattr(opts, f.name)
                                           for f in dataclasses.fields(opts)
                                           if f.name != "policy"}),
                               max_frames=REDUCED_FRAMES)
    got = t_common.segment_absrel(seq["cam"], seq["scene"], seq["frames"], seq["cfg"], opts,
                                  REDUCED_FRAMES)
    assert 0 < got < 1
    if opts.voting == "nearest":
        assert got == want
        kernel = t_common.segment_absrel(
            seq["cam"], seq["scene"], seq["frames"], seq["cfg"],
            dataclasses.replace(opts, formulation="kernel"), REDUCED_FRAMES)
        assert kernel == got
    else:
        assert abs(got - want) <= BILINEAR_ABSREL_ATOL


def test_table_rows_add_kernel_rows(monkeypatch):
    """`table_rows` adds a kernel row beside each nearest row and refuses a
    kernel row that differs from its matmul row."""
    calls = []

    def fake(seq, opts, device, max_frames):
        calls.append(opts.formulation)
        return 0.25 if opts.formulation != "kernel" or opts.quantized else 0.5

    monkeypatch.setattr(t_common, "SEQUENCES", ("simulation_3planes",))
    monkeypatch.setattr(t_common, "absrel_for", fake)
    rows = t_common.table_rows({"q": tp.EMVSOptions(quantized=True),
                                "b": tp.EMVSOptions(voting="bilinear")}, "cpu")
    assert rows == {"simulation_3planes": {"q": 0.25, "q_kernel": 0.25, "b": 0.25}}
    with pytest.raises(RuntimeError, match="kernel AbsRel"):
        t_common.table_rows({"f": tp.EMVSOptions()}, "cpu")
