"""Canonical input-shape cells and their input specs, in PyTorch.

Counterpart of `repro.configs.shapes`. LM cells (seq_len x global_batch):
    train_4k     seq 4096,    batch 256   -> train_step
    prefill_32k  seq 32768,   batch 32    -> serve prefill
    decode_32k   seq 32768,   batch 128   -> serve_step (1 new token, KV=seq)
    long_500k    seq 524288,  batch 1     -> decode; SSM/hybrid only

EMVS cells (the paper's workload):
    emvs_rt      1 frame  x 1024 events  (real-time packet)
    emvs_seg     256 frames x 1024 events (one key-frame segment sweep)

`input_specs(cfg, cell, device=)` returns {name: tensor} with the
reference's shapes and dtypes and no storage: tensors on the `meta`
device by default, or fake tensors on `device` (under `fake_mode`, a new
`FakeTensorMode` unless given), which trace like that device's tensors
and allocate nothing (the dry run's contract).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs import ArchConfig

__all__ = ["ShapeCell", "LM_CELLS", "EMVS_CELLS", "cells_for", "input_specs",
           "cell_skipped"]


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


LM_CELLS = {
    "train_4k": ShapeCell("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524288, 1),
}

EMVS_CELLS = {
    "emvs_rt": ShapeCell("emvs_rt", "emvs", 1024, 1),  # events/frame, frames
    "emvs_seg": ShapeCell("emvs_seg", "emvs", 1024, 256),
}

# production DSI depth resolution of the EMVS cells
EMVS_CELL_PLANES = 256


def cell_skipped(cfg: ArchConfig, cell: ShapeCell) -> str | None:
    """Return a skip reason, or None if the cell runs for this arch."""
    if cfg.family == "emvs":
        return None if cell.kind == "emvs" else "emvs arch has no LM cells"
    if cell.kind == "emvs":
        return "LM arch has no EMVS cells"
    if cell.name == "long_500k" and cfg.full_attention:
        return ("pure full-attention arch: no sub-quadratic path at 500k "
                "context (assignment skip rule; DESIGN.md §Arch-applicability)")
    return None


def cells_for(cfg: ArchConfig) -> list[ShapeCell]:
    table = EMVS_CELLS if cfg.family == "emvs" else LM_CELLS
    return [c for c in table.values() if cell_skipped(cfg, c) is None]


def _spec_shapes(cfg: ArchConfig, cell: ShapeCell) -> dict[str, tuple[tuple, torch.dtype]]:
    f32, i32 = torch.float32, torch.int32
    if cfg.family == "emvs":
        frames, e, nz = cell.global_batch, cell.seq_len, EMVS_CELL_PLANES
        return {"xy": ((frames, e, 2), f32), "valid": ((frames, e), f32),
                "H": ((frames, 3, 3), f32), "phi": ((frames, nz, 3), f32)}
    b, s = cell.global_batch, cell.seq_len
    n_front = cfg.n_frontend_tokens
    if cell.kind in ("train", "prefill"):
        specs = {"tokens": ((b, s), i32)}
        if cell.kind == "train":
            specs["targets"] = ((b, s), i32)
        if cfg.frontend == "vision_patches" and n_front:
            # patch embeddings occupy the first n_front positions of s
            specs["frontend_embed"] = ((b, n_front, cfg.d_model), f32)
        elif cfg.frontend == "audio_frames":
            # EnCodec frame embeddings for the full sequence (stubbed frontend)
            specs["frontend_embed"] = ((b, s, cfg.d_model), f32)
        return specs
    if cell.kind == "decode":
        specs = {"tokens": ((b, 1), i32)}
        if cfg.frontend == "audio_frames":
            specs["frontend_embed"] = ((b, 1, cfg.d_model), f32)
        return specs
    raise ValueError(cell.kind)


def input_specs(cfg: ArchConfig, cell: ShapeCell, *, device="meta",
                fake_mode=None) -> dict[str, torch.Tensor]:
    """Storage-free stand-ins for every model input of the cell: meta
    tensors on `device="meta"`, else fake tensors on `device` under
    `fake_mode` (a new `FakeTensorMode` when None)."""
    shapes = _spec_shapes(cfg, cell)
    dev = torch.device(device)
    if dev.type == "meta":
        return {k: torch.empty(s, dtype=d, device=dev) for k, (s, d) in shapes.items()}
    if fake_mode is None:
        from torch._subclasses.fake_tensor import FakeTensorMode

        fake_mode = FakeTensorMode(allow_non_fake_inputs=True)
    with fake_mode:
        return {k: torch.empty(s, dtype=d, device=dev) for k, (s, d) in shapes.items()}
