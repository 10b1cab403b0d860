"""Roofline terms for one H100 SXM, and the bounds of the port's kernels.

Counterpart of `repro.launch.roofline`. Three terms per traced step, in
seconds, from the graph analysis's counts (`launch/graph_analysis.py`,
which takes the place of XLA's `cost_analysis` and HLO text):

    compute    = bf16 FLOPs / 989 TFLOP/s + other FLOPs / 67 TFLOP/s
    memory     = HBM bytes / 3.35 TB/s
    collective = collective bytes / 450 GB/s (NVLink, per direction)

Every peak is the H100 SXM datasheet's, not a measurement: dense bf16 on
the tensor cores, float32 off them, HBM3, NVLink 4. The counts are per
card: the port traces the program one card runs.

The same peaks give the least time of each hand-written kernel on the
inputs it is handed (`sweep_bound` for B1, `depth_argmax_bound` for B2,
`flash_bound` for B3): each input read once and each output written once
at the memory rate, against the kernel's operations at the peak of their
type; the larger is the bound. `emvs_fusion_ladder` models the fusion
stages of one quantized sweep dispatch.
"""
from __future__ import annotations

import dataclasses
from typing import Any

# H100 SXM datasheet peaks
PEAK_FLOPS_BF16 = 989e12  # dense bf16, tensor cores
PEAK_FLOPS_F32 = 67e12  # float32 off the tensor cores
HBM_BW = 3.35e12  # HBM3, bytes/s
NVLINK_BW = 450e9  # NVLink 4, bytes/s per direction

# float32 operations per (valid event, plane) in the sweep kernel B1: per
# coordinate a subtract, an FMA (2) and an add, then the vote's add
B1_OPS_PER_PROJECTION = 9
# per (pixel, plane) in the depth max/argmax B2: a compare and a select
B2_OPS_PER_VOXEL = 2
# the reference's count for detection's streaming argmax and parabola, per voxel
DETECT_FLOPS_PER_VOXEL = 6


def bound_ms(nbytes: float, nops: float, peak: float = PEAK_FLOPS_F32
             ) -> tuple[float, str]:
    """Least ms for `nbytes` of device-memory traffic and `nops` operations
    at `peak`, and which of the two bounds it ("bytes" or "operations")."""
    t_bytes, t_ops = nbytes / HBM_BW, nops / peak
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def sweep_bytes(s: int, c: int, e: int, nz: int, w: int, h: int,
                quantized: bool = True) -> int:
    """Bytes B1 must move for S segments of C frames of E events onto Nz
    planes of w x h: x0, y0 (float32) and the bool mask per event, phi
    (3 float32 per frame and plane), the stored DSI (int16 quantized,
    else float32)."""
    store = 2 if quantized else 4
    return 9 * s * c * e + 12 * s * c * nz + store * s * nz * h * w


def sweep_ops(nz: int, n_valid: int) -> int:
    """B1's float32 operations: 9 per valid (event, plane)."""
    return B1_OPS_PER_PROJECTION * n_valid * nz


def sweep_bound(s: int, c: int, e: int, nz: int, w: int, h: int, n_valid: int,
                quantized: bool = True) -> tuple[float, str]:
    """B1's least ms and what bounds it (`n_valid`: valid events, all frames)."""
    return bound_ms(sweep_bytes(s, c, e, nz, w, h, quantized), sweep_ops(nz, n_valid))


def depth_argmax_bytes(s: int, nz: int, h: int, w: int, itemsize: int = 2) -> int:
    """Bytes B2 must move: the stored DSI read once, conf and zf written."""
    return itemsize * s * nz * h * w + 8 * s * h * w


def depth_argmax_bound(s: int, nz: int, h: int, w: int, itemsize: int = 2
                       ) -> tuple[float, str]:
    """B2's least ms over an (S, Nz, h, w) DSI of `itemsize`-byte values."""
    return bound_ms(depth_argmax_bytes(s, nz, h, w, itemsize),
                    B2_OPS_PER_VOXEL * s * nz * h * w)


def flash_work(b: int, hq: int, hkv: int, sq: int, skv: int, d: int, itemsize: int,
               causal: bool = True) -> tuple[int, int]:
    """`(bytes, flops)` of attention of (B, Hq, Sq, D) over (B, Hkv, Skv, D):
    q, k, v read once and o written once; both products' FLOPs, the causal
    triangle only when `causal` (Sq == Skv)."""
    nbytes = itemsize * b * (2 * hq * sq * d + 2 * hkv * skv * d)
    pairs = sq * (sq + 1) // 2 if causal and sq == skv else sq * skv
    return nbytes, 4 * b * hq * d * pairs


def flash_bound(s: int, dtype, *, b: int = 1, hq: int = 32, hkv: int = 8, d: int = 128
                ) -> tuple[float, str]:
    """B3's least ms for causal (B, Hq, S, D) over (B, Hkv, S, D) at the
    peak of `dtype` (bf16 tensor cores, float32 CUDA cores)."""
    import torch

    nbytes, flops = flash_work(b, hq, hkv, s, s, d, torch.finfo(dtype).bits // 8)
    peak = PEAK_FLOPS_BF16 if dtype == torch.bfloat16 else PEAK_FLOPS_F32
    return bound_ms(nbytes, flops, peak)


@dataclasses.dataclass
class Roofline:
    flops: float  # per card: every traced operation's FLOPs
    bytes_hbm: float  # per card: reads and writes of materializing operations
    collective_bytes: float  # per card
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float  # 6*N_active*D tokens-based useful flops (global)
    model_flops_per_device: float
    useful_fraction: float  # model_flops_per_device / traced flops
    collectives: dict[str, Any]
    flops_by_dtype: dict[str, float]
    n_ops: int

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def analyze(stats, *, n_devices: int, model_flops_global: float) -> Roofline:
    """Three-term roofline from a graph analysis (`GraphStats`): bf16 FLOPs
    at the tensor cores' peak, every other FLOP at float32's."""
    bf16 = stats.flops_by_dtype.get("bfloat16", 0.0)
    compute_s = bf16 / PEAK_FLOPS_BF16 + (stats.flops - bf16) / PEAK_FLOPS_F32
    memory_s = stats.hbm_bytes / HBM_BW
    collective_s = stats.collective_bytes / NVLINK_BW
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    dominant = max(terms, key=terms.get)
    mf_dev = model_flops_global / n_devices
    return Roofline(
        flops=stats.flops, bytes_hbm=stats.hbm_bytes,
        collective_bytes=stats.collective_bytes,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        dominant=dominant,
        model_flops=model_flops_global, model_flops_per_device=mf_dev,
        useful_fraction=(mf_dev / stats.flops if stats.flops else 0.0),
        collectives={"counts": stats.collective_counts,
                     "bytes": stats.collective_bytes_by_kind},
        flops_by_dtype=dict(stats.flops_by_dtype), n_ops=stats.n_ops,
    )


def model_flops_for_cell(cfg, cell) -> float:
    """6*N*D (dense) / 6*N_active*D (MoE); D = tokens processed this step.

    decode cells process batch*1 new tokens but read the KV cache —
    model_flops uses 2*N_active*tokens (fwd only) for serve cells and
    6*N_active*tokens for train (fwd+bwd)."""
    n_active = cfg.active_params()
    if cell.kind == "train":
        tokens = cell.global_batch * cell.seq_len
        return 6.0 * n_active * tokens
    if cell.kind == "prefill":
        tokens = cell.global_batch * cell.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence + attention over the cache
    tokens = cell.global_batch * 1
    flops = 2.0 * n_active * tokens
    if cfg.n_heads:
        # KV-cache attention reads: 2 * 2 * Hq * hd * S per token (qk + pv)
        n_attn_layers = sum(1 for k in cfg.pattern() if k == "attn") \
            * cfg.n_superblocks()
        flops += (4.0 * cfg.n_heads * cfg.head_dim * cell.seq_len
                  * n_attn_layers * tokens)
    return flops


# ---------------------------------------------------------------------------
# EMVS sweep fusion ladder (analytic)
#
# Every term is a tensor the stage must move through HBM at its contract
# dtype width (docs/quantization_contracts.md). The traffic is the
# reference's, term for term. The work is the card's: B1 votes by
# shared-memory atomics, not the TPU's one-hot matmuls, so each rung's
# compute time counts B1's 9 float32 operations per (event, plane) and
# detection's 6 per voxel at 67 TFLOP/s. The reference's FLOPs stay beside
# them as `flops_reference`. Fusion only deletes traffic, so each rung
# sits strictly closer to its bound than the one before.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SweepStageRoofline:
    """One rung of the fusion ladder under the two-term roofline."""

    name: str
    hbm_bytes: float
    flops: float  # the card's operations
    flops_reference: float  # the reference's count (one-hot vote matmuls)
    compute_s: float
    memory_s: float
    time_s: float  # max(compute, memory); one card, no collectives
    intensity: float  # flops / hbm_bytes
    bound_gap: float  # time_s / compute_s; 1.0 == sitting on the roofline

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def emvs_fusion_ladder(*, nz: int, h: int, w: int, events: int, frames: int,
                       quantized: bool = True) -> list[SweepStageRoofline]:
    """The three fusion stages of one sweep dispatch on the card.

    unfused        — the vote writes a float32 DSI to HBM, the storage
                     round trip reads it back and rewrites it int16 (Table
                     1's store), and detection reads the stored volume.
    fused-store    — the saturating int16 store runs against the resident
                     block (B1): the float32 spill and its re-read go;
                     detection (B2) still re-reads the volume.
    fused-detect   — detection consumes each stored plane while it is
                     resident, so the DSI is written once and never read.
    """
    f32, i16 = 4.0, 2.0
    store = i16 if quantized else f32
    vox = float(nz) * h * w
    # tensors every stage reads exactly once, at contract dtype widths
    inputs = frames * events * (2 * f32 + f32) + frames * nz * 3 * f32
    outputs = 2.0 * h * w * f32  # conf + zf maps
    flops_reference = (frames * nz * events * 10.0
                       + frames * nz * 2.0 * events * (h + w)
                       + vox * 6.0)
    flops = (float(frames) * events * nz * B1_OPS_PER_PROJECTION
             + vox * DETECT_FLOPS_PER_VOXEL)

    def rung(name: str, traffic: float) -> SweepStageRoofline:
        hbm = inputs + outputs + traffic
        compute_s = flops / PEAK_FLOPS_F32
        memory_s = hbm / HBM_BW
        time_s = max(compute_s, memory_s)
        return SweepStageRoofline(
            name=name, hbm_bytes=hbm, flops=flops, flops_reference=flops_reference,
            compute_s=compute_s, memory_s=memory_s, time_s=time_s,
            intensity=flops / hbm, bound_gap=time_s / compute_s,
        )

    if quantized:
        unfused = vox * (f32 + f32 + store + store)  # spill, re-read, store, detect-read
    else:
        unfused = vox * (f32 + f32)  # spill + detect re-read (no roundtrip)
    return [
        rung("unfused", unfused),
        rung("fused-store", vox * (store + store)),
        rung("fused-detect", vox * store),
    ]
