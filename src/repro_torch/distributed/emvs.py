"""Distributed EMVS over `torch.distributed`: the paper's parallelism levels.

Counterpart of `repro.distributed.emvs`. Parallelism mapping (the FPGA's
three levels):

  axis      paper's level                here
  -----     -------------------------    ---------------------------------
  model     DSI-level (multiple PE_Zi)   depth planes split; each rank votes
                                         its own plane slice, with no
                                         communication during R
  data      event-level (pipelining)     event frames split; partial DSIs
                                         merged by ONE integer all-reduce
                                         (votes are additive, so exact)
  segments  key-frame level              segments processed concurrently;
                                         ranks exchange only final outputs

The program is SPMD, one rank per card (or per CPU process under gloo):
every rank calls the same function on the same full inputs, sweeps its own
slice, and the collectives hand every rank the full outputs, as JAX's
replicated outputs do. Meshes are `torch.distributed.device_mesh.DeviceMesh`
objects over the default process group, which the caller initializes
(`torch.distributed.init_process_group`): there is no implicit group.

Two entry points:

  * `process_segments_sharded` — the key-frame-level backend of
    `run_emvs(sweep="sharded")` and `StreamConfig(sweep="sharded")`: each
    rank runs `sweep_segment_batch` (on the card, the sweep kernel B1 and
    the depth max/argmax kernel B2) on its rows of the `SegmentBatch`, and
    the outputs are all-gathered. Per-segment outputs equal the batched
    backend's bitwise: the per-segment program is the same.
  * `make_emvs_step` — the data/model(/pod)-split step over precomputed
    geometry (H, phi). The nearest vote merge is an int32 all-reduce (gloo
    and NCCL reduce no int16); bilinear votes stay float32.

Wire types: gloo and NCCL carry no int16, so an int16 tensor is gathered as
its bytes (a uint8 view of the contiguous tensor, viewed back after the
gather), which is exact and no wider. A quantized DSI goes on the wire in
its int16 storage type (Table 1's DSI width).
"""
from __future__ import annotations

import contextlib
import os
import tempfile

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.core import dsi as dsi_lib
from repro_torch.core.camera import CameraModel
from repro_torch.core.detection import DepthMap
from repro_torch.core.dsi import DSIConfig
from repro_torch.core.geometry import PlaneSweepCoeffs, apply_homography, propagate_to_planes
from repro_torch.core.pipeline import EMVSOptions, SegmentBatch, sweep_segment_batch
from repro_torch.core.voting import vote_onehot_matmul
from repro_torch.kernels.detect_filter.ops import detect_filter
from repro_torch.kernels.local_max.ref import depth_argmax_ref

Tensor = torch.Tensor

# Mesh dimension name of the key-frame-segment axis.
SEGMENT_AXIS = "segments"

# dtypes that neither gloo nor NCCL carries: gathered as their bytes
_BYTE_GATHERED = (torch.int16,)


def _rank_in(mesh: DeviceMesh, axis: str) -> tuple[int, int, dist.ProcessGroup]:
    """(this rank's index along `axis`, the axis size, its process group).
    The index is the rank within the group, the order all_gather uses."""
    group = mesh.get_group(axis)
    return dist.get_rank(group), dist.get_world_size(group), group


def all_gather_rows(x: Tensor, group: dist.ProcessGroup) -> Tensor:
    """Concatenate every rank's `x` along its first axis, in group-rank
    order. Dtypes in `_BYTE_GATHERED` go on the wire as bytes. Raises when
    the collective fails."""
    n = dist.get_world_size(group)
    x = x.contiguous()
    wire = x.view(torch.uint8) if x.dtype in _BYTE_GATHERED else x
    out = torch.empty((n * wire.shape[0], *wire.shape[1:]), dtype=wire.dtype,
                      device=wire.device)
    dist.all_gather_into_tensor(out, wire, group=group)
    return out.view(x.dtype) if wire is not x else out


# ---------------------------------------------------------------------------
# The data/model(/pod)-split step over precomputed geometry
# ---------------------------------------------------------------------------


def _vote_local(cam: CameraModel, xy: Tensor, valid: Tensor, frame_valid: Tensor,
                H: Tensor, phi: Tensor, nz_local: int, mode: str) -> Tensor:
    """Vote local frames into a local (Nz_loc, h, w) float32 plane slice,
    frame by frame. Padded frames repeat a real frame and vote with weight
    0 through `frame_valid`."""
    dsi = torch.zeros((nz_local, cam.height, cam.width), dtype=torch.float32,
                      device=xy.device)
    for f in range(xy.shape[0]):
        xy0 = apply_homography(H[f], xy[f])
        coeffs = PlaneSweepCoeffs(phi[f, :, 0], phi[f, :, 1], phi[f, :, 2])
        x_i, y_i = propagate_to_planes(cam, xy0, coeffs)
        w = valid[f].to(torch.float32) * frame_valid[f].to(torch.float32)
        dsi = vote_onehot_matmul(dsi, x_i, y_i, w=cam.width, h=cam.height, mode=mode,
                                 weights=w[None, :].expand(x_i.shape))
    return dsi


def make_emvs_step(cam: CameraModel, dsi_cfg: DSIConfig, mesh: DeviceMesh, *,
                   mode: str = "nearest", data_axis: str = "data",
                   model_axis: str = "model", pod_axis: str | None = None,
                   vote_dtype=torch.int32):
    """Build the split EMVS segment step for `mesh`.

    The step takes the global inputs on every rank (shapes as
    `emvs_input_specs` gives them; a leading G = segments when `pod_axis`):
        xy (G?, F, E, 2), valid (G?, F, E), frame_valid (G?, F),
        H (G?, F, 3, 3), phi (G?, F, Nz, 3)
    and returns (dsi (G?, Nz, h, w), depth, mask, conf (G?, h, w)), whole
    on every rank. dsi is int32 on nearest voting, float32 on bilinear.

    Each rank votes frames [d F/nd, (d+1) F/nd) into planes
    [m Nz/nm, (m+1) Nz/nm) (d, m its index along the data and model axes);
    the data ranks' partial DSIs merge by one all-reduce (int32 on nearest:
    `vote_dtype` narrows the counts as the reference's link does, and the
    wire widens them again, since gloo and NCCL reduce no int16), the model
    ranks' slices are gathered along planes, and every rank detects
    structure on the whole DSI.
    """
    nz = dsi_cfg.num_planes
    n_model = mesh.get_group(model_axis).size()
    assert nz % n_model == 0, (nz, n_model)
    nz_loc = nz // n_model

    def seg_body(xy, valid, frame_valid, H, phi):
        d, n_data, data_group = _rank_in(mesh, data_axis)
        m, _, model_group = _rank_in(mesh, model_axis)
        f = xy.shape[0]
        if f % n_data != 0:
            raise ValueError(
                f"frame count {f} is not a multiple of the mesh's '{data_axis}' axis "
                f"size {n_data}; pad the frames (repeat a real frame with "
                f"frame_valid 0) before calling the step")
        rows = slice(d * f // n_data, (d + 1) * f // n_data)
        planes_loc = slice(m * nz_loc, (m + 1) * nz_loc)
        dsi = _vote_local(cam, xy[rows], valid[rows], frame_valid[rows], H[rows],
                          phi[rows, planes_loc], nz_loc, mode)
        if mode == "nearest":
            # integral counts: an integer all-reduce is exact
            dsi = dsi.to(vote_dtype).to(torch.int32)
        dist.all_reduce(dsi, op=dist.ReduceOp.SUM, group=data_group)
        dsi_full = all_gather_rows(dsi, model_group)
        conf, zf = depth_argmax_ref(dsi_full.to(torch.float32))
        dm = detect_filter(conf, zf, dsi_cfg.planes(device=xy.device), median_filter=False)
        return dsi_full, dm.depth, dm.mask, dm.confidence

    if pod_axis is None:
        return seg_body

    def step(xy, valid, frame_valid, H, phi):
        # key-frame-level parallelism: the leading segment axis over pods
        p, n_pod, pod_group = _rank_in(mesh, pod_axis)
        g = xy.shape[0]
        if g % n_pod != 0:
            raise ValueError(
                f"segment count {g} is not a multiple of the mesh's '{pod_axis}' axis "
                f"size {n_pod}")
        rows = range(p * g // n_pod, (p + 1) * g // n_pod)
        outs = [seg_body(xy[k], valid[k], frame_valid[k], H[k], phi[k]) for k in rows]
        return tuple(all_gather_rows(torch.stack(o), pod_group) for o in zip(*outs))

    return step


def emvs_input_specs(dsi_cfg: DSIConfig, *, frames: int, events: int,
                     segments: int | None = None) -> dict:
    """Meta-tensor stand-ins for the split step's inputs, in its positional
    argument order. With `segments`, each gains the leading G axis the pod
    path takes (`make_emvs_step(pod_axis=...)`)."""
    lead = () if segments is None else (segments,)

    def spec(*shape):
        return torch.empty(lead + shape, dtype=torch.float32, device="meta")

    return {
        "xy": spec(frames, events, 2),
        "valid": spec(frames, events),
        "frame_valid": spec(frames),
        "H": spec(frames, 3, 3),
        "phi": spec(frames, dsi_cfg.num_planes, 3),
    }


# ---------------------------------------------------------------------------
# Key-frame-level segment sharding: the `sweep="sharded"` backend
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def local_process_group(device, *, rank: int = 0, world_size: int = 1,
                        store_path: str | None = None):
    """The default process group of `world_size` ranks on this machine,
    rendezvous through a `FileStore` (no network): NCCL for a CUDA
    `device`, gloo otherwise; destroyed on exit. Ranks of one group pass
    the same `store_path`; with one rank it defaults to a file in a fresh
    temporary directory."""
    device = torch.device(device)
    with contextlib.ExitStack() as stack:
        if store_path is None:
            if world_size != 1:
                raise ValueError("ranks of a group of more than one must share a store_path")
            store_path = os.path.join(stack.enter_context(tempfile.TemporaryDirectory()),
                                      "store")
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                store=dist.FileStore(store_path, world_size),
                                rank=rank, world_size=world_size)
        try:
            yield
        finally:
            dist.destroy_process_group()


def make_segment_mesh() -> DeviceMesh:
    """1-D mesh with the segment axis over every rank of the default
    process group, which must be initialized: on the card under NCCL, on
    the CPU otherwise (gloo)."""
    if not dist.is_initialized():
        raise RuntimeError(
            "the sharded sweep needs a process group: call "
            "torch.distributed.init_process_group (one rank per card, or gloo "
            "ranks on the CPU) before make_segment_mesh()")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (dist.get_world_size(),),
                            mesh_dim_names=(SEGMENT_AXIS,))


def segment_axis_size(mesh: DeviceMesh, axis_name: str = SEGMENT_AXIS) -> int:
    """Size of the mesh's segment axis, with a clear error when absent."""
    names = tuple(mesh.mesh_dim_names or ())
    if axis_name not in names:
        raise ValueError(
            f"mesh has axes {names} but the sharded sweep needs a "
            f"'{axis_name}' axis — build the mesh with make_segment_mesh() "
            f"or name its segment axis '{axis_name}'")
    return mesh.shape[names.index(axis_name)]


def process_segments_sharded(
    cam: CameraModel,
    dsi_cfg: DSIConfig,
    batch: SegmentBatch,
    opts: EMVSOptions,
    *,
    mesh: DeviceMesh | None = None,
    axis_name: str = SEGMENT_AXIS,
) -> tuple[Tensor, DepthMap]:
    """`process_segments_batched` with the segment axis split over `mesh`.

    Every rank passes the same whole batch; rank r of the segment axis
    sweeps rows [r S/n, (r+1) S/n) and the outputs are all-gathered, so
    every rank returns the whole stacked (S, ...) outputs. S must be a
    multiple of the axis size n; callers pad S by repeating a real segment
    (`run_emvs` and the streaming engine's S buckets do), and the padded
    rows are discarded work. Per-segment outputs equal the batched
    backend's bitwise: each rank runs the same per-segment program.
    """
    if mesh is None:
        mesh = make_segment_mesh()
    n = segment_axis_size(mesh, axis_name)
    s = batch.xy.shape[0]
    if s % n != 0:
        raise ValueError(
            f"segment count {s} is not a multiple of the mesh's "
            f"'{axis_name}' axis size {n}; pad the segment list (repeat a "
            f"real segment) before calling process_segments_sharded")
    r, _, group = _rank_in(mesh, axis_name)
    rows = slice(r * s // n, (r + 1) * s // n)
    dsi, dm = sweep_segment_batch(cam, dsi_cfg, SegmentBatch(*(t[rows] for t in batch)), opts)
    if opts.quantized:
        # the DSI's values fit its int16 store: the wire carries that width
        dsi = dsi_lib.from_storage(all_gather_rows(dsi_lib.to_storage(dsi), group))
    else:
        dsi = all_gather_rows(dsi, group)
    return dsi, DepthMap(*(all_gather_rows(t, group) for t in dm))
