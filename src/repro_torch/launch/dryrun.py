"""Dry run: trace every (arch x cell) step on fake tensors and record its
memory, FLOPs, bytes and roofline, without allocating or launching.

    python -m repro_torch.launch.dryrun --arch qwen3-8b --cell prefill_32k [--mesh card]
    python -m repro_torch.launch.dryrun --all [--mesh both] [--out results/dryrun_torch]

Counterpart of `repro.launch.dryrun`, which lowers and compiles each cell
for a 256- or 512-chip TPU mesh. The step is traced on fake tensors of
the chosen device (`FakeTensorMode`; the card unless `--device cpu`)
under `launch/graph_analysis.py`, whose counts feed `launch/roofline.py`.
On the card the step reaches the hand-written kernels as one operation
each (their fake implementations), on the CPU their plain versions.

Meshes (`--mesh`, default "single" as in the reference; "both" is single
and multi):
  * "single" is the reference's (data=16, model=16) and "multi" its
    (pod=2, data=16, model=16), each over a fake process group of 256 or
    512 ranks (`torch.testing._internal.distributed.fake_pg`; the trace
    runs as rank 0 and no collective moves data). Parameters and inputs
    are DTensors placed by the reference's serving policy (FSDP only
    where the model-parallel copy passes 8 GB; EP where the experts
    divide `model`; `SeqShard` for the hybrid `long_500k`; `--opts
    pad_heads` pads heads to `model`), and train cells trace
    `training.train_step.lower_train_step` with the reference's
    microbatch choice (FSDP on, so mamba2-2.7b's stacked leaves are held
    in the mesh layout of `distributed/sharding.py`). The EMVS cells trace
    `distributed.emvs.make_emvs_step` as the reference lowers it: 256
    planes; `emvs_rt` one 1024-event packet split into `data` frames,
    `emvs_seg` 256 frames of 1024 events; on multi two segments over
    `pod`; `--opts int16_votes` narrows the votes to int16 on the link.
    DTensor runs each operation on rank 0's shards, so a record's FLOPs,
    bytes and memory are one rank's; `devices` is 256 or 512 and
    `memory.argument_bytes_global` holds the unsharded argument bytes.
  * "card" is one card, unsharded: the train cells trace the unsharded
    `make_train_step`, the EMVS cells the batched sweep (the main path's
    options, 256 planes), which reaches B1 and B2. It answers the port's
    own question: does the cell fit one H100, and what does B1 count.

The record keeps the reference's keys: arch, cell, mesh, devices, opts
(production meshes), memory (argument, output and peak temporary bytes;
for LM cells also the parameters' bytes, one rank's and global),
roofline and, for EMVS, `emvs_votes`; `trace_s` takes the place of the
lowering and compile times, and `kernels` lists each hand-written
kernel's call with its declared bytes and FLOPs.

Cells: every LM arch runs `train_4k`, `prefill_32k` and `decode_32k`, and
the SSM and hybrid archs `long_500k` (a decode step at 524,288 tokens of
context); `eventor-davis240` runs `emvs_rt` and `emvs_seg`. Skipped cells
carry the reference's own skip reason. A cell whose step reaches an
operation that fake tensors cannot run (no meta kernel) is recorded as
skipped, naming the operation.

`--all` writes one JSON per cell into `--out`, tracing each cell in a
subprocess of its own (a skipped cell's record is written directly).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import time

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import UnsupportedOperatorException
from torch.distributed.tensor import DTensor

from repro_torch.configs import ArchConfig, get_config
from repro_torch.configs.shapes import (
    EMVS_CELL_PLANES,
    EMVS_CELLS,
    LM_CELLS,
    ShapeCell,
    cell_skipped,
    input_specs,
)
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding as shd
from repro_torch.launch import graph_analysis as ga
from repro_torch.launch import roofline as rf
from repro_torch.launch.mesh import make_production_mesh

ARCHS = [
    "kimi-k2-1t-a32b", "deepseek-moe-16b", "musicgen-large", "stablelm-3b",
    "qwen3-8b", "starcoder2-15b", "qwen1.5-4b", "jamba-1.5-large-398b",
    "llava-next-mistral-7b", "mamba2-2.7b", "eventor-davis240",
]
MESHES = ("card", "single", "multi")
DEFAULT_OUT = "results/dryrun_torch"
# ranks of the fake group each production mesh is built over
PRODUCTION_RANKS = {"single": 256, "multi": 512}


MAX_TOKENS_PER_DEV_MB = 16384  # microbatch sizing target (activation memory)


def _pick_microbatches(cell: ShapeCell, batch_shards: int) -> int:
    tokens_per_dev = cell.global_batch * cell.seq_len // batch_shards
    mb = 1
    while (tokens_per_dev // mb > MAX_TOKENS_PER_DEV_MB
           and (cell.global_batch // (mb * 2)) % batch_shards == 0
           and cell.global_batch // (mb * 2) >= batch_shards):
        mb *= 2
    return mb


def _batch_shards(mesh) -> int:
    sizes = shd.axis_sizes(mesh)
    return math.prod(sizes.get(a, 1) for a in ("pod", "data"))


def _local(t):
    return t.to_local() if isinstance(t, DTensor) else t


def _tree_bytes(tree, local: bool = True) -> int:
    """Bytes of a tree's tensors: one rank's shards, or with `local=False`
    the whole (unsharded) tensors."""
    return sum(t.numel() * t.element_size() if not local else
               _local(t).numel() * _local(t).element_size() for t in ga.tensors_of(tree))


@contextlib.contextmanager
def fake_process_group(world: int):
    """A fake default process group of `world` ranks (this process is rank
    0; collectives move nothing), destroyed on exit. An initialized group
    is used as it is."""
    if dist.is_initialized():
        yield
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _emvs_step(cell: ShapeCell, dev: torch.device, fake):
    """The batched sweep of one segment of the cell's frames, and its inputs."""
    from repro_torch.core.camera import CameraModel
    from repro_torch.core.dsi import DSIConfig
    from repro_torch.core.pipeline import EMVSOptions, SegmentBatch, sweep_segment_batch

    cam = CameraModel()
    dsi_cfg = DSIConfig.for_camera(cam, num_planes=EMVS_CELL_PLANES)
    opts = EMVSOptions(formulation="kernel", voting="nearest", quantized=True)
    s, c, e = 1, cell.global_batch, cell.seq_len
    f32 = torch.float32
    with fake:
        batch = SegmentBatch(
            xy=torch.empty((s, c, e, 2), dtype=f32, device=dev),
            valid=torch.empty((s, c, e), dtype=torch.bool, device=dev),
            frame_valid=torch.empty((s, c), dtype=torch.bool, device=dev),
            poses_R=torch.empty((s, c, 3, 3), dtype=f32, device=dev),
            poses_t=torch.empty((s, c, 3), dtype=f32, device=dev),
            ref_R=torch.empty((s, 3, 3), dtype=f32, device=dev),
            ref_t=torch.empty((s, 3), dtype=f32, device=dev))

    def step(b):
        dsi, dm = sweep_segment_batch(cam, dsi_cfg, b, opts)
        return dsi, dm.depth, dm.mask, dm.confidence

    n_votes = s * c * e * dsi_cfg.num_planes
    return step, (batch,), {"emvs_votes": n_votes, "model_flops": 5.0 * n_votes}


def _train_step(cfg: ArchConfig, cell: ShapeCell, dev: torch.device, fake):
    """The unsharded train step of the cell's global batch, and its inputs."""
    from repro_torch.training.train_step import TrainOptions, init_train_state, make_train_step

    opts = TrainOptions(microbatches=_pick_microbatches(cell, 1), remat=True)
    specs = input_specs(cfg, cell, device=dev, fake_mode=fake)
    with fake:
        state = init_train_state(None, cfg, opts, device=dev)
    step = make_train_step(cfg, opts)
    return step, (state, specs), {"microbatches": opts.microbatches}


def _lm_step(cfg: ArchConfig, cell: ShapeCell, dev: torch.device, fake):
    """Prefill or one decode step of the cell's batch, and its inputs."""
    from repro_torch.models import model as M

    if cell.kind == "train":
        return _train_step(cfg, cell, dev, fake)
    specs = input_specs(cfg, cell, device=dev, fake_mode=fake)
    with fake:
        params = M.init_params(cfg, generator=None, dtype=torch.bfloat16, device=dev)
    front = specs.get("frontend_embed")
    if cell.kind == "prefill":
        def step(params, tokens, front):
            logits, _ = M.prefill(params, tokens, cfg, cell.seq_len, frontend_embed=front)
            return logits

        return step, (params, specs["tokens"], front), {}
    with fake:
        state = M.init_decode_state(cfg, cell.global_batch, cell.seq_len, device=dev)

    def step(params, state, tokens, front):
        logits, _ = M.decode_step(params, state, tokens, cell.seq_len - 1, cfg,
                                  frontend_embed=front)
        return logits

    return step, (params, state, specs["tokens"], front), {}


def _emvs_mesh_trace(cell: ShapeCell, mesh, dev: torch.device, fake, opt_flags: frozenset):
    """The reference's `_lower_emvs`: `make_emvs_step` over the mesh (two
    segments over `pod` on the multi mesh), traced on its global inputs;
    returns (`analyze`'s result, the step's arguments, extra entries)."""
    from repro_torch.core.camera import CameraModel
    from repro_torch.core.dsi import DSIConfig
    from repro_torch.distributed.emvs import emvs_input_specs, make_emvs_step

    cam = CameraModel()
    dsi_cfg = DSIConfig.for_camera(cam, num_planes=EMVS_CELL_PLANES)
    multi = "pod" in mesh.mesh_dim_names
    data = shd.axis_sizes(mesh)["data"]
    if cell.name == "emvs_rt":
        # one 1024-event packet, split into pose-identical slices so the
        # event axis shards over `data` (votes are additive: exact)
        frames, events = data, cell.seq_len // data
    else:
        frames, events = cell.global_batch, cell.seq_len
    segments = 2 if multi else None
    step = make_emvs_step(cam, dsi_cfg, mesh, pod_axis="pod" if multi else None,
                          vote_dtype=torch.int16 if "int16_votes" in opt_flags else torch.int32)
    specs = emvs_input_specs(dsi_cfg, frames=frames, events=events, segments=segments)
    with fake:
        args = tuple(torch.empty(v.shape, dtype=v.dtype, device=dev) for v in specs.values())
    n_votes = (segments or 1) * frames * events * dsi_cfg.num_planes
    return (ga.analyze(step, *args, fake=fake), args,
            {"emvs_votes": n_votes, "model_flops": 5.0 * n_votes})


def _mesh_trace(cfg: ArchConfig, cell: ShapeCell, mesh, dev: torch.device, fake,
                opt_flags: frozenset):
    """The reference's `lower_cell` on a production mesh: the cell's step
    over DTensors placed by its policy (EMVS: `_emvs_mesh_trace`), traced;
    returns (`analyze`'s result, the step's arguments, extra entries)."""
    from repro_torch.distributed.expert_parallel import EPShard
    from repro_torch.distributed.flash_decode import SeqShard
    from repro_torch.models import model as M

    if cfg.family == "emvs":
        return _emvs_mesh_trace(cell, mesh, dev, fake, opt_flags)
    if "pad_heads" in opt_flags and cfg.n_heads:
        cfg = cfg.pad_heads_to(shd.axis_sizes(mesh).get("model", 1))
    specs = input_specs(cfg, cell, device=dev, fake_mode=fake)
    plan = shd.ShardingPlan.for_mesh(mesh)
    if cell.kind == "train":
        from repro_torch.training.train_step import TrainOptions, lower_train_step

        mb = _pick_microbatches(cell, _batch_shards(mesh))
        opts = TrainOptions(
            microbatches=mb, remat=True,
            grad_acc_sharded="grad_acc_spec" in opt_flags,
            moe_combine_bf16="bf16_combine" in opt_flags,
            ep_dispatch="a2a" if "ep_a2a" in opt_flags else "psum",
            ep_zero3="ep_zero3" in opt_flags,
            seq_parallel="seq_parallel" in opt_flags)
        (out, stats, mode), state = lower_train_step(cfg, opts, mesh, plan, specs,
                                                     fake=fake, device=dev)
        return (out, stats, mode), (state, specs), {"microbatches": mb}

    # Serving sharding policy: replicate params over `data` (no FSDP) when
    # the TP-sharded copy fits comfortably in HBM; FSDP only when a replica
    # cannot fit (kimi-1t, jamba-398b).
    with fake:
        params = M.init_params(cfg, generator=None, dtype=torch.bfloat16, device=dev)
    tp = shd.axis_sizes(mesh).get("model", 1)
    serve_fsdp = _tree_bytes(params) / tp > 8e9
    plan = shd.ShardingPlan.for_mesh(mesh, fsdp=serve_fsdp)
    batch_axes = tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)
    act_batch_axes = batch_axes if cell.global_batch % _batch_shards(mesh) == 0 else ()
    ep = None
    if cfg.moe is not None and cfg.moe.num_experts % tp == 0 and act_batch_axes:
        ep = EPShard(mesh, token_axes=act_batch_axes)
    seq = (SeqShard(mesh) if cell.name == "long_500k" and cfg.family == "hybrid" else None)
    ctx = M.ModelCtx(mesh=mesh, batch_axes=act_batch_axes, ep_shard=ep, seq_shard=seq)
    with fake:
        params = shd.distribute(params, shd.param_specs(cfg, params, mesh, plan), mesh,
                                src_data_rank=None)
        inputs = {k: shd.constrain(v, mesh, shd.batch_spec(tuple(v.shape), mesh, plan))
                  for k, v in specs.items()}
    front = inputs.get("frontend_embed")
    if cell.kind == "prefill":
        def step(params, tokens, front):
            logits, _ = M.prefill(params, tokens, cfg, cell.seq_len, frontend_embed=front,
                                  ctx=ctx)
            return logits

        args = (params, inputs["tokens"], front)
        return ga.analyze(step, *args, fake=fake), args, {}
    with fake:
        state = M.init_decode_state(cfg, cell.global_batch, cell.seq_len, ctx=ctx, device=dev)
        state = shd.distribute(state, shd.decode_state_specs(cfg, state, mesh, plan), mesh,
                               src_data_rank=None)

    def step(params, state, tokens, front):
        logits, _ = M.decode_step(params, state, tokens, cell.seq_len - 1, cfg,
                                  frontend_embed=front, ctx=ctx)
        return logits

    args = (params, state, inputs["tokens"], front)
    return ga.analyze(step, *args, fake=fake), args, {}


def run_cell(arch: str, cell_name: str, mesh_kind: str = "single", *,
             device=None, opt_flags: frozenset = frozenset()) -> dict:
    """Trace one cell on fake tensors of `device` (the card unless "cpu")
    on `mesh_kind` ("card", "single" or "multi") and return its record
    (see the module docstring)."""
    cfg = get_config(arch)
    table = EMVS_CELLS if cfg.family == "emvs" else LM_CELLS
    cell = table[cell_name]
    rec: dict = {"arch": arch, "cell": cell_name, "mesh": mesh_kind}
    world = PRODUCTION_RANKS.get(mesh_kind)
    if world is None and mesh_kind != "card":
        raise ValueError(f"mesh {mesh_kind!r}: one of {MESHES}")
    if world:
        rec["opts"] = sorted(opt_flags)
    skip = cell_skipped(cfg, cell)
    if skip:
        rec["skipped"] = skip
        return rec
    dev = resolve_device(device)
    with (fake_process_group(world) if world else contextlib.nullcontext()):
        fake = ga.fake_mode()
        t0 = time.time()
        try:
            if world:
                mesh = make_production_mesh(multi_pod=mesh_kind == "multi", device_type=dev.type)
                (out, stats, mode), args, extra = _mesh_trace(cfg, cell, mesh, dev, fake,
                                                              opt_flags)
            else:
                step, args, extra = (_emvs_step(cell, dev, fake) if cfg.family == "emvs"
                                     else _lm_step(cfg, cell, dev, fake))
                out, stats, mode = ga.analyze(step, *args, fake=fake)
        except UnsupportedOperatorException as exc:
            rec["skipped"] = (f"fake tensors cannot trace {exc.func}: the operation "
                              "has no meta kernel")
            return rec
        n_dev = world or 1
        t1 = time.time()
        mf = extra.pop("model_flops", None)
        if mf is None:
            mf = rf.model_flops_for_cell(cfg, cell)
        roof = rf.analyze(stats, n_devices=n_dev, model_flops_global=mf)
        memory = {"argument_bytes": _tree_bytes(args),
                  "argument_bytes_global": _tree_bytes(args, local=False),
                  "output_bytes": _tree_bytes(out),
                  "peak_temp_bytes": stats.peak_temp_bytes}
        if cfg.family != "emvs":  # the parameters: the first argument (a train state's)
            params = args[0].params if cell.kind == "train" else args[0]
            memory.update(param_bytes=_tree_bytes(params),
                          param_bytes_global=_tree_bytes(params, local=False))
        rec.update({
            "devices": n_dev,
            "device": dev.type,
            "trace_s": round(t1 - t0, 2),
            "memory": memory,
            "roofline": roof.to_json(),
            "kernels": [{"op": o.name, "bytes": o.bytes_read + o.bytes_written,
                         "flops": o.flops, "outputs": o.outputs}
                        for o in mode.ops if o.name.startswith("repro_torch.")],
            **extra,
        })
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch")
    ap.add_argument("--cell")
    ap.add_argument("--mesh", choices=[*MESHES, "both"], default="single",
                    help="card (one card, unsharded), single (data=16, model=16 over 256 "
                    "fake ranks), multi (pod=2, data=16, model=16 over 512), both "
                    "(single and multi)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--json", help="write the single cell's record here")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--opts", default="", help="comma-separated options of the production "
                    "meshes: pad_heads,grad_acc_spec,bf16_combine,ep_a2a,ep_zero3,"
                    "seq_parallel,int16_votes")
    args = ap.parse_args(argv)

    if args.all:
        os.makedirs(args.out, exist_ok=True)
        meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
        failures = 0
        for arch in ARCHS:
            cfg = get_config(arch)
            table = EMVS_CELLS if cfg.family == "emvs" else LM_CELLS
            for cell_name in table:
                for mk in meshes:
                    tag = f"{arch}__{cell_name}__{mk}".replace("/", "_")
                    out_json = os.path.join(args.out, tag + ".json")
                    if os.path.exists(out_json):
                        print(f"[skip-cached] {tag}")
                        continue
                    skip = cell_skipped(cfg, table[cell_name])
                    if skip:  # no trace to isolate: the record, in process
                        with open(out_json, "w") as f:
                            json.dump({"arch": arch, "cell": cell_name, "mesh": mk,
                                       "skipped": skip}, f, indent=1)
                        print(f"[skip] {tag}: {skip}")
                        continue
                    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                           "--arch", arch, "--cell", cell_name, "--mesh", mk,
                           "--json", out_json]
                    if args.device:
                        cmd += ["--device", args.device]
                    if args.opts:
                        cmd += ["--opts", args.opts]
                    print(f"[run] {tag}", flush=True)
                    r = subprocess.run(cmd, capture_output=True, text=True, timeout=3600)
                    if r.returncode != 0:
                        failures += 1
                        with open(out_json + ".err", "w") as f:
                            f.write(r.stdout[-4000:] + "\n" + r.stderr[-8000:])
                        print(f"[FAIL] {tag}: see {out_json}.err")
        print(f"done; {failures} failures")
        return 1 if failures else 0

    rec = run_cell(args.arch, args.cell, args.mesh, device=args.device,
                   opt_flags=frozenset(x for x in args.opts.split(",") if x))
    out = json.dumps(rec, indent=1, default=str)
    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as f:
            f.write(out)
    print(out)
    if "skipped" not in rec:
        print(f"\nmemory: {rec['memory']}")
        print(f"roofline: flops={rec['roofline']['flops']:.3e} "
              f"bytes={rec['roofline']['bytes_hbm']:.3e} "
              f"dominant={rec['roofline']['dominant']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
