"""Fault tolerance, host half: checkpoint/restart, preemption drain,
elastic re-meshing, straggler detection.

Counterpart of `repro.distributed.fault_tolerance`, with its on-disk
format, so a checkpoint crosses packages both ways:

* a step directory `step_<10 digits>` holding `arrays.npz` (one entry per
  leaf, keyed by its path: dict keys, sequence indices and NamedTuple
  field names joined by "/") and `manifest.json` (step, time, keys,
  shapes, the true dtypes, extra);
* bfloat16 leaves stored as their uint16 bit patterns, read back through
  an int16 view into `torch.bfloat16` (no ml_dtypes);
* atomic writes (a `.tmp` directory renamed into place) and rolling
  cleanup (`keep_last`).

Trees are nested dicts, lists, tuples and NamedTuples of tensors or numpy
arrays. A tree of DTensors (a sharded state) is saved as full arrays:
every rank gathers each leaf (`full_tensor`), rank 0 writes, and a
barrier follows. `restore_checkpoint(shardings=)` is the elastic path:
every rank reads the full arrays and keeps its own shard of each, on the
mesh of the given shardings, which may differ from the mesh that saved.
Preemption drain, elastic re-meshing and the straggler watchdog are the
reference's, copied.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import signal
import time
from typing import Any, Iterable, Iterator

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

MANIFEST = "manifest.json"


# ---------------------------------------------------------------------------
# Checkpoint save/restore
# ---------------------------------------------------------------------------


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _leaves_with_paths(tree: Any, path: tuple = ()) -> Iterator[tuple[str, Any]]:
    """(key, leaf) in the reference's flatten order: dict keys sorted,
    sequences by index, NamedTuples by field."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_paths(tree[k], path + (str(k),))
    elif _is_namedtuple(tree):
        for name in tree._fields:
            yield from _leaves_with_paths(getattr(tree, name), path + (name,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_paths(v, path + (str(i),))
    else:
        yield "/".join(path), tree


def _rebuild(tree: Any, leaves: Iterator) -> Any:
    """`tree`'s structure with its leaves replaced, in flatten order."""
    if isinstance(tree, dict):
        new = {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
        return {k: new[k] for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(_rebuild(getattr(tree, n), leaves) for n in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves) for v in tree)
    return next(leaves)


def _host_array(leaf) -> tuple[np.ndarray, str]:
    """(the array to store, the leaf's true dtype name). A DTensor is
    gathered whole (a collective: every rank of its mesh calls this)."""
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:  # store the raw bits
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
        return arr, str(arr.dtype)
    arr = np.asarray(leaf)
    if arr.dtype.kind == "V":  # numpy's bfloat16 & friends: store raw uint view
        return arr.view(np.uint16 if arr.dtype.itemsize == 2 else np.uint8), arr.dtype.name
    return arr, str(arr.dtype)


def save_checkpoint(ckpt_dir: str, step: int, tree: Any, *,
                    extra: dict | None = None, keep_last: int = 3) -> str:
    """Atomic rolling checkpoint. Returns the final step directory. With
    DTensor leaves every rank calls it: each gathers, rank 0 writes."""
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    leaves = list(_leaves_with_paths(tree))
    sharded = any(isinstance(leaf, DTensor) for _, leaf in leaves)
    flat, true_dtypes = {}, {}
    for key, leaf in leaves:
        flat[key], true_dtypes[key] = _host_array(leaf)
    if sharded and dist.get_rank() != 0:
        dist.barrier()
        return final
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "arrays.npz"), **flat)
    manifest = {
        "step": step,
        "time": time.time(),
        "keys": sorted(flat),
        "shapes": {k: list(v.shape) for k, v in flat.items()},
        "dtypes": true_dtypes,
        "extra": extra or {},
    }
    with open(os.path.join(tmp, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic publish
    # rolling cleanup
    steps = sorted(all_steps(ckpt_dir))
    for s in steps[:-keep_last]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:010d}"), ignore_errors=True)
    if sharded:
        dist.barrier()
    return final


def all_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp") and \
                os.path.exists(os.path.join(ckpt_dir, name, MANIFEST)):
            out.append(int(name.split("_")[1]))
    return sorted(out)


def latest_step(ckpt_dir: str) -> int | None:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore_checkpoint(ckpt_dir: str, step: int, like: Any,
                       shardings: Any = None) -> Any:
    """Restore into the structure of `like` (tensors or numpy arrays, whose
    shapes must match; meta tensors give shapes only): each leaf a tensor
    of the stored dtype, on the device of `like`'s leaf when that is a
    tensor off the meta device, else on the CPU.

    `shardings`: a matching tree of `sharding.NamedSharding`s — the
    elastic path: each leaf becomes a DTensor on that sharding's mesh,
    which may differ from the mesh that saved."""
    shard_leaves = ([s for _, s in _leaves_with_paths(shardings)]
                    if shardings is not None else None)
    d = os.path.join(ckpt_dir, f"step_{step:010d}")
    with open(os.path.join(d, MANIFEST)) as f:
        manifest = json.load(f)
    leaves = []
    with np.load(os.path.join(d, "arrays.npz")) as data:
        for key, leaf in _leaves_with_paths(like):
            arr = data[key]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"checkpoint leaf {key}: shape {arr.shape}, "
                                 f"expected {tuple(leaf.shape)}")
            if manifest.get("dtypes", {}).get(key) == "bfloat16" and arr.dtype == np.uint16:
                t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
            else:
                t = torch.from_numpy(np.array(arr))
            if shard_leaves is not None:
                leaves.append(shard_leaves[len(leaves)].place(t))
                continue
            on = isinstance(leaf, torch.Tensor) and leaf.device.type != "meta"
            leaves.append(t.to(leaf.device) if on else t)
    return _rebuild(like, iter(leaves))


# ---------------------------------------------------------------------------
# Preemption drain
# ---------------------------------------------------------------------------


class PreemptionHandler:
    """SIGTERM/SIGINT -> drain flag. The train loop checkpoints and exits."""

    def __init__(self, signals: Iterable[int] = (signal.SIGTERM,)):
        self._flag = False
        self._installed = []
        for s in signals:
            try:
                prev = signal.signal(s, self._handle)
                self._installed.append((s, prev))
            except (ValueError, OSError):  # non-main thread
                pass

    def _handle(self, signum, frame):
        self._flag = True

    @property
    def should_drain(self) -> bool:
        return self._flag

    def restore(self) -> None:
        for s, prev in self._installed:
            signal.signal(s, prev)


# ---------------------------------------------------------------------------
# Elastic re-meshing
# ---------------------------------------------------------------------------


def elastic_mesh_shape(n_devices: int, *, model: int = 16,
                       pod_size: int = 256) -> tuple[dict[str, int], int]:
    """Largest (pod, data, model) mesh for the surviving device count.

    TP degree (`model`) is held fixed (model-memory constraint); the data
    axis shrinks first, then pods. Returns (axes dict, devices used).
    Unused survivors become hot spares.
    """
    if n_devices < model:
        raise ValueError(f"need >= {model} devices for TP={model}")
    pods = max(n_devices // pod_size, 1)
    while pods >= 1:
        per_pod = n_devices // pods
        data = per_pod // model
        if data >= 1:
            used = pods * data * model
            axes = {"pod": pods, "data": data, "model": model}
            if pods == 1:
                axes = {"data": data, "model": model}
            return axes, used
        pods -= 1
    raise ValueError("no viable mesh")


@dataclasses.dataclass
class ElasticPlan:
    """What a restart after failure does: re-mesh + resume from step."""

    old_devices: int
    new_devices: int
    new_axes: dict[str, int]
    resume_step: int | None
    spares: int

    def describe(self) -> str:
        return (f"re-mesh {self.old_devices}->{self.new_devices} devices as "
                f"{self.new_axes} (+{self.spares} spares), resume at step "
                f"{self.resume_step}")


def plan_elastic_restart(ckpt_dir: str, old_devices: int, surviving: int,
                         *, model: int = 16, pod_size: int = 256) -> ElasticPlan:
    axes, used = elastic_mesh_shape(surviving, model=model, pod_size=pod_size)
    return ElasticPlan(
        old_devices=old_devices, new_devices=used, new_axes=axes,
        resume_step=latest_step(ckpt_dir), spares=surviving - used)


# ---------------------------------------------------------------------------
# Straggler detection
# ---------------------------------------------------------------------------


class StragglerMonitor:
    """Rolling-median step-time watchdog.

    `observe(dt)` returns an action string when dt exceeds factor x the
    rolling median (None otherwise). Two graded responses:
      * "warn"  — single slow step (transient: host GC, network blip)
      * "drain" — `patience` consecutive slow steps (persistent straggler:
        checkpoint + restart without the slow host)
    """

    def __init__(self, window: int = 32, factor: float = 2.0, patience: int = 3):
        self.window = window
        self.factor = factor
        self.patience = patience
        self.times: list[float] = []
        self.slow_streak = 0

    def observe(self, dt: float) -> str | None:
        med = float(np.median(self.times)) if len(self.times) >= 8 else None
        self.times.append(dt)
        if len(self.times) > self.window:
            self.times.pop(0)
        if med is None:
            return None
        if dt > self.factor * med:
            self.slow_streak += 1
            if self.slow_streak >= self.patience:
                self.slow_streak = 0
                return "drain"
            return "warn"
        self.slow_streak = 0
        return None
