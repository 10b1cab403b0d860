"""Build, load and count the hand-written CUDA kernels.

Each `csrc/<name>.cu` compiles with nvcc into its own shared library
`build/lib<name>.so` (a plain C interface, loaded with ctypes) at first
use; `build_all` starts one nvcc per source at once. Nothing here runs at
import time, so the package imports on machines without CUDA or nvcc;
asking for a kernel there raises.

`launch_counts` holds one plain integer per kernel. A launcher adds one
exactly where it enqueues its kernel, so a caller can zero the counts,
drive a path and read which kernels that path launched. One key is not a
launch count: `backproject_vote_bands` adds each B1 launch's row bands
(its CTAs per plane and segment), so it counts work units, not launches.
"""
from __future__ import annotations

import collections
import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
KERNEL_SOURCES = ("backproject_vote", "local_max", "flash_attention", "detect_filter",
                  "canonical_project", "frame_poses")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
NVCC_DEFAULT = "/usr/local/cuda/bin/nvcc"

launch_counts: collections.Counter[str] = collections.Counter()
_libraries: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: `nvcc` on PATH, else the toolkit's default place."""
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.exists(NVCC_DEFAULT):
        return NVCC_DEFAULT
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are built from source at first "
        "use and need the CUDA toolkit (PATH or /usr/local/cuda/bin)")


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = library_path(name)
    src = CSRC / f"{name}.cu"
    return not lib.exists() or lib.stat().st_mtime < src.stat().st_mtime


def build_all(names: tuple[str, ...] = KERNEL_SOURCES, force: bool = False
              ) -> dict[str, tuple[float, str]]:
    """Compile the named sources in parallel; `{name: (seconds, log)}`.

    Up-to-date libraries are skipped (seconds 0.0, empty log) unless
    `force`. Raises `RuntimeError` with the compiler's output when any
    build fails.
    """
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        if not force and not _stale(name):
            continue
        out = library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       time.perf_counter(), tmp, out, cmd)
    results = {name: (0.0, "") for name in names}
    failed = []
    for name, (proc, t0, tmp, out, cmd) in procs.items():
        log, _ = proc.communicate()
        results[name] = (time.perf_counter() - t0, log)
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return results


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, building it first if needed."""
    lib = _libraries.get(name)
    if lib is None:
        build_all((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        _libraries[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def current_stream(device) -> ctypes.c_void_p:
    """PyTorch's current stream on `device`, as the C entry points take it."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
