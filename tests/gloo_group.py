"""Gloo groups for the tests that run the port over `torch.distributed` on
the CPU (`test_torch_sharded.py`, `test_torch_lm_distributed.py`,
`test_torch_stacked_fsdp.py`).

A rank runs `target(rank, world, tmp)`, reports each case with `check`,
and pickles its outcomes to `tmp/out{world}_{rank}.pkl`. `run_ranks`
starts the group and joins it against one deadline below the per-test
limit of the repository's root `conftest.py`, so a rank blocked in a
collective (where no signal reaches the parent's Python) fails its test
instead of holding the worker. Each rank's process-group timeout stays
below the deadline. `outcomes` runs each group once per module and keeps
its result or its failure, so a group that failed fails every later test
of the module at once instead of being spawned again.
"""
from __future__ import annotations

import os
import pickle
import time
import traceback

import pytest
import torch
import torch.multiprocessing as mp

RANKS_DEADLINE_S = 360


def _rank(rank: int, target, world: int, tmp: str, threads: int) -> None:
    torch.set_num_threads(threads)
    target(rank, world, tmp)


def _stop(processes) -> None:
    """Terminate every rank still running, then reap them all."""
    for p in processes:
        if p.is_alive():
            p.terminate()
    for p in processes:
        p.join(10)
        if p.is_alive():
            p.kill()
            p.join()


def run_ranks(target, world: int, tmp: str) -> list[dict]:
    """Run `world` ranks of `target`, which share this process's torch
    threads; every rank's outcomes, in rank order. A rank that raises
    fails the test with its traceback; at `RANKS_DEADLINE_S` every rank is
    terminated and the test fails, naming the ranks that had not
    returned."""
    deadline = RANKS_DEADLINE_S
    threads = max(1, torch.get_num_threads() // world)
    ctx = mp.start_processes(_rank, args=(target, world, tmp, threads), nprocs=world,
                             join=False)
    end = time.monotonic() + deadline
    try:
        while not ctx.join(timeout=max(0.0, end - time.monotonic())):
            if time.monotonic() >= end:
                late = [r for r, p in enumerate(ctx.processes) if p.exitcode is None]
                pytest.fail(f"gloo ranks {late} of {world} had not returned within {deadline} s")
    finally:
        _stop(ctx.processes)
    outs = []
    for r in range(world):
        with open(os.path.join(tmp, f"out{world}_{r}.pkl"), "rb") as f:
            outs.append(pickle.load(f))
    return outs


def outcomes(target, spec, world: int, order=(4, 2)) -> list[dict]:
    """Every rank's outcomes of the `world`-rank group of `target`. The
    groups of `order` run in turn, once per module (`spec.ranks` keeps each
    one's outcomes, or the failure that ended it), up to and including
    `world`; a group that failed fails the test at once."""
    for w in order:
        if w not in spec.ranks:
            try:
                spec.ranks[w] = run_ranks(target, w, spec.tmp)
            except (Exception, pytest.fail.Exception) as e:
                spec.ranks[w] = e
                raise
        if isinstance(spec.ranks[w], BaseException):
            pytest.fail(f"the {w}-rank gloo group failed in an earlier test: {spec.ranks[w]}")
        if w == world:
            break
    return spec.ranks[world]


def check(out: dict, name, fn) -> None:
    """Run one case on a rank; record None, or the failure's traceback."""
    try:
        fn()
        out[name] = None
    except Exception:  # noqa: BLE001 — reported to the parent, which fails the test
        out[name] = traceback.format_exc()


def assert_case(outs: list[dict], case) -> None:
    """Every rank ran `case` and it passed."""
    for r, out in enumerate(outs):
        assert case in out, f"rank {r} never ran {case}"
        assert out[case] is None, f"rank {r} of {len(outs)}, {case}:\n{out[case]}"
