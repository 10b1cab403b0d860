"""Two rules that keep the tier-1 suite (`tests/`) inside its clock.

* One thread budget: each pytest process (an xdist worker, or the only
  one) takes its share of the cores, `THREADS`, for torch's intra-op
  threads and, through `OMP_NUM_THREADS` and `MKL_NUM_THREADS`, for the
  BLAS pools of numpy and of every child interpreter and gloo rank. It is
  set here, before any test module imports torch.
* A time limit: each test under `tests/` gets `TEST_LIMIT_S` for its setup
  plus call, after which SIGALRM fails it with its node id. A signal does
  not reach a thread blocked in C++ (a gloo collective), so the gloo
  groups of `tests/gloo_group.py` join against a deadline below the limit.
"""
from __future__ import annotations

import os
import pathlib
import signal
import threading
import time

import pytest


def _budget(workers: int) -> int:
    cores = len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity") else os.cpu_count()
    return max(1, (cores or 1) // workers)


def _export(threads: int) -> None:
    os.environ["OMP_NUM_THREADS"] = os.environ["MKL_NUM_THREADS"] = str(threads)


THREADS = _budget(int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
_export(THREADS)
try:
    import torch
except ImportError:  # the reference's tests run without the port
    pass
else:
    torch.set_num_threads(THREADS)

TEST_LIMIT_S = 420  # about four times the slowest setup plus call of a calm run
SUITE = pathlib.Path(__file__).parent / "tests"

pytest_plugins = ["pytester"]


def pytest_configure(config):
    """The xdist controller exports the workers' budget before it starts
    them: numpy's BLAS, which pytest's plugins import before this file,
    reads it when it loads."""
    workers = getattr(config.option, "numprocesses", None)
    if isinstance(workers, int) and workers > 0:
        _export(_budget(workers))


_STARTED = pytest.StashKey[float]()


def _limited(item: pytest.Item):
    """One phase of `item` (its setup, then its call) under what is left of
    `TEST_LIMIT_S`. It does nothing outside `SUITE`, off the main thread,
    where no signal handler can be set, or without `signal.setitimer`."""
    if (not item.path.is_relative_to(SUITE) or not hasattr(signal, "setitimer")
            or threading.current_thread() is not threading.main_thread()):
        return (yield)
    left = TEST_LIMIT_S - (time.monotonic() - item.stash.setdefault(_STARTED, time.monotonic()))

    def expire(signum, frame):
        pytest.fail(f"{item.nodeid} ran past the per-test limit of {TEST_LIMIT_S} s")

    previous = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, max(left, 1e-3))
    try:
        return (yield)
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_setup(item):
    return (yield from _limited(item))


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    return (yield from _limited(item))
