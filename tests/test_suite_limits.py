"""The per-test limit of the repository's root `conftest.py`, held in an
inner pytest session (a child interpreter, so its SIGALRM is not this
worker's) that loads that conftest's hooks with the limit patched to 2 s
and the limited directory patched to the inner session's own."""
from __future__ import annotations

import os
import pathlib
import signal
import threading
import time

import pytest

ROOT_CONFTEST = pathlib.Path(__file__).resolve().parents[1] / "conftest.py"

INNER_LIMIT_S = 2
INNER_CONFTEST = f"""
import importlib.util
import pathlib

spec = importlib.util.spec_from_file_location("suite_conftest", {str(ROOT_CONFTEST)!r})
suite = importlib.util.module_from_spec(spec)
spec.loader.exec_module(suite)
suite.TEST_LIMIT_S = {INNER_LIMIT_S}
suite.SUITE = pathlib.Path(__file__).parent
pytest_runtest_setup = suite.pytest_runtest_setup
pytest_runtest_call = suite.pytest_runtest_call
"""
CHILD = ("subprocess.run([sys.executable, '-c', 'import os, time; "
         "open(\\'child.pid\\', \\'w\\').write(str(os.getpid())); time.sleep(600)'], "
         "timeout=1500)")
# (setup, call): past the limit in the setup, in the call, in neither
# alone but in both together, and in the call while it waits on a child
# interpreter whose own timeout is longer than the limit
OVERRUNS = {"setup": ("time.sleep(600)", "pass"), "call": ("pass", "time.sleep(600)"),
            "setup+call": ("time.sleep(1)", "time.sleep(1.5)"), "child": ("pass", CHILD)}
INNER_TESTS = """
import subprocess
import sys
import time

import pytest


@pytest.fixture
def slow_setup():
    {setup}


def test_overruns(slow_setup):
    {call}


def test_next_passes():
    pass
"""


@pytest.mark.parametrize("phase", list(OVERRUNS))
def test_a_test_past_the_limit_fails_alone(pytester, phase):
    """The overrunning test fails with its node id and the limit; the next
    test in the file passes, on a clock of its own. A child interpreter the
    test waited on is killed with it."""
    setup, call = OVERRUNS[phase]
    pytester.makeconftest(INNER_CONFTEST)
    pytester.makepyfile(test_inner=INNER_TESTS.format(setup=setup, call=call))
    start = time.monotonic()
    result = pytester.runpytest_subprocess("-p", "no:cacheprovider", "-p", "no:randomly",
                                           timeout=120)
    assert time.monotonic() - start < 90
    result.stdout.fnmatch_lines(
        [f"*test_inner.py::test_overruns ran past the per-test limit of {INNER_LIMIT_S} s*"])
    if phase == "setup":
        result.assert_outcomes(passed=1, errors=1)
    else:
        result.assert_outcomes(passed=1, failed=1)
    if phase == "child":
        with pytest.raises(ProcessLookupError):
            os.kill(int((pytester.path / "child.pid").read_text()), 0)


def test_this_test_runs_under_the_limit(pytestconfig):
    """xdist runs each test on its worker's main thread, so the limit is
    armed here, with at most `TEST_LIMIT_S` left."""
    limit = pytestconfig.pluginmanager.get_plugin(str(ROOT_CONFTEST)).TEST_LIMIT_S
    assert threading.current_thread() is threading.main_thread()
    left, _ = signal.getitimer(signal.ITIMER_REAL)
    assert 0 < left <= limit
