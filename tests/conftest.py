"""Suite-wide fixtures: per-test watchdog + offline-environment shims.

Threaded runtime tests can hang indefinitely when a drain bug deadlocks the
pipeline; a SIGALRM watchdog turns such hangs into loud TimeoutErrors so CI
surfaces them as failures instead of stalling.  Override the limit per test
with ``@pytest.mark.timeout(seconds)`` or globally via ``REPRO_TEST_TIMEOUT``.

Tier-1 command (see ROADMAP.md):  PYTHONPATH=src python -m pytest -x -q
"""
from __future__ import annotations

import os
import signal
import sys

import pytest

# Make tests/ importable (for _hypothesis_compat) regardless of rootdir.
sys.path.insert(0, os.path.dirname(__file__))

DEFAULT_TIMEOUT = int(os.environ.get("REPRO_TEST_TIMEOUT", "120"))
# The coverage gate (scripts/coverage_gate.py) line-traces the core package,
# slowing its hot paths; it sets this scale so per-test limits stretch
# proportionally instead of turning tracer overhead into fake hangs.
TIMEOUT_SCALE = float(os.environ.get("REPRO_TIMEOUT_SCALE", "1"))


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_call(item):
    marker = item.get_closest_marker("timeout")
    limit = int(marker.args[0]) if marker and marker.args else DEFAULT_TIMEOUT
    limit = int(limit * TIMEOUT_SCALE)
    if limit <= 0 or not hasattr(signal, "SIGALRM"):
        yield
        return

    def on_alarm(signum, frame):
        raise TimeoutError(
            f"watchdog: {item.nodeid} exceeded {limit}s (likely drain hang)"
        )

    old = signal.signal(signal.SIGALRM, on_alarm)
    signal.alarm(limit)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "timeout(seconds): per-test watchdog limit override"
    )
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc; skips without a card"
    )
