"""An autouse fixture for the port's test modules of at most 18 cases.

The suite runs under pytest-xdist with ``--dist loadfile``, which queues
modules by their number of cases, largest first.  A module of at most 18
cases therefore starts after the reference's ``tests/test_sketch.py`` (19
cases), the longest module on one worker, is already running; lowering the
priority of the worker that runs it leaves that module the CPU it needs.
It changes no result."""

import os

import pytest


@pytest.fixture(scope="module", autouse=True)
def lower_priority():
    os.nice(10)
