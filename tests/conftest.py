"""Shared pytest setup.

Makes ``tests/`` importable so the offline ``_hypothesis_compat`` shim
can be found by the property-test modules, and registers the ``slow``
marker used to keep the fast CI tier (scripts/ci.sh) under a minute.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(__file__))


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: multi-minute dryrun/model-compile tests (deselect with -m 'not slow')",
    )
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA card and nvcc; skips elsewhere (run with -m cuda on the card)",
    )
