"""Shared set-up of the benchmark's own tests (run them with
`python -m pytest benchmark/tests -q`; the repository's tests/ do not
collect them). Tests that need a CUDA card carry the repository's `gpu`
marker and skip here; the decision is taken inside the test."""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips without one"
    )
