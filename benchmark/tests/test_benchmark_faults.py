"""A run with its timed path broken underneath must come out not correct:
the harness's look for a chip is skipped (the port's plain path on the
CPU, tiny cells) and the rest of a run is driven as on the card, once for
each fault a search cell can have. (Its one chip: no exchange between
chips to leave out.)"""

from __future__ import annotations

import numpy as np
import pytest

from bench_util import CELLS, tiny_cell
from benchmark import run


class _Handle:
    def __init__(self, fn):
        self.fn = fn

    def finish(self):
        return self.fn()


def stale():
    """Each batch answers with the batch before it: the state unchanged."""
    prev = {}

    def wrap(i, handle):
        def fn():
            out = handle.finish()
            last = prev.get("out", out)
            prev["out"] = out
            return last
        return _Handle(fn)
    return wrap


def half():
    """Half of each batch is left out (its rows come back unranked)."""
    def wrap(i, handle):
        def fn():
            s, d = handle.finish()
            s, d = s.copy(), d.copy()
            s[len(s) // 2:] = -np.inf
            return s, d
        return _Handle(fn)
    return wrap


def altered():
    """One answer of each batch is altered where it is produced."""
    def wrap(i, handle):
        def fn():
            s, d = handle.finish()
            d = d.copy()
            d[0, 0] = (int(d[0, 0]) + 7919) % 2500
            return s, d
        return _Handle(fn)
    return wrap


@pytest.mark.parametrize("fault", [None, stale, half, altered],
                         ids=["sound", "stale", "half", "altered"])
@pytest.mark.parametrize("name", CELLS)
def test_fault_makes_the_run_incorrect(name, fault):
    cell = tiny_cell(name)
    # a stream of one block (8 batches) that the window runs out of,
    # whatever the host's speed; every answer is checked
    result, checks = run.run_cell(cell, 31, 60.0, False, "cpu",
                                  fault=None if fault is None else fault(),
                                  n_check=10_000, window_blocks=1)
    assert result["attempted"] == 1024
    assert result["correct"] is (fault is None), checks
