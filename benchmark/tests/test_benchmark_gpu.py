"""On the card: both cells' whole run at a tiny size, correct against the
reference (run with `python -m pytest benchmark/tests -m gpu`)."""

from __future__ import annotations

import pytest

from bench_util import CELLS, tiny_cell
from benchmark import run

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(cuda, name, trace):
    result, checks = run.run_cell(tiny_cell(name), 41, 1.0, trace, cuda)
    assert result["correct"], checks
    assert result["device"]["platform"] == "gpu"
    if trace:
        assert result["device"]["busy_s"] > 0
