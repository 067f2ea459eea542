"""On the card: both cells' whole run at a tiny size, and a BM25 shard's,
correct against their references (run with `python -m pytest
benchmark/tests -m gpu`)."""

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


def test_bm25_cell_on_the_card(cuda):
    """The port's BM25 on the card (K1 over its tiles, the sparse phrase
    lane) against BM25's reference, through a whole tiny run."""
    cell = tiny_cell("lucene-mixed")
    cell["config_data"].update(ranker="spaghettisearch_tpu_torch.models.bm25:BM25Ranker",
                               reference="benchmark.reference_bm25:Reference")
    result, checks = run.run_cell(cell, 42, 1.0, False, cuda)
    assert result["correct"], checks
