"""The keyword- and mixed-program probes of experiments/ on the PyTorch
port, end to end on the CPU (the kernels' plain versions).

Each runs its main() with --device cpu on one tiny benchmark corpus (1,000
pages of the port's bench, built once for the file under a temporary
build directory) and must pass its own exactness check:
torch_probe1m_decomp.py (the keyword scorer's variants and the hot split
against the full sweep), torch_headline_tbound_probe.py (the natural and
doc-sorted layouts' top-10), torch_mixed_tbound_probe.py (K2 with the
body bound at every stage against the static call, bit for bit),
torch_phrase_tmax_probe.py (the same through the engine, mixed and
all-phrase batches) and torch_post16_probe.py (int16 against f32 planes,
bit for bit).
"""

from __future__ import annotations

import os
import sys

import pytest
import torch

EXPERIMENTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "experiments")
sys.path.insert(0, EXPERIMENTS)

import torch_headline_tbound_probe  # noqa: E402
import torch_mixed_tbound_probe  # noqa: E402
import torch_phrase_tmax_probe  # noqa: E402
import torch_post16_probe  # noqa: E402
import torch_probe1m_decomp  # noqa: E402

torch.set_num_threads(1)

PAGES = 1000
NO_LAUNCHES = {"K1": 0, "K2": 0, "K2_tmax": 0}


@pytest.fixture(scope="module")
def probe_corpus(tmp_path_factory):
    """The port's benchmark corpus of PAGES pages (seed 0), built on the CPU
    under a temporary BENCH_DIR that the probes' main() then reuses."""
    from spaghettisearch_tpu_torch import bench

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bench, "BENCH_DIR", str(tmp_path_factory.mktemp("bench")))
        bench.ensure_bench_corpus(PAGES, device="cpu")
        yield [str(PAGES), "--device", "cpu", "--reps", "1"]


def test_probe1m_decomp_runs_on_cpu(probe_corpus):
    res = torch_probe1m_decomp.main(probe_corpus)
    assert res["ok"], res
    assert res["prefix_ok"] and res["hot_scores_close"]
    assert set(res["parts_ms"]) == {"K1", "hot matmul", "finalize", "exact_top_k k=50"}
    assert res["launches"] == NO_LAUNCHES


def test_headline_tbound_probe_runs_on_cpu(probe_corpus):
    argv = ["--pages", *probe_corpus, "--batches", "2"]
    res = torch_headline_tbound_probe.main(argv)
    assert res["ok"], res
    assert set(res["ms_per_batch"]) == {"natural", "doc_sort"}
    assert 0 < res["layout"]["swept_frac"] <= 1 and res["score_max_rel"] == 0.0


def test_mixed_tbound_probe_runs_on_cpu(probe_corpus):
    res = torch_mixed_tbound_probe.main(probe_corpus)
    assert res["ok"], res
    assert res["doc_sort"] and res["phrase_rows"] > 0
    assert res["exact"] == {f"dynamic {s}": True for s in ("kw", "phrase", "both")}
    assert res["launches"] == NO_LAUNCHES


def test_mixed_tbound_probe_natural_runs_static_only(probe_corpus):
    res = torch_mixed_tbound_probe.main([*probe_corpus, "--natural"])
    assert res["ok"], res
    assert not res["doc_sort"] and set(res["ms"]) == {"static"} and res["exact"] == {}


def test_phrase_tmax_probe_runs_on_cpu(probe_corpus):
    res = torch_phrase_tmax_probe.main([*probe_corpus, "--inner", "1"])
    assert res["ok"], res
    assert set(res["exact"]) == {"mixed16/phrase", "mixed16/both", "allph/phrase", "allph/both"}
    assert res["phrase_rows"] > 0


def test_post16_probe_runs_on_cpu(probe_corpus):
    res = torch_post16_probe.main(probe_corpus)
    assert res["ok"], res
    assert res["exact"] == {"mixed-128": True, "allph-128": True}
