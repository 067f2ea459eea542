"""The engine-level and sparse-lane probes of experiments/ on the PyTorch
port, end to end on the CPU (the kernels' plain versions).

Each runs its main() with --device cpu on one tiny benchmark corpus (1,000
pages of the port's bench, built once for the file under a temporary
build directory) and must pass its own exactness check:
torch_mixed_stage_probe.py (the sparse matcher's matches equal the dense
phrase stage's), torch_phrase_stage_probe.py (the matcher with and
without pos_mat), torch_mixed256_probe.py (each query's top-50 the same at
B = 16, 128, 256), torch_split_probe.py (the split program's rows equal
the mixed program's), torch_probe1m.py (pipelined ranks equal serial ones)
and torch_segregate_probe.py (each query's top-50 the same in the
segregated pattern and the control).
"""

from __future__ import annotations

import os
import sys

import torch

EXPERIMENTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "experiments")
sys.path.insert(0, EXPERIMENTS)

import torch_mixed256_probe  # noqa: E402
import torch_mixed_stage_probe  # noqa: E402
import torch_phrase_stage_probe  # noqa: E402
import torch_probe1m  # noqa: E402
import torch_segregate_probe  # noqa: E402
import torch_split_probe  # noqa: E402
from test_torch_probes_mixed import PAGES, probe_corpus  # noqa: E402, F401 — module fixture

torch.set_num_threads(1)


def test_mixed_stage_probe_runs_on_cpu(probe_corpus):
    res = torch_mixed_stage_probe.main(["--pages", *probe_corpus])
    assert res["ok"], res
    assert res["phrase_rows"] > 0 and res["vs_dense"]["matched_docs"] > 0
    assert res["matcher_ms"] and set(res["ms"]) == {"A rank() mixed", "A' rank() keyword-only",
                                                    "B matcher"}


def test_phrase_stage_probe_runs_on_cpu(probe_corpus):
    res = torch_phrase_stage_probe.main(["--pages", *probe_corpus])
    assert res["ok"], res
    assert res["pos_mat"] and res["matches"] > 0 and len(res["ms"]) == 7


def test_mixed256_probe_runs_on_cpu(probe_corpus):
    res = torch_mixed256_probe.main(probe_corpus)
    assert res["ok"], res
    assert set(res["ms"]) == {16, 128, 256}


def test_split_probe_runs_on_cpu(probe_corpus):
    res = torch_split_probe.main(probe_corpus)
    assert res["ok"], res
    assert 0 < res["phrase_rows"] <= 16
    assert res["exact"] == {"phrase_rows": True, "keyword_rows": True}


def test_probe1m_runs_on_cpu(probe_corpus):
    res = torch_probe1m.main(probe_corpus)
    assert res["ok"], res
    assert res["phrase_rows"] > 0 and res["docs"] == PAGES


def test_segregate_probe_runs_on_cpu(probe_corpus):
    res = torch_segregate_probe.main([*probe_corpus, "--passes", "1"])
    assert res["ok"], res
    assert not res["batcher_segregates"] and res["vs_control"]["ranked"] > 0
