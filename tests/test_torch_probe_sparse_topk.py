"""The top-k and sparse-scoring probes on the PyTorch port, on the CPU.

experiments/torch_topk_probe.py's exact variants (the two-stage top-k at
m = 64, 256, 1024 and k rounds of argmax) against torch.topk and
jax.lax.top_k on a seeded [16, 3000] matrix: values equal.
experiments/torch_sparse_probe.py's score_sparse, score_candidates and
host_dedup against the original's JAX functions (experiments/
sparse_probe.py) on the same inputs from a small synthetic snapshot: ids
equal up to ties, scores within rtol 1e-6. Each probe script also runs at
a tiny size with --device cpu and passes its own exactness check.
"""

from __future__ import annotations

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spaghettisearch_tpu_torch.corpus import synth_snapshot
from spaghettisearch_tpu_torch.ops.kernels import check
from spaghettisearch_tpu_torch.retrieval.device_index import DeviceIndex

EXPERIMENTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "experiments")
sys.path.insert(0, EXPERIMENTS)

import sparse_probe  # noqa: E402
import torch_sparse_probe  # noqa: E402
import torch_topk_probe  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def matrix():
    return np.random.default_rng(3).normal(size=(16, 3000)).astype(np.float32)


@pytest.mark.parametrize("variant", ["m64", "m256", "m1024", "argmax"])
def test_topk_variants_match_torch_and_lax(matrix, variant):
    k = 10
    x = torch.from_numpy(matrix)
    want_t = torch.topk(x, k, dim=1)
    want_j = jax.lax.top_k(jnp.asarray(matrix), k)
    if variant == "argmax":
        got_s, got_i = torch_topk_probe.argmax_topk(x, k)
    else:
        got_s, got_i = torch_topk_probe.two_stage_topk(x, k, int(variant[1:]))
    assert torch.equal(got_s, want_t.values)
    assert np.array_equal(got_s.numpy(), np.asarray(want_j[0]))
    assert np.array_equal(got_i.numpy(), np.asarray(want_j[1]))
    # the winners' values sit at the indices they name
    assert torch.equal(torch.gather(x, 1, got_i), got_s)


def test_topk_probe_runs_on_cpu():
    res = torch_topk_probe.main(["--device", "cpu", "--batch", "16", "--docs", "3000",
                                 "--reps", "1"])
    assert res["ok"], res
    assert set(res["ms"]) >= {"exact top_k", "two-stage m=64", "argmax xk",
                              "exact_top_k (production)"}
    assert res["not_run"] == list(torch_topk_probe.APPROX)


@pytest.fixture(scope="module")
def sparse_inputs():
    """A small synthetic snapshot on the CPU, natural layout, and 16
    df-weighted Q=4 queries with their windows (the original's draws)."""
    snap = synth_snapshot(n_docs=3000, n_words=1500, body_terms_per_doc=24,
                          title_terms_per_doc=4, max_df=512)
    idx = DeviceIndex.from_snapshot(snap, "cpu", doc_sort=False)
    rng = np.random.default_rng(1)
    p = np.diff(snap.body.post_offsets).astype(np.float64)
    terms = rng.choice(1500, size=(16, 4), p=p / p.sum()).astype(np.int32)
    ws, wl, flags, cat_ids, cat_w = torch_sparse_probe.windows(snap, terms)
    keep = wl.sum(1) <= 1024
    assert keep.sum() >= 8
    return {"snap": snap, "idx": idx, "terms": terms[keep], "ws": ws[keep], "wl": wl[keep],
            "flags": flags, "cat_ids": cat_ids, "cat_w": cat_w}


def _same_up_to_ties(got, want):
    rep = check.compare_topk(tuple(torch.as_tensor(np.array(a)) for a in got),
                             tuple(torch.as_tensor(np.array(a)) for a in want),
                             rtol=1e-6, atol=0.0)
    assert rep["ok"], rep
    assert rep["ranked"] > 0


@pytest.mark.parametrize("weights", ["dyadic", "real"])
def test_score_sparse_matches_jax(sparse_inputs, weights):
    """score_sparse's segment sums are differences of float32 prefix sums
    over the whole [B, N] buffer, and XLA's and PyTorch's cumsum add in
    different orders. With the posting weights rounded to multiples of
    2^-8 every prefix sum is exact in float32, so the two must agree to
    rtol 1e-6; with the snapshot's own weights they agree to the
    original's own bar against the dense scan (rtol 2e-5, atol 1e-6)."""
    s = sparse_inputs
    idx = s["idx"]
    b = len(s["terms"])
    cat_w = s["cat_w"]
    if weights == "dyadic":
        cat_w = np.maximum(np.round(cat_w * 256.0), 1.0).astype(np.float32) / 256.0
        assert 1024 * float(cat_w.max()) < 2.0 ** 15  # a row's prefix: 23 bits at most
    pr = idx.pagerank[:, :1].contiguous()
    args = [s["cat_ids"], cat_w, idx.mag_title.numpy(), idx.mag_body.numpy(), pr.numpy(),
            s["ws"], s["wl"], s["flags"], np.full(b, 4.0, np.float32),
            np.zeros((b, 1), np.float32)]
    kw = {"topk": 10, "n_docs": idx.n_docs, "n_entries": 1024}
    want = sparse_probe.score_sparse(*(jnp.asarray(a) for a in args), **kw)
    got = torch_sparse_probe.score_sparse(*(torch.from_numpy(np.asarray(a)) for a in args), **kw)
    if weights == "dyadic":
        _same_up_to_ties(got, want)
    else:
        rep = check.compare_topk(tuple(torch.as_tensor(np.array(a)) for a in got),
                                 tuple(torch.as_tensor(np.array(a)) for a in want),
                                 rtol=2e-5, atol=1e-6)
        assert rep["ok"] and rep["ranked"] > 0, rep


def test_score_candidates_and_host_dedup_match_jax(sparse_inputs):
    s = sparse_inputs
    idx = s["idx"]
    b = len(s["terms"])
    f_t, f_b = idx.title.fwd, idx.body.fwd
    args = [f_t.ft, f_t.fw, f_b.ft, f_b.fw, idx.mag_title, idx.mag_body,
            idx.pagerank[:, :1].contiguous(), s["cat_ids"], s["ws"], s["wl"], s["terms"],
            np.full(b, 4.0, np.float32), np.zeros((b, 1), np.float32)]
    args = [np.asarray(a) for a in args]
    kw = {"topk": 10, "n_entries": 1024}
    want = [np.asarray(a) for a in sparse_probe.score_candidates(
        *(jnp.asarray(a) for a in args), **kw)]
    got = [a.numpy() for a in torch_sparse_probe.score_candidates(
        *(torch.from_numpy(a) for a in args), **kw)]
    _same_up_to_ties(got, want)
    want_d = sparse_probe.host_dedup(want[0], want[1], 10)
    got_d = torch_sparse_probe.host_dedup(got[0], got[1], 10)
    _same_up_to_ties(got_d, want_d)
    # host_dedup itself, on one input: the same code path as the original's
    for a, c in zip(torch_sparse_probe.host_dedup(want[0], want[1], 10), want_d):
        assert np.array_equal(a, c)


def test_sparse_probe_runs_on_cpu():
    res = torch_sparse_probe.main(["--device", "cpu", "--docs", "3000", "--words", "2000",
                                   "--batch", "16", "--levels", "512,1024", "--checkN", "1024",
                                   "--reps", "1"])
    assert res["ok"], res
    assert res["checked_rows"] > 0 and res["checks"]["score_candidates"]["ids_up_to_ties"]
