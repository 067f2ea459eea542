"""The PyTorch port's ranking models and alternative routes against the JAX
package's, engine against engine on the CPU (the kernels' plain versions):
a custom blend (kernel K3's route, phrases on the sparse lane), BM25's
posting weights and its keyword and phrase top-50s (K1 over BM25 tiles, the
sparse lane), and an index truncated by DOC_TERM_CAP, routed through the
exact CSR scorer (score_csr, the CSR phrase matcher) in both packages.

Ids equal up to ties at equal scores, FinalRank / scores within rtol=1e-6
(test_torch_engine._check_rank); BM25 posting weights exact.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from corpus import build_corpus_db
from spaghettisearch_tpu.models.blended import BlendedRanker as JaxBlended
from spaghettisearch_tpu.models.bm25 import BM25Ranker as JaxBM25
from spaghettisearch_tpu.models.bm25 import bm25_posting_weights as jax_bm25_weights
from spaghettisearch_tpu.retrieval import device_index as jdi
from spaghettisearch_tpu.retrieval.engine import QueryEngine as JaxEngine
from spaghettisearch_tpu_torch.corpus import bench_queries, write_corpus
from spaghettisearch_tpu_torch.models.blended import BlendedRanker
from spaghettisearch_tpu_torch.models.bm25 import BM25Ranker, bm25_posting_weights
from spaghettisearch_tpu_torch.ops import scoring
from spaghettisearch_tpu_torch.ops.kernels import membership as k1
from spaghettisearch_tpu_torch.retrieval import device_index as tdi
from spaghettisearch_tpu_torch.retrieval.engine import QueryEngine, parse_query
from test_torch_engine import CRAWL_QUERIES, _check_rank

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def crawl_db():
    return build_corpus_db(n_pages=70, seed=3)


@pytest.fixture(scope="module")
def bench_db():
    return write_corpus(None, n_pages=140, n_vocab=600, seed=6, device="cpu")


def _queries(which, db, snap):
    if which == "crawl":
        return CRAWL_QUERIES
    return bench_queries(snap, 16, seed=2, phrase_every=4, db=db)


def _spy(monkeypatch, cls, name):
    calls = []
    orig = getattr(cls, name)

    def spy(*a, **k):
        calls.append(name)
        return orig(*a, **k)

    monkeypatch.setattr(cls, name, spy)
    return calls


@pytest.mark.parametrize("which", ["crawl", "bench"])
def test_custom_blend_engine_matches_jax(crawl_db, bench_db, which, monkeypatch):
    """A title-only blend: keyword batches take K3 per section, phrase
    batches the sparse lane (no fused mixed lane for custom blends)."""
    db = crawl_db if which == "crawl" else bench_db
    weights = dict(w_pagerank=0.0, w_title=1.0, w_body=0.0)
    jax_eng = JaxEngine(db, model=JaxBlended(**weights))
    eng = QueryEngine(db, device="cpu", model=BlendedRanker(**weights))
    assert not eng.model.supports_mixed(eng.index) and not eng.model.supports_hot(eng.index)
    k3 = _spy(monkeypatch, k1, "forward_scores")
    matched = _spy(monkeypatch, QueryEngine, "_match_phrases_batch")
    queries = _queries(which, db, eng.snapshot)
    _check_rank(jax_eng, eng, [q for q in queries if '"' not in q])
    assert k3 and not matched
    _check_rank(jax_eng, eng, queries)
    assert matched


def test_bm25_posting_weights_equal(bench_db, crawl_db):
    for db in (crawl_db, bench_db):
        snap = QueryEngine(db, device="cpu").snapshot
        for sec in ("title", "body"):
            csr = getattr(snap, sec)
            got = bm25_posting_weights(csr, snap.n_docs)
            assert np.array_equal(got, jax_bm25_weights(csr, snap.n_docs))
            assert (got[: csr.n_postings] > 0).all() and (got[csr.n_postings:] == 0).all()


@pytest.mark.parametrize("doc_sort", [False, True])
@pytest.mark.parametrize("which", ["crawl", "bench"])
def test_bm25_engine_matches_jax(crawl_db, bench_db, which, doc_sort, monkeypatch):
    """BM25 keyword (K1 over BM25 tiles, counts elided) and phrase (the
    sparse lane with BM25 posting weights) top-50s."""
    db = crawl_db if which == "crawl" else bench_db
    jax_eng = JaxEngine(db, model=JaxBM25(), doc_sort=doc_sort)
    eng = QueryEngine(db, device="cpu", model=BM25Ranker(), doc_sort=doc_sort)
    assert (eng.index.doc_perm is not None) == doc_sort
    assert eng.index.pos_dense  # planes exist, yet BM25 phrases take the sparse lane
    matched = _spy(monkeypatch, QueryEngine, "_match_phrases_batch")
    queries = _queries(which, db, eng.snapshot)
    _check_rank(jax_eng, eng, [q for q in queries if '"' not in q])
    assert not matched
    sj, _, _, _ = _check_rank(jax_eng, eng, queries)
    assert matched and np.isfinite(sj).any()


@pytest.mark.parametrize("model", ["blended", "custom", "bm25"])
def test_truncated_index_routes_through_csr(crawl_db, model, monkeypatch):
    """A doc past DOC_TERM_CAP (lowered here for both packages) truncates
    the dense view: keyword and phrase batches score through score_csr with
    the CSR phrase matcher, equal to the JAX engine's CSR route."""
    snap = QueryEngine(crawl_db, device="cpu").snapshot
    nt = np.bincount(snap.body.doc_ids[: snap.body.n_postings], minlength=snap.n_docs)
    cap = int(np.sort(nt)[-3])  # two docs past the cap
    monkeypatch.setattr(jdi, "DOC_TERM_CAP", cap)
    monkeypatch.setattr(tdi, "DOC_TERM_CAP", cap)
    make = {
        "blended": (JaxBlended, BlendedRanker, {}),
        "custom": (JaxBlended, BlendedRanker, dict(w_title=0.5)),
        "bm25": (JaxBM25, BM25Ranker, {}),
    }[model]
    jax_eng = JaxEngine(crawl_db, snapshot=snap, model=make[0](**make[2]))
    eng = QueryEngine(crawl_db, snapshot=snap, device="cpu", model=make[1](**make[2]))
    assert eng.index.dense_truncated and jax_eng.index.dense_truncated
    assert eng.index.doc_perm is None and not eng.index.pos_dense
    csr = _spy(monkeypatch, type(eng.model), "score_csr")
    _check_rank(jax_eng, eng, [q for q in CRAWL_QUERIES if '"' not in q])
    _check_rank(jax_eng, eng, CRAWL_QUERIES)
    assert len(csr) == 2
    eng.warmup()  # the CSR warmup families run


def test_score_queries_matches_forward_path(crawl_db):
    """The CSR formulation is an independent oracle for the forward path:
    same candidates, scores within rtol=1e-5 (the JAX package's own bar for
    the two formulations, tests/test_scoring_paths.py)."""
    eng = QueryEngine(crawl_db, device="cpu", doc_sort=False)
    idx, snap = eng.index, eng.snapshot
    term_ids = np.full((4, 4), snap.n_words, np.int32)
    for i, q in enumerate(["algorithm", "quantum physics database", "matrix matrix",
                           "galaxy poetry theater music"]):
        ids = snap.term_ids(parse_query(q).keyword_hashes)
        term_ids[i, : len(ids)] = ids
    t = torch.from_numpy(term_ids)
    qlen = torch.full((4,), 2.0)
    tp = torch.zeros((4, idx.n_categories))
    fs, fi = scoring.score_queries_forward(
        idx.title.fwd, idx.body.fwd, idx.mag_title, idx.mag_body, idx.pagerank,
        t, qlen, tp, topk=50,
    )
    ph = torch.full((4, 8), idx.n_docs, dtype=torch.int32)
    z = torch.zeros((4, 8))
    cs, ci = scoring.score_queries(
        idx.title.offsets, idx.title.doc_ids, idx.title.weights,
        idx.body.offsets, idx.body.doc_ids, idx.body.weights,
        idx.mag_title, idx.mag_body, idx.pagerank, t, qlen, tp, ph, z, z, z,
        posting_cap=idx.posting_cap, topk=50, n_docs=idx.n_docs,
    )
    fs, fi, cs, ci = (x.numpy() for x in (fs, fi, cs, ci))
    for r in range(4):
        f = {int(i): float(s) for s, i in zip(fs[r], fi[r]) if np.isfinite(s)}
        c = {int(i): float(s) for s, i in zip(cs[r], ci[r]) if np.isfinite(s)}
        assert f and f.keys() == c.keys()
        for d in f:
            assert f[d] == pytest.approx(c[d], rel=1e-5, abs=1e-7)
