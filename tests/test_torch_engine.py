"""The PyTorch port's engine against the JAX package's, on the CPU (the
kernels' plain versions): engine vs engine top-50 on both lanes, layouts
and the catch-all shape, the seeded corpus writer, refresh, and the
alternative routes (sparse phrase lane, custom blend, CSR).

Ids equal up to ties at equal scores (bench.py --mode parity's rule);
FinalRank within rtol=1e-6."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from corpus import build_corpus_db
from spaghettisearch_tpu.index.snapshot import build_snapshot as jax_build_snapshot
from spaghettisearch_tpu.models.blended import BlendedRanker as JaxBlended
from spaghettisearch_tpu.retrieval.engine import QueryEngine as JaxEngine
from spaghettisearch_tpu.retrieval.engine import parse_query as jax_parse
from spaghettisearch_tpu_torch.corpus import make_queries, write_corpus
from spaghettisearch_tpu_torch.index.snapshot import build_snapshot
from spaghettisearch_tpu_torch.models.blended import BlendedRanker
from spaghettisearch_tpu_torch.retrieval.engine import QueryEngine, parse_query

torch.set_num_threads(1)

CRAWL_QUERIES = [
    "algorithm database", '"quantum physics"', 'ranking "matrix tensor" cluster',
    "poetry", "galaxy poetry theater music", "nonexistentzz", '"document gradient" kernel',
    '"gradient"', "compiler kernel memory bandwidth latency throughput query",
    'neural "network graph node"', "history",
]


@pytest.fixture(scope="module")
def crawl_db():
    return build_corpus_db(n_pages=70, seed=3)


@pytest.fixture(scope="module")
def bench_db():
    return write_corpus(None, n_pages=120, n_vocab=600, seed=4)


def _rows(scores, ids):
    return [
        [(int(d), float(s)) for s, d in zip(scores[r], ids[r]) if np.isfinite(s)]
        for r in range(len(scores))
    ]


def _same_up_to_ties(got, want) -> bool:
    if len(got) != len(want):
        return False
    ref = dict(want)
    for (dg, sg), (dw, sw) in zip(got, want):
        if dg != dw and abs(ref.get(dg, want[-1][1]) - sw) > 1e-6 * max(abs(sw), 1e-9):
            return False
    return True


def _check_rank(jax_eng, eng, queries):
    pj = [p for p in (jax_parse(q) for q in queries) if not p.is_empty]
    pt = [p for p in (parse_query(q) for q in queries) if not p.is_empty]
    assert [p.keyword_hashes for p in pj] == [p.keyword_hashes for p in pt]
    sj, ij = jax_eng.rank(pj)
    st, it = eng.rank(pt)
    for q, got, want in zip(queries, _rows(st, it), _rows(sj, ij)):
        assert _same_up_to_ties(got, want), q
        np.testing.assert_allclose([s for _, s in got], [s for _, s in want], rtol=1e-6)
    return sj, ij, pj, pt


@pytest.mark.parametrize("doc_sort", [False, True])
@pytest.mark.parametrize("which", ["crawl", "bench"])
def test_engine_top50_matches_jax(crawl_db, bench_db, which, doc_sort):
    db = crawl_db if which == "crawl" else bench_db
    jax_eng = JaxEngine(db, doc_sort=doc_sort)
    eng = QueryEngine(db, device="cpu", doc_sort=doc_sort)
    assert eng.index.pos_dense and eng.model.supports_mixed(eng.index)
    if which == "bench":
        assert eng.index.hot_body_map is not None  # the hot split is exercised
        queries = make_queries(eng.snapshot, db, 16, seed=doc_sort)
    else:
        queries = CRAWL_QUERIES
    _check_rank(jax_eng, eng, queries)  # one mixed batch
    _check_rank(jax_eng, eng, [q for q in queries if '"' not in q])  # keyword lane
    if which == "crawl" and not doc_sort:
        long_q = " ".join(queries).replace('"', "")  # > Q_BASE keywords: catch-all
        _check_rank(jax_eng, eng, [long_q, queries[0]])


def test_corpus_writer_snapshots_and_engines_agree(bench_db):
    """The JAX build_snapshot and the port's copy read the writer's store
    into equal snapshots, and both engines rank its queries alike."""
    a, b = jax_build_snapshot(bench_db), build_snapshot(bench_db)
    assert a.doc_hashes == b.doc_hashes and a.word_hashes == b.word_hashes
    for sec in ("title", "body"):
        x, y = a.section(sec), b.section(sec)
        for f in ("post_offsets", "doc_ids", "weights", "pos_offsets", "positions"):
            assert np.array_equal(getattr(x, f), getattr(y, f)), (sec, f)
        assert x.n_postings == y.n_postings > 0
    for f in ("mag_title", "mag_body", "pagerank"):
        assert np.array_equal(getattr(a, f), getattr(b, f))
    assert (a.mag_body > 0).all() and a.categories == ["General", "Science"]
    # rows of the writer look like the indexer's: [normTF, sorted positions]
    row = bench_db.inv_body.get(a.word_hashes[0])
    vals = next(iter(row.values()))
    assert vals[1:] == sorted(vals[1:]) and vals[0] > 0
    queries = make_queries(b, bench_db, 16, seed=9)
    assert sum('"' in q for q in queries) == 4
    _check_rank(JaxEngine(bench_db, snapshot=a), QueryEngine(bench_db, snapshot=b, device="cpu"), queries)


def test_unported_routes_raise(crawl_db):
    """The routes the first slice of the port refused now answer, equal to
    the JAX engine in the same setup: phrases without position planes (the
    sparse phrase lane), a custom blend (kernel K3's route) and a
    dense-truncated index (the exact CSR route). A missing device still
    raises."""
    no_planes = QueryEngine(crawl_db, device="cpu")
    no_planes.index.body.posT = None
    jax_no_planes = JaxEngine(crawl_db)
    jax_no_planes.index.body.posT = None
    assert not no_planes.model.supports_mixed(no_planes.index)
    _check_rank(jax_no_planes, no_planes, CRAWL_QUERIES)
    custom = QueryEngine(crawl_db, device="cpu", model=BlendedRanker(w_title=0.5))
    _check_rank(JaxEngine(crawl_db, model=JaxBlended(w_title=0.5)), custom, CRAWL_QUERIES)
    trunc = QueryEngine(crawl_db, device="cpu")
    trunc.index.title.dense_truncated = True
    jax_trunc = JaxEngine(crawl_db)
    jax_trunc.index.title.dense_truncated = True
    _check_rank(jax_trunc, trunc, CRAWL_QUERIES)
    with pytest.raises(ValueError, match="explicit device"):
        QueryEngine(crawl_db)


def test_refresh_swaps_in_new_docs(tmp_path):
    from datetime import datetime, timezone

    from spaghettisearch_tpu.index.indexer import index_page
    from spaghettisearch_tpu.ops.pagerank import update_pagerank
    from spaghettisearch_tpu.ops.weighting import update_term_weights

    db = build_corpus_db(n_pages=12, seed=7, root=str(tmp_path / "db"))
    eng = QueryEngine(db, device="cpu")
    assert eng.query("zzuniquetitleword") == []
    index_page(db, b"<html><head><title>zzuniquetitleword</title></head><body>x</body></html>",
               "http://test.local/new-doc",
               last_modified=datetime(2026, 2, 1, tzinfo=timezone.utc))
    update_pagerank(db)
    update_term_weights(db, "title")
    update_term_weights(db, "body")
    old_db = eng.commit_refresh(eng.prepare_refresh())
    assert old_db is not None
    old_db.close()
    hits = eng.query("zzuniquetitleword")
    assert [h["Url"] for h in hits] == ["http://test.local/new-doc"]
    eng.db.close()
