"""The port's doc-sharded scorers and PageRank (parallel/sharded.py)
against the JAX package's on the CPU: each scorer and PageRank test of
tests/test_sharded.py has a counterpart here that puts the same inputs
through the JAX function (on the virtual CPU devices of tests/conftest.py)
and the port's (on a mesh of ["cpu"] * S, the kernels' plain versions).
The engine and CLI tests are in tests/test_torch_sharded_engine.py.

Ids are equal up to ties at equal scores (bench.py --mode parity's rule).
Scores match the single-device engine at rtol 1e-5, atol 1e-7 (the JAX
tests' own bar between sharded and single-chip) and JAX's sharded scorer
at the same S at rtol 1e-6."""

from __future__ import annotations

import random
from datetime import datetime, timezone

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spaghettisearch_tpu.parallel.sharded as jsh
import spaghettisearch_tpu_torch.parallel.sharded as tsh
from corpus import build_corpus_db, make_page
from spaghettisearch_tpu.index.indexer import index_page
from spaghettisearch_tpu.ops.pagerank import _load_graph
from spaghettisearch_tpu.ops.pagerank import update_pagerank as jax_update_pagerank
from spaghettisearch_tpu.ops.weighting import update_term_weights
from spaghettisearch_tpu.parallel.mesh import make_mesh as jax_mesh
from spaghettisearch_tpu.parallel.mesh import make_mesh2d as jax_mesh2d
from spaghettisearch_tpu.retrieval.engine import QueryEngine as JaxEngine
from spaghettisearch_tpu.retrieval.engine import parse_query
from spaghettisearch_tpu.text.laundry import laundry
from spaghettisearch_tpu_torch.models.bm25 import BM25Ranker
from spaghettisearch_tpu_torch.ops.pagerank import pagerank_power
from spaghettisearch_tpu_torch.parallel.mesh import make_mesh, make_mesh2d
from spaghettisearch_tpu_torch.retrieval.engine import QueryEngine
from spaghettisearch_tpu_torch.retrieval.engine import parse_query as tparse
from test_sharded import QUERIES


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


RTOL_SINGLE, ATOL_SINGLE = 1e-5, 1e-7
RTOL_JAX = 1e-6


@pytest.fixture(scope="module")
def db():
    return build_corpus_db(n_pages=30, seed=5)


@pytest.fixture(scope="module")
def single(db):
    return QueryEngine(db, device="cpu")


@pytest.fixture(scope="module")
def jax_single(db):
    return JaxEngine(db)


def _cpu_mesh(s: int):
    return make_mesh(s, devices=["cpu"] * s)


def _rows(scores, ids) -> list[list[tuple[int, float]]]:
    scores, ids = np.atleast_2d(np.asarray(scores)), np.atleast_2d(np.asarray(ids))
    return [[(int(d), float(s)) for s, d in zip(sr, ir) if np.isfinite(s)]
            for sr, ir in zip(scores, ids)]


def _agree(got, want, rtol: float, atol: float = 0.0, what="") -> None:
    """Finite results of equal length; where the ids differ, the got id's
    score in `want` (or the k-th score, for an id cut at the k-th place)
    equals want's score at that place: a tie. Scores within rtol/atol."""
    for r, (g, w) in enumerate(zip(_rows(*got), _rows(*want))):
        assert len(g) == len(w), (what, r)
        ref = dict(w)
        for (dg, sg), (dw, sw) in zip(g, w):
            if dg != dw:
                assert abs(ref.get(dg, w[-1][1]) - sw) <= max(rtol * abs(sw), atol), (what, r, dg, dw)
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w], rtol=rtol, atol=atol,
                                   err_msg=f"{what} row {r}")


def _inputs(snap, query: str, c: int):
    """One query as test_sharded.py's _run_sharded builds it: [1, Q] terms,
    one [P] phrase set broadcast to the row."""
    parsed = parse_query(query)
    q = max(len(parsed.keyword_hashes), 1)
    term_ids = np.full((1, q), snap.n_words, np.int32)
    ids = snap.term_ids(parsed.keyword_hashes)
    term_ids[0, : len(ids)] = ids
    qlen = np.array([float(parsed.query_len)], np.float32)
    tp = np.zeros((1, c), np.float32)
    pmax = max(len(parsed.phrase_hashes), 4)
    ph_ids = np.full(pmax, snap.n_words, np.int32)
    ph_valid = np.zeros(pmax, bool)
    gen = 0
    if parsed.phrase_hashes:
        pids = snap.term_ids(parsed.phrase_hashes)
        ph_ids[: len(pids)] = pids
        ph_valid[: len(pids)] = True
        gen = int(np.argmin(snap.title.df(pids) + snap.body.df(pids)))
    return term_ids, qlen, tp, ph_ids, ph_valid, gen


def _run_both(snap, jpair, tpair, query: str):
    """-> (port (scores, ids), JAX (scores, ids)), one [1, K] row each."""
    (jidx, jscorer), (tidx, tscorer) = jpair, tpair
    term_ids, qlen, tp, ph_ids, ph_valid, gen = _inputs(snap, query, jidx.pagerank.shape[-1])
    js, ji = jscorer(jidx, jnp.asarray(term_ids), jnp.asarray(qlen), jnp.asarray(tp),
                     jnp.asarray(ph_ids), jnp.asarray(ph_valid), jnp.asarray(gen, jnp.int32))
    ts, ti = tscorer(tidx, term_ids, qlen, tp, ph_ids, ph_valid, gen)
    return (ts.numpy(), ti.numpy()), (np.asarray(js), np.asarray(ji))


def _pair(snap, s: int, topk: int = 50, mesh=None, jmesh=None, **kw):
    """(JAX index, scorer), (port index, scorer) at S shards."""
    scorer_kw = {k: kw.pop(k) for k in ("scoring",) if k in kw}
    j = jsh.ShardedIndex.from_snapshot(snap, jmesh or jax_mesh(s), **kw)
    t = tsh.ShardedIndex.from_snapshot(snap, mesh or _cpu_mesh(s), **kw)
    return ((j, jsh.make_sharded_scorer(j, topk=topk, **scorer_kw)),
            (t, tsh.make_sharded_scorer(t, topk=topk, **scorer_kw)))


def _phrase(db, snap, n: int) -> str:
    for h in snap.doc_hashes:
        raw = db.cached_doc(h)
        if raw:
            toks = laundry(" ".join(raw.decode().split("<p>")[1].split("</p>")[0].split()))
            if len(toks) >= n:
                return '"' + " ".join(toks[:n]) + '"'
    raise AssertionError("no page with a phrase")


@pytest.fixture(scope="module", params=[2, 8])
def pairs(jax_single, request):
    return _pair(jax_single.snapshot, request.param)


# --- the scorers ---------------------------------------------------------------

def test_sharded_matches_single_chip(single, jax_single, pairs):
    snap = jax_single.snapshot
    for query in QUERIES:
        got, want_jax = _run_both(snap, *pairs, query)
        want = single.rank([tparse(query)], topk=50)
        _agree(got, want, RTOL_SINGLE, ATOL_SINGLE, query)
        _agree(got, want_jax, RTOL_JAX, 0.0, query)
        assert _rows(*want)[0] or query == "nonexistentword"


def test_sharded_phrase(db, single, jax_single, pairs):
    snap = jax_single.snapshot
    query = _phrase(db, snap, 3)
    got, want_jax = _run_both(snap, *pairs, query)
    want = single.rank([tparse(query)], topk=50)
    assert _rows(*want)[0]
    _agree(got, want, RTOL_SINGLE, ATOL_SINGLE, query)
    _agree(got, want_jax, RTOL_JAX, 0.0, query)


@pytest.mark.parametrize("n_shards", [2, 8])
def test_sharded_pagerank_matches(db, n_shards):
    node_list, es, ed, od = _load_graph(db)
    n = len(node_list)
    n_pages = np.array([float(n)], np.float32)
    want_jax = np.asarray(jsh.sharded_pagerank(
        jax_mesh(n_shards), es, ed, od.astype(np.float32), n_pages, n, eps=1e-10))
    want = pagerank_power(torch.from_numpy(es), torch.from_numpy(ed),
                          torch.from_numpy(od.astype(np.float32)), torch.from_numpy(n_pages),
                          n, eps=1e-10).numpy()
    stats: dict = {}
    got = tsh.sharded_pagerank(_cpu_mesh(n_shards), es, ed, od.astype(np.float32), n_pages, n,
                               eps=1e-10, stats=stats).numpy()
    assert got.shape == want.shape == (1, n) and stats["iterations"] > 1
    np.testing.assert_allclose(got, want_jax, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    again = tsh.sharded_pagerank(_cpu_mesh(n_shards), es, ed, od.astype(np.float32), n_pages, n,
                                 eps=1e-10).numpy()
    np.testing.assert_array_equal(again, got)


@pytest.mark.parametrize("n_q,n_d", [(2, 2), (2, 4)])
def test_2d_mesh_batch_dp_matches_1d(jax_single, n_q, n_d):
    """(q, d) mesh: the batch splits over q, docs over d; rows equal the
    1-D mesh's and JAX's 2-D mesh's."""
    snap = jax_single.snapshot
    t1 = tsh.ShardedIndex.from_snapshot(snap, _cpu_mesh(n_d))
    t2 = tsh.ShardedIndex.from_snapshot(snap, make_mesh2d(n_q, n_d, devices=["cpu"] * (n_q * n_d)))
    j2 = jsh.ShardedIndex.from_snapshot(snap, jax_mesh2d(n_q, n_d))
    rng = np.random.default_rng(0)
    b, q = 4, 3
    term_ids = rng.integers(0, snap.n_words, (b, q)).astype(np.int32)
    qlen = np.full((b,), float(q), np.float32)
    tp = np.zeros((b, t1.shards[0].pagerank.shape[-1]), np.float32)
    ph_ids = np.full(4, snap.n_words, np.int32)
    ph_valid = np.zeros(4, bool)
    args = (term_ids, qlen, tp, ph_ids, ph_valid, 0)
    s1, i1 = tsh.make_sharded_scorer(t1, topk=20)(t1, *args)
    s2, i2 = tsh.make_sharded_scorer(t2, topk=20)(t2, *args)
    np.testing.assert_allclose(s2.numpy(), s1.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(i2.numpy(), i1.numpy())
    js, ji = jsh.make_sharded_scorer(j2, topk=20)(
        j2, *map(jnp.asarray, args[:5]), jnp.asarray(0, jnp.int32))
    _agree((s2.numpy(), i2.numpy()), (np.asarray(js), np.asarray(ji)), RTOL_JAX)
    with pytest.raises(ValueError, match="does not split"):
        tsh.make_sharded_scorer(t2, topk=20)(t2, term_ids[:3], qlen[:3], tp[:3], ph_ids, ph_valid, 0)


def test_sharded_bm25_matches_single_chip(db, jax_single):
    single25 = QueryEngine(db, device="cpu", model=BM25Ranker())
    snap = jax_single.snapshot
    pairs = _pair(snap, 4, weights="bm25", scoring="bm25")
    for query in ("algorithm database", "quantum", '"algorithm"'):
        got, want_jax = _run_both(snap, *pairs, query)
        want = single25.rank([tparse(query)], topk=50)
        assert _rows(*want)[0]
        _agree(got, want, RTOL_SINGLE, ATOL_SINGLE, query)
        _agree(got, want_jax, RTOL_JAX, 0.0, query)


def _truncated_db():
    rng = random.Random(0)
    from spaghettisearch_tpu.store.tables import Database

    db = Database(None)
    db.topic_meta.set("G", {"numPages": 10.0, "wordCount": 1.0})
    ts = datetime(2026, 1, 1, tzinfo=timezone.utc)
    for i in range(8):
        url, html = make_page(rng, i, 8, "http://tr.local")
        index_page(db, html, url, last_modified=ts)
    body = " ".join(f"uw{j}" for j in range(40)) + " zzmk quantum"
    index_page(db, f"<html><head><title>big</title></head><body><p>{body}</p></body></html>".encode(),
               "http://tr.local/big", last_modified=ts)
    jax_update_pagerank(db)
    update_term_weights(db, "title")
    update_term_weights(db, "body")
    return db


def test_sharded_phrase_with_truncated_dense_rows(monkeypatch):
    """Capped dense rows (DOC_TERM_CAP lowered on both sides): phrases take
    the exact CSR matcher on every shard."""
    monkeypatch.setattr(jsh, "DOC_TERM_CAP", 16)
    monkeypatch.setattr(tsh, "DOC_TERM_CAP", 16)
    db = _truncated_db()
    snap = JaxEngine(db).snapshot
    pairs = _pair(snap, 2, topk=20)
    assert pairs[1][0].dense_truncated
    for query in ('"zzmk quantum"', '"quantum"', "quantum uw3"):
        got, want_jax = _run_both(snap, *pairs, query)
        _agree(got, want_jax, RTOL_JAX, 0.0, query)
    got, _ = _run_both(snap, *pairs, '"zzmk quantum"')
    hits = [snap.doc_hashes[d] for d, _ in _rows(*got)[0]]
    assert [db.doc_info.get(h).url for h in hits] == ["http://tr.local/big"]


def test_sharded_doc_sorted_matches_natural(jax_single, pairs):
    """The per-shard doc-sorted layout (T bound + doc_perm gather) returns
    the natural layout's ids and scores, and JAX's doc-sorted scorer's."""
    snap = jax_single.snapshot
    s = pairs[1][0].n_shards
    (_, _), (tn, scn) = pairs
    jpair_s, (ts_, scs) = _pair(snap, s, doc_sort=True)
    assert tn.doc_perm is None and ts_.doc_perm is not None
    assert all(sh.body.tmax_blocks is not None for sh in ts_.shards)
    for query in QUERIES + ('"algorithm database"',):
        term_ids, qlen, tp, ph_ids, ph_valid, gen = _inputs(snap, query, 2)
        sn, i_n = scn(tn, term_ids, qlen, tp, ph_ids, ph_valid, gen)
        (ss, i_s), want_jax = _run_both(snap, jpair_s, (ts_, scs), query)
        fin = np.isfinite(sn.numpy()[0])
        assert np.isfinite(ss[0]).sum() == fin.sum(), query
        np.testing.assert_array_equal(i_s[0][fin], i_n.numpy()[0][fin], err_msg=query)
        np.testing.assert_allclose(ss[0][fin], sn.numpy()[0][fin], rtol=1e-5, atol=1e-7)
        _agree((ss, i_s), want_jax, RTOL_JAX, 0.0, query)


def _tie_db():
    """40 pages without links: every even page holds the same words, so
    their scores tie exactly, across every shard."""
    from spaghettisearch_tpu.store.tables import Database

    db = Database(None)
    db.topic_meta.set("G", {"numPages": 40.0, "wordCount": 1.0})
    ts = datetime(2026, 1, 1, tzinfo=timezone.utc)
    for i in range(40):
        words = "alpha beta" if i % 2 == 0 else f"gamma delta w{i}"
        html = f"<html><head><title>t</title></head><body><p>{words}</p></body></html>"
        index_page(db, html.encode(), f"http://tie.local/p{i}", last_modified=ts)
    jax_update_pagerank(db)
    update_term_weights(db, "title")
    update_term_weights(db, "body")
    return db


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_merge_breaks_cross_shard_ties_as_lax_top_k(n_shards):
    """A batch whose top-k cuts through 20 equal scores spread over every
    shard: the merged ids equal JAX's sharded scorer's exactly (lax.top_k
    over the flat shard-major [B, S*k] row), and the merge alone equals
    lax.top_k on crafted pieces full of ties."""
    snap = JaxEngine(_tie_db()).snapshot
    pairs = _pair(snap, n_shards, topk=7)
    got, want = _run_both(snap, *pairs, "alpha")
    assert len(set(got[0][0].tolist())) == 1 and np.isfinite(got[0]).all()
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])
    rng = np.random.default_rng(n_shards)
    k = 5
    scores = rng.integers(0, 3, (6, n_shards * k)).astype(np.float32)
    scores[0, :] = -np.inf
    ids = rng.permutation(6 * n_shards * k).reshape(6, n_shards * k).astype(np.int32)
    parts = [(torch.from_numpy(scores[:, s * k:(s + 1) * k]),
              torch.from_numpy(ids[:, s * k:(s + 1) * k])) for s in range(n_shards)]
    ms, mi = tsh._merge(parts, k, torch.device("cpu"))
    ws, wp = jax.lax.top_k(jnp.asarray(scores), k)
    np.testing.assert_array_equal(ms.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(mi.numpy(), np.take_along_axis(ids, np.asarray(wp), 1))
