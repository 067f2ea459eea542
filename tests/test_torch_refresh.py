"""The port's live index against the JAX package's, on the CPU:
QueryEngine.refresh() picks up appended docs; queries race refresh() (the
counterpart of tests/test_integration.py's test_concurrent_queries_and_refresh);
the server's /refresh runs under batched keyword and phrase load on the
native store (the counterpart of test_refresh_under_load_native_backend);
after a refresh the port's top-50 equals the JAX engine's on the same
appended store; and a refresh frees the old index once a batch has run on
the new one.

Ids equal up to ties at equal scores; FinalRank within rtol 1e-6."""

from __future__ import annotations

import gc
import random
import threading
import time
import weakref
from datetime import datetime, timezone

import pytest
import torch

from spaghettisearch_tpu.retrieval.engine import QueryEngine as JaxEngine
from spaghettisearch_tpu.store.tables import Database as JaxDatabase
from spaghettisearch_tpu_torch.cli import crawl as crawl_cli
from spaghettisearch_tpu_torch.corpus import build_corpus_db, make_page
from spaghettisearch_tpu_torch.crawl.localsite import LocalSite
from spaghettisearch_tpu_torch.index.indexer import index_page
from spaghettisearch_tpu_torch.ops.pagerank import update_pagerank
from spaghettisearch_tpu_torch.ops.weighting import update_term_weights
from spaghettisearch_tpu_torch.retrieval.engine import QueryEngine
from spaghettisearch_tpu_torch.retrieval.sharded_engine import ShardedQueryEngine
from spaghettisearch_tpu_torch.serve.server import SearchServer
from spaghettisearch_tpu_torch.store.tables import Database
from test_torch_engine import CRAWL_QUERIES, _check_rank
from test_torch_sharded_engine import _same_results

torch.set_num_threads(1)

T_APPEND = datetime(2026, 2, 1, tzinfo=timezone.utc)
LOAD_QUERIES = ("algorithm database", '"algorithm database"', 'x "algorithm"')


def _append(db, n: int, seed: int, marker: str = "") -> list[str]:
    """Index n make_page pages (each titled with `marker` too, when given)
    and rerun PageRank and term weighting. -> their URLs."""
    rng = random.Random(seed)
    urls = []
    for i in range(n):
        url, html = make_page(rng, 1000 + i, 10_000, f"http://append{seed}.local")
        if marker:
            html = html.replace(b"<title>", f"<title>{marker} ".encode(), 1)
        index_page(db, html, url, last_modified=T_APPEND)
        urls.append(url)
    update_pagerank(db, device="cpu")
    update_term_weights(db, "title")
    update_term_weights(db, "body")
    return urls


def test_refresh_picks_up_appended_docs(tmp_path):
    db = build_corpus_db(n_pages=12, seed=7, root=str(tmp_path / "db"), device="cpu")
    eng = QueryEngine(db, device="cpu")
    assert eng.query("zzuniquetitleword") == []
    n0 = eng.index.n_docs
    urls = _append(db, 4, seed=1, marker="zzuniquetitleword")
    eng.refresh()
    assert eng.db is not db and eng.index.n_docs > n0
    hits = eng.query("zzuniquetitleword")
    assert sorted(h["Url"] for h in hits) == sorted(urls)
    eng.db.close()


def test_refresh_top50_matches_jax_on_appended_store(tmp_path):
    """The port's engine refreshed over an appended store ranks what a JAX
    engine opened on that store ranks."""
    root = str(tmp_path / "db")
    db = build_corpus_db(n_pages=40, seed=3, root=root, device="cpu")
    eng = QueryEngine(db, device="cpu")
    _append(db, 9, seed=2)
    eng.refresh()
    jdb = JaxDatabase(root)
    try:
        jeng = JaxEngine(jdb)
        assert jeng.index.n_docs == eng.index.n_docs
        _check_rank(jeng, eng, CRAWL_QUERIES)
        _same_results(eng.query_batch(CRAWL_QUERIES), jeng.query_batch(CRAWL_QUERIES), 1e-6,
                      CRAWL_QUERIES)
    finally:
        jdb.close()
        eng.db.close()


def _fixture_site() -> dict[str, bytes]:
    """tests/test_integration.py's site: 12 make_page pages, each linking
    the next, and a home page."""
    rng = random.Random(42)
    pages = {}
    n = 12
    for i in range(n):
        _, html = make_page(rng, i, n, "http://placeholder")
        pages[f"/page{i}"] = html.replace(
            b"</body>", b'<a href="/page%d">next page</a></body>' % ((i + 1) % n)
        )
    pages["/"] = (
        b"<html><head><title>Fixture Home</title></head><body>"
        b'<p>fixture home entry</p><a href="/page0">zero</a><a href="/page1">one</a></body></html>'
    )
    return pages


def test_concurrent_queries_and_refresh(tmp_path):
    """Race-safety: parallel queries while the snapshot swaps underneath."""
    db_path = str(tmp_path / "db2")
    with LocalSite(_fixture_site(), last_modified="Wed, 01 Jan 2026 00:00:00 GMT") as site:
        crawl_cli.main(["--startURL", site.base, "--numPages", "20", "--db", db_path,
                        "--skipODP", "--device", "cpu"])
    db = Database(db_path)
    engine = QueryEngine(db, device="cpu")
    errors: list[Exception] = []
    answers: list[list[str]] = []

    def worker():
        try:
            for _ in range(5):
                answers.append([r["Url"] for r in engine.query("fixture home entry")])
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for _ in range(3):
        engine.refresh()
    for t in threads:
        t.join()
    assert not errors
    assert len(answers) == 20 and all(a == answers[0] for a in answers)
    assert answers[0][0] == site.base  # the home page: both query terms in its title
    jdb = JaxDatabase(db_path)
    try:
        _same_results(engine.query_batch(["fixture home entry"]),
                      JaxEngine(jdb).query_batch(["fixture home entry"]), 1e-6)
    finally:
        jdb.close()
        engine.db.close()


def test_refresh_under_load_native_backend(tmp_path):
    """/refresh reopens the native store while the batcher hydrates results
    through it (the JAX package's regression for a segfault through
    ctypes); afterwards the server still answers what JAX answers."""
    root = str(tmp_path / "ndb")
    db = build_corpus_db(n_pages=12, seed=3, root=root, device="cpu")
    assert db.backend_kind in ("native", "log")
    srv = SearchServer(QueryEngine(db, device="cpu"), batching=True, max_wait_ms=0.5)
    errors: list[str] = []
    n_refresh = [0]
    stop = time.time() + 4.0

    def q():
        # keyword AND phrase traffic: phrases ride the fused mixed lane,
        # whose posT planes swap with the live tuple on every refresh
        i = 0
        while time.time() < stop:
            try:
                srv.handle_query(LOAD_QUERIES[i % len(LOAD_QUERIES)])
                i += 1
            except Exception as e:  # noqa: BLE001
                errors.append(repr(e))

    def refresh():
        while time.time() < stop:
            try:
                srv.handle_refresh()
                n_refresh[0] += 1
            except Exception as e:  # noqa: BLE001
                errors.append(repr(e))
            time.sleep(0.05)

    threads = [threading.Thread(target=q) for _ in range(4)] + [threading.Thread(target=refresh)]
    [t.start() for t in threads]
    [t.join() for t in threads]
    assert errors == [] and n_refresh[0] >= 1
    assert srv.handle_query("algorithm")  # still serving, still correct
    got = [srv.handle_query(q) for q in LOAD_QUERIES]
    srv.batcher.shutdown()
    jdb = JaxDatabase(root)
    try:
        _same_results(got, JaxEngine(jdb).query_batch(list(LOAD_QUERIES)), 1e-6, LOAD_QUERIES)
    finally:
        jdb.close()
        srv.engine.db.close()


@pytest.mark.parametrize("sharded", [False, True])
def test_refresh_frees_the_old_index(tmp_path, sharded):
    """After /refresh, once a batch has run on the new live state, nothing
    keeps the old index alive (on the card each one holds the whole index's
    device memory). The batcher's threads hold the live state of the last
    batch they ran until their next batch, so the old index is released by
    the first batch after the swap, not by the swap itself."""
    db = build_corpus_db(n_pages=12, seed=3, root=str(tmp_path / "db"), device="cpu")
    eng = (ShardedQueryEngine(db, n_shards=2, device="cpu") if sharded
           else QueryEngine(db, device="cpu"))
    srv = SearchServer(eng, batching=True, max_wait_ms=0.5)
    try:
        old = []
        for _ in range(3):
            for q in LOAD_QUERIES:
                assert srv.handle_query(q) is not None
            old.append((weakref.ref(eng.index), weakref.ref(eng.snapshot)))
            srv.handle_refresh()
        for q in LOAD_QUERIES:
            srv.handle_query(q)
        gc.collect()
        assert all(i() is None and s() is None for i, s in old)
    finally:
        srv.batcher.shutdown()
        eng.db.close()
