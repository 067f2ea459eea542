"""The port's ShardedQueryEngine (retrieval/sharded_engine.py) and the
server CLI's --meshShards/--meshBatch against the JAX package's on the CPU:
the engine tests of tests/test_sharded.py and tests/test_shape_policy.py's
sharded refresh tests, each with a counterpart that runs the same queries
through both packages' engines (the port's shards on ["cpu"] * S).

Results equal up to ties at equal scores; FinalRank within rtol 1e-5 of the
single-device engine and 1e-6 of JAX's mesh (tests/test_torch_sharded.py).
tests/test_shape_policy.py's compile counts have no counterpart: the port
compiles nothing per shape."""

from __future__ import annotations

import json
import random
import urllib.request
from datetime import datetime, timezone

import numpy as np
import pytest
import torch

import spaghettisearch_tpu.retrieval.device_index as jdi
import spaghettisearch_tpu_torch.parallel.sharded as tsh
import spaghettisearch_tpu_torch.retrieval.device_index as tdi
from corpus import build_corpus_db, make_page
from spaghettisearch_tpu.index.indexer import index_page
from spaghettisearch_tpu.ops.pagerank import update_pagerank as jax_update_pagerank
from spaghettisearch_tpu.ops.weighting import update_term_weights
from spaghettisearch_tpu.retrieval.engine import parse_query
from spaghettisearch_tpu.retrieval.sharded_engine import ShardedQueryEngine as JaxShardedEngine
from spaghettisearch_tpu_torch.models.bm25 import BM25Ranker
from spaghettisearch_tpu_torch.retrieval import sharded_engine as tse
from spaghettisearch_tpu_torch.retrieval.engine import QueryEngine
from spaghettisearch_tpu_torch.retrieval.engine import parse_query as tparse
from test_sharded import _hot_cold_queries, _hot_synth_snap
from test_torch_sharded import ATOL_SINGLE, RTOL_JAX, RTOL_SINGLE, _agree, _cpu_mesh, _phrase


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def db():
    return build_corpus_db(n_pages=30, seed=5)


@pytest.fixture(scope="module")
def single(db):
    return QueryEngine(db, device="cpu")


# --- the engine ----------------------------------------------------------------

def _same_results(got: list, want: list, rtol: float, what="") -> None:
    for q, g, w in zip(what or [""] * len(want), got, want):
        assert len(g) == len(w), q
        ref = {r["Url"]: r["FinalRank"] for r in w}
        for rg, rw in zip(g, w):
            if rg["Url"] != rw["Url"]:
                assert ref.get(rg["Url"], w[-1]["FinalRank"]) == pytest.approx(rw["FinalRank"], rel=rtol), q
            assert rg["FinalRank"] == pytest.approx(rw["FinalRank"], rel=rtol, abs=ATOL_SINGLE), q


def _engine_queries(db, snap) -> list[str]:
    phrase = _phrase(db, snap, 2)
    return ["algorithm database", phrase, "quantum physics galaxy",
            f"{phrase} ranking", "nonexistentzz", ""]


@pytest.mark.parametrize("shards,rows", [(4, 2), (2, 1), (8, 1)])
def test_sharded_engine_matches_single_chip(db, single, shards, rows):
    eng = tse.ShardedQueryEngine(db, n_shards=shards, n_query_rows=rows, device="cpu")
    assert eng._mesh.shape == ({"q": rows, "d": shards} if rows > 1 else {"d": shards})
    queries = _engine_queries(db, single.snapshot)
    got = eng.query_batch(queries)
    _same_results(got, single.query_batch(queries), RTOL_SINGLE, queries)
    _same_results(got, JaxShardedEngine(db, n_shards=shards, n_query_rows=rows).query_batch(queries),
                  RTOL_JAX, queries)


def test_sharded_engine_bm25_matches_single_chip(db):
    from spaghettisearch_tpu.models.bm25 import BM25Ranker as JaxBM25

    eng = tse.ShardedQueryEngine(db, model=BM25Ranker(), n_shards=4, device="cpu")
    queries = ["algorithm database", "quantum physics galaxy", '"algorithm"', ""]
    got = eng.query_batch(queries)
    want = QueryEngine(db, model=BM25Ranker(), device="cpu").query_batch(queries)
    _same_results(got, want, RTOL_SINGLE, queries)
    _same_results(got, JaxShardedEngine(db, model=JaxBM25(), n_shards=4).query_batch(queries),
                  RTOL_JAX, queries)


@pytest.mark.parametrize("shards,rows", [(4, 2), (2, 4)])
def test_sharded_engine_phrase_rows_cross_query_axis(db, single, shards, rows):
    """On a 2-D mesh the phrase rows are global batch positions, localized
    per query row: row 2's phrase lands on q-row 1."""
    phrase = _phrase(db, single.snapshot, 2)
    queries = [f"{phrase} algorithm", "galaxy", phrase, "database ranking"]
    eng = tse.ShardedQueryEngine(db, n_shards=shards, n_query_rows=rows, device="cpu")
    got = eng.query_batch(queries)
    _same_results(got, single.query_batch(queries), RTOL_SINGLE, queries)
    jeng = JaxShardedEngine(db, n_shards=shards, n_query_rows=rows)
    _same_results(got, jeng.query_batch(queries), RTOL_JAX, queries)
    # the sparse lane with phrases at rows of both q-rows (bp = b)
    for e in (eng, jeng):
        e.index.scorers.clear()
        e._scorer_cache.clear()
    eng.index.sidx.rows[0][0].title.posT = None
    jeng.index.sidx.title_posT = None
    _same_results(eng.query_batch(queries), jeng.query_batch(queries), RTOL_JAX, queries)


def test_sharded_mixed_lane_routed_and_matches(db, single):
    """Phrase batches take the fused mixed lane (K2 per shard) on a
    pos-dense index, equal to the single-device engine and to JAX's mesh."""
    eng = tse.ShardedQueryEngine(db, n_shards=4, device="cpu")
    jeng = JaxShardedEngine(db, n_shards=4)
    sidx = eng.index.sidx
    assert sidx.pos_dense and not sidx.dense_truncated
    phrase = _phrase(db, single.snapshot, 3)
    one = '"' + phrase.strip('"').split()[1] + '"'
    batches = [
        [phrase, one, '"quantum galaxy algorithm"', f"{phrase} database"],
        [phrase] * 3,
        [f"ranking {one}"],
    ]
    for queries in batches:
        parsed = [tparse(q) for q in queries]
        assert eng._use_mixed(sidx, parsed)
        got = eng.rank(parsed)
        _agree(got, single.rank(parsed), RTOL_SINGLE, ATOL_SINGLE, queries)
        _agree(got, jeng.rank([parse_query(q) for q in queries]), RTOL_JAX, 0.0, queries)
    assert any(isinstance(k, tuple) and k[0] == "mixed" for k in eng.index.scorers)


def test_sharded_no_posT_falls_back_to_sparse_lane(db, single):
    eng = tse.ShardedQueryEngine(db, n_shards=4, device="cpu")
    jeng = JaxShardedEngine(db, n_shards=4)
    for sh in eng.index.sidx.shards:
        sh.title.posT = None
    jeng.index.sidx.title_posT = None
    for e in (eng, jeng):
        e.index.scorers.clear()
        e._scorer_cache.clear()
    queries = ['"algorithm database"', "galaxy ranking"]
    parsed = [tparse(q) for q in queries]
    assert not eng._use_mixed(eng.index.sidx, parsed)
    got = eng.rank(parsed)
    _agree(got, single.rank(parsed), RTOL_SINGLE, ATOL_SINGLE, queries)
    _agree(got, jeng.rank([parse_query(q) for q in queries]), RTOL_JAX, 0.0, queries)


def test_sharded_class_batching_advice(db, monkeypatch):
    from spaghettisearch_tpu.retrieval import sharded_engine as jse

    eng = tse.ShardedQueryEngine(db, n_shards=2, device="cpu")
    jeng = jse.ShardedQueryEngine(db, n_shards=2)
    assert eng.class_batching_pays() is jeng.class_batching_pays() is False
    monkeypatch.setattr(tse, "SEGREGATE_MIN_DOCS", 1)
    monkeypatch.setattr(jse, "SEGREGATE_MIN_DOCS", 1)
    assert eng.class_batching_pays() is jeng.class_batching_pays() is True
    bm = tse.ShardedQueryEngine(db, n_shards=2, device="cpu", model=BM25Ranker())
    assert bm.class_batching_pays() is False


def test_sharded_hot_cache_built_and_global(monkeypatch):
    monkeypatch.setattr(tdi, "HOT_H_MAX", 64)
    snap = _hot_synth_snap()
    sidx = tsh.ShardedIndex.from_snapshot(snap, _cpu_mesh(4))
    one = tdi.DeviceIndex.from_snapshot(snap, "cpu")
    assert sidx.hot_body_w is not None and one.hot_body_w is not None
    assert sidx.hot_body_map == one.hot_body_map
    got = torch.stack(sidx.hot_body_w).numpy()  # [S, H, Dl]
    want = one.hot_body_w.numpy()  # [H, D_pad]
    s, h, dl = got.shape
    flat = np.moveaxis(got, 0, 1).reshape(h, s * dl)
    np.testing.assert_array_equal(flat[: want.shape[0], : snap.n_docs], want[:, : snap.n_docs])


@pytest.mark.parametrize("phrase_every", [0, 4])
def test_sharded_hot_cold_mix_matches_single_chip(monkeypatch, phrase_every):
    """Hot and cold terms mixed: the qnb split and the hot matmul fold on
    the mesh (keyword scorer; with phrases, the mixed scorer)."""
    monkeypatch.setattr(tdi, "HOT_H_MAX", 64)
    monkeypatch.setattr(jdi, "HOT_H_MAX", 64)
    snap = _hot_synth_snap()
    single = QueryEngine(None, snapshot=snap, device="cpu")
    eng = tse.ShardedQueryEngine(None, snapshot=snap, n_shards=4, device="cpu")
    jeng = JaxShardedEngine(None, snapshot=snap, n_shards=4)
    assert eng.index.sidx.hot_body_map == single.index.hot_body_map
    assert len(eng.index.sidx.hot_body_map) == 64
    batch = _hot_cold_queries(snap, np.random.default_rng(17), 16, phrase_every)
    got = eng.rank(batch, topk=30)
    _agree(got, single.rank(batch, topk=30), RTOL_SINGLE, ATOL_SINGLE)
    _agree(got, jeng.rank(batch, topk=30), RTOL_JAX)


def test_sharded_engine_doc_sorted_end_to_end(db, monkeypatch):
    """A force-gated doc-sorted mesh equals the single-device natural layout
    and JAX's doc-sorted mesh."""
    single = QueryEngine(db, doc_sort=False, device="cpu")
    for di in (tdi, jdi):
        monkeypatch.setattr(di, "DOC_SORT_MIN_DOCS", 1)
        monkeypatch.setattr(di, "_doc_sort_pays", lambda nt: True)
    eng = tse.ShardedQueryEngine(db, n_shards=4, device="cpu")
    assert eng.index.sidx.doc_perm is not None
    queries = _engine_queries(db, single.snapshot)
    got = eng.query_batch(queries)
    _same_results(got, single.query_batch(queries), RTOL_SINGLE, queries)
    jeng = JaxShardedEngine(db, n_shards=4)
    assert jeng.index.sidx.doc_perm is not None
    _same_results(got, jeng.query_batch(queries), RTOL_JAX, queries)


def _grow(db, lo: int, hi: int) -> None:
    rng = random.Random(99)
    ts = datetime(2026, 2, 2, tzinfo=timezone.utc)
    for i in range(lo, hi):
        url, html = make_page(rng, i, hi, "http://test.local")
        index_page(db, html, url, last_modified=ts)
    jax_update_pagerank(db)
    update_term_weights(db, "title")
    update_term_weights(db, "body")


def test_sharded_live_pins_refresh():
    """A live tuple captured before /refresh keeps scoring against its own
    index; the swapped-in one scores the grown corpus as JAX's mesh does."""
    db = build_corpus_db(n_pages=12, seed=4)
    eng = tse.ShardedQueryEngine(db, n_shards=2, device="cpu")
    parsed = tparse("algorithm database")
    old_live = eng._live
    want = eng.rank([parsed], topk=20, live=old_live)
    _grow(db, 12, 30)
    eng.refresh()
    assert eng._live is not old_live
    got = eng.rank([parsed], topk=20, live=old_live)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
    new = eng.rank([parsed], topk=20)
    assert np.isfinite(new[0]).sum() >= np.isfinite(want[0]).sum()
    _agree(new, JaxShardedEngine(db, n_shards=2).rank([parse_query("algorithm database")], topk=20),
           RTOL_JAX)


def test_sharded_scorer_reused_across_same_geometry_refresh():
    db = build_corpus_db(n_pages=12, seed=4)
    eng = tse.ShardedQueryEngine(db, n_shards=2, device="cpu")
    eng.rank([tparse("algorithm")], topk=20)
    scorer = eng._live[1].scorers[20]
    eng.refresh()
    eng.rank([tparse("algorithm")], topk=20)
    assert eng._live[1].scorers[20] is scorer


def test_sharded_refresh_warm_covers_all_live_shapes(monkeypatch):
    """After a geometry-changing prepare_refresh(warm=True) the new index
    runs every shape family once off-lock (warmup), and every batch the
    batcher can dispatch then equals JAX's mesh on the grown corpus."""
    from corpus import VOCAB

    db = build_corpus_db(n_pages=24, seed=11)
    eng = tse.ShardedQueryEngine(db, n_shards=2, device="cpu")
    eng.warmup()
    old_sig = tse._index_sig(eng.index.sidx)
    body = " ".join(f"zfreshterm{i}" for i in range(64))
    html = f"<html><head><title>fresh geometry page</title></head><body><p>{body}</p></body></html>"
    index_page(db, html.encode(), "http://test.local/fresh",
               last_modified=datetime(2026, 2, 1, tzinfo=timezone.utc))
    jax_update_pagerank(db)
    update_term_weights(db, "title")
    update_term_weights(db, "body")
    warmed = []
    real = tse.ShardedQueryEngine.warmup
    monkeypatch.setattr(tse.ShardedQueryEngine, "warmup",
                        lambda self, *a, **k: warmed.append(self) or real(self, *a, **k))
    state = eng.prepare_refresh(warm=True)
    assert len(warmed) == 1 and warmed[0] is not eng
    old = eng.commit_refresh(state)
    assert old is None  # in-memory store
    assert tse._index_sig(eng.index.sidx) != old_sig
    jeng = JaxShardedEngine(db, n_shards=2)
    kw, ph = "algorithm database", '"algorithm database"'
    rare_kw = " ".join(VOCAB[:12])
    rare_ph = '"' + " ".join(VOCAB[:12]) + '" ' + rare_kw
    for batch in ([kw], [ph, kw, kw], [kw] * 16, [ph] * 16, [ph, kw] * 30, [kw] * 128,
                  ([ph] * 3 + [kw] * 5) * 16, [rare_kw, rare_ph, kw, ph], ["zfreshterm3"]):
        _same_results(eng.query_batch(batch), jeng.query_batch(batch), RTOL_JAX, batch)
    assert eng.query("zfreshterm3")[0]["Url"] == "http://test.local/fresh"


# --- the server CLI --------------------------------------------------------------

def _fetch(url, payload=None):
    req = url if payload is None else urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    with urllib.request.urlopen(req, timeout=120) as r:
        assert r.status == 200
        return json.loads(r.read())


def _start_cli(cli, argv, monkeypatch, started: list) -> str:
    """Run a server CLI's main with its SearchServer serving in the
    background; -> its base URL."""
    real = cli.SearchServer

    class Background(real):
        def serve(self, port=8080, host="127.0.0.1"):
            started.append(self)
            self.base = "http://%s:%d" % self.start_background(port=0)

    monkeypatch.setattr(cli, "SearchServer", Background)
    cli.main(argv)
    return started[-1].base


@pytest.mark.parametrize("mesh_batch", [1, 2])
def test_server_cli_mesh_bodies_equal_jax(tmp_path, monkeypatch, mesh_batch):
    """`cli.server --device cpu --meshShards 2 [--meshBatch 2]` serves /query
    bodies that parse-equal the JAX server's with the same flags."""
    from spaghettisearch_tpu.cli import server as jcli
    from spaghettisearch_tpu_torch.cli import server as tcli
    from test_torch_engine import CRAWL_QUERIES
    from test_torch_serve import _same_body

    monkeypatch.setenv("SPAGHETTI_JAX_CACHE", "0")
    root = str(tmp_path / "db")
    build_corpus_db(n_pages=40, seed=3, root=root).close()
    flags = ["--db", root, "--meshShards", "2", "--meshBatch", str(mesh_batch), "--noWarmup"]
    started: list = []
    try:
        base = _start_cli(tcli, flags + ["--device", "cpu"], monkeypatch, started)
        jbase = _start_cli(jcli, flags, monkeypatch, started)
        assert isinstance(started[0].engine, tse.ShardedQueryEngine)
        assert started[0].engine._mesh.shape == (
            {"q": 2, "d": 2} if mesh_batch == 2 else {"d": 2})
        n = 0
        for q in CRAWL_QUERIES:
            want = _fetch(jbase + "/query", {"query": q})
            _same_body(_fetch(base + "/query", {"query": q}), want)
            n += len(want)
        assert n > 0
    finally:
        for s in started:
            s.shutdown()
            s.engine.db.close()


@pytest.mark.parametrize("argv,need", [(["--meshShards", "2"], 2),
                                       (["--meshShards", "2", "--meshBatch", "2"], 4)])
def test_server_cli_mesh_above_device_count_exits(monkeypatch, argv, need):
    """On --device cuda, a mesh larger than the visible cards exits with a
    message: the CLI never shrinks the mesh to the cards it finds."""
    from spaghettisearch_tpu_torch.cli import server as cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit) as e:
        cli.main(["--db", "/nonexistent-db"] + argv)
    assert f"needs {need} CUDA devices, 1 visible" in str(e.value)
