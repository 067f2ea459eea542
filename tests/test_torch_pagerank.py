"""The PyTorch port's PageRank (ops/pagerank.py) against the JAX package's:
the quirk model (`pagerank_power`) and the repaired topic model
(`pagerank_personalized`) on seeded graphs, in float32 (rtol 1e-5: the two
sum in different orders) and in float64 (rtol 1e-12, the JAX side under
`jax.enable_x64(True)` as a context manager); the Go restatement of the
reference loop; `update_pagerank` store round trips for both models; and
the corpus writer's doc_rank against the JAX update_pagerank."""

from __future__ import annotations

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corpus import build_corpus_db
from spaghettisearch_tpu.ops import pagerank as jpr
from spaghettisearch_tpu.store.tables import Database as JaxDatabase
from spaghettisearch_tpu_torch.corpus import write_corpus
from spaghettisearch_tpu_torch.ops import pagerank as tpr
from spaghettisearch_tpu_torch.store.tables import Database
from test_ranking import _random_graph, go_pagerank

torch.set_num_threads(1)

F32_RTOL = 1e-5
F64_RTOL = 1e-12


def _graph(seed: int, n: int):
    """Edge arrays (sorted by destination) of a seeded random graph with a
    dangling stub node, as tests/test_ranking.py builds them."""
    web = _random_graph(random.Random(seed), n)
    nodes = sorted(set(web) | {c for kids in web.values() for c in kids})
    node_id = {h: i for i, h in enumerate(nodes)}
    srcs, dsts = [], []
    outdeg = np.zeros(len(nodes))
    for p, kids in web.items():
        outdeg[node_id[p]] = len(kids)
        for c in kids:
            srcs.append(node_id[p])
            dsts.append(node_id[c])
    order = np.argsort(dsts, kind="stable")
    src = np.asarray(srcs, np.int32)[order]
    dst = np.asarray(dsts, np.int32)[order]
    return web, nodes, src, dst, outdeg


def _personalization(seed: int, c: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    p = rng.random((c, n)) * (rng.random((c, n)) < 0.3)
    p[0] = 1.0  # one uniform row
    return p / p.sum(axis=1, keepdims=True)


def _run_jax(model: str, src, dst, outdeg, extra, n, dtype, **kw) -> np.ndarray:
    fn = jpr.pagerank_power if model == "power" else jpr.pagerank_personalized
    return np.asarray(fn(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(outdeg, dtype),
                         jnp.asarray(extra, dtype), n, **kw))


def _run_torch(model: str, src, dst, outdeg, extra, n, dtype, **kw) -> np.ndarray:
    fn = tpr.pagerank_power if model == "power" else tpr.pagerank_personalized
    return fn(torch.as_tensor(src), torch.as_tensor(dst), torch.as_tensor(outdeg, dtype=dtype),
              torch.as_tensor(extra, dtype=dtype), n, **kw).numpy()


CASES = [("power", 7, 30), ("power", 3, 200), ("personalized", 5, 40), ("personalized", 11, 300)]


def _extra(model: str, seed: int, n_nodes: int, n_pages: int) -> np.ndarray:
    if model == "power":
        return np.array([float(n_pages), n_pages / 2.0, 1000.0])
    return _personalization(seed, 4, n_nodes)


@pytest.mark.parametrize("model,seed,n", CASES)
def test_matches_jax_float32(model, seed, n):
    _, nodes, src, dst, outdeg = _graph(seed, n)
    extra = _extra(model, seed, len(nodes), n)
    want = _run_jax(model, src, dst, outdeg, extra, len(nodes), jnp.float32)
    got = _run_torch(model, src, dst, outdeg, extra, len(nodes), torch.float32)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=F32_RTOL, atol=0)


@pytest.mark.parametrize("eps", [None, 1e-6])
@pytest.mark.parametrize("model,seed,n", CASES)
def test_matches_jax_float64(model, seed, n, eps):
    """float64 on both sides; eps=1e-6 stops both early, so the stop rule
    (after the first iteration whose delta <= eps) must agree too."""
    _, nodes, src, dst, outdeg = _graph(seed, n)
    extra = _extra(model, seed, len(nodes), n)
    kw = {} if eps is None else {"eps": eps}
    with jax.enable_x64(True):
        want = _run_jax(model, src, dst, outdeg, extra, len(nodes), jnp.float64, **kw)
    stats: dict = {}
    got = _run_torch(model, src, dst, outdeg, extra, len(nodes), torch.float64, stats=stats, **kw)
    assert want.dtype == np.float64 and got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=F64_RTOL, atol=0)
    if eps is not None:
        assert stats["delta"] <= eps and stats["iterations"] < tpr.DEFAULT_MAX_ITERS


def test_stop_rule_counts_iterations():
    _, nodes, src, dst, outdeg = _graph(7, 30)
    stats: dict = {}
    _run_torch("power", src, dst, outdeg, [30.0], len(nodes), torch.float64, stats=stats)
    # stopped at the first iteration whose delta <= eps (1e-20), which f64
    # reaches on this graph (delta 0: the fixed point exactly)
    assert stats["delta"] <= 1e-20 and 1 < stats["iterations"] < tpr.DEFAULT_MAX_ITERS
    n_stop = stats["iterations"]
    _run_torch("power", src, dst, outdeg, [30.0], len(nodes), torch.float64, stats=stats,
               max_iters=n_stop - 1)
    assert stats["iterations"] == n_stop - 1 and stats["delta"] > 1e-20
    for max_iters in (1, 2, n_stop - 2):
        _run_torch("power", src, dst, outdeg, [30.0], len(nodes), torch.float64, stats=stats,
                   max_iters=max_iters)
        assert stats["iterations"] == max_iters


def test_matches_go_reference_loop():
    web, nodes, src, dst, outdeg = _graph(7, 30)
    expected = go_pagerank(web, nodes, 0.75, 1e-12, 30)
    got = _run_torch("power", src, dst, outdeg, [30.0], len(nodes), torch.float64, eps=1e-12)
    np.testing.assert_allclose(got[0], [expected[k] for k in nodes], rtol=1e-9, atol=0)
    got32 = _run_torch("power", src, dst, outdeg, [30.0], len(nodes), torch.float32, eps=1e-12)
    np.testing.assert_allclose(got32[0], [expected[k] for k in nodes], rtol=2e-4, atol=1e-6)


#: the stop-point check: seeded graphs of ~3,000 nodes, 16 categories for the
#: topic model (the quirk model's three numPages inits, as _extra gives them)
STOP_NODES, STOP_CATEGORIES = 3000, 16


@pytest.mark.parametrize("seed", range(1, 9))
@pytest.mark.parametrize("model", ["power", "personalized"])
def test_float32_stop_point_against_jax(model, seed):
    """Where the JAX package's float32 loop stops, found without changing
    it: the port stops after n = stats["iterations"]; its last iteration
    that changed the ranks is n, or n - 1 when the stop came from a zero
    delta (that iteration changed nothing). The JAX run at max_iters=last
    must be bit-equal to its run at the default and the run at last - 1
    must not: then the JAX loop settled at the same iteration.

    The quirk model must stop where the JAX package does on every graph.
    The topic model's eps (1e-12) is below float32's rounding noise, so its
    stop is the first iteration whose rounding happens to leave a delta
    that small, and that depends on the order of the float32 sums: where
    the two packages stop apart, the port's own stop must move when each
    destination's in-edges are summed in another order (the graph and the
    ranks unchanged). The ranks agree within F32_RTOL either way."""
    _, nodes, src, dst, outdeg = _graph(seed, STOP_NODES)
    n = len(nodes)
    extra = (_extra(model, seed, n, STOP_NODES) if model == "power"
             else _personalization(seed, STOP_CATEGORIES, n))
    stats: dict = {}
    got = _run_torch(model, src, dst, outdeg, extra, n, torch.float32, stats=stats)
    last = stats["iterations"] - (stats["delta"] == 0)
    want = _run_jax(model, src, dst, outdeg, extra, n, jnp.float32)
    np.testing.assert_allclose(got, want, rtol=F32_RTOL, atol=0)
    at_last = _run_jax(model, src, dst, outdeg, extra, n, jnp.float32, max_iters=last)
    before = _run_jax(model, src, dst, outdeg, extra, n, jnp.float32, max_iters=last - 1)
    same_stop = np.array_equal(at_last, want) and not np.array_equal(before, want)
    order = np.lexsort((np.random.default_rng(seed).random(len(dst)), dst))
    reordered: dict = {}
    _run_torch(model, src[order], dst[order], outdeg, extra, n, torch.float32, stats=reordered)
    print(f"{model} seed {seed}: port stops at {stats['iterations']} (delta {stats['delta']:.3g}), "
          f"JAX settles there: {same_stop}; with the edges reordered the port stops at "
          f"{reordered['iterations']}")
    if model == "power":
        assert same_stop
    else:
        assert same_stop or reordered["iterations"] != stats["iterations"]


def test_quirk_categories_identical():
    """Different numPages inits converge to the same fixed point."""
    _, nodes, src, dst, outdeg = _graph(3, 15)
    got = _run_torch("power", src, dst, outdeg, [10.0, 1000.0], len(nodes), torch.float32,
                     eps=1e-10, max_iters=500)
    np.testing.assert_allclose(got[0], got[1], rtol=1e-6)


def _copy_store(db, rows=("doc_children", "topic_meta", "inv_topic", "doc_info")) -> tuple:
    """The same rows in a JAX package store and in a port store."""
    jdb, tdb = JaxDatabase(None), Database(None)
    for name in rows:
        for k, v in db.tables[name].items():
            jdb.tables[name].set(k, v)
            tdb.tables[name].set(k, v)
    return jdb, tdb


def _ranks(db) -> dict:
    return {k: v for k, v in db.doc_rank.items()}


def _assert_ranks_close(got: dict, want: dict, rtol: float) -> None:
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].keys() == want[k].keys(), k
        for c in want[k]:
            assert got[k][c] == pytest.approx(want[k][c], rel=rtol, abs=0), (k, c)


@pytest.fixture(scope="module")
def crawled():
    db = build_corpus_db(n_pages=60, seed=5)
    # ODP term profiles, so the personalized model has distinct categories
    rng = random.Random(1)
    for wh in sorted(db.word.keys())[:30]:
        db.inv_topic.set(wh, {rng.choice(["Science", "Arts"]): rng.randint(1, 9)})
    return db


@pytest.mark.parametrize("personalized", [False, True])
def test_update_pagerank_matches_jax(crawled, personalized):
    jdb, tdb = _copy_store(crawled)
    jpr.update_pagerank(jdb, personalized=personalized)
    run = tpr.update_pagerank(tdb, personalized=personalized, device="cpu")
    assert run["nodes"] == len(_ranks(jdb)) and run["categories"] == 2
    assert 0 < run["iterations"] <= tpr.DEFAULT_MAX_ITERS
    _assert_ranks_close(_ranks(tdb), _ranks(jdb), F32_RTOL)
    if personalized:  # genuinely different categories
        r = np.array([[v["Arts"], v["Science"]] for v in _ranks(tdb).values()])
        assert not np.allclose(r[:, 0], r[:, 1])
        np.testing.assert_allclose(r.sum(axis=0), 1.0, rtol=1e-4)


@pytest.mark.parametrize("personalized", [False, True])
def test_update_pagerank_float64_matches_jax(crawled, personalized):
    jdb, tdb = _copy_store(crawled)
    with jax.enable_x64(True):
        jpr.update_pagerank(jdb, personalized=personalized)
    tpr.update_pagerank(tdb, personalized=personalized, device="cpu", dtype=torch.float64)
    _assert_ranks_close(_ranks(tdb), _ranks(jdb), F64_RTOL)


def test_update_pagerank_small_store():
    db = Database()
    db.doc_children.set("a", ["b", "c"])
    db.doc_children.set("b", ["c"])
    db.doc_children.set("c", [])
    db.topic_meta.set("Sci", {"numPages": 3.0, "wordCount": 10.0})
    run = tpr.update_pagerank(db, device="cpu")
    ranks = _ranks(db)
    assert set(ranks) == {"a", "b", "c"} and run["edges"] == 3
    assert ranks["c"]["Sci"] > ranks["a"]["Sci"]
    empty = Database()
    assert tpr.update_pagerank(empty, device="cpu")["nodes"] == 0 and len(empty.doc_rank) == 0
    no_topics = Database()
    no_topics.doc_children.set("a", ["b"])
    tpr.update_pagerank(no_topics, device="cpu")
    assert _ranks(no_topics) == {"a": {}, "b": {}}


def test_corpus_writer_pagerank_matches_jax():
    """corpus.py's doc_rank is the JAX update_pagerank's on bench.py's
    corpus (reference model, f32), within rtol 1e-5."""
    db = write_corpus(None, n_pages=2000, seed=0, device="cpu")
    jdb, _ = _copy_store(db, rows=("doc_children", "topic_meta"))
    jpr.update_pagerank(jdb)
    got, want = _ranks(db), _ranks(jdb)
    assert len(got) == 2000 and set(next(iter(got.values()))) == {"General", "Science"}
    _assert_ranks_close(got, want, F32_RTOL)
