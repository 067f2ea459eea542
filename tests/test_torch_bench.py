"""The port's bench (spaghettisearch_tpu_torch/bench.py) and its oracle
(spaghettisearch_tpu_torch/oracle.py) against the repo's bench.py and
tests/oracle.py, on the CPU at a 600-page benchmark corpus.

The JAX bench builds one corpus (jax_corpus); both benches read it, so the
parity comparison sees one store. The port builds its own (port_corpus)
for the modes only it runs here: parity_rare, sparse2m's body and serve.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench as jax_bench
import oracle as jax_oracle
from test_sharded_build import _random_csr, _shard_csr_vectorized

from spaghettisearch_tpu_torch import bench
from spaghettisearch_tpu_torch import oracle
from spaghettisearch_tpu_torch.retrieval.engine import parse_query
from spaghettisearch_tpu_torch.retrieval.topics import compute_topic_probs
from spaghettisearch_tpu_torch.store.tables import Database

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAGES = 600


@pytest.fixture(scope="module")
def jax_corpus(tmp_path_factory):
    """The JAX bench's corpus of PAGES pages; BENCH_DIR of both benches
    points at its directory while a test uses it."""
    d = str(tmp_path_factory.mktemp("jax_bench"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_bench, "BENCH_DIR", d)
        jax_bench.ensure_bench_corpus(PAGES)
    return d


@pytest.fixture(scope="module")
def port_corpus(tmp_path_factory):
    """The port's corpus of PAGES pages, built by ensure_bench_corpus (a
    subprocess of the port's bench, PageRank on the CPU)."""
    d = str(tmp_path_factory.mktemp("port_bench"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bench, "BENCH_DIR", d)
        root = bench.ensure_bench_corpus(PAGES, device="cpu")
    with open(os.path.join(root, "BUILT.json"), encoding="utf-8") as f:
        built = json.load(f)
    assert built["n_pages"] == PAGES and built["docs"] >= PAGES
    return d


@pytest.fixture
def on_jax_corpus(jax_corpus, monkeypatch):
    monkeypatch.setattr(jax_bench, "BENCH_DIR", jax_corpus)
    monkeypatch.setattr(bench, "BENCH_DIR", jax_corpus)
    return bench.corpus_root(PAGES)


@pytest.fixture
def on_port_corpus(port_corpus, monkeypatch):
    monkeypatch.setattr(bench, "BENCH_DIR", port_corpus)
    return bench.corpus_root(PAGES)


def _jax_store(root):
    from spaghettisearch_tpu.index.persist import load_snapshot
    from spaghettisearch_tpu.store.tables import Database as JaxDatabase

    return JaxDatabase(os.path.join(root, "store")), load_snapshot(os.path.join(root, "snapshot"))


def test_oracle_copy_answers_as_the_original(on_jax_corpus):
    """64 queries of the bench mix (keywords, mined phrases), each with no
    topic model and with compute_topic_probs(fixed=True): the port's
    oracle.retrieve equals tests/oracle.py's on the same store."""
    jdb, jsnap = _jax_store(on_jax_corpus)
    db = Database(os.path.join(on_jax_corpus, "store"))
    try:
        queries = bench.bench_queries(jsnap, 64, seed=9, phrase_every=3, db=jdb)
        assert sum('"' in q for q in queries) == 22
        n_hits = 0
        for q in queries:
            tp = compute_topic_probs(db, parse_query(q).keyword_hashes, fixed=True)
            assert set(tp) == {"General", "Science"}
            for probs in (None, tp, {"General": 0.25, "Science": 0.75}):
                got = oracle.retrieve(db, q, topic_probs=probs)
                assert got == jax_oracle.retrieve(jdb, q, topic_probs=probs), q
                n_hits += len(got)
        assert n_hits > 1000
    finally:
        db.close()
        jdb.close()


@pytest.mark.parametrize("phrase_every", [3, 4, 8])
def test_bench_queries_match_jax(on_jax_corpus, phrase_every):
    jdb, jsnap = _jax_store(on_jax_corpus)
    try:
        got = bench.bench_queries(jsnap, 200, seed=phrase_every, phrase_every=phrase_every, db=jdb)
        want = jax_bench.bench_queries(jsnap, 200, seed=phrase_every,
                                       phrase_every=phrase_every, db=jdb)
        assert got == want
        assert sum('"' in q for q in got) == len(range(0, 200, phrase_every))
    finally:
        jdb.close()


def test_summary_is_the_mined_body(on_port_corpus):
    """bench_queries mines phrases from a cached page's <p> words; for the
    rendered benchmark pages those are exactly the doc's summary words, so
    mining either gives the same phrases."""
    db, snap = bench.load_bench_corpus(on_port_corpus)
    try:
        for doc in snap.doc_hashes:
            raw = db.cached_doc(doc)
            body = raw.decode().split("<p>", 1)[-1].split("</p>", 1)[0].split() if raw else []
            assert (db.doc_summary.get(doc) or "").split() == body, doc
    finally:
        db.close()


def test_bench_parity_matches_jax(on_jax_corpus):
    """bench_parity at PAGES pages and 64 queries: the port on the CPU and
    the JAX package on its CPU backend agree field for field."""
    got = bench.bench_parity(PAGES, 64, "cpu")
    want = jax_bench.bench_parity(PAGES, 64)
    for key in ("metric", "value", "unit", "exact_order_at_10", "exact_order_at_50",
                "order_divergences_at_50", "divergences_tie_explained", "queries", "docs"):
        assert got[key] == want[key], key
    assert abs(got["score_max_rel_err"] - want["score_max_rel_err"]) <= 1e-6
    assert got["value"] == 1.0 and got["score_max_rel_err"] <= 1e-6


@pytest.fixture(scope="module")
def rare_families(port_corpus):
    """bench_parity_rare at PAGES pages, every family."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bench, "BENCH_DIR", port_corpus)
        return bench.bench_parity_rare(PAGES, "cpu")["families"]


def test_parity_rare_families(rare_families):
    fams = rare_families
    assert set(fams) == {"kw_catchall", "phrase_long", "widefold", "csr_lane", "big_batch",
                         "topic_fixed"}
    for name, fam in fams.items():
        assert fam["queries"] > 0, name
        assert fam["recall_at_10"] == 1.0, (name, fam)
        assert fam["order_divergences_at_50"] == fam["divergences_tie_explained"], (name, fam)
        assert fam["score_max_rel_err"] <= 1e-6, (name, fam)
        assert fam["launches"] == {"K1": 0, "K2": 0, "K3": 0, "K4": 0}  # plain versions
        assert fam["oracle_s"] > 0, name
    assert fams["big_batch"]["queries"] == 256


def test_parity_rare_subset_asks_the_same_queries(rare_families, on_port_corpus):
    """--families: a subset whose queries are drawn after skipped families'
    gives those families' results of the full run."""
    got = bench.bench_parity_rare(PAGES, "cpu", families=("widefold", "csr_lane"))["families"]
    assert set(got) == {"widefold", "csr_lane"}
    for name, fam in got.items():
        want = {k: v for k, v in rare_families[name].items() if k != "oracle_s"}
        assert {k: v for k, v in fam.items() if k != "oracle_s"} == want, name
    with pytest.raises(ValueError, match="not in"):
        bench.bench_parity_rare(PAGES, "cpu", families=("kw_catchall", "no_such_family"))


def test_corpus_of_another_seed_is_reused(tmp_path, monkeypatch):
    """A corpus built with seed 1 is reused by ensure_bench_corpus(seed=1);
    asked for seed 0, the bench builds anew, in a subprocess told the
    seed."""
    monkeypatch.setattr(bench, "BENCH_DIR", str(tmp_path))
    root = bench.corpus_root(40)
    bench.build_bench_corpus(root, n_pages=40, n_vocab=500, seed=1, device="cpu", quiet=True)
    calls = []
    monkeypatch.setattr(bench.subprocess, "run", lambda cmd, **kw: calls.append(cmd))
    assert bench.ensure_bench_corpus(40, n_vocab=500, device="cpu", seed=1) == root
    assert calls == []
    bench.ensure_bench_corpus(40, n_vocab=500, device="cpu", seed=0)
    assert len(calls) == 1 and calls[0][calls[0].index("--seed") + 1] == "0"
    assert calls[0][-4:] == ["--build-corpus", "40", "500", root]


def test_sparse2m_body(port_corpus):
    """bench_sparse2m at PAGES pages in a process of its own (it zeroes the
    position-plane budget): no planes, the sparse lane's matcher ran, and
    every divergence from the oracle is tie-explained."""
    code = (
        "import json, torch\n"
        "torch.set_num_threads(1)\n"
        "from spaghettisearch_tpu_torch import bench\n"
        f"bench.BENCH_DIR = {port_corpus!r}\n"
        f"print(json.dumps(bench.bench_sparse2m({PAGES}, 16, 'cpu')))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300, env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["pos_dense"] is False and res["matcher_calls"] > 0, res
    assert res["n_queries"] == 16 and res["phrase_queries"] == 8, res
    assert res["order_divergences_at_50"] == res["divergences_tie_explained"], res
    assert res["metric"] == "sparse_lane_exact_order_at_50_0k"


def test_serve_route_mix(on_port_corpus, monkeypatch):
    """The serve mode with --routeMix on the CPU, 16 connections: the
    server subprocess answers every request with 200, the contract holds
    and all three routes answer. With 17 distinct requests each connection
    cycles through all of them: with the default 4,096, connection 14 sends
    only /wordlist/w, whose answer is the whole vocabulary, and on the CPU
    that starves the plain versions' thread of the interpreter lock. No
    warm period: the window then holds the first batch, which carries
    connection 15's GET /query, however long a batch takes on a loaded
    host."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    res = bench.bench_serve(PAGES, duration_s=10.0, n_conns=16, warm_s=0.0, n_queries=17,
                            route_mix=True, device="cpu")
    assert res["contract"] is True and res["non_200"] == 0, res
    assert res["requests"] > 0 and res["connections"] == 16
    assert set(res["routes"]) == {"wordlist", "get_query", "post_query"}, res
    assert all(r["n"] > 0 for r in res["routes"].values())
    assert res["batches"] > 0 and res["spans_ms"]["dispatch"] is not None


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n_shards", [2, 4])
def test_shard_split_copy_matches_original(seed, n_shards):
    """The port's copy of the argsort splitter (the sharded mode's timed
    alternative) equals tests/test_sharded_build.py's on random CSRs."""
    csr = _random_csr(np.random.default_rng(seed), 173, 61, density=0.04)
    dl = -(-173 // n_shards)
    per_doc = np.bincount(csr.doc_ids[: csr.n_postings], minlength=173)
    t_pad = max(int(per_doc.max(initial=0)), 1)
    got = bench._shard_csr_vectorized(csr, n_shards, dl, t_pad)
    want = _shard_csr_vectorized(csr, n_shards, dl, t_pad)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_bench_refuses_cuda_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        bench.main(["--mode", "pagerank"])
    assert "CUDA is not available" in str(e.value)
