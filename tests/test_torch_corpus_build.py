"""The benchmark corpus built by several processes (corpus.write_corpus with
workers > 1, index/parallel_build.py) against the one-process build: every
table value for value, the docs pack byte for byte, the snapshot arrays.

Two tables are sums whose order follows the store's row order, which
differs between any two builds, one-process ones included (PERF.md §6, PR
13): `doc_magnitude` (float64 sums of squared weights; two one-process
builds differ by up to 9e-16 relative) and `doc_rank` (PageRank sums each
node's in-edges in the order the children table yields its rows; up to
1.5e-7 relative in float32). They are held at 1e-12 and 1e-6 relative.

Also: the parallel build against the JAX package's own bench.py build at
300 pages, a worker that raises or dies failing the build, and the parity
modes' oracle spread over processes answering as the serial one."""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from spaghettisearch_tpu_torch import corpus
from spaghettisearch_tpu_torch.corpus import BASE_URL, write_corpus, write_corpus_with_snapshot
from spaghettisearch_tpu_torch.index import parallel_build
from spaghettisearch_tpu_torch.index.snapshot import build_snapshot
from spaghettisearch_tpu_torch.store.tables import TABLE_SPECS
from spaghettisearch_tpu_torch.utils.hashing import md5_hex

torch.set_num_threads(1)

PAGES, VOCAB, SEED = 1500, 3000, 1
MAG_RTOL, RANK_RTOL = 1e-12, 1e-6


def _table(db, name) -> dict:
    spec = next(s for s in TABLE_SPECS if s.name == name)
    return {k: spec.encode(v) for k, v in db.tables[name].items()}


def _close(got: dict, want: dict, rtol: float) -> None:
    assert got.keys() == want.keys()
    for k, row in want.items():
        assert list(got[k]) == list(row), k
        for c, v in row.items():
            assert got[k][c] == pytest.approx(v, rel=rtol, abs=0), (k, c)


def assert_same_build(got, want) -> None:
    """Every table equal (each row in the same key order), doc_magnitude and
    doc_rank at their bars; the cached pages and the docs pack's files equal
    byte for byte; the snapshots' arrays equal."""
    for spec in TABLE_SPECS:
        g, w = _table(got, spec.name), _table(want, spec.name)
        if spec.name == "doc_magnitude":
            _close(g, w, MAG_RTOL)
        elif spec.name == "doc_rank":
            _close(g, w, RANK_RTOL)
        else:
            assert g == w, spec.name
            for k, v in w.items():
                if isinstance(v, dict):
                    assert list(g[k]) == list(v), (spec.name, k)
    for h in _table(want, "doc_info"):
        assert got.cached_doc(h) == want.cached_doc(h)
    for fn in ("docs.pack", "docs.pki"):
        with open(os.path.join(got.root, fn), "rb") as a:
            with open(os.path.join(want.root, fn), "rb") as b:
                assert a.read() == b.read(), fn
    sg, sw = build_snapshot(got), build_snapshot(want)
    assert sg.doc_hashes == sw.doc_hashes and sg.word_hashes == sw.word_hashes
    for sec in ("title", "body"):
        x, y = sg.section(sec), sw.section(sec)
        for f in ("post_offsets", "doc_ids", "weights", "pos_offsets", "positions"):
            assert np.array_equal(getattr(x, f), getattr(y, f)), (sec, f)
    for f, rtol in (("mag_title", MAG_RTOL), ("mag_body", MAG_RTOL), ("pagerank", RANK_RTOL)):
        np.testing.assert_allclose(getattr(sg, f), getattr(sw, f), rtol=rtol, atol=0)


@pytest.fixture(scope="module")
def one_process(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("one") / "store")
    db = write_corpus(root, n_pages=PAGES, n_vocab=VOCAB, seed=SEED, device="cpu", workers=1)
    yield db
    db.close()


@pytest.mark.parametrize("workers", [1, 2, 4])
def test_parallel_build_equals_one_process(one_process, tmp_path, workers):
    db = write_corpus(str(tmp_path / "store"), n_pages=PAGES, n_vocab=VOCAB, seed=SEED,
                      device="cpu", workers=workers)
    try:
        assert len(db.doc_info) == PAGES
        assert_same_build(db, one_process)
    finally:
        db.close()
    assert not os.path.exists(str(tmp_path / "store") + ".parts")


@pytest.mark.parametrize("workers", [2, 4])
def test_corpus_crosses_the_task_boundaries(one_process, workers):
    """The state index_page carries from page to page crosses the index
    tasks' page ranges in every way the build handles: links both ways, a
    page linked before it is indexed from an earlier range, a child with
    linkers in two ranges, and a page linking to itself after an earlier
    range's page linked to it (its stub's parents then include itself)."""
    chunk = parallel_build.default_chunk_pages(PAGES, workers)
    page = {md5_hex(f"{BASE_URL}/p{i}"): i for i in range(PAGES)}
    edges = [(page[p], page[k]) for p, kids in one_process.doc_children.items() for k in kids]
    fwd = [(i, j) for i, j in edges if i // chunk < j // chunk]
    bwd = [(i, j) for i, j in edges if i // chunk > j // chunk]
    assert fwd and bwd
    ranges: dict[int, set] = {}
    for i, j in edges:
        ranges.setdefault(j, set()).add(i // chunk)
    assert any(len(r) > 1 for r in ranges.values())
    self_linked = [i for i, j in edges if i == j and min(ranges[i]) < i // chunk]
    assert self_linked
    for i in self_linked:
        info = one_process.doc_info.get(md5_hex(f"{BASE_URL}/p{i}"))
        assert md5_hex(f"{BASE_URL}/p{i}") in info.parents


def test_parallel_build_equals_bench_corpus(tmp_path):
    """At 300 pages the parallel build writes what the JAX package's
    bench.py build writes (test_torch_crawl's test of the one-process
    build, doc_magnitude at 1e-12)."""
    import bench
    from spaghettisearch_tpu.store.tables import Database as JaxDatabase
    from test_torch_crawl import assert_same_store, _table as crawl_table

    bench.build_bench_corpus(str(tmp_path / "bench"), n_pages=300, seed=0, quiet=True)
    jdb = JaxDatabase(str(tmp_path / "bench" / "store"))
    tdb = write_corpus(str(tmp_path / "store"), n_pages=300, seed=0, device="cpu", workers=2)
    try:
        assert len(tdb.doc_info) >= 300
        assert_same_store(tdb, jdb, skip=("doc_magnitude",))
        from spaghettisearch_tpu.store.tables import TABLE_SPECS as JSPECS

        _close(crawl_table(tdb, TABLE_SPECS, "doc_magnitude"),
               crawl_table(jdb, JSPECS, "doc_magnitude"), MAG_RTOL)
    finally:
        tdb.close()
        jdb.close()


@pytest.mark.parametrize("fault", ["raises", "dies", "snapshot_raises", "snapshot_dies"])
def test_a_failed_worker_fails_the_build(tmp_path, monkeypatch, fault):
    """A worker that raises, or one that dies, while indexing a page or
    while writing its key bucket's part of the snapshot fails the whole
    build (the forked workers see the patched function); nothing finishes
    it in one process or falls back to build_snapshot, and the work
    directory is removed."""
    index_page = parallel_build.index_page
    snapshot_part = parallel_build._snapshot_part
    bad = f"{BASE_URL}/p150"

    def fail():
        if fault.endswith("dies"):
            os._exit(3)
        raise ValueError("injected fault")

    def faulty(db, raw, url, **kw):
        if url == bad:
            fail()
        return index_page(db, raw, url, **kw)

    def faulty_part(db, b, sums):
        if b == 1:
            fail()
        return snapshot_part(db, b, sums)

    if fault.startswith("snapshot"):
        monkeypatch.setattr(parallel_build, "_snapshot_part", faulty_part)
        monkeypatch.setattr(corpus, "build_snapshot",
                            lambda db: pytest.fail("the build fell back to build_snapshot"))
    else:
        monkeypatch.setattr(parallel_build, "index_page", faulty)
    want = ValueError if fault.endswith("raises") else parallel_build.cf.process.BrokenProcessPool
    with pytest.raises(want):
        write_corpus_with_snapshot(str(tmp_path / "store"), n_pages=300, n_vocab=VOCAB,
                                   seed=SEED, device="cpu", workers=2)
    assert not os.path.exists(str(tmp_path / "store") + ".parts")


def test_in_memory_store_needs_one_process():
    with pytest.raises(ValueError, match="root directory"):
        write_corpus(None, n_pages=10, n_vocab=VOCAB, device="cpu", workers=2)


def test_oracle_over_processes_equals_serial(one_process):
    """bench.rank_vs_oracle with its oracle's queries spread over forked
    processes (parity1m and parity2m on the card) answers what the serial
    oracle answers, query for query."""
    from spaghettisearch_tpu_torch import bench
    from spaghettisearch_tpu_torch.corpus import bench_queries
    from spaghettisearch_tpu_torch.retrieval.engine import QueryEngine

    snap = build_snapshot(one_process)
    eng = QueryEngine(one_process, snapshot=snap, device="cpu")
    queries = bench_queries(snap, 24, seed=9, phrase_every=3, db=one_process)
    got1, want1, _ = bench.rank_vs_oracle(eng, one_process, snap, queries)
    got3, want3, _ = bench.rank_vs_oracle(eng, one_process, snap, queries, oracle_procs=3)
    assert want3 == want1 and got3 == got1 and any(want1)
