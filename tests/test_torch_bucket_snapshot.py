"""The benchmark corpus's snapshot as the parallel build assembles it from
its key buckets (index/parallel_build.py build_store, through
corpus.write_corpus_with_snapshot) against `build_snapshot` of the joined
store: the port's and the JAX package's, every field equal with
np.array_equal, no tolerance (the postings are the same rows, and the
magnitudes and ranks the same doubles the store's JSON rows hold). Also
the census, a bucket with no title word, the doc lookup on a prefix two
docs share, and the uncompressed save read back through the pinned
load_snapshot."""

from __future__ import annotations

import os
import zipfile

import numpy as np
import pytest
import torch

from spaghettisearch_tpu_torch.corpus import write_corpus_with_snapshot
from spaghettisearch_tpu_torch.index import parallel_build
from spaghettisearch_tpu_torch.index.persist import load_snapshot
from spaghettisearch_tpu_torch.index.snapshot import build_snapshot

torch.set_num_threads(1)

PAGES, VOCAB, SEED = 1500, 3000, 1
CSR_FIELDS = ("post_offsets", "doc_ids", "weights", "pos_offsets", "positions")


def assert_same_snapshot(got, want) -> None:
    """Every field of two snapshots equal: the hash lists and ids, each
    section's CSR arrays (pads included) and counts, the magnitudes, the
    categories and the ranks."""
    assert got.doc_hashes == want.doc_hashes
    assert got.word_hashes == want.word_hashes
    assert got.doc_id == want.doc_id and got.word_id == want.word_id
    for sec in ("title", "body"):
        x, y = got.section(sec), want.section(sec)
        for f in CSR_FIELDS:
            a, b = getattr(x, f), getattr(y, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), (sec, f)
        for f in ("n_postings", "max_df", "max_positions"):
            assert getattr(x, f) == getattr(y, f), (sec, f)
    for f in ("mag_title", "mag_body"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert got.categories == want.categories
    assert (got.pagerank is None) == (want.pagerank is None)
    if want.pagerank is not None:
        assert got.pagerank.dtype == want.pagerank.dtype
        assert np.array_equal(got.pagerank, want.pagerank)


@pytest.fixture(scope="module", params=[2, 4])
def built(request, tmp_path_factory):
    root = str(tmp_path_factory.mktemp(f"w{request.param}") / "store")
    db, snap, stats = write_corpus_with_snapshot(root, n_pages=PAGES, n_vocab=VOCAB, seed=SEED,
                                                 device="cpu", workers=request.param)
    yield db, snap, stats
    db.close()


def test_bucket_snapshot_equals_build_snapshot(built):
    db, snap, stats = built
    assert stats["workers"] > 1 and stats["seconds"]["snapshot"] > 0
    assert snap.n_docs == PAGES and snap.title.n_postings and snap.body.n_postings
    assert_same_snapshot(snap, build_snapshot(db))


def test_census_is_the_doc_info_keys(built):
    db, snap, _ = built
    assert snap.doc_hashes == sorted(db.doc_info.keys())


def test_uncompressed_save_round_trips(built, tmp_path):
    _, snap, _ = built
    path = str(tmp_path / "snapshot")
    parallel_build.save_snapshot_uncompressed(snap, path)
    with zipfile.ZipFile(os.path.join(path, "arrays.npz")) as z:
        assert {i.compress_type for i in z.infolist()} == {zipfile.ZIP_STORED}
    back = load_snapshot(path)
    assert back.source_dir == os.path.abspath(path)
    assert_same_snapshot(back, snap)
    # written again over itself, atomically: nothing beside it
    parallel_build.save_snapshot_uncompressed(back, path)
    assert sorted(os.listdir(tmp_path)) == ["snapshot"]
    assert_same_snapshot(load_snapshot(path), snap)


def test_bucket_snapshot_equals_jax_build_snapshot(tmp_path):
    """At 300 pages, the JAX package's build_snapshot on its own Database
    opened over the parallel build's store gives the same snapshot."""
    from spaghettisearch_tpu.index.snapshot import build_snapshot as jax_build_snapshot
    from spaghettisearch_tpu.store.tables import Database as JaxDatabase

    root = str(tmp_path / "store")
    db, snap, _ = write_corpus_with_snapshot(root, n_pages=300, seed=0, device="cpu", workers=2)
    db.close()
    jdb = JaxDatabase(root)
    try:
        assert_same_snapshot(snap, jax_build_snapshot(jdb))
    finally:
        jdb.close()


def test_bucket_with_no_title_word(tmp_path, monkeypatch):
    """Many buckets for few pages: some bucket holds body words and no
    title word, and one holds no word of either section; the snapshot is
    still exact."""
    n_buckets = 512
    monkeypatch.setattr(parallel_build, "default_buckets", lambda n, workers: n_buckets)
    db, snap, stats = write_corpus_with_snapshot(str(tmp_path / "store"), n_pages=30,
                                                 n_vocab=VOCAB, seed=SEED, device="cpu",
                                                 workers=2)
    try:
        assert stats["buckets"] == n_buckets
        buckets = {}
        for sec in ("title", "body"):
            df = np.diff(snap.section(sec).post_offsets)
            buckets[sec] = {parallel_build._bucket(w, n_buckets)
                            for w, n in zip(snap.word_hashes, df) if n}
        assert buckets["body"] - buckets["title"]
        assert set(range(n_buckets)) - buckets["body"] - buckets["title"]
        assert_same_snapshot(snap, build_snapshot(db))
    finally:
        db.close()


def test_census_ids_on_a_shared_prefix(monkeypatch):
    """A doc's census id as searchsorted on the whole hash finds it, where
    two census docs share their first 16 hex digits; a hash outside the
    census raises KeyError."""
    census = np.asarray(sorted(["0" * 16 + "a" * 16, "0" * 16 + "b" * 16, "1" * 32,
                                "f" * 16 + "0" * 16]), dtype="S32")
    monkeypatch.setattr(parallel_build, "_S", {"census": census,
                                               "census_keys": parallel_build._prefix64(census)})
    hashes = census[[3, 1, 0, 2, 1]]
    assert parallel_build._census_ids(hashes).tolist() == [3, 1, 0, 2, 1]
    assert np.array_equal(parallel_build._census_ids(hashes), np.searchsorted(census, hashes))
    with pytest.raises(KeyError):
        parallel_build._census_ids(np.asarray(["0" * 16 + "c" * 16], dtype="S32"))


def test_bucket_is_a_key_range():
    """_bucket splits the 32-bit prefix into contiguous ranges: sorted keys
    fall into non-decreasing buckets, and every bucket is reached."""
    keys = sorted(f"{v:08x}" + "0" * 24 for v in range(0, 2**32, 2**32 // 1000))
    got = [parallel_build._bucket(k, 7) for k in keys]
    assert got == sorted(got) and set(got) == set(range(7))
