"""The port's sharded host build (spaghettisearch_tpu_torch/parallel/
sharded.py: _shard_csr, _shard_hot_cache, ShardedIndex.from_snapshot) and
its meshes (parallel/mesh.py) against the JAX package's, array for array,
and against tests/test_sharded_build.py's independent implementation.

The port's meshes are ["cpu"] * S: one device named S times, the
counterpart of the JAX tests' S virtual CPU devices (tests/conftest.py).
The builders are numpy in both packages, so every comparison is exact."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import spaghettisearch_tpu.parallel.sharded as jsh
import spaghettisearch_tpu.retrieval.device_index as jdi
import spaghettisearch_tpu_torch.parallel.sharded as tsh
import spaghettisearch_tpu_torch.retrieval.device_index as tdi
import test_sharded_build as oracle
from corpus import build_corpus_db
from spaghettisearch_tpu.parallel.mesh import make_mesh as jax_mesh
from spaghettisearch_tpu.retrieval.engine import QueryEngine as JaxEngine
from spaghettisearch_tpu_torch.parallel.mesh import Mesh, make_mesh, make_mesh2d


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _cpu_mesh(s: int) -> Mesh:
    return make_mesh(s, devices=["cpu"] * s)


def _same_dict(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        if w is None or isinstance(w, (bool, int)):
            assert g == w, k
        else:
            assert g.dtype == w.dtype, k
            np.testing.assert_array_equal(g, w, err_msg=k)


# --- _shard_csr: the JAX package's builder and the independent oracle ---------

def _t_pad(csr, n_docs: int) -> int:
    per_doc = np.bincount(csr.doc_ids[: csr.n_postings], minlength=n_docs)
    return max(int(per_doc.max(initial=0)), 1)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n_shards", [2, 4])
def test_shard_build_matches_independent_impl(seed, n_shards):
    rng = np.random.default_rng(seed)
    n_docs, n_words = 173, 61
    csr = oracle._random_csr(rng, n_docs, n_words, density=0.04)
    dl = -(-n_docs // n_shards)
    t_pad = _t_pad(csr, n_docs)
    got = tsh._shard_csr(csr, n_shards, dl, t_pad)
    _same_dict(got, jsh._shard_csr(csr, n_shards, dl, t_pad))
    want = oracle._shard_csr_vectorized(csr, n_shards, dl, t_pad)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_shard_build_truncated_matches_independent_impl(monkeypatch):
    """DOC_TERM_CAP lowered on both sides (and in the oracle): truncation
    keeps each doc's top-weight terms identically, and the position planes
    are refused."""
    rng = np.random.default_rng(7)
    n_docs, n_words, n_shards = 31, 300, 2
    csr = oracle._random_csr(rng, n_docs, n_words, density=0.5)
    t_pad = _t_pad(csr, n_docs)
    dl = -(-n_docs // n_shards)
    cap = 16
    assert t_pad > cap, "fixture must actually exceed the cap"
    monkeypatch.setattr(jsh, "DOC_TERM_CAP", cap)
    monkeypatch.setattr(tsh, "DOC_TERM_CAP", cap)
    monkeypatch.setattr(oracle, "_CAP", cap)
    got = tsh._shard_csr(csr, n_shards, dl, t_pad)
    assert got["truncated"] and got["posT"] is None
    _same_dict(got, jsh._shard_csr(csr, n_shards, dl, t_pad))
    want = oracle._shard_csr_vectorized(csr, n_shards, dl, t_pad)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_empty_csr_shards():
    csr = oracle._random_csr(np.random.default_rng(0), 10, 5, density=0.0)
    out = tsh._shard_csr(csr, 2, 5, 1)
    _same_dict(out, jsh._shard_csr(csr, 2, 5, 1))
    ref = oracle._shard_csr_vectorized(csr, 2, 5, 1)
    for k in ref:
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_shard_csr_doc_sorted_equals_jax(n_shards):
    """With a per-shard doc permutation (the doc-sorted layout) and the
    DOC_SORT_TC width multiple."""
    rng = np.random.default_rng(n_shards)
    n_docs, n_words = 400, 90
    csr = oracle._random_csr(rng, n_docs, n_words, density=0.05)
    dl = -(-n_docs // n_shards)
    inv = np.stack([rng.permutation(dl) for _ in range(n_shards)]).astype(np.int32)
    kw = dict(inv_perm=inv, t_multiple=tdi.DOC_SORT_TC)
    got = tsh._shard_csr(csr, n_shards, dl, _t_pad(csr, n_docs), **kw)
    _same_dict(got, jsh._shard_csr(csr, n_shards, dl, _t_pad(csr, n_docs), **kw))


# --- _shard_hot_cache ----------------------------------------------------------

def _hot_snap():
    from test_sharded import _hot_synth_snap

    return _hot_synth_snap()


@pytest.mark.parametrize("n_shards", [2, 4, 8])
@pytest.mark.parametrize("permuted", [False, True])
def test_shard_hot_cache_equals_jax(monkeypatch, n_shards, permuted):
    monkeypatch.setattr(jdi, "HOT_H_MAX", 64)
    monkeypatch.setattr(tdi, "HOT_H_MAX", 64)
    snap = _hot_snap()
    dl = -(-snap.n_docs // n_shards)
    dl = -(-dl // 512) * 512
    inv = None
    if permuted:
        rng = np.random.default_rng(n_shards)
        inv = np.stack([rng.permutation(dl) for _ in range(n_shards)]).astype(np.int32)
    got = tsh._shard_hot_cache(snap.body, n_shards, dl, inv_perm=inv)
    want = jsh._shard_hot_cache(snap.body, n_shards, dl, inv_perm=inv)
    assert got[1] == want[1] and len(got[1]) == 64
    np.testing.assert_array_equal(got[0], want[0])


# --- ShardedIndex.from_snapshot ------------------------------------------------

@pytest.fixture(scope="module")
def crawl_snapshot():
    return JaxEngine(build_corpus_db(n_pages=30, seed=5)).snapshot


def _same_index(t: tsh.ShardedIndex, j: jsh.ShardedIndex) -> None:
    """Every array of every shard, the static facts and the hot set equal;
    every tensor of a shard lies on that shard's device."""
    flags = dict(mixed=j.pos_dense, hot=j.hot_body_w is not None,
                 doc_sorted=j.doc_perm is not None)
    assert (t.pos_dense, t.hot_body_w is not None, t.doc_perm is not None) == tuple(flags.values())
    want, got = jsh.index_args(j, **flags), tsh.index_args(t, **flags)
    assert len(got) == t.n_shards == j.n_shards
    for s, per_shard in enumerate(got):
        assert len(per_shard) == len(want)
        for i, (a, b) in enumerate(zip(want, per_shard)):
            a = np.asarray(a)[s]
            assert b.device == t.shards[s].device == t.mesh.devices.flat[s]
            assert a.dtype == b.numpy().dtype and np.array_equal(a, b.numpy()), (s, i)
    assert tsh.scorer_meta(t)[2:] == jsh.scorer_meta(j)[2:]
    assert (t.n_docs, t.n_words, t.hot_body_map) == (j.n_docs, j.n_words, j.hot_body_map)


@pytest.mark.parametrize("n_shards", [2, 4, 8])
@pytest.mark.parametrize("doc_sort", [False, True])
def test_sharded_index_equals_jax(crawl_snapshot, n_shards, doc_sort):
    j = jsh.ShardedIndex.from_snapshot(crawl_snapshot, jax_mesh(n_shards), doc_sort=doc_sort)
    t = tsh.ShardedIndex.from_snapshot(crawl_snapshot, _cpu_mesh(n_shards), doc_sort=doc_sort)
    assert (t.doc_perm is not None) == doc_sort and t.pos_dense
    _same_index(t, j)
    assert t.device_bytes() == [sh.device_bytes() for sh in t.shards]
    assert min(t.device_bytes()) > 0


@pytest.mark.parametrize("n_shards", [2, 4, 8])
@pytest.mark.parametrize("doc_sort", [False, True])
def test_sharded_index_hot_equals_jax(monkeypatch, n_shards, doc_sort):
    monkeypatch.setattr(jdi, "HOT_H_MAX", 64)
    monkeypatch.setattr(tdi, "HOT_H_MAX", 64)
    snap = _hot_snap()
    j = jsh.ShardedIndex.from_snapshot(snap, jax_mesh(n_shards), doc_sort=doc_sort)
    t = tsh.ShardedIndex.from_snapshot(snap, _cpu_mesh(n_shards), doc_sort=doc_sort)
    assert t.hot_body_w is not None and len(t.hot_body_map) == 64
    _same_index(t, j)


def test_sharded_index_bm25_equals_jax(crawl_snapshot):
    j = jsh.ShardedIndex.from_snapshot(crawl_snapshot, jax_mesh(4), weights="bm25")
    t = tsh.ShardedIndex.from_snapshot(crawl_snapshot, _cpu_mesh(4), weights="bm25")
    _same_index(t, j)


def test_sharded_index_truncated_equals_jax(crawl_snapshot, monkeypatch):
    """A lowered DOC_TERM_CAP on both sides: capped dense rows, no planes,
    no hot cache, no doc-sorted layout even when asked for."""
    monkeypatch.setattr(jsh, "DOC_TERM_CAP", 16)
    monkeypatch.setattr(tsh, "DOC_TERM_CAP", 16)
    j = jsh.ShardedIndex.from_snapshot(crawl_snapshot, jax_mesh(2), doc_sort=True)
    t = tsh.ShardedIndex.from_snapshot(crawl_snapshot, _cpu_mesh(2), doc_sort=True)
    assert t.dense_truncated and not t.pos_dense and t.doc_perm is None
    _same_index(t, j)


def test_sharded_index_2d_rows_share_shards(crawl_snapshot):
    """On a 2-D mesh the index is replicated over the query axis: every row
    holds the same arrays, on its own devices; rows on the same devices
    share their Shard objects."""
    devs = ["cpu"] * 2 + ["meta"] * 2
    t = tsh.ShardedIndex.from_snapshot(crawl_snapshot, make_mesh2d(2, 2, devices=devs))
    assert [sh.device.type for row in t.rows for sh in row] == ["cpu", "cpu", "meta", "meta"]
    for a, b in zip(t.rows[0][1].tensors(), t.rows[1][1].tensors()):
        assert a.shape == b.shape and a.dtype == b.dtype
    same = tsh.ShardedIndex.from_snapshot(crawl_snapshot, make_mesh2d(2, 2, devices=["cpu"] * 4))
    assert same.rows[1][0] is same.rows[0][0]


# --- meshes --------------------------------------------------------------------

def test_mesh_devices_and_refusals(monkeypatch):
    m = make_mesh(3, devices=["cpu"] * 4)
    assert m.shape == {"d": 3} and [d.type for d in m.devices.flat] == ["cpu"] * 3
    m2 = make_mesh2d(2, 4, devices=["cpu"] * 8)
    assert m2.shape == {"q": 2, "d": 4} and m2.devices.shape == (2, 4)
    assert m == make_mesh(3, devices=["cpu"] * 3) and hash(m) == hash(make_mesh(3, devices=["cpu"] * 3))
    assert m != make_mesh(2, devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="need 8 devices"):
        make_mesh2d(2, 4, devices=["cpu"] * 6)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert [str(d) for d in make_mesh(2).devices.flat] == ["cuda:0", "cuda:1"]
    assert [str(d) for d in make_mesh().devices.flat] == ["cuda:0", "cuda:1"]
    with pytest.raises(ValueError, match="need 4 devices, have 2"):
        make_mesh2d(2, 2)
