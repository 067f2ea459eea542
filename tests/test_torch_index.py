"""The PyTorch port's DeviceIndex against the JAX package's: every array
equal (dtype, shape, values) in the natural and the forced doc-sorted
layouts, from the JAX package's IndexSnapshot and from the port's copy of
build_snapshot; plus the layout contract the CUDA kernels rely on and
the locked lazy upload of the doc-major forward arrays."""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

from corpus import build_corpus_db
from spaghettisearch_tpu.index.snapshot import build_snapshot as jax_build_snapshot
from spaghettisearch_tpu.retrieval.device_index import DeviceIndex as JaxIndex
from spaghettisearch_tpu_torch.corpus import write_corpus
from spaghettisearch_tpu_torch.index.snapshot import build_snapshot
from spaghettisearch_tpu_torch.retrieval import device_index as tdi
from spaghettisearch_tpu_torch.retrieval.device_index import (
    DeviceIndex,
    arrays_from_jax,
    index_arrays,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def dbs():
    return {
        "crawl": build_corpus_db(n_pages=60, seed=5),
        "crawl_b": build_corpus_db(n_pages=130, seed=8),
        "bench": write_corpus(None, n_pages=200, n_vocab=700, seed=1, device="cpu"),
    }


def _assert_same(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, np.ndarray):
            assert isinstance(y, np.ndarray), k
            assert x.dtype == y.dtype and x.shape == y.shape, (k, x.dtype, y.dtype, x.shape, y.shape)
            assert np.array_equal(x, y), k
        else:
            assert x == y, (k, x, y)


@pytest.mark.parametrize("doc_sort", [False, True])
@pytest.mark.parametrize("which", ["crawl", "crawl_b", "bench"])
def test_device_index_arrays_equal_jax(dbs, which, doc_sort):
    snap = jax_build_snapshot(dbs[which])
    jax_arrays = arrays_from_jax(JaxIndex.from_snapshot(snap, doc_sort=doc_sort))
    idx = DeviceIndex.from_snapshot(snap, torch.device("cpu"), doc_sort=doc_sort)
    _assert_same(jax_arrays, index_arrays(idx))
    assert (idx.doc_perm is not None) == doc_sort
    assert idx.pos_dense and idx.device_bytes() > 0
    if which == "bench":
        assert idx.hot_body_w is not None and not idx.has_zero_weight
    # the port's copy of build_snapshot gives the same index
    _assert_same(
        index_arrays(idx),
        index_arrays(DeviceIndex.from_snapshot(build_snapshot(dbs[which]), "cpu", doc_sort=doc_sort)),
    )


@pytest.mark.parametrize("which", ["crawl", "bench"])
def test_forward_slots_are_packed(dbs, which):
    """The kernels' layout contract: in each doc column of ftT the real
    term slots come first and -1 pads follow; fwT is 0 on pads."""
    idx = DeviceIndex.from_snapshot(build_snapshot(dbs[which]), "cpu", doc_sort=True)
    for sec in (idx.title, idx.body):
        ft = sec.fwd.ftT.numpy()
        real = ft >= 0
        assert not (real[1:] & ~real[:-1]).any()
        assert (sec.fwd.fwT.numpy()[~real] == 0).all()
        if sec.tmax_blocks is not None:
            nt = real.sum(0).reshape(-1, tdi.DOC_BLOCK).max(1)
            assert np.array_equal(nt, sec.tmax_blocks.numpy())


def test_lazy_forward_upload_is_locked_and_memoized(dbs, monkeypatch):
    snap = build_snapshot(dbs["bench"])
    eager = DeviceIndex.from_snapshot(snap, "cpu")
    monkeypatch.setattr(tdi, "FWD_DEV_MAX_DPAD", 0)
    idx = DeviceIndex.from_snapshot(snap, "cpu")
    assert isinstance(idx.body.fwd.ft, np.ndarray)
    got = []
    threads = [threading.Thread(target=lambda: got.append(idx.body.fwd_device())) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert all(g is got[0] for g in got) and idx.body.fwd is got[0]
    for name in ("ft", "fw", "fj"):
        assert torch.equal(getattr(got[0], name), getattr(eager.body.fwd, name))
