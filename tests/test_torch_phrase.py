"""The PyTorch port's sparse phrase lane matcher against the JAX package:
match_phrase_fwd_batch (the forward matcher) and match_phrase_batch (the
exact CSR matcher) vs the JAX functions on the same index arrays, with and
without the pos_mat row layout, the pairwise and the sorted-membership
intersect branches (pos_cap <= 16 and > 16), 1-term phrases, -100-anchored
title terms, planted real bigrams, repeated and absent terms, natural and
doc-sorted layouts, the full and a tight generator cap.

Doc ids and match flags exact; the summed phrase weights within rtol=1e-6
(the JAX package's kernel-vs-twin bar: the sum over phrase terms may be
taken in another order). Inputs are made with numpy from a seed and handed
to both packages.
"""

from __future__ import annotations

import random
from datetime import datetime, timezone

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spaghettisearch_tpu.ops.phrase import match_phrase_batch as jax_match_csr
from spaghettisearch_tpu.ops.phrase import match_phrase_fwd_batch as jax_match_fwd
from spaghettisearch_tpu_torch.ops.phrase import (
    match_phrase,
    match_phrase_batch,
    match_phrase_fwd,
    match_phrase_fwd_batch,
)
from test_torch_membership import (  # noqa: F401 — module fixtures
    RTOL,
    _indexes,
    bench_snap,
    crawl_snap,
)
from test_torch_mixed import _phrase_batch

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def repetitive_snap():
    """Bodies dominated by repeated bigrams: position lists of ~30, so
    pos_cap > 16 (the sorted-membership intersect branch)."""
    from spaghettisearch_tpu.index.indexer import index_page
    from spaghettisearch_tpu.index.snapshot import build_snapshot
    from spaghettisearch_tpu.ops.weighting import update_term_weights
    from spaghettisearch_tpu.store.tables import Database

    rng = random.Random(4)
    db = Database(None)
    ts = datetime(2026, 1, 1, tzinfo=timezone.utc)
    words = ["alpha", "bravo", "charlie", "delta"]
    for i in range(12):
        body = []
        for _ in range(30):
            body += [words[i % 4], words[(i + 1) % 4]]
        body += [rng.choice(words) for _ in range(rng.randint(0, 10))]
        html = (f"<html><head><title>page {words[i % 4]} {i}</title></head>"
                f"<body><p>{' '.join(body)}</p></body></html>")
        index_page(db, html.encode(), f"http://rep.local/{i}", last_modified=ts)
    update_term_weights(db, "title", total_docs=12)
    update_term_weights(db, "body", total_docs=12)
    return build_snapshot(db)


def _rows(snap, b, seed):
    """Phrase rows [b, 4] with their validity and generator (the rarest
    valid term, as the engine picks it)."""
    _, _, _, ids, valid, _ = _phrase_batch(snap, b, 4, seed)
    valid = valid > 0
    df = snap.title.df(ids).astype(np.int64) + snap.body.df(ids)
    df = np.where(valid, df, np.iinfo(np.int64).max)
    return ids, valid, np.argmin(df, axis=1).astype(np.int32)


def _fwd_args(idx):
    t, b = idx.title, idx.body
    return (t.fwd.ft, t.fwd.fj, t.weights, t.pos_offsets, t.positions,
            b.fwd.ft, b.fwd.fj, b.weights, b.pos_offsets, b.positions,
            t.offsets, t.doc_ids, b.offsets, b.doc_ids)


def _csr_args(idx):
    t, b = idx.title, idx.body
    return (t.offsets, t.doc_ids, t.weights, t.pos_offsets, t.positions,
            b.offsets, b.doc_ids, b.weights, b.pos_offsets, b.positions)


def _same(got, want):
    """-> the number of matches; docs and flags exact, weights within rtol."""
    gd, gt, gb, gf = (np.asarray(x) for x in got)
    wd, wt, wb, wf = (np.asarray(x) for x in want)
    assert gd.dtype == np.int32 and np.array_equal(gd, wd)
    assert np.array_equal(gf, wf)
    np.testing.assert_allclose(gt, wt, rtol=RTOL)
    np.testing.assert_allclose(gb, wb, rtol=RTOL)
    return int(wf.sum())


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


@pytest.mark.parametrize("pos_mat", [True, False])
@pytest.mark.parametrize("which,doc_sort", [
    ("crawl", False), ("crawl", True), ("bench", True), ("repetitive", False),
])
def test_fwd_matcher_matches_jax(crawl_snap, bench_snap, repetitive_snap, which, doc_sort, pos_mat):
    snap = {"crawl": crawl_snap, "bench": bench_snap, "repetitive": repetitive_snap}[which]
    jdx, tdx = _indexes(snap, doc_sort)
    assert (tdx.pos_cap > 16) == (which == "repetitive")
    assert tdx.title.pos_mat is not None and tdx.body.pos_mat is not None
    ids, valid, gens = _rows(snap, 16, seed=5)
    if which == "repetitive":  # the repeated bigrams, both orders
        ids[:4, :2] = snap.term_ids([snap.word_hashes[0], snap.word_hashes[1]])
        ids[2:4, :2] = ids[2:4, 1::-1]
        valid[:4] = [True, True, False, False]
        gens[:4] = 0
    common = dict(posting_cap=tdx.posting_cap, pos_cap=tdx.pos_cap, n_docs=tdx.match_pad)
    want = jax_match_fwd(
        *_fwd_args(jdx), *map(jnp.asarray, (ids, valid, gens)),
        jdx.title.pos_mat if pos_mat else None, jdx.body.pos_mat if pos_mat else None,
        **common,
    )
    got = match_phrase_fwd_batch(
        *_fwd_args(tdx), *_t(ids, valid, gens),
        tdx.title.pos_mat if pos_mat else None, tdx.body.pos_mat if pos_mat else None,
        **common,
    )
    assert got[0].shape == (16, 2 * tdx.posting_cap)
    assert _same(got, want) > 0  # phrases do match (the chain is exercised)
    # the one-phrase form is the batch's row
    one = match_phrase_fwd(*_fwd_args(tdx), *_t(ids[3], valid[3]), int(gens[3]), **common)
    for a, b in zip(one, got):
        assert torch.equal(a, b[3])


@pytest.mark.parametrize("which", ["crawl", "repetitive"])
def test_csr_matcher_matches_jax_and_fwd(crawl_snap, repetitive_snap, which):
    """The CSR oracle against the JAX one, and against the forward matcher
    (same semantics: the same matches with the same weights)."""
    snap = crawl_snap if which == "crawl" else repetitive_snap
    jdx, tdx = _indexes(snap, False)
    ids, valid, gens = _rows(snap, 12, seed=9)
    common = dict(posting_cap=tdx.posting_cap, pos_cap=tdx.pos_cap, n_docs=tdx.n_docs)
    want = jax_match_csr(*_csr_args(jdx), *map(jnp.asarray, (ids, valid, gens)), **common)
    got = match_phrase_batch(*_csr_args(tdx), *_t(ids, valid, gens), **common)
    assert _same(got, want) > 0
    fwd = match_phrase_fwd_batch(*_fwd_args(tdx), *_t(ids, valid, gens),
                                 tdx.title.pos_mat, tdx.body.pos_mat, **common)
    for r in range(len(ids)):
        a = {int(d): (float(t), float(b)) for d, t, b in zip(*(x[r] for x in got[:3])) if d < tdx.n_docs}
        b = {int(d): (float(t), float(b)) for d, t, b in zip(*(x[r] for x in fwd[:3])) if d < tdx.n_docs}
        assert a.keys() == b.keys()
        for d in a:
            np.testing.assert_allclose(a[d], b[d], rtol=RTOL)
    one = match_phrase(*_csr_args(tdx), *_t(ids[0], valid[0]), int(gens[0]), **common)
    for a, b in zip(one, got):
        assert torch.equal(a, b[0])


def test_intersect_branches_agree(crawl_snap):
    """The sorted-membership branch (pos_cap > 16, position lists gathered
    per element with inf pads) gives the pairwise branch's result."""
    _, tdx = _indexes(crawl_snap, False)
    assert tdx.pos_cap <= 16
    ids, valid, gens = _rows(crawl_snap, 16, seed=2)
    args = (*_fwd_args(tdx), *_t(ids, valid, gens))
    pairwise = match_phrase_fwd_batch(
        *args, None, None, posting_cap=tdx.posting_cap, pos_cap=tdx.pos_cap, n_docs=tdx.n_docs
    )
    searched = match_phrase_fwd_batch(
        *args, None, None, posting_cap=tdx.posting_cap, pos_cap=24, n_docs=tdx.n_docs
    )
    assert _same(searched, pairwise) > 0


def test_tight_generator_cap(bench_snap):
    """The engine's cap levels: a cap covering only the generator's df
    gives the full cap's matches."""
    _, tdx = _indexes(bench_snap, True)
    ids, valid, gens = _rows(bench_snap, 16, seed=7)
    need = max(1, int((bench_snap.title.df(ids[np.arange(16), gens])
                       + bench_snap.body.df(ids[np.arange(16), gens])).max()))
    cap = 8
    while cap < need:
        cap *= 2
    assert cap < tdx.posting_cap
    args = (*_fwd_args(tdx), *_t(ids, valid, gens), tdx.title.pos_mat, tdx.body.pos_mat)
    common = dict(pos_cap=tdx.pos_cap, n_docs=tdx.match_pad)
    full = match_phrase_fwd_batch(*args, posting_cap=tdx.posting_cap, **common)
    tight = match_phrase_fwd_batch(*args, posting_cap=cap, **common)
    for r in range(16):
        f = {int(d): (float(t), float(b)) for d, t, b in zip(*(x[r] for x in full[:3])) if d < tdx.match_pad}
        t = {int(d): (float(t), float(b)) for d, t, b in zip(*(x[r] for x in tight[:3])) if d < tdx.match_pad}
        assert f == t
