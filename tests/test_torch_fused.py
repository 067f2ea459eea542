"""The PyTorch port's K4 (fused membership + finalize) against the JAX
package: K4's plain version (the wrapper's CPU route) vs
pallas_fused_final_scores in interpret mode, and the port's
score_queries_fused vs the JAX one, with topics off (C=1) and a seeded C=3
topic blend, batches that are not a multiple of 8, an idf-zero posting (a
candidate with score 0) and docs with magnitude 0 (NaN -> 0, +inf kept);
and K4's probe algorithm (one table per row tile shared by both sections,
walked with torch ops, then the kernel's finalize) vs both, on the
adversarial batches of check.ADVERSARIAL and on an idf-zero posting.

Scores within rtol=1e-6 (the JAX package's kernel-vs-twin bar,
tests/test_scoring_paths.py); the -inf (non-candidate) and +inf sets exact;
top-k ids equal up to ties at equal scores. Inputs are made with numpy from
a seed and handed to both packages.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spaghettisearch_tpu.ops.kernels.fused import pallas_fused_final_scores
from spaghettisearch_tpu.ops.scoring import score_queries_fused as jax_fused
from spaghettisearch_tpu_torch.config import SCORE_SCALE, W_BODY, W_PAGERANK, W_TITLE
from spaghettisearch_tpu_torch.ops.kernels import check, probe
from spaghettisearch_tpu_torch.ops.kernels import fused as k4
from spaghettisearch_tpu_torch.ops.scoring import score_queries_fused
from test_torch_membership import (  # noqa: F401 — module fixtures
    RTOL,
    _indexes,
    bench_snap,
    crawl_snap,
)

torch.set_num_threads(1)


def _zero_weight_posting(snap):
    """(term id, natural doc id) of an idf-zero title or body posting."""
    for csr in (snap.body, snap.title):
        n = csr.n_postings
        hits = np.flatnonzero(csr.weights[:n] <= 0)
        if hits.size:
            j = int(hits[0])
            return int(np.searchsorted(csr.post_offsets, j, side="right") - 1), int(csr.doc_ids[j])
    return None


def _inputs(snap, jdx, b, c, seed):
    """Seeded query rows (random + sentinel + repeated terms; row 0 holds an
    idf-zero term when the corpus has one), magnitudes with zeros, and a
    [C, D] PageRank / [B, C] topic blend (C=1: zero probabilities, topics
    off)."""
    rng = np.random.default_rng(seed)
    n_words = snap.n_words
    term_ids = rng.integers(0, n_words + 1, (b, 4)).astype(np.int32)
    term_ids[1, 1] = term_ids[1, 0]  # a repeated query term counts twice
    zw = _zero_weight_posting(snap)
    if zw is not None:
        term_ids[0] = [zw[0], n_words, n_words, n_words]
    return (term_ids, *_doc_inputs(jdx, b, c, rng), zw)


def _doc_inputs(jdx, b, c, rng):
    """Magnitudes with zeros, qlen, and a [C, D] PageRank / [B, C] topic
    blend (C=1: zero probabilities, topics off)."""
    d = jdx.n_docs_padded
    mag_t = np.array(jdx.mag_title)
    mag_b = np.array(jdx.mag_body)
    zero = rng.choice(jdx.n_docs, size=max(jdx.n_docs // 4, 1), replace=False)
    mag_t[zero[::2]] = 0.0
    mag_b[zero[1::2]] = 0.0
    qlen = rng.uniform(1, 4, b).astype(np.float32)
    prT = rng.uniform(0, 1e-3, (c, d)).astype(np.float32)
    if c == 1:  # topics off: the engine's zero topic probabilities
        tp = np.zeros((b, 1), np.float32)
    else:
        tp = rng.dirichlet(np.ones(c), b).astype(np.float32)
    return mag_t, mag_b, prT, qlen, tp


def _col(jdx, doc):
    """Column of natural doc `doc` in the index's (maybe permuted) doc axis."""
    if jdx.doc_perm is None:
        return doc
    return int(np.flatnonzero(np.asarray(jdx.doc_perm) == doc)[0])


def _same_final(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    for v in (-np.inf, np.inf):
        assert np.array_equal(got == v, want == v)
    fin = np.isfinite(want)
    assert np.array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=0.0)


@pytest.mark.parametrize("doc_sort", [False, True])
@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("which", ["crawl", "bench"])
def test_fused_plain_matches_pallas(crawl_snap, bench_snap, which, c, doc_sort):
    snap = crawl_snap if which == "crawl" else bench_snap
    jdx, tdx = _indexes(snap, doc_sort)
    term_ids, mag_t, mag_b, prT, qlen, tp, zw = _inputs(snap, jdx, 16, c, seed=c + 5)
    want = pallas_fused_final_scores(
        jdx.title.fwd.ftT, jdx.title.fwd.fwT, jdx.body.fwd.ftT, jdx.body.fwd.fwT,
        jnp.asarray(mag_t), jnp.asarray(mag_b), jnp.asarray(prT), jnp.asarray(term_ids),
        jnp.asarray(qlen), jnp.asarray(tp), interpret=True,
    )
    got = k4.fused_final_scores(
        tdx.title.fwd.ftT, tdx.title.fwd.fwT, tdx.body.fwd.ftT, tdx.body.fwd.fwT,
        *(torch.from_numpy(a) for a in (mag_t, mag_b, prT, term_ids, qlen, tp)),
    )
    _same_final(got.numpy(), want)
    final = got.numpy()
    assert np.isfinite(final).any() and (final == -np.inf).any()
    assert (final == np.inf).any()  # a candidate with magnitude 0 keeps +inf
    if which == "crawl":
        assert zw is not None  # the crawl corpus has idf-zero postings
        col = _col(jdx, zw[1])
        assert np.isfinite(final[0, col])  # a score-0 candidate is ranked


@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("which,doc_sort", [("crawl", False), ("bench", True)])
def test_score_queries_fused_matches_jax(crawl_snap, bench_snap, which, doc_sort, c):
    """B=13 (padded to 16 inside): top-20 values within rtol, ids up to ties
    (permuted-space ids under the doc-sorted layout, as the JAX package's)."""
    snap = crawl_snap if which == "crawl" else bench_snap
    jdx, tdx = _indexes(snap, doc_sort)
    term_ids, mag_t, mag_b, prT, qlen, tp, _ = _inputs(snap, jdx, 13, c, seed=c)
    js, ji = jax_fused(
        jdx.title.fwd, jdx.body.fwd, jnp.asarray(mag_t), jnp.asarray(mag_b),
        jnp.asarray(prT), jnp.asarray(term_ids), jnp.asarray(qlen), jnp.asarray(tp),
        topk=20, interpret=True,
    )
    ts, ti = score_queries_fused(
        tdx.title.fwd, tdx.body.fwd,
        *(torch.from_numpy(a) for a in (mag_t, mag_b, prT, term_ids, qlen, tp)), topk=20,
    )
    js, ji, ts, ti = map(np.asarray, (js, ji, ts.numpy(), ti.numpy()))
    assert ts.shape == (13, 20) and ti.dtype == np.int32
    _same_final(ts, js)
    for r in range(13):
        ref = dict(zip(ji[r].tolist(), js[r].tolist()))
        for dg, dw, sw in zip(ti[r], ji[r], js[r]):
            if np.isfinite(sw) and dg != dw:
                assert abs(ref.get(int(dg), js[r][-1]) - sw) <= 1e-6 * max(abs(sw), 1e-9)


def _pad_rows(x, b_pad, value):
    out = np.full((b_pad,) + x.shape[1:], value, x.dtype)
    out[: x.shape[0]] = x
    return out


def _walk_vs_plain_and_pallas(jdx, tdx, term_ids, mag_t, mag_b, prT, qlen, tp):
    """K4's algorithm on one batch: the shared table (equal to both tables
    of K1's build without qn, holding only real entries), the walk, and
    the walk held to the plain version and the interpret-mode Pallas
    kernel (rows padded to 8 as the JAX wrapper pads them). -> the walk."""
    tq = torch.from_numpy(term_ids)
    b = tq.shape[0]
    terms, pay, rows, _ = probe.plain_tables(tq, None, None, sections=1)
    two = probe.plain_tables(tq, None, None)
    for s in (0, 1):
        assert torch.equal(two[0][s], terms[0]) and torch.equal(two[1][s], pay[0])
    pairs = {(int(t), i) for i, r in enumerate(term_ids) for t in r if 0 <= t != probe.TERM_PAD}
    assert int((terms != probe.TERM_PAD).sum()) == len(pairs)
    t, bd = tdx.title.fwd, tdx.body.fwd
    args = [torch.from_numpy(a) for a in (mag_t, mag_b, prT, qlen, tp)]
    walk = probe.walk_fused(t.ftT, t.fwT, bd.ftT, bd.fwT, terms, pay, b, rows, *args,
                            (W_PAGERANK, W_TITLE, W_BODY, SCORE_SCALE))
    plain = k4.plain_fused_final_scores(t.ftT, t.fwT, bd.ftT, bd.fwT, args[0], args[1],
                                        args[2], tq, args[3], args[4])
    _same_final(walk.numpy(), plain.numpy())
    b_pad = -(-b // 8) * 8
    want = pallas_fused_final_scores(
        jdx.title.fwd.ftT, jdx.title.fwd.fwT, jdx.body.fwd.ftT, jdx.body.fwd.fwT,
        jnp.asarray(mag_t), jnp.asarray(mag_b), jnp.asarray(prT),
        jnp.asarray(_pad_rows(term_ids, b_pad, tdx.n_words)),
        jnp.asarray(_pad_rows(qlen, b_pad, 1.0)), jnp.asarray(_pad_rows(tp, b_pad, 0.0)),
        interpret=True,
    )
    _same_final(walk.numpy(), np.asarray(want)[:b])
    return walk.numpy()


@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("kind", check.ADVERSARIAL)
def test_fused_probe_walk_matches_plain_and_pallas(bench_snap, kind, c):
    """K4's algorithm on the adversarial batches (multiplicity, one term in
    every row, Q=32, sentinel rows, B=13, B=80, int32-max columns): every
    column enters the one shared table except negative ids and int32 max;
    the -inf and +inf sets exact, scores within rtol 1e-6."""
    jdx, tdx = _indexes(bench_snap, doc_sort=True)
    df = np.diff(bench_snap.body.post_offsets).astype(np.float64)
    nb = check.adversarial_batch(tdx, kind, seed=17, df=df, snap=bench_snap)
    term_ids = nb["term_ids"]
    if kind == "int_max":
        assert (term_ids == probe.TERM_PAD).any()
    rng = np.random.default_rng(c + 17)
    final = _walk_vs_plain_and_pallas(jdx, tdx, term_ids, *_doc_inputs(jdx, len(term_ids), c, rng))
    assert np.isfinite(final).any() and (final == -np.inf).any()


@pytest.mark.parametrize("c", [1, 3])
def test_fused_probe_walk_keeps_zero_weight_candidates(crawl_snap, c):
    """An idf-zero posting sets the walk's hit mask: its doc is a ranked
    candidate with a finite score; magnitude-0 docs keep +inf."""
    jdx, tdx = _indexes(crawl_snap, doc_sort=False)
    term_ids, mag_t, mag_b, prT, qlen, tp, zw = _inputs(crawl_snap, jdx, 13, c, seed=c + 9)
    final = _walk_vs_plain_and_pallas(jdx, tdx, term_ids, mag_t, mag_b, prT, qlen, tp)
    assert zw is not None and np.isfinite(final[0, _col(jdx, zw[1])])
    assert (final == np.inf).any()
