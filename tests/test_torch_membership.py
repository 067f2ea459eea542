"""The PyTorch port's K1/K3 plain versions and top-k against the JAX
package: K1's plain version (the wrapper's CPU route) vs
pallas_forward_scores_2sec in interpret mode and the XLA twin
forward_section_scores, with the per-block q bound, the hot split, both
count variants and the doc-sorted T bound; K1's probe algorithm (its
wrapper's tables, walked with torch ops) vs both on adversarial batches;
K3's (forward_scores) vs pallas_forward_scores with qn-sorted rows and both
count variants; K3's probe algorithm (its one table per row tile, walked)
vs its plain version and pallas_forward_scores on the adversarial batches;
the port's exact_top_k vs the JAX one on ties, with and without doc_map.

Scores within rtol=1e-6 (the JAX package's own kernel-vs-twin bar,
tests/test_scoring_paths.py); counts, candidacy masks and ids exact. Inputs
are made with numpy from a seed and handed to both packages.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corpus import build_corpus_db
from spaghettisearch_tpu.index.snapshot import build_snapshot
from spaghettisearch_tpu.ops.kernels.membership import (
    pallas_forward_scores,
    pallas_forward_scores_2sec,
)
from spaghettisearch_tpu.ops.scoring import exact_top_k as jax_top_k
from spaghettisearch_tpu.ops.scoring import forward_section_scores, mask_cold
from spaghettisearch_tpu.retrieval.device_index import DeviceIndex as JaxIndex
from spaghettisearch_tpu_torch.corpus import write_corpus
from spaghettisearch_tpu_torch.ops.kernels import check, probe
from spaghettisearch_tpu_torch.ops.kernels import membership as k1
from spaghettisearch_tpu_torch.ops.scoring import exact_top_k
from spaghettisearch_tpu_torch.retrieval.device_index import DeviceIndex

torch.set_num_threads(1)
RTOL = 1e-6


@pytest.fixture(scope="module")
def crawl_snap():
    """HTML-indexed fixture: anchors (-100 title positions), meta terms,
    idf-zero postings (counts needed)."""
    return build_snapshot(build_corpus_db(n_pages=48, seed=4))


@pytest.fixture(scope="module")
def bench_snap():
    """The port's corpus writer: all weights positive, so the hot cache
    exists and counts may be elided."""
    return build_snapshot(write_corpus(None, n_pages=160, n_vocab=600, seed=2, device="cpu"))


def _indexes(snap, doc_sort):
    return JaxIndex.from_snapshot(snap, doc_sort=doc_sort), DeviceIndex.from_snapshot(
        snap, "cpu", doc_sort=doc_sort
    )


def _keyword_batch(n_words, b, q, seed):
    """Rows sorted by descending qn, slots past qn hold the sentinel, and
    qnb <= qn cold slots (the engine's contract)."""
    rng = np.random.default_rng(seed)
    qn = np.sort(rng.integers(0, q + 1, b))[::-1].astype(np.int32)
    term_ids = np.full((b, q), n_words, np.int32)
    for i, n in enumerate(qn):
        term_ids[i, :n] = rng.integers(0, n_words + 1, n)
    qnb = np.minimum(qn, rng.integers(0, q + 1, b)).astype(np.int32)
    return term_ids, qn, qnb


def _np(x):
    return None if x is None else np.asarray(x)


@pytest.mark.parametrize("doc_sort", [False, True])
@pytest.mark.parametrize("split,emit_counts", [(False, True), (True, False)])
@pytest.mark.parametrize("which", ["crawl", "bench"])
def test_membership_plain_matches_pallas_and_twin(
    crawl_snap, bench_snap, which, split, emit_counts, doc_sort
):
    snap = crawl_snap if which == "crawl" else bench_snap
    jdx, tdx = _indexes(snap, doc_sort)
    term_ids, qn, qnb = _keyword_batch(snap.n_words, 16, 4, seed=7)
    qnb_arg = qnb if split else None
    want = pallas_forward_scores_2sec(
        jdx.title.fwd.ftT, jdx.title.fwd.fwT, jdx.body.fwd.ftT, jdx.body.fwd.fwT,
        jnp.asarray(term_ids), jnp.asarray(qn), doc_block=512,
        emit_counts=emit_counts, interpret=True,
        qnb=None if qnb_arg is None else jnp.asarray(qnb_arg),
        body_tmax=jdx.body.tmax_blocks,
    )
    got = k1.forward_scores_2sec(
        tdx.title.fwd.ftT, tdx.title.fwd.fwT, tdx.body.fwd.ftT, tdx.body.fwd.fwT,
        torch.from_numpy(term_ids), torch.from_numpy(qn), emit_counts=emit_counts,
        qnb=None if qnb_arg is None else torch.from_numpy(qnb_arg),
        body_tmax=tdx.body.tmax_blocks,
    )
    assert (tdx.body.tmax_blocks is not None) == doc_sort
    # the XLA twin on the doc-major arrays, body on the cold slots only
    bt = term_ids if qnb_arg is None else np.asarray(mask_cold(jnp.asarray(term_ids), jnp.asarray(qnb)))
    twin = [
        *forward_section_scores(jdx.title.fwd.ft, jdx.title.fwd.fw, jnp.asarray(term_ids), 4),
        *forward_section_scores(jdx.body.fwd.ft, jdx.body.fwd.fw, jnp.asarray(bt), 4),
    ]
    for g, w, x in zip(got, want, twin):
        if w is None:
            assert g is None
            continue
        np.testing.assert_allclose(g.numpy(), _np(w), rtol=RTOL)
        np.testing.assert_allclose(g.numpy(), _np(x), rtol=RTOL)
    if emit_counts:
        assert np.array_equal(got[1].numpy(), _np(want[1]))
        assert np.array_equal(got[3].numpy(), _np(want[3]))
    cand = (got[0] + got[2]).numpy() > 0
    assert np.array_equal(cand, (_np(want[0]) + _np(want[2])) > 0)


@pytest.mark.parametrize("route", ["small", "chunked"])
@pytest.mark.parametrize("with_map", [False, True])
def test_exact_top_k_ties_match_jax(route, with_map):
    """Many exact ties (scores drawn from 6 values, -inf non-candidates)
    across the k-th cut: both routes must pick the same ids in the same
    (score desc, id asc) order as the JAX exact_top_k."""
    rng = np.random.default_rng(11)
    b, d, k = 5, (4096 if route == "small" else 1 << 18), 50
    levels = np.array([-np.inf, 0.5, 1.0, 2.0, 3.0, 7.0], np.float32)
    scores = levels[rng.integers(0, len(levels), (b, d))]
    scores[0] = -np.inf  # an all non-candidate row
    doc_map = rng.permutation(d).astype(np.int32) if with_map else None
    kw = {"chunk_min_docs": 1 << 18}
    jv, ji = jax_top_k(
        jnp.asarray(scores), k, doc_map=None if doc_map is None else jnp.asarray(doc_map), **kw
    )
    tv, ti = exact_top_k(
        torch.from_numpy(scores), k,
        doc_map=None if doc_map is None else torch.from_numpy(doc_map), **kw,
    )
    assert ti.dtype == torch.int32
    assert np.array_equal(tv.numpy(), np.asarray(jv))
    assert np.array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("emit_counts", [True, False])
@pytest.mark.parametrize("section", ["title", "body"])
@pytest.mark.parametrize("which", ["crawl", "bench"])
def test_one_section_plain_matches_pallas(crawl_snap, bench_snap, which, section, emit_counts):
    """K3: rows sorted by descending qn, terms past qn are sentinels."""
    snap = crawl_snap if which == "crawl" else bench_snap
    jdx, tdx = _indexes(snap, doc_sort=which == "bench")
    term_ids, qn, _ = _keyword_batch(snap.n_words, 16, 4, seed=11)
    jsec, tsec = getattr(jdx, section), getattr(tdx, section)
    want = pallas_forward_scores(
        jsec.fwd.ftT, jsec.fwd.fwT, jnp.asarray(term_ids), jnp.asarray(qn),
        doc_block=512, emit_counts=emit_counts, interpret=True,
    )
    got = k1.forward_scores(
        tsec.fwd.ftT, tsec.fwd.fwT, torch.from_numpy(term_ids), torch.from_numpy(qn),
        emit_counts=emit_counts,
    )
    np.testing.assert_allclose(got[0].numpy(), _np(want[0]), rtol=RTOL)
    if emit_counts:
        assert np.array_equal(got[1].numpy(), _np(want[1]))
        assert got[1].sum() > 0
    else:
        assert got[1] is None and want[1] is None
    assert (got[0].numpy() > 0).sum() > 0


def _pad_rows(x, b_pad, value):
    out = np.full((b_pad,) + x.shape[1:], value, x.dtype)
    out[: x.shape[0]] = x
    return out


@pytest.mark.parametrize("kind", check.ADVERSARIAL)
def test_probe_walk_matches_plain_and_pallas(bench_snap, kind):
    """K1's algorithm (the probe tables its wrapper builds, walked slot by
    slot with torch ops) equals the plain version and the interpret-mode
    Pallas kernel on batches built to stress the tables: multiplicity,
    one term in every row, Q=32, all-sentinel and unknown-word rows, B=13,
    B=80 (two row tiles); hot split and doc-sorted T bound on."""
    jdx, tdx = _indexes(bench_snap, doc_sort=True)
    df = np.diff(bench_snap.body.post_offsets).astype(np.float64)
    nb = check.adversarial_batch(tdx, kind, seed=5, df=df, snap=bench_snap)
    batch = check.to_device(nb, "cpu")
    tq, qn, qnb = batch["term_ids"], batch["qn"], batch["qnb"]
    b, q = tq.shape
    assert batch["split"] and b == {"b13": 13, "b80": 80}.get(kind, 16)
    assert q == (32 if kind == "q32" else 4)
    terms, pay, rows, _ = probe.plain_tables(tq, qn, qnb)
    assert terms.shape[1] == -(-b // probe.ROWS_MAX)
    real = terms[0] != probe.TERM_PAD  # the title tables of every row tile
    assert int(real.sum()) == len({(int(t), i) for i in range(b) for t in nb["term_ids"][i, : nb["qn"][i]]
                                   if t != probe.TERM_PAD})
    if kind == "dup":
        assert int((pay[0][real] & 0x7FFF).max()) >= 2  # multiplicity carried
    bound = tdx.body.tmax_blocks.repeat_interleave(k1.TMAX_BLOCK)
    t, bd = tdx.title.fwd, tdx.body.fwd
    walk = probe.walk_sections(t.ftT, t.fwT, bd.ftT, bd.fwT, terms, pay, b, rows, body_bound=bound)
    plain = k1.plain_forward_scores_2sec(t.ftT, t.fwT, bd.ftT, bd.fwT, tq, qn, qnb=qnb,
                                         body_tmax=tdx.body.tmax_blocks)
    rep = check.compare(walk, plain)
    assert rep["ok"], rep
    assert rep["candidates"] > 0
    b_pad = -(-b // 8) * 8
    want = pallas_forward_scores_2sec(
        jdx.title.fwd.ftT, jdx.title.fwd.fwT, jdx.body.fwd.ftT, jdx.body.fwd.fwT,
        jnp.asarray(_pad_rows(nb["term_ids"], b_pad, tdx.n_words)),
        jnp.asarray(_pad_rows(nb["qn"], b_pad, 0)), doc_block=512, emit_counts=True,
        interpret=True, qnb=jnp.asarray(_pad_rows(nb["qnb"], b_pad, 0)),
        body_tmax=jdx.body.tmax_blocks,
    )
    for g, w in zip(walk, want):
        np.testing.assert_allclose(g.numpy(), _np(w)[:b], rtol=RTOL)
    assert np.array_equal(walk[1].numpy(), _np(want[1])[:b])
    assert np.array_equal(walk[3].numpy(), _np(want[3])[:b])


@pytest.mark.parametrize("section", ["title", "body"])
@pytest.mark.parametrize("kind", check.ADVERSARIAL)
def test_one_section_probe_walk_matches_plain_and_pallas(bench_snap, kind, section):
    """K3's algorithm: one probe table per row tile (columns < qn, K1's
    title table; all columns without qn), one section swept against it
    with torch ops. Both tables hold only real entries (no int32-max
    column), the qn one equals K1's title table, and the walk equals the
    plain version and the interpret-mode Pallas kernel: counts exact,
    scores within rtol 1e-6."""
    jdx, tdx = _indexes(bench_snap, doc_sort=False)
    df = np.diff(bench_snap.body.post_offsets).astype(np.float64)
    nb = check.adversarial_batch(tdx, kind, seed=13, df=df, snap=bench_snap)
    batch = check.to_device(nb, "cpu")
    tq, qn = batch["term_ids"], batch["qn"]
    b = tq.shape[0]
    sec = getattr(tdx, section).fwd
    plain = k1.plain_section_scores(sec.ftT, sec.fwT, tq)
    k1_title = probe.plain_tables(tq, qn, batch["qnb"])
    for active in (qn, None):
        terms, pay, rows, _ = probe.plain_tables(tq, active, None, sections=1)
        assert terms.shape == (1, -(-b // probe.ROWS_MAX), rows * tq.shape[1])
        cols = nb["term_ids"] if active is None else [r[:n] for r, n in zip(nb["term_ids"], nb["qn"])]
        pairs = {(int(t), i) for i, r in enumerate(cols) for t in r if 0 <= t != probe.TERM_PAD}
        real = terms[0] != probe.TERM_PAD
        assert int(real.sum()) == len(pairs)  # only real entries, one per (term, row)
        assert bool(((pay[0] & 0x7FFF) > 0)[real].all())
        if active is not None:
            assert torch.equal(terms[0], k1_title[0][0]) and torch.equal(pay[0], k1_title[1][0])
        score, count, _ = probe.walk_section(sec.ftT, sec.fwT, terms[0], pay[0], b, rows)
        rep = check.compare_section((score, count), plain)
        assert rep["ok"], (active is None, rep)
        assert rep["candidates"] > 0
    if kind == "int_max":  # the batch holds int32-max columns in and past qn
        assert bool((tq == probe.TERM_PAD).any())
    b_pad = -(-b // 8) * 8
    jsec = getattr(jdx, section).fwd
    want = pallas_forward_scores(
        jsec.ftT, jsec.fwT, jnp.asarray(_pad_rows(nb["term_ids"], b_pad, tdx.n_words)),
        jnp.asarray(_pad_rows(nb["qn"], b_pad, 0)), doc_block=512, emit_counts=True,
        interpret=True,
    )
    np.testing.assert_allclose(score.numpy(), _np(want[0])[:b], rtol=RTOL)
    assert np.array_equal(count.numpy(), _np(want[1])[:b])
