"""The PyTorch port's K2 plain version against the JAX package: the mixed
lane's plain version (the wrapper's CPU route) vs pallas_mixed_scores_2sec
in interpret mode and the XLA twin mixed_forward_scores, with int16 and f32
position planes, 1-term phrases, -100-anchored title terms, planted real
bigrams, repeated and absent terms, natural and doc-sorted layouts.

Scores within rtol=1e-6 (the JAX package's own kernel-vs-twin bar,
tests/test_scoring_paths.py); counts exact. Inputs are made with numpy from
a seed and handed to both packages. K2's probe algorithm (its wrapper's
tables, walked with torch ops) is held to both on adversarial batches.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spaghettisearch_tpu.ops.kernels.mixed import (
    _deq_posT,
    mixed_forward_scores,
    pallas_mixed_scores_2sec,
)
from spaghettisearch_tpu.ops.scoring import forward_section_scores
from spaghettisearch_tpu_torch.ops.kernels import check, probe
from spaghettisearch_tpu_torch.ops.kernels import membership as k1
from spaghettisearch_tpu_torch.ops.kernels import mixed as k2
from test_torch_membership import (  # noqa: F401 — module fixtures
    RTOL,
    _indexes,
    _keyword_batch,
    _np,
    bench_snap,
    crawl_snap,
)

torch.set_num_threads(1)


def _phrase_batch(snap, b, p, seed):
    """Phrase rows first: 1-term phrases, -100-anchored title terms,
    planted adjacent body bigrams, repeated terms and unknown words."""
    rng = np.random.default_rng(seed)
    n_words = snap.n_words
    title = snap.title
    n_post = title.n_postings
    anchored = [
        int(np.searchsorted(title.post_offsets, j, side="right") - 1)
        for j in range(n_post)
        if title.positions[title.pos_offsets[j]] == -100.0
    ]
    body = snap.body
    bigrams = []
    for j in rng.integers(0, body.n_postings, 24):
        d = body.doc_ids[j]
        mine = np.flatnonzero(body.doc_ids[: body.n_postings] == d)
        at = {}
        for k in mine:
            w = int(np.searchsorted(body.post_offsets, k, side="right") - 1)
            for v in body.positions[body.pos_offsets[k] : body.pos_offsets[k + 1]]:
                at[float(v)] = w
        for v in sorted(at):
            if v >= 0 and v + 1 in at:
                bigrams.append([at[v], at[v + 1]])
                break
    ph_ids = np.full((b, p), n_words, np.int32)
    ph_valid = np.zeros((b, p), np.float32)
    rows = []
    for i in range(b):
        kind = i % 8
        if kind == 0 and anchored:
            ids = [anchored[int(rng.integers(0, len(anchored)))]]
        elif kind == 1 and anchored:
            ids = [anchored[int(rng.integers(0, len(anchored)))], int(rng.integers(0, n_words))]
        elif kind in (2, 3) and bigrams:
            ids = bigrams[int(rng.integers(0, len(bigrams)))]
        elif kind == 4:
            ids = [int(rng.integers(0, n_words))] * 2
        elif kind == 5:
            ids = [int(rng.integers(0, n_words)), n_words]  # an absent term
        elif kind == 6:
            ids = rng.integers(0, n_words, int(rng.integers(1, p + 1))).tolist()
        else:
            ids = []
        rows.append(ids)
        ph_ids[i, : len(ids)] = ids
        ph_valid[i, : len(ids)] = 1.0
    pn = ph_valid.sum(1).astype(np.int32)
    term_ids, qn, qnb = _keyword_batch(n_words, b, 4, seed + 1)
    perm = np.lexsort((-qn, -pn))
    return term_ids[perm], qn[perm], qnb[perm], ph_ids[perm], ph_valid[perm], pn[perm]


@pytest.mark.parametrize("which,doc_sort,planes,emit_counts", [
    ("crawl", False, "int16", True),
    ("crawl", True, "f32", False),
    ("bench", False, "f32", True),
    ("bench", True, "int16", False),
])
def test_mixed_plain_matches_pallas_and_twin(crawl_snap, bench_snap, which, doc_sort, planes, emit_counts):
    snap = crawl_snap if which == "crawl" else bench_snap
    jdx, tdx = _indexes(snap, doc_sort)
    assert tdx.pos_dense and tdx.body.posT.dtype == torch.int16
    term_ids, qn, _, ph_ids, ph_valid, pn = _phrase_batch(snap, 16, 16, seed=3)
    tpos, bpos = jdx.title.posT, jdx.body.posT
    ttp, tbp = tdx.title.posT, tdx.body.posT
    if planes == "f32":
        tpos, bpos = _deq_posT(tpos), _deq_posT(bpos)
        ttp, tbp = k2.deq_posT(ttp), k2.deq_posT(tbp)
    args = (jnp.asarray(term_ids), jnp.asarray(qn), jnp.asarray(ph_ids),
            jnp.asarray(ph_valid), jnp.asarray(pn))
    want = pallas_mixed_scores_2sec(
        jdx.title.fwd.ftT, jdx.title.fwd.fwT, jdx.body.fwd.ftT, jdx.body.fwd.fwT,
        tpos, bpos, *args, emit_counts=emit_counts, interpret=True,
    )
    twin = mixed_forward_scores(
        jdx.title.fwd.ft, jdx.title.fwd.fw, jdx.body.fwd.ft, jdx.body.fwd.fw,
        tpos, bpos, jnp.asarray(term_ids), jnp.asarray(ph_ids), jnp.asarray(ph_valid),
    )
    got = k2.mixed_scores_2sec(
        tdx.title.fwd.ftT, tdx.title.fwd.fwT, tdx.body.fwd.ftT, tdx.body.fwd.fwT,
        ttp, tbp, *(torch.from_numpy(a) for a in (term_ids, qn, ph_ids, ph_valid, pn)),
        emit_counts=emit_counts,
    )
    for g, w, x in zip(got, want, twin):
        if w is None:
            assert g is None
            continue
        np.testing.assert_allclose(g.numpy(), _np(w), rtol=RTOL)
        np.testing.assert_allclose(g.numpy(), _np(x), rtol=RTOL)
    if emit_counts:
        assert np.array_equal(got[1].numpy(), _np(want[1]))
        assert np.array_equal(got[3].numpy(), _np(want[3]))
    # the planted phrases do match (the chain stage is exercised)
    flag = _np(twin[1]) - np.asarray(forward_section_scores(
        jdx.title.fwd.ft, jdx.title.fwd.fw, jnp.asarray(term_ids), 4)[1])
    assert (flag > 0).sum() > 0


def test_mixed_counts_derive_after_hot_fold():
    ts = torch.tensor([[0.0, 1.0, 0.0]])
    bs = torch.tensor([[0.0, 0.0, 2.0]])
    _, tc, _, bc = k2.derive_mixed_counts(ts, None, bs, None)
    assert tc.tolist() == [[0.0, 1.0, 1.0]] and bc.tolist() == [[0.0, 0.0, 0.0]]


def _pad_rows(x, b_pad, value):
    out = np.full((b_pad,) + x.shape[1:], value, x.dtype)
    out[: x.shape[0]] = x
    return out


@pytest.mark.parametrize("kind", check.ADVERSARIAL)
def test_probe_walk_matches_plain_and_pallas(bench_snap, kind):
    """K2's algorithm (one probe table per section holding keyword and
    phrase entries, walked slot by slot with torch ops; the chain checked
    only where the sweep found every required phrase term) equals the plain
    version and the interpret-mode Pallas kernel on adversarial batches:
    phrase terms that are keyword terms, repeated phrase terms, unknown and
    invalid phrase slots, one term in every row, Q=32, B=13, B=80."""
    jdx, tdx = _indexes(bench_snap, doc_sort=False)
    df = np.diff(bench_snap.body.post_offsets).astype(np.float64)
    nb = check.adversarial_batch(tdx, kind, seed=9, df=df, snap=bench_snap)
    batch = check.to_device(nb, "cpu")
    tq, qn, qnb = batch["term_ids"], batch["qn"], batch["qnb"]
    ph_ids, ph_valid = batch["ph_ids"], batch["ph_valid"]
    b, p = ph_ids.shape
    terms, pay, rows, req = probe.plain_tables(tq, qn, qnb, ph_ids, ph_valid)
    real = terms[0] != probe.TERM_PAD
    assert int(((pay[0] & probe.PHRASE) != 0)[real].sum()) == int(
        ((ph_valid > 0) & (ph_ids >= 0)).sum()
    )
    t, bd = tdx.title, tdx.body
    tpos, bpos = k2.deq_posT(t.posT), k2.deq_posT(bd.posT)
    walk = probe.walk_sections(
        t.fwd.ftT, t.fwd.fwT, bd.fwd.ftT, bd.fwd.fwT, terms, pay, b, rows,
        title_posT=tpos, body_posT=bpos, req=req, n_phrase=p,
    )
    plain = k2.plain_mixed_scores(t.fwd.ftT, t.fwd.fwT, bd.fwd.ftT, bd.fwd.fwT, t.posT, bd.posT,
                                  tq, ph_ids, ph_valid, qnb=qnb)
    rep = check.compare(walk, plain)
    assert rep["ok"], rep
    b_pad = -(-b // 8) * 8
    args = [jnp.asarray(_pad_rows(nb[k], b_pad, v)) for k, v in (
        ("term_ids", tdx.n_words), ("qn", 0), ("ph_ids", tdx.n_words), ("ph_valid", 0.0), ("pn", 0),
    )]
    want = pallas_mixed_scores_2sec(
        jdx.title.fwd.ftT, jdx.title.fwd.fwT, jdx.body.fwd.ftT, jdx.body.fwd.fwT,
        jdx.title.posT, jdx.body.posT, *args, emit_counts=True, interpret=True,
        qnb=jnp.asarray(_pad_rows(nb["qnb"], b_pad, 0)),
    )
    for g, w in zip(walk, want):
        np.testing.assert_allclose(g.numpy(), _np(w)[:b], rtol=RTOL)
    assert np.array_equal(walk[1].numpy(), _np(want[1])[:b])
    assert np.array_equal(walk[3].numpy(), _np(want[3])[:b])
    # phrase matches happened where the batch holds real phrases
    kw = k1.plain_forward_scores_2sec(t.fwd.ftT, t.fwd.fwT, bd.fwd.ftT, bd.fwd.fwT, tq, qn, qnb=qnb)
    if kind != "sentinel":
        assert int((walk[1] - kw[1]).sum()) > 0, kind
