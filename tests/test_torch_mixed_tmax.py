"""K2's doc-sorted body bound (body_tmax, tmax_stage) on the PyTorch port,
on the CPU.

The port's mixed_scores_padded with body_tmax, for each tmax_stage, with
and without the hot split's qnb, counts on and elided, against the JAX
package's pallas_mixed_scores_2sec(..., body_tmax=, tmax_stage=) in
interpret mode, as tests/test_doc_sort.py runs it: a doc-sorted index of
the same seeded pages in both packages, B=16, Q=4, P=4, phrase rows first;
scores within rtol 1e-6 / atol 1e-7, counts equal. The kernel's algorithm
with the bound (its probe tables walked with torch ops, each doc's body
sweep cut at its 512-doc block's tmax) equals the plain version; the
scoring entry point with the bound returns the unbounded top-50; and the
wrapper refuses a bound it does not take.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spaghettisearch_tpu.ops.kernels.mixed import pallas_mixed_scores_2sec
from spaghettisearch_tpu_torch.ops import scoring
from spaghettisearch_tpu_torch.ops.kernels import check, probe
from spaghettisearch_tpu_torch.ops.kernels import membership as k1
from spaghettisearch_tpu_torch.ops.kernels import mixed as k2
from test_torch_membership import (  # noqa: F401 — module fixtures
    _indexes,
    _np,
    bench_snap,
    crawl_snap,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def sorted_pair(crawl_snap):
    jdx, tdx = _indexes(crawl_snap, doc_sort=True)
    assert tdx.body.tmax_blocks is not None and tdx.pos_dense
    assert np.array_equal(_np(jdx.body.tmax_blocks), tdx.body.tmax_blocks.numpy())
    return jdx, tdx


def _batch(n_words):
    """tests/test_doc_sort.py's draws: B=16, Q=4, P=4, phrase rows first,
    then by descending qn; qnb one cold term fewer than qn."""
    rng = np.random.default_rng(5)
    b, q, p = 16, 4, 4
    term_ids = rng.integers(0, n_words + 1, (b, q)).astype(np.int32)
    qn = rng.integers(0, q + 1, b).astype(np.int32)
    ph_ids = rng.integers(0, n_words, (b, p)).astype(np.int32)
    pn = rng.integers(0, p + 1, b).astype(np.int32)
    ph_valid = (np.arange(p)[None, :] < pn[:, None]).astype(np.float32)
    ph_ids[ph_valid == 0] = n_words
    order = np.lexsort((-qn, -pn))
    term_ids, qn, ph_ids, ph_valid, pn = (
        term_ids[order], qn[order], ph_ids[order], ph_valid[order], pn[order]
    )
    qnb = np.maximum(qn - 1, 0).astype(np.int32)
    return term_ids, qn, ph_ids, ph_valid, pn, qnb


@pytest.mark.parametrize("emit_counts", [True, False])
@pytest.mark.parametrize("use_qnb", [False, True])
@pytest.mark.parametrize("stage", ["kw", "phrase", "both"])
def test_bounded_mixed_matches_pallas(crawl_snap, sorted_pair, stage, use_qnb, emit_counts):
    jdx, tdx = sorted_pair
    term_ids, qn, ph_ids, ph_valid, pn, qnb = _batch(crawl_snap.n_words)
    d = tdx.n_docs_padded
    doc_block = 256
    tmax = jnp.repeat(jdx.body.tmax_blocks, (d // doc_block) // jdx.body.tmax_blocks.shape[0])
    want = pallas_mixed_scores_2sec(
        jdx.title.fwd.ftT, jdx.title.fwd.fwT, jdx.body.fwd.ftT, jdx.body.fwd.fwT,
        jdx.title.posT, jdx.body.posT,
        *(jnp.asarray(a) for a in (term_ids, qn, ph_ids, ph_valid, pn)),
        doc_block=doc_block, emit_counts=emit_counts, interpret=True,
        qnb=jnp.asarray(qnb) if use_qnb else None, body_tmax=tmax, tmax_stage=stage,
    )
    t, bd = tdx.title, tdx.body
    got = k2.mixed_scores_padded(
        t.fwd.ftT, t.fwd.fwT, bd.fwd.ftT, bd.fwd.fwT, t.posT, bd.posT,
        *(torch.from_numpy(a) for a in (term_ids, qn, ph_ids, ph_valid, pn)),
        emit_counts=emit_counts, qnb=torch.from_numpy(qnb) if use_qnb else None,
        derive=False, body_tmax=bd.tmax_blocks, tmax_stage=stage,
    )
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        np.testing.assert_allclose(g.numpy(), _np(w), rtol=1e-6, atol=1e-7)
    if emit_counts:
        assert np.array_equal(got[1].numpy(), _np(want[1]))
        assert np.array_equal(got[3].numpy(), _np(want[3]))
    assert (got[0] + got[2] > 0).any()


@pytest.mark.parametrize("kind", ["log_full", "every_row", "b80"])
def test_bounded_walk_matches_plain(bench_snap, kind):
    """The kernel's sweep with the body bound (keyword and phrase hits from
    one sweep, each doc's body slots read up to its block's tmax) equals
    the plain version, which reads every slot."""
    tdx = _indexes(bench_snap, doc_sort=True)[1]
    df = np.diff(bench_snap.body.post_offsets).astype(np.float64)
    batch = check.to_device(
        check.adversarial_batch(tdx, kind, seed=9, df=df, snap=bench_snap), "cpu"
    )
    tq, qn, qnb = batch["term_ids"], batch["qn"], batch["qnb"]
    ph_ids, ph_valid = batch["ph_ids"], batch["ph_valid"]
    b, p = ph_ids.shape
    terms, pay, rows, req = probe.plain_tables(tq, qn, qnb, ph_ids, ph_valid)
    t, bd = tdx.title, tdx.body
    per_doc = bd.tmax_blocks.repeat_interleave(k1.TMAX_BLOCK)
    assert int(per_doc.min()) < bd.fwd.ftT.shape[0]  # the bound cuts some blocks
    walk = probe.walk_sections(
        t.fwd.ftT, t.fwd.fwT, bd.fwd.ftT, bd.fwd.fwT, terms, pay, b, rows,
        title_posT=k2.deq_posT(t.posT), body_posT=k2.deq_posT(bd.posT), req=req,
        n_phrase=p, body_bound=per_doc,
    )
    plain = k2.plain_mixed_scores(t.fwd.ftT, t.fwd.fwT, bd.fwd.ftT, bd.fwd.fwT, t.posT, bd.posT,
                                  tq, ph_ids, ph_valid, qnb=qnb)
    rep = check.compare(walk, plain)
    assert rep["ok"], rep


@pytest.mark.parametrize("stage", ["kw", "phrase", "both"])
def test_score_queries_mixed_bound_keeps_top50(bench_snap, stage):
    tdx = _indexes(bench_snap, doc_sort=True)[1]
    df = np.diff(bench_snap.body.post_offsets).astype(np.float64)
    batch = check.to_device(check.mixed_batch(tdx, 16, 4, 4, seed=3, df=df, snap=bench_snap),
                            "cpu")
    b = batch["term_ids"].shape[0]
    qlen = batch["qn"].clamp(min=1).to(torch.float32)
    tp = torch.zeros((b, tdx.n_categories))

    def rank(**bound):
        return scoring.score_queries_mixed(
            tdx.title.fwd, tdx.body.fwd, tdx.title.posT, tdx.body.posT, tdx.mag_title,
            tdx.mag_body, tdx.pagerank, batch["term_ids"], qlen, tp, batch["ph_ids"],
            batch["ph_valid"], qn=batch["qn"], pn=batch["pn"], qnb=batch["qnb"],
            hot_sids=batch["hot_sids"], hot_w=tdx.hot_body_w, doc_map=tdx.doc_perm,
            topk=50, emit_counts=False, **bound,
        )

    want = rank()
    got = rank(body_tmax=tdx.body.tmax_blocks, tmax_stage=stage)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert bool(torch.isfinite(want[0]).any())


def test_wrapper_rejects_bad_bounds(bench_snap):
    tdx = _indexes(bench_snap, doc_sort=True)[1]
    batch = check.to_device(check.mixed_batch(tdx, 8, 4, 4, seed=1), "cpu")
    t, bd = tdx.title, tdx.body
    args = (t.fwd.ftT, t.fwd.fwT, bd.fwd.ftT, bd.fwd.fwT, t.posT, bd.posT, batch["term_ids"],
            batch["qn"], batch["ph_ids"], batch["ph_valid"], batch["pn"])
    tmax = bd.tmax_blocks
    for bad in (tmax[:-1], tmax.to(torch.int64), tmax[None]):
        with pytest.raises(ValueError):
            k2.mixed_scores_2sec(*args, body_tmax=bad)
    for stage in ("body", "", None):
        with pytest.raises(ValueError):
            k2.mixed_scores_2sec(*args, body_tmax=tmax, tmax_stage=stage)
    with pytest.raises(ValueError):
        k2.mixed_scores_padded(*args, body_tmax=tmax, tmax_stage="tc16")
    ok = k2.mixed_scores_2sec(*args, body_tmax=tmax, tmax_stage="both")
    assert all(torch.equal(a, b) for a, b in zip(ok, k2.mixed_scores_2sec(*args)))
