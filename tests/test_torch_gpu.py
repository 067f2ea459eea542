"""GPU tests of the PyTorch port: each hand-written CUDA kernel (K1-K4)
against its plain PyTorch version on the card, at small and at the main
path's full widths (B=128, Q=4/32, P=16), all four also on the batches
that stress their probe tables (and each table build against its plain
version), and the CUDA engine against the CPU engine on the reference
blend, BM25, a custom blend and the CSR route.

This file imports no jax: on the card run it as

    python3 -m pytest --noconftest -m gpu tests/test_torch_gpu.py

(tests/conftest.py imports jax). Without a card every test skips; the
decision is made inside a fixture, never at import time.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from spaghettisearch_tpu_torch.corpus import make_queries, write_corpus
from spaghettisearch_tpu_torch.index.snapshot import build_snapshot
from spaghettisearch_tpu_torch.models.blended import BlendedRanker
from spaghettisearch_tpu_torch.models.bm25 import BM25Ranker
from spaghettisearch_tpu_torch.ops.kernels import check
from spaghettisearch_tpu_torch.ops.kernels import fused as k4
from spaghettisearch_tpu_torch.ops.kernels import membership as k1
from spaghettisearch_tpu_torch.ops.kernels import mixed as k2
from spaghettisearch_tpu_torch.ops.kernels import probe
from spaghettisearch_tpu_torch.retrieval import device_index as tdi
from spaghettisearch_tpu_torch.retrieval.device_index import DeviceIndex
from spaghettisearch_tpu_torch.retrieval.engine import QueryEngine, parse_query

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def corpus(cuda):
    db = write_corpus(None, n_pages=3000, n_vocab=8000, seed=0)
    snap = build_snapshot(db)
    return db, snap


@pytest.fixture(scope="module")
def indexes(cuda, corpus):
    _, snap = corpus
    return {ds: DeviceIndex.from_snapshot(snap, cuda, doc_sort=ds) for ds in (False, True)}


def _df(snap):
    return np.diff(snap.body.post_offsets).astype(np.float64)


@pytest.mark.parametrize("doc_sort", [False, True])
@pytest.mark.parametrize("emit_counts", [True, False])
@pytest.mark.parametrize("b,q", [(16, 4), (128, 4), (128, 32)])
def test_membership_kernel_matches_plain(cuda, corpus, indexes, doc_sort, emit_counts, b, q):
    idx = indexes[doc_sort]
    assert idx.hot_body_w is not None and (idx.body.tmax_blocks is not None) == doc_sort
    batch = check.to_device(check.keyword_batch(idx, b, q, seed=b + q, df=_df(corpus[1])), cuda)
    n0 = k1.LAUNCHES
    got = check.run_k1(idx, batch, emit_counts, body_tmax=doc_sort)
    assert k1.LAUNCHES == n0 + 1
    want = check.run_k1(idx, batch, emit_counts, body_tmax=doc_sort, plain=True)
    torch.cuda.synchronize()
    rep = check.compare(got, want)
    assert rep["ok"], rep
    assert rep["candidates"] > 0


@pytest.mark.parametrize("pos16", [True, False])
@pytest.mark.parametrize("emit_counts", [True, False])
@pytest.mark.parametrize("b", [16, 128])
def test_mixed_kernel_matches_plain(cuda, corpus, indexes, pos16, emit_counts, b):
    idx = indexes[True]
    assert idx.body.posT.dtype == torch.int16
    if not pos16:  # the f32 planes a pathological corpus keeps
        idx = dataclasses.replace(idx, **{
            sec: dataclasses.replace(
                getattr(idx, sec), posT=k2.deq_posT(getattr(idx, sec).posT).contiguous()
            )
            for sec in ("title", "body")
        })
    batch = check.to_device(
        check.mixed_batch(idx, b, 4, 16, seed=b, df=_df(corpus[1]), snap=corpus[1]), cuda
    )
    n0 = k2.LAUNCHES
    got = check.run_k2(idx, batch, emit_counts)
    assert k2.LAUNCHES == n0 + 1
    want = check.run_k2(idx, batch, emit_counts, plain=True)
    torch.cuda.synchronize()
    rep = check.compare(got, want)
    assert rep["ok"], rep
    assert got[0].shape == (b, idx.n_docs_padded)


@pytest.mark.parametrize("doc_sort", [False, True])
@pytest.mark.parametrize("emit_counts", [True, False])
@pytest.mark.parametrize("kind", check.ADVERSARIAL)
def test_membership_kernel_adversarial(cuda, corpus, indexes, kind, emit_counts, doc_sort):
    """K1 on the batches that stress its probe tables (multiplicity, one
    term in every row, Q=32, sentinel rows, B=13)."""
    idx = indexes[doc_sort]
    batch = check.to_device(
        check.adversarial_batch(idx, kind, seed=3, df=_df(corpus[1]), snap=corpus[1]), cuda
    )
    got = check.run_k1(idx, batch, emit_counts, body_tmax=doc_sort)
    want = check.run_k1(idx, batch, emit_counts, body_tmax=doc_sort, plain=True)
    torch.cuda.synchronize()
    rep = check.compare(got, want)
    assert rep["ok"], rep
    assert rep["candidates"] > 0


@pytest.mark.parametrize("phrases", [False, True])
@pytest.mark.parametrize("kind", check.ADVERSARIAL)
def test_probe_tables_match_plain_builder(cuda, corpus, indexes, kind, phrases):
    """The table build the K1/K2 entry points launch equals its plain
    version (probe.build_tables) entry for entry."""
    idx = indexes[False]
    batch = check.to_device(
        check.adversarial_batch(idx, kind, seed=11, df=_df(corpus[1]), snap=corpus[1], b=128), cuda
    )
    assert check.tables_agree(batch, phrases)


@pytest.mark.parametrize("emit_counts", [True, False])
@pytest.mark.parametrize("b", [16, 128])
@pytest.mark.parametrize("kind", check.ADVERSARIAL)
def test_mixed_kernel_adversarial(cuda, corpus, indexes, kind, b, emit_counts):
    """K2 on the adversarial batches. every_row at B=128 and log_full at
    both sizes give docs more phrase hits in a section than the kernel's
    log keeps, so they take the rescan path."""
    idx = indexes[False]
    batch = check.to_device(
        check.adversarial_batch(idx, kind, seed=b, df=_df(corpus[1]), snap=corpus[1], b=b), cuda
    )
    got = check.run_k2(idx, batch, emit_counts)
    want = check.run_k2(idx, batch, emit_counts, plain=True)
    torch.cuda.synchronize()
    rep = check.compare(got, want)
    assert rep["ok"], rep


@pytest.mark.parametrize("section", ["title", "body"])
@pytest.mark.parametrize("emit_counts", [True, False])
@pytest.mark.parametrize("b,q", [(16, 4), (128, 4), (128, 32)])
def test_one_section_kernel_matches_plain(cuda, corpus, indexes, section, emit_counts, b, q):
    idx = indexes[True]
    batch = check.to_device(
        check.keyword_batch(idx, b, q, seed=b + q, df=_df(corpus[1]), split=False), cuda
    )
    assert bool((batch["qn"][:-1] >= batch["qn"][1:]).all())  # qn-sorted rows
    n0 = k1.LAUNCHES_1SEC
    got = check.run_k3(idx, batch, emit_counts, section)
    assert k1.LAUNCHES_1SEC == n0 + 1
    want = check.run_k3(idx, batch, emit_counts, section, plain=True)
    torch.cuda.synchronize()
    rep = check.compare_section(got, want)
    assert rep["ok"], rep
    assert rep["candidates"] > 0


@pytest.mark.parametrize("doc_sort", [False, True])
@pytest.mark.parametrize("c", [1, 8])
@pytest.mark.parametrize("b,q", [(13, 4), (128, 4), (128, 32)])
def test_fused_kernel_matches_plain(cuda, corpus, indexes, doc_sort, c, b, q):
    idx = indexes[doc_sort]
    batch = check.to_device(
        check.keyword_batch(idx, b, q, seed=b * q + c, df=_df(corpus[1]), split=False), cuda
    )
    inputs = check.fused_inputs(idx, batch, c, seed=c)
    n0 = k4.LAUNCHES
    got = check.run_k4(idx, batch, inputs)
    assert k4.LAUNCHES == n0 + 1 and got.shape == (b, idx.n_docs_padded)
    want = check.run_k4(idx, batch, inputs, plain=True)
    torch.cuda.synchronize()
    rep = check.compare_final(got, want)
    assert rep["ok"], rep
    assert rep["candidates"] > 0


@pytest.mark.parametrize("one", ["K3", "K4"])
@pytest.mark.parametrize("kind", check.ADVERSARIAL)
def test_one_table_builds_match_plain_build(cuda, corpus, indexes, kind, one):
    """The one table per row tile that K3 (columns < qn) and K4 (every
    column) build equals its plain version entry for entry."""
    idx = indexes[False]
    batch = check.to_device(
        check.adversarial_batch(idx, kind, seed=19, df=_df(corpus[1]), snap=corpus[1], b=128), cuda
    )
    assert check.tables_agree(batch, one=one)


@pytest.mark.parametrize("section", ["title", "body"])
@pytest.mark.parametrize("emit_counts", [True, False])
@pytest.mark.parametrize("kind", check.ADVERSARIAL)
def test_one_section_kernel_adversarial(cuda, corpus, indexes, kind, emit_counts, section):
    """K3 on the adversarial batches (B=128 unless the kind fixes 13 or 80;
    Q=4, Q=32 for q32; int32-max columns)."""
    idx = indexes[True]
    batch = check.to_device(
        check.adversarial_batch(idx, kind, seed=21, df=_df(corpus[1]), snap=corpus[1], b=128), cuda
    )
    got = check.run_k3(idx, batch, emit_counts, section)
    want = check.run_k3(idx, batch, emit_counts, section, plain=True)
    torch.cuda.synchronize()
    rep = check.compare_section(got, want)
    assert rep["ok"], rep
    assert rep["candidates"] > 0


@pytest.mark.parametrize("c", [1, 8])
@pytest.mark.parametrize("kind", check.ADVERSARIAL)
def test_fused_kernel_adversarial(cuda, corpus, indexes, kind, c):
    """K4 on the adversarial batches, topics off (C=1) and a seeded C=8
    blend."""
    idx = indexes[True]
    batch = check.to_device(
        check.adversarial_batch(idx, kind, seed=23, df=_df(corpus[1]), snap=corpus[1], b=128), cuda
    )
    inputs = check.fused_inputs(idx, batch, c, seed=c)
    got = check.run_k4(idx, batch, inputs)
    want = check.run_k4(idx, batch, inputs, plain=True)
    torch.cuda.synchronize()
    rep = check.compare_final(got, want)
    assert rep["ok"], rep
    assert rep["candidates"] > 0


def test_fused_kernel_keeps_inf_and_zero_weight_candidates(cuda, indexes):
    """mag 0 with a positive score keeps +inf, 0/0 becomes 0, and a
    zero-weight posting still makes its doc a candidate."""
    idx = indexes[False]
    sec = idx.body.fwd
    ftT, fwT = sec.ftT.clone(), sec.fwT.clone()
    d0 = int(torch.nonzero(ftT[0] >= 0)[0])
    term = int(ftT[0, d0])
    fwT[0, d0] = 0.0  # a zero-weight posting
    mag_b = idx.mag_body.clone()
    docs = torch.nonzero((ftT == term).any(0)).flatten()
    mag_b[docs[docs != d0][:3]] = 0.0
    tq = torch.full((8, 4), idx.n_words, dtype=torch.int32, device=cuda)
    tq[0, 0] = term
    qlen = torch.ones(8, device=cuda)
    tp = torch.zeros((8, 1), device=cuda)
    args = (idx.title.fwd.ftT, idx.title.fwd.fwT, ftT, fwT, idx.mag_title, mag_b,
            idx.pagerankT[:1].contiguous(), tq, qlen, tp)
    got = k4.fused_final_scores(*args)
    want = k4.plain_fused_final_scores(*args)
    rep = check.compare_final(got, want)
    assert rep["ok"], rep
    assert torch.isfinite(got[0, d0]) and bool((got[0] == float("inf")).any())


def test_wrappers_reject_bad_inputs(cuda, indexes):
    idx = indexes[False]
    tq = torch.zeros((8, 4), dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):
        k1.forward_scores_2sec(
            idx.title.fwd.ftT, idx.title.fwd.fwT, idx.body.fwd.ftT, idx.body.fwd.fwT, tq
        )
    wide = torch.zeros((8, 40), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        k1.forward_scores_2sec(
            idx.title.fwd.ftT, idx.title.fwd.fwT, idx.body.fwd.ftT, idx.body.fwd.fwT, wide
        )
    with pytest.raises(ValueError):
        k1.forward_scores(idx.body.fwd.ftT, idx.body.fwd.fwT, wide)
    # K4 holds the tile's topic probabilities in shared memory: C <= C_MAX
    d = idx.n_docs_padded
    tq = torch.zeros((8, 4), dtype=torch.int32, device=cuda)
    c = k4.C_MAX + 1
    args = (idx.title.fwd.ftT, idx.title.fwd.fwT, idx.body.fwd.ftT, idx.body.fwd.fwT,
            idx.mag_title, idx.mag_body, torch.zeros((c, d), device=cuda), tq,
            torch.ones(8, device=cuda), torch.zeros((8, c), device=cuda))
    with pytest.raises(ValueError):
        k4.fused_final_scores(*args)
    with pytest.raises(ValueError):  # Q above the table's limit
        k4.fused_final_scores(*args[:6], idx.pagerankT[:1].contiguous(), wide, args[8],
                              torch.zeros((8, 1), device=cuda))
    # and its entry point refuses them itself, before any launch
    rows, out = 8, torch.empty((8, d), device=cuda)
    tables = probe.scratch(8, rows, rows * 4, cuda, sections=1)
    lib = k4.library().lib
    stream = torch.cuda.current_stream().cuda_stream
    for cc, q in ((c, 4), (1, k1.Q_MAX + 1)):
        err = lib.ss_fused(
            *(a.data_ptr() for a in args[:2]), args[0].shape[0],
            *(a.data_ptr() for a in args[2:4]), args[2].shape[0], d,
            args[4].data_ptr(), args[5].data_ptr(), args[6].data_ptr(), cc,
            tq.data_ptr(), 8, q, args[8].data_ptr(), args[9].data_ptr(),
            0.33, 0.38, 0.29, 100.0, tables.data_ptr(), rows, rows * q, out.data_ptr(), stream,
        )
        assert err != 0, (cc, q)


def _same_up_to_ties(got, want) -> bool:
    """Top-k rows equal except where the differing positions hold docs
    with equal reference scores (bench.py --mode parity's rule)."""
    if len(got) != len(want):
        return False
    score_of = {d: s for d, s in want}
    for (dg, _), (dw, sw) in zip(got, want):
        if dg != dw:
            sg = score_of.get(dg)
            if sg is None or abs(sg - sw) > 1e-6 * max(abs(sw), 1e-9):
                return False
    return True


def test_engine_on_cuda_matches_cpu(cuda, corpus):
    db, snap = corpus
    eng_gpu = QueryEngine(db, snapshot=snap, device=cuda)
    eng_cpu = QueryEngine(db, snapshot=snap, device="cpu")
    assert eng_gpu.index.doc_perm is None and eng_gpu.index.pos_dense
    queries = make_queries(snap, db, 64, seed=3)
    parsed = [parse_query(q) for q in queries]
    k1.reset_launches()
    k2.reset_launches()
    sg, ig = eng_gpu.rank(parsed)
    sc, ic = eng_cpu.rank(parsed)
    assert k1.LAUNCHES == 0 and k2.LAUNCHES == 1  # the batch holds phrases
    kw = [p for p in parsed if not p.phrase_hashes]
    eng_gpu.rank(kw)
    assert k1.LAUNCHES == 1
    for row in range(len(parsed)):
        got = [(int(d), float(s)) for s, d in zip(sg[row], ig[row]) if np.isfinite(s)]
        want = [(int(d), float(s)) for s, d in zip(sc[row], ic[row]) if np.isfinite(s)]
        assert _same_up_to_ties(got, want), queries[row]
        np.testing.assert_allclose([s for _, s in got], [s for _, s in want], rtol=1e-6)


def _rank_rows(eng, parsed):
    s, i = eng.rank(parsed)
    return [
        [(int(d), float(v)) for v, d in zip(s[r], i[r]) if np.isfinite(v)] for r in range(len(s))
    ]


def _engines_agree(eng_gpu, eng_cpu, parsed, queries):
    for q, got, want in zip(queries, _rank_rows(eng_gpu, parsed), _rank_rows(eng_cpu, parsed)):
        assert _same_up_to_ties(got, want), q
        np.testing.assert_allclose([s for _, s in got], [s for _, s in want], rtol=1e-6)


def test_bm25_engine_on_cuda_matches_cpu(cuda, corpus):
    """BM25 keyword batches on K1 over BM25 tiles; phrase batches on the
    sparse lane (BM25 has no fused mixed lane)."""
    db, snap = corpus
    eng_gpu = QueryEngine(db, snapshot=snap, device=cuda, model=BM25Ranker())
    eng_cpu = QueryEngine(db, snapshot=snap, device="cpu", model=BM25Ranker())
    queries = make_queries(snap, db, 64, seed=5)
    parsed = [parse_query(q) for q in queries]
    k1.reset_launches()
    k2.reset_launches()
    _engines_agree(eng_gpu, eng_cpu, parsed, queries)
    assert k1.LAUNCHES >= 1 and k2.LAUNCHES == 0
    kw = [p for p in parsed if not p.phrase_hashes]
    _engines_agree(eng_gpu, eng_cpu, kw, [q for q in queries if '"' not in q])


def test_custom_blend_and_csr_on_cuda_match_cpu(cuda, corpus, monkeypatch):
    """A custom blend ranks on K3 (phrases on the sparse lane); an index
    truncated by a lowered DOC_TERM_CAP ranks through the CSR route."""
    db, snap = corpus
    queries = make_queries(snap, db, 64, seed=6)
    parsed = [parse_query(q) for q in queries]
    model = BlendedRanker(w_pagerank=0.0, w_title=1.0, w_body=0.0)
    k1.reset_launches()
    _engines_agree(QueryEngine(db, snapshot=snap, device=cuda, model=model),
                   QueryEngine(db, snapshot=snap, device="cpu", model=model), parsed, queries)
    assert k1.LAUNCHES_1SEC >= 2 and k1.LAUNCHES == 0
    nt = np.bincount(snap.body.doc_ids[: snap.body.n_postings], minlength=snap.n_docs)
    monkeypatch.setattr(tdi, "DOC_TERM_CAP", int(np.sort(nt)[-4]))
    eng_gpu = QueryEngine(db, snapshot=snap, device=cuda)
    assert eng_gpu.index.dense_truncated
    k1.reset_launches()
    _engines_agree(eng_gpu, QueryEngine(db, snapshot=snap, device="cpu"), parsed, queries)
    assert k1.LAUNCHES == 0 and k1.LAUNCHES_1SEC == 0
