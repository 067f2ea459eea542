"""GPU tests of the PyTorch port: each hand-written CUDA kernel (K1-K6)
against its plain PyTorch version on the card, at small and at the main
path's full widths (B=128, Q=4/32, P=16), all also on the batches that
stress their probe tables (and each table build against its plain
version), K5's top-k on ties across doc tiles and ragged row tiles, the
finalize kernel against its plain route bit for bit (also through the
lanes, and one launch a batch in a traced run of each benchmark cell at a
tiny size), and the CUDA engine against the CPU engine on the reference
blend, BM25, a custom blend and the CSR route; the doc-sharded mesh with
its shards on the card against the same mesh on the CPU; refresh on the
card (appended docs, and the device memory an old index must give back);
the graft entry points on the card against the CPU.

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

from spaghettisearch_tpu_torch.corpus import bench_queries, write_corpus
from spaghettisearch_tpu_torch.index.snapshot import build_snapshot
from spaghettisearch_tpu_torch.models.blended import BlendedRanker
from spaghettisearch_tpu_torch.models.bm25 import BM25Ranker
from spaghettisearch_tpu_torch.ops import scoring
from spaghettisearch_tpu_torch.ops.kernels import check
from spaghettisearch_tpu_torch.ops.kernels import finalize as fin
from spaghettisearch_tpu_torch.ops.kernels import fused as k4
from spaghettisearch_tpu_torch.ops.kernels import fused_topk as k5
from spaghettisearch_tpu_torch.ops.kernels import membership as k1
from spaghettisearch_tpu_torch.ops.kernels import mixed as k2
from spaghettisearch_tpu_torch.ops.kernels import phrase_delta as k6
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


@pytest.mark.parametrize("split", [True, False])
@pytest.mark.parametrize("emit_counts", [True, False])
@pytest.mark.parametrize("stage", ["kw", "phrase", "both"])
@pytest.mark.parametrize("kind", ["mixed16", "mixed128", *check.ADVERSARIAL])
def test_mixed_kernel_with_body_tmax(cuda, corpus, indexes, kind, stage, emit_counts, split):
    """K2 with the doc-sorted layout's body bound, each stage, with and
    without the hot split's qnb: bit-identical to K2 without the bound,
    and within the tolerance of its plain version. every_row and log_full
    take the rescan path the "phrase" stage bounds."""
    idx = indexes[True]
    snap = corpus[1]
    if kind.startswith("mixed"):
        b = int(kind[5:])
        nb = check.mixed_batch(idx, b, 4, 16 if b == 128 else 4, seed=b, df=_df(snap), snap=snap)
    else:
        nb = check.adversarial_batch(idx, kind, seed=5, df=_df(snap), snap=snap, b=128)
    batch = dict(check.to_device(nb, cuda), split=split and nb["split"])
    n0, t0 = k2.LAUNCHES, k2.LAUNCHES_TMAX
    got = check.run_k2(idx, batch, emit_counts, tmax_stage=stage)
    assert (k2.LAUNCHES, k2.LAUNCHES_TMAX) == (n0 + 1, t0 + 1)
    static = check.run_k2(idx, batch, emit_counts)
    assert k2.LAUNCHES_TMAX == t0 + 1
    want = check.run_k2(idx, batch, emit_counts, plain=True)
    torch.cuda.synchronize()
    for g, s in zip(got, static):
        assert (g is None and s is None) or torch.equal(g, s)
    rep = check.compare(got, want)
    assert rep["ok"], rep


def test_mixed_kernel_rejects_bad_bounds(cuda, indexes):
    idx = indexes[True]
    batch = check.to_device(check.mixed_batch(idx, 16, 4, 4, seed=1), cuda)
    args = (idx.title.fwd.ftT, idx.title.fwd.fwT, idx.body.fwd.ftT, idx.body.fwd.fwT,
            idx.title.posT, idx.body.posT, batch["term_ids"], batch["qn"], batch["ph_ids"],
            batch["ph_valid"], batch["pn"])
    tmax = idx.body.tmax_blocks
    for bad in (tmax[:-1], tmax.to(torch.int64), tmax.cpu()):
        with pytest.raises(ValueError):
            k2.mixed_scores_2sec(*args, body_tmax=bad)
    with pytest.raises(ValueError):
        k2.mixed_scores_2sec(*args, body_tmax=tmax, tmax_stage="body")


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


def _finalize_agrees(case: dict, exact: bool) -> torch.Tensor:
    n0 = fin.LAUNCHES
    got = check.run_finalize(case)
    want = check.run_finalize(case, plain=True)
    torch.cuda.synchronize()
    assert fin.LAUNCHES == n0 + 1
    rep = check.compare_finalize(got, want, exact=exact)
    assert rep["ok"], rep
    b, d = got[0].shape
    m = got[1].shape[1]
    pad = got[0].as_strided((b, m * fin.CHUNK - d), (m * fin.CHUNK, 1), d)
    assert bool((pad == -float("inf")).all())
    return got


@pytest.mark.parametrize("c", [0, 1, 4])
@pytest.mark.parametrize("weights", [None, (0.0, 1.0, 0.0, 1.0)], ids=["reference", "title_only"])
@pytest.mark.parametrize("phrase", [False, True])
@pytest.mark.parametrize("counts", [False, True])
@pytest.mark.parametrize("hot", [False, True])
def test_finalize_kernel_matches_plain(cuda, hot, counts, phrase, weights, c):
    """Every variant at B = 13, 80, 128 and D = 1000 (float4 rows, a ragged
    last chunk), 1027 (scalar rows) and 4096: bit for bit with at most one
    topic category, within RTOL where sqd sums four (cuBLAS's order)."""
    for b in (13, 80, 128):
        for d in (1000, 1027, 4096):
            case = check.finalize_case(b, d, seed=b + d + c, hot=hot, counts=counts,
                                       phrase=phrase, c=c, weights=weights, device=cuda)
            _finalize_agrees(case, exact=c <= 1)


@pytest.mark.parametrize("hot,counts,phrase", [(True, False, False), (True, True, False),
                                               (False, False, True), (False, True, False)])
@pytest.mark.parametrize("d", [1_250_000, 1_340_734])
def test_finalize_kernel_at_full_width(cuda, d, hot, counts, phrase):
    """The cells' widths at B=128 (1,340,734 is not a multiple of 4: the
    scalar rows), bit for bit, and the top-50 started from its chunk
    maxima equal to exact_top_k over the plain route's scores."""
    case = check.finalize_case(128, d, seed=d, hot=hot, counts=counts, phrase=phrase, device=cuda)
    final, cmax = _finalize_agrees(case, exact=True)
    want = check.run_finalize(case, plain=True)[0].contiguous()
    got = scoring.exact_top_k(final, 50, cmax=cmax)
    ref = scoring.exact_top_k(want, 50)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    del case, final, cmax, want
    torch.cuda.empty_cache()


@pytest.mark.parametrize("doc_sort", [False, True])
@pytest.mark.parametrize("lane", ["keyword", "keyword_counts", "mixed"])
def test_lanes_top50_identical_with_plain_finalize(cuda, corpus, indexes, doc_sort, lane,
                                                   monkeypatch):
    """score_queries_forward and score_queries_mixed (through the
    reference blend's model) on the card: the top-50 ids and scores with
    the finalize kernel equal those with its plain route, exactly."""
    idx = indexes[doc_sort]
    model = BlendedRanker()
    if lane == "mixed":
        batch = check.to_device(check.mixed_batch(idx, 128, 4, 16, seed=5, df=_df(corpus[1]),
                                                  snap=corpus[1]), cuda)
    else:
        batch = check.to_device(check.keyword_batch(idx, 128, 32, seed=6, df=_df(corpus[1])), cuda)
    qlen = batch["qn"].clamp(min=1).to(torch.float32)
    tp = torch.zeros((128, idx.n_categories), device=cuda)

    def rank():
        if lane == "mixed":
            return model.score_mixed(idx, batch["term_ids"], qlen, tp, batch["ph_ids"],
                                     batch["ph_valid"], topk=50, qn=batch["qn"], pn=batch["pn"],
                                     qnb=batch["qnb"], hot_sids=batch["hot_sids"])
        if lane == "keyword_counts":  # K1 emits its counts (an index with zero weights)
            return scoring.score_queries_forward(
                idx.title.fwd, idx.body.fwd, idx.mag_title, idx.mag_body, idx.pagerank,
                batch["term_ids"], qlen, tp, batch["qn"], batch["qnb"], batch["hot_sids"],
                idx.hot_body_w, idx.body.tmax_blocks, idx.doc_perm, topk=50, emit_counts=True)
        return model.score_keywords(idx, batch["term_ids"], qlen, tp, topk=50, qn=batch["qn"],
                                    qnb=batch["qnb"], hot_sids=batch["hot_sids"])

    n0 = fin.LAUNCHES
    got = rank()
    assert fin.LAUNCHES == n0 + 1
    monkeypatch.setattr(fin, "finalize_chunked", fin.plain_finalize_chunked)
    want = rank()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert bool(torch.isfinite(got[0]).any())


@pytest.mark.parametrize("name,kernel", [("lucene-mixed", "mixed_kernel"),
                                         ("nq-questions", "membership2_kernel")])
def test_traced_cell_one_finalize_and_membership_launch_a_batch(cuda, name, kernel):
    """A traced 1-second run of each benchmark cell at a tiny size: the
    membership kernel's roofline reader pairs one launch with each batch,
    the finalize kernel launches as often under its own base name, and
    every batch took the kernel route (the TRACER counters)."""
    from benchmark import devtrace, run, stages
    from spaghettisearch_tpu_torch.utils.timing import TRACER

    cell = run.load_cell(name)
    cell["config_data"].update(n_docs=2500, vocab_size=20000, body_words=60)

    def counts():
        rep = TRACER.report()
        return [rep.get(n, {}).get("count", 0) for n in
                ("scoring.finalize.kernel", "scoring.finalize.plain", "engine.launch")]

    n0 = counts()
    result, checks, ev = stages.stage_run(cell, 41, 1.0, "cuda")
    n1 = counts()
    assert result["correct"], checks
    # the reader is there only where its kernel's launches pair one to one
    # with the batches of its lane
    assert ("k2" if kernel == "mixed_kernel" else "k1") + ".roofline_pct" in result["metrics"]
    launches = sum(devtrace.kernel(ev, k)[0] for k in ("mixed_kernel", "membership2_kernel"))
    finalizes, _ = devtrace.kernel(ev, "finalize_kernel")
    assert launches >= devtrace.kernel(ev, kernel)[0] > 0 and finalizes == launches
    assert {devtrace.base_name(n) for n, _, _ in devtrace.in_window(ev) if "finalize" in n} == {
        "finalize_kernel"}
    assert n1[0] - n0[0] == n1[2] - n0[2] > 0 and n1[1] == n0[1]


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


@pytest.mark.parametrize("doc_sort", [False, True])
@pytest.mark.parametrize("b,q", [(13, 4), (45, 4), (128, 4), (256, 4), (128, 32)])
def test_fused_topk_kernel_matches_plain(cuda, corpus, indexes, doc_sort, b, q):
    idx = indexes[doc_sort]
    batch = check.to_device(
        check.keyword_batch(idx, b, q, seed=b + q, df=_df(corpus[1]), split=False), cuda
    )
    args = check.k5_inputs(idx, batch)
    n0 = k5.LAUNCHES
    got = check.run_k5(args)
    assert k5.LAUNCHES == n0 + 1
    rep = check.compare_topk(got, check.run_k5(args, plain=True))
    assert rep["ok"], rep
    assert rep["ranked"] > 0


@pytest.mark.parametrize("k_pad", [1, 16, 32])
@pytest.mark.parametrize("b", [16, 45, 77])
def test_fused_topk_kernel_adversarial(cuda, corpus, indexes, b, k_pad):
    """No-hit rows, rows with fewer hits than k_pad, 20 equal finals across
    the doc tiles (the k-th cut inside the tie), a duplicated term, B not a
    multiple of the row tile."""
    idx = indexes[False]
    args = check.topk_case(idx, b, seed=b, df=_df(corpus[1]))
    got = check.run_k5(args, k_pad)
    want = check.run_k5(args, k_pad, plain=True)
    rep = check.compare_topk(got, want)
    assert rep["ok"], rep
    assert not bool((want[0][0] > -float("inf")).any())  # no hit
    assert bool((want[0][1] == -float("inf")).any()) or k_pad == 1  # fewer than k_pad
    tie = want[0][2][want[0][2] > -float("inf")]
    assert len(tie) >= min(k_pad, 17) and bool((tie == tie[0]).all())  # a tie at the cut
    assert torch.equal(got[0][2], want[0][2]) and torch.equal(got[1][2], want[1][2])


@pytest.mark.parametrize("kind", check.ADVERSARIAL)
def test_fused_topk_kernel_on_probe_adversarial_batches(cuda, corpus, indexes, kind):
    idx = indexes[True]
    batch = check.to_device(
        check.adversarial_batch(idx, kind, seed=7, df=_df(corpus[1]), snap=corpus[1], b=128),
        cuda,
    )
    args = check.k5_inputs(idx, batch)
    rep = check.compare_topk(check.run_k5(args), check.run_k5(args, plain=True))
    assert rep["ok"], rep


@pytest.mark.parametrize("pos16", [True, False])
@pytest.mark.parametrize("emit_flag", [True, False])
@pytest.mark.parametrize("b,rows", [(16, None), (128, 16), (128, None)])
def test_phrase_delta_kernel_matches_plain(cuda, corpus, indexes, pos16, emit_flag, b, rows):
    idx = indexes[True]
    if not pos16:
        idx = dataclasses.replace(idx, **{
            s: dataclasses.replace(getattr(idx, s), posT=k2.deq_posT(getattr(idx, s).posT).contiguous())
            for s in ("title", "body")
        })
    batch = check.to_device(
        check.mixed_batch(idx, b, 4, 16, seed=b + 1, df=_df(corpus[1]), snap=corpus[1]), cuda
    )
    n0 = k6.LAUNCHES
    got = check.run_k6(idx, batch, emit_flag, rows)
    assert k6.LAUNCHES == n0 + 1
    rep = check.compare_delta(got, check.run_k6(idx, batch, emit_flag, rows, plain=True))
    assert rep["ok"], rep
    assert rep["matched"] > 0


@pytest.mark.parametrize("kind", check.ADVERSARIAL)
def test_phrase_delta_kernel_adversarial(cuda, corpus, indexes, kind):
    """The phrase halves of the probe-table batches (P=4: repeated phrase
    terms, invalid slots, the log's overflow and rescan, ragged tiles),
    with the flag, and K6's table build against its plain version."""
    idx = indexes[False]
    batch = check.to_device(
        check.adversarial_batch(idx, kind, seed=7, df=_df(corpus[1]), snap=corpus[1], b=128),
        cuda,
    )
    rep = check.compare_delta(check.run_k6(idx, batch, True),
                              check.run_k6(idx, batch, True, plain=True))
    assert rep["ok"], rep
    pad = k6.pad_column(batch["ph_ids"].shape[0], cuda)
    got = probe.cuda_tables(pad, None, None, batch["ph_ids"], batch["ph_valid"], sections=1)
    want = probe.plain_tables(pad, None, None, batch["ph_ids"], batch["ph_valid"], sections=1)
    assert got[2] == want[2]
    assert all(torch.equal(g, w) for g, w in zip((got[0], got[1], got[3]), (want[0], want[1], want[3])))


def test_phrase_delta_plus_keywords_is_the_mixed_kernel(cuda, corpus, indexes):
    """K1's scores plus K6's adds (the flag in the title count) equal K2's
    on the card, exactly: the two kernels share phrase.cuh."""
    idx = indexes[True]
    batch = check.to_device(
        check.mixed_batch(idx, 128, 4, 16, seed=5, df=_df(corpus[1]), snap=corpus[1]), cuda
    )
    mixed = check.run_k2(idx, batch, True)
    kw = check.run_k1(idx, batch, True, body_tmax=True)
    add_t, add_b, flag = check.run_k6(idx, batch, True)
    for got, want in zip(mixed, (kw[0] + add_t, kw[1] + flag, kw[2] + add_b, kw[3])):
        assert torch.equal(got, want)


@pytest.mark.parametrize("b", [1, 31, 33, 256, 257])
def test_fused_topk_kernel_batch_sizes(cuda, corpus, indexes, b):
    """Batches around the row tile (32) and the benchmark's B=256, with 20
    equal finals planted in docs spread over the doc axis, so blocks that
    own different doc ranges each hold some of the tie, and more of them
    than k_pad: within check.compare_topk's bar of the plain version, and
    the tie row exactly equal to it, cut by ascending doc id."""
    idx = indexes[False]
    args = check.topk_case(idx, max(b, 4), seed=b, df=_df(corpus[1]))
    if b == 1:  # the tie row alone
        args = (*args[:6], args[6][2:3].contiguous(), args[7][2:3].contiguous())
    got = check.run_k5(args)
    want = check.run_k5(args, plain=True)
    rep = check.compare_topk(got, want)
    assert rep["ok"], rep
    tie = 0 if b == 1 else 2
    assert torch.equal(got[0][tie], want[0][tie]) and torch.equal(got[1][tie], want[1][tie])
    assert bool((want[0][tie] == want[0][tie, 0]).all())  # the cut falls in the tie
    assert bool((want[1][tie][1:] > want[1][tie][:-1]).all())  # by ascending id


def _scattered(batch: dict, seed: int) -> dict:
    """The rows of a mixed batch in a seeded order (phrase rows no longer
    first)."""
    perm = torch.from_numpy(np.random.default_rng(seed).permutation(batch["ph_ids"].shape[0]))
    return {k: (v[perm.to(v.device)].contiguous() if isinstance(v, torch.Tensor) else v)
            for k, v in batch.items()}


@pytest.mark.parametrize("bp", [1, 16, 17, 64, 65, 128])
def test_phrase_delta_kernel_scattered_phrase_rows(cuda, corpus, indexes, bp):
    """K6 on the first bp rows of a B=128 mixed batch whose rows are in a
    seeded order, so phrase rows sit anywhere (the kernel's partition puts
    them first), with the flag: exact against the plain version, and the
    partition equal to plain_phrase_rows."""
    idx = indexes[True]
    batch = _scattered(check.to_device(
        check.mixed_batch(idx, 128, 4, 16, seed=11, df=_df(corpus[1]), snap=corpus[1]), cuda),
        seed=bp)
    rep = check.compare_delta(check.run_k6(idx, batch, True, bp),
                              check.run_k6(idx, batch, True, bp, plain=True))
    assert rep["ok"], rep
    ph_ids, ph_valid = batch["ph_ids"][:bp].contiguous(), batch["ph_valid"][:bp].contiguous()
    got, want = k6.cuda_phrase_rows(ph_ids, ph_valid), k6.plain_phrase_rows(ph_ids, ph_valid)
    assert got[3] == want[3] and all(torch.equal(g, w) for g, w in zip(got[:3], want[:3]))
    if bp >= 16:
        assert 0 < got[3] < bp and rep["matched"] > 0


def _with_planes(index, c: int, pos16: bool):
    """The index with c position planes per section: the first c of its
    own, then copies of its first plane (a repeated position changes no
    chain); int16 or their f32 dequantization."""
    out = {}
    for s in ("title", "body"):
        sec = getattr(index, s)
        t = sec.fwd.ftT.shape[0]
        pos = sec.posT.view(-1, t, sec.posT.shape[1])
        planes = [pos[i if i < pos.shape[0] else 0] for i in range(c)]
        pos = torch.stack(planes).reshape(c * t, -1).contiguous()
        out[s] = dataclasses.replace(sec, posT=pos if pos16 else k2.deq_posT(pos).contiguous())
    return dataclasses.replace(index, **out)


@pytest.mark.parametrize("flag", [True, False])
@pytest.mark.parametrize("pos16", [True, False])
@pytest.mark.parametrize("c", [1, 3, 7, 8, 9, 32])
def test_phrase_delta_kernel_plane_buckets(cuda, corpus, indexes, c, pos16, flag):
    """K6 at plane counts on each side of every compiled bucket (4, 8, 16,
    32), int16 and f32 planes, with and without the flag, on the B=128
    mixed batch and on log_full at B=16 (docs whose phrase hits overflow
    the log: the rescan): exact against the plain version."""
    idx = _with_planes(indexes[False], c, pos16)
    assert k6.plane_bucket(c) >= c
    for batch in (
        check.mixed_batch(idx, 128, 4, 16, seed=c, df=_df(corpus[1]), snap=corpus[1]),
        check.adversarial_batch(idx, "log_full", seed=8, df=_df(corpus[1]), snap=corpus[1], b=16),
    ):
        batch = check.to_device(batch, cuda)
        rep = check.compare_delta(check.run_k6(idx, batch, flag),
                                  check.run_k6(idx, batch, flag, plain=True))
        assert rep["ok"], (c, rep)


def test_probe_wrappers_reject_bad_inputs(cuda, indexes):
    idx = indexes[False]
    b = 8
    tq = torch.zeros((b, 4), dtype=torch.int32, device=cuda)
    args = check.k5_inputs(idx, {"term_ids": tq, "qn": torch.ones(b, dtype=torch.int32,
                                                                  device=cuda)})
    with pytest.raises(ValueError):
        k5.fused_topk(*args, k5.K_MAX + 1)
    with pytest.raises(ValueError):
        k5.fused_topk(*args[:6], tq.long(), args[7])
    ph = torch.zeros((b, k2.P_MAX + 1), dtype=torch.int32, device=cuda)
    fwd = (idx.title.fwd.ftT, idx.title.fwd.fwT, idx.body.fwd.ftT, idx.body.fwd.fwT,
           idx.title.posT, idx.body.posT)
    with pytest.raises(ValueError):
        k6.phrase_delta(*fwd, ph, ph.float(), ph[:, 0])
    with pytest.raises(ValueError):
        k6.phrase_delta(*fwd, ph[:, :4], ph[:, :4].float(), ph[:4, 0])
    wide = _with_planes(idx, k2.C_MAX + 1, True)  # planes past the largest bucket
    with pytest.raises(ValueError):
        k6.phrase_delta(*fwd[:4], wide.title.posT, wide.body.posT, ph[:, :4],
                        ph[:, :4].float(), ph[:, 0])


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
    queries = bench_queries(snap, 64, seed=3, phrase_every=4, db=db)
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
    queries = bench_queries(snap, 64, seed=5, phrase_every=4, db=db)
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
    queries = bench_queries(snap, 64, seed=6, phrase_every=4, db=db)
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


# --- the offline build path: PageRank and the crawl CLI on the card ------------

def _pagerank_inputs(model: str, n: int = 3000, c: int = 16, seed: int = 0):
    """A seeded 3,000-node graph (0-7 uniform out-links per node, plus hubs
    with long in-edge runs and dangling nodes), destination-sorted, and the
    model's per-category input (numPages, or [C, N] personalization)."""
    rng = np.random.default_rng(seed)
    n_links = rng.integers(0, 8, n)
    dst = rng.integers(0, n, int(n_links.sum()))
    dst[rng.random(len(dst)) < 0.05] = rng.integers(0, 8)  # hubs
    src = np.repeat(np.arange(n), n_links)
    order = np.argsort(dst, kind="stable")
    outdeg = n_links.astype(np.float64)
    if model == "power":
        extra = np.array([float(n), n / 2.0])
    else:
        extra = rng.random((c, n)) * (rng.random((c, n)) < 0.05)
        extra[0] = 1.0
        extra /= extra.sum(axis=1, keepdims=True)
    return src[order].astype(np.int32), dst[order].astype(np.int32), outdeg, extra


def _pagerank(model, inputs, device, dtype):
    from spaghettisearch_tpu_torch.ops import pagerank as pr

    src, dst, outdeg, extra = inputs
    fn = pr.pagerank_power if model == "power" else pr.pagerank_personalized
    stats: dict = {}
    ranks = fn(torch.as_tensor(src, device=device), torch.as_tensor(dst, device=device),
               torch.as_tensor(outdeg, dtype=dtype, device=device),
               torch.as_tensor(extra, dtype=dtype, device=device), len(outdeg), stats=stats)
    return ranks.cpu().numpy(), stats["iterations"]


@pytest.mark.parametrize("model", ["power", "personalized"])
def test_pagerank_on_cuda_matches_cpu_float64(cuda, model):
    inputs = _pagerank_inputs(model)
    got, _ = _pagerank(model, inputs, cuda, torch.float32)
    want, _ = _pagerank(model, inputs, "cpu", torch.float64)
    assert got.dtype == np.float32 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("model", ["power", "personalized"])
def test_pagerank_on_cuda_is_repeatable(cuda, model):
    """The segmented sum adds each node's in-edges in one order: two runs
    give bit-identical float32 ranks after the same iteration count."""
    inputs = _pagerank_inputs(model, seed=1)
    (a, ia), (b, ib) = (_pagerank(model, inputs, cuda, torch.float32) for _ in range(2))
    assert ia == ib and np.array_equal(a.view(np.uint32), b.view(np.uint32))


def test_crawl_cli_on_cuda(cuda, tmp_path):
    """The crawl CLI on the card over a 200-page local site and a small ODP
    directory: every page indexed, topic PageRank on the card equal to
    float64 on the CPU, and the saved snapshot serves on the card."""
    from spaghettisearch_tpu_torch.cli import crawl as crawl_cli
    from spaghettisearch_tpu_torch.corpus import render_pages
    from spaghettisearch_tpu_torch.crawl.localsite import LocalSite
    from spaghettisearch_tpu_torch.index.persist import load_snapshot
    from spaghettisearch_tpu_torch.ops.pagerank import update_pagerank
    from spaghettisearch_tpu_torch.store.tables import Database

    pages = render_pages(n_pages=200, n_vocab=2000, seed=3)
    pages["/"] = ("<html><body>" + "".join(f'<a href="/p{i}">p</a>' for i in range(200))
                  + "</body></html>").encode()
    with LocalSite(pages, last_modified="Thu, 01 Jan 2026 00:00:00 GMT") as site:
        cats = "".join(f'<li><a href="/C{k}">C{k}</a></li>' for k in range(4))
        odp = {"/": f'<html><body><div class="container"><ul id="triple">{cats}</ul></div>'
                    f"</body></html>".encode()}
        for k in range(4):
            res = "".join(f'<li class="listings"><h4><a href="{site.base}/p{j}">r</a></h4></li>'
                          for j in range(k, 200, 23))
            odp[f"/C{k}"] = (f'<html><body><div class="container"><ul>{res}</ul></div>'
                             f"</body></html>").encode()
        with LocalSite(odp) as directory:
            crawl_cli.main(["--startURL", site.base + "/", "--numPages", "201", "--db",
                            str(tmp_path / "db"), "--odpURL", directory.base + "/",
                            "--topicPagerank", "--saveSnapshot", str(tmp_path / "snap")])
    db = Database(str(tmp_path / "db"))
    assert len(db.doc_info) >= 201 and len(db.topic_meta) == 4
    got = {k: v for k, v in db.doc_rank.items()}
    update_pagerank(db, personalized=True, device="cpu", dtype=torch.float64)
    want = {k: v for k, v in db.doc_rank.items()}
    assert got.keys() == want.keys() and len(got) >= 201
    for k in want:
        np.testing.assert_allclose([got[k][c] for c in sorted(want[k])],
                                   [want[k][c] for c in sorted(want[k])], rtol=1e-5, atol=1e-9)
    snap = load_snapshot(str(tmp_path / "snap"))
    eng = QueryEngine(db, snapshot=snap, device=cuda, use_topic_model=True)
    queries = bench_queries(snap, 16, seed=1, phrase_every=4, db=db)
    _engines_agree(eng, QueryEngine(db, snapshot=snap, device="cpu", use_topic_model=True),
                   [parse_query(q) for q in queries], queries)
    db.close()


# --- the doc-sharded mesh on the card --------------------------------------------

@pytest.mark.parametrize("n_shards,n_rows", [(2, 1), (4, 1), (2, 2)])
def test_sharded_engine_on_cuda_matches_cpu(cuda, corpus, n_shards, n_rows):
    """The mesh's shards all on the card: a mixed batch (K2 once per shard
    and query row), a keyword batch (K1 likewise) and a 5-query batch (16
    rows: 8 per query row on the 2-D mesh) rank as the same mesh on the
    CPU."""
    from spaghettisearch_tpu_torch.retrieval.sharded_engine import ShardedQueryEngine

    db, snap = corpus
    n_dev = n_shards * n_rows
    kw = dict(snapshot=snap, n_shards=n_shards, n_query_rows=n_rows)
    eng_gpu = ShardedQueryEngine(db, devices=[cuda] * n_dev, **kw)
    eng_cpu = ShardedQueryEngine(db, device="cpu", **kw)
    assert all(sh.device.type == "cuda" for row in eng_gpu.index.sidx.rows for sh in row)
    queries = bench_queries(snap, 64, seed=7, phrase_every=4, db=db)
    parsed = [parse_query(q) for q in queries]
    assert eng_gpu._use_mixed(eng_gpu.index.sidx, parsed)
    k1.reset_launches()
    k2.reset_launches()
    _engines_agree(eng_gpu, eng_cpu, parsed, queries)
    assert k2.LAUNCHES == n_dev and k1.LAUNCHES == 0
    kw_rows = [i for i, p in enumerate(parsed) if not p.phrase_hashes]
    _engines_agree(eng_gpu, eng_cpu, [parsed[i] for i in kw_rows], [queries[i] for i in kw_rows])
    assert k1.LAUNCHES == n_dev
    _engines_agree(eng_gpu, eng_cpu, [parsed[i] for i in kw_rows[:5]],
                   [queries[i] for i in kw_rows[:5]])
    assert k1.LAUNCHES == 2 * n_dev


def test_sharded_pagerank_on_cuda_matches_cpu(cuda):
    from spaghettisearch_tpu_torch.parallel.mesh import make_mesh
    from spaghettisearch_tpu_torch.parallel.sharded import sharded_pagerank

    src, dst, outdeg, extra = _pagerank_inputs("power")
    args = (src, dst, outdeg.astype(np.float32), extra.astype(np.float32), len(outdeg))
    got = sharded_pagerank(make_mesh(4, devices=[cuda] * 4), *args)
    assert got.device.type == "cuda"
    want = sharded_pagerank(make_mesh(4, devices=["cpu"] * 4), *args).numpy()
    np.testing.assert_allclose(got.cpu().numpy(), want, rtol=1e-5, atol=1e-9)


def test_server_cli_mesh_on_cuda(cuda, tmp_path, monkeypatch):
    """`cli.server --device cuda:0 --meshShards 2`: both shards on the card,
    and a POST /query answers with the CPU mesh's results."""
    import json
    import urllib.request

    from spaghettisearch_tpu_torch.cli import server as cli
    from spaghettisearch_tpu_torch.retrieval.sharded_engine import ShardedQueryEngine

    write_corpus(str(tmp_path / "db"), n_pages=300, n_vocab=2000, seed=1).close()
    started = []

    class Background(cli.SearchServer):
        def serve(self, port=8080, host="127.0.0.1"):
            started.append(self)
            self.base = "http://%s:%d" % self.start_background(port=0)

    monkeypatch.setattr(cli, "SearchServer", Background)
    cli.main(["--db", str(tmp_path / "db"), "--device", "cuda:0", "--meshShards", "2"])
    server = started[0]
    try:
        assert [sh.device.type for sh in server.engine.index.sidx.shards] == ["cuda", "cuda"]
        q = "w00100 w00200"
        req = urllib.request.Request(server.base + "/query", data=json.dumps({"query": q}).encode(),
                                     headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            assert r.status == 200
            got = json.loads(r.read())
        want = ShardedQueryEngine(server.engine.db, n_shards=2, device="cpu").query(q)
        rows = [[(r["Url"], r["FinalRank"]) for r in res] for res in (got, want)]
        assert got and _same_up_to_ties(*rows)
        np.testing.assert_allclose([s for _, s in rows[0]], [s for _, s in rows[1]], rtol=1e-6)
    finally:
        server.shutdown()
        server.engine.db.close()


# --- the live index and the graft entry points on the card ----------------------

def _append_marked(db, n: int, marker: str, seed: int) -> list[str]:
    """Index n make_page pages into db, each titled with `marker` too and
    linking nowhere (so no stub docs). -> their URLs."""
    import random
    from datetime import datetime, timezone

    from spaghettisearch_tpu_torch.corpus import make_page
    from spaghettisearch_tpu_torch.index.indexer import index_page

    rng = random.Random(seed)
    urls = []
    for i in range(n):
        url, html = make_page(rng, i, 1, f"http://append{seed}.local")
        index_page(db, html.replace(b"<title>", f"<title>{marker} ".encode(), 1), url,
                   last_modified=datetime(2026, 2, 1, tzinfo=timezone.utc))
        urls.append(url)
    return urls


def test_engine_refresh_on_cuda(cuda, tmp_path):
    """refresh() on the card picks up appended docs, and the refreshed
    engine ranks as the CPU engine (the plain versions) on the same store."""
    db = write_corpus(str(tmp_path / "db"), n_pages=600, n_vocab=3000, seed=2)
    eng = QueryEngine(db, device=cuda)
    n0 = eng.index.n_docs
    urls = _append_marked(db, 10, "zzmarkerone", seed=1)
    eng.refresh()
    assert eng.index.n_docs == n0 + 10 and eng.index.title.fwd.ftT.device.type == "cuda"
    assert sorted(r["Url"] for r in eng.query("zzmarkerone")) == sorted(urls)
    queries = bench_queries(eng.snapshot, 48, seed=4, phrase_every=4, db=eng.db)
    parsed = [parse_query(q) for q in queries]
    k2.reset_launches()
    _engines_agree(eng, QueryEngine(eng.db, snapshot=eng.snapshot, device="cpu"), parsed, queries)
    assert k2.LAUNCHES >= 1
    eng.db.close()


def test_refresh_frees_device_memory(cuda, tmp_path):
    """Three /refresh swaps under the batching server, a query after each:
    the device memory left allocated stays below its level before the first
    refresh plus half the index (an old index kept alive adds a whole one)."""
    import gc

    from spaghettisearch_tpu_torch.serve.server import SearchServer

    db = write_corpus(str(tmp_path / "db"), n_pages=3000, n_vocab=8000, seed=3)
    srv = SearchServer(QueryEngine(db, device=cuda), batching=True, max_wait_ms=0.5)
    try:
        for q in ("w00100 w00200", '"w00100 w00200"'):
            srv.handle_query(q)
        gc.collect()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        index_bytes = srv.engine.index.device_bytes()
        for k in range(3):
            _append_marked(srv.engine.db, 10, f"zzmark{k}", seed=10 + k)
            r = srv.handle_refresh()
            assert r["ok"] and r["docs"] == srv.engine.index.n_docs == 3000 + 10 * (k + 1)
            assert len(srv.handle_query(f"zzmark{k}")) == 10
        srv.handle_query('"w00100 w00200"')
        gc.collect()
        torch.cuda.synchronize()
        after = torch.cuda.memory_allocated()
        assert after < before + index_bytes / 2, (before, after, index_bytes)
    finally:
        srv.batcher.shutdown()
        srv.engine.db.close()


def test_entry_on_cuda_matches_cpu(cuda):
    from spaghettisearch_tpu_torch.graft_entry import entry

    fn, args = entry("cuda")
    assert all(a.device.type == "cuda" for a in args)
    k2.reset_launches()
    got = fn(*args)
    assert k2.LAUNCHES == 1
    cfn, cargs = entry("cpu")
    want = cfn(*cargs)
    for row in range(8):
        g = [(int(d), float(s)) for s, d in zip(*(t[row].cpu().numpy() for t in got)) if np.isfinite(s)]
        w = [(int(d), float(s)) for s, d in zip(*(t[row].numpy() for t in want)) if np.isfinite(s)]
        assert _same_up_to_ties(g, w), row
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w], rtol=1e-6)


def test_dryrun_multichip_on_cuda(cuda):
    from spaghettisearch_tpu_torch.graft_entry import dryrun_multichip

    k1.reset_launches()
    k2.reset_launches()
    out = dryrun_multichip(2)
    assert out["scores"].device.type == "cuda" and out["ranks"].device.type == "cuda"
    # the scorer's batch runs K1 once per shard, the HTTP query K2
    assert min(k1.LAUNCHES, k2.LAUNCHES) >= 2 and k1.LAUNCHES % 2 == k2.LAUNCHES % 2 == 0
    want = dryrun_multichip(2, devices=["cpu"] * 2)
    for row in range(2):
        g = [(int(d), float(s)) for s, d in zip(out["scores"][row].cpu().numpy(),
                                                 out["ids"][row].cpu().numpy()) if np.isfinite(s)]
        w = [(int(d), float(s)) for s, d in zip(want["scores"][row].numpy(),
                                                 want["ids"][row].numpy()) if np.isfinite(s)]
        assert g and _same_up_to_ties(g, w), row
    np.testing.assert_allclose(out["ranks"].cpu().numpy(), want["ranks"].numpy(), rtol=1e-5)
    rows = [[(r["Url"], r["FinalRank"]) for r in res] for res in (out["results"], want["results"])]
    assert _same_up_to_ties(*rows)


def test_shard_scale_probe_slice_on_cuda(cuda, corpus):
    """experiments/torch_shard_scale_probe.py's 8-shard slice (the first 512
    docs of the 3,000-page corpus) on the card: its kw-128 batch's top-50
    through the kernels equals the plain path's (check.compare_topk), and
    K1 and K2 launched on its three batches."""
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                    "experiments"))
    import torch_shard_scale_probe as probe

    db, snap = corpus
    res = probe.run(snap, db, cuda, reps=1, say=lambda msg: None, shards=(8,))
    r = res["shards8"]
    assert res["ok"] and r["local_docs"] == 512
    assert r["kw128_vs_plain"]["ok"] and r["kw128_vs_plain"]["ranked"] > 0
    assert r["launches"]["K1"] > 0 and r["launches"]["K2"] > 0 and r["merge_ms"] > 0
