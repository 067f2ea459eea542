"""BM25 ranking model on torch (the counterpart of
spaghettisearch_tpu/models/bm25.py).

Okapi BM25 over the same columnar index: the per-posting term frequency is
the position-list length already stored in the CSR, doc length the per-doc
tf sum, so the full BM25 weight

    idf = ln((N - df + 0.5) / (df + 0.5) + 1)
    w   = idf * tf*(k1+1) / (tf + k1*(1 - b + b*dl/avgdl))

is precomputed per posting at prepare time. Keyword scoring reuses kernel K1
over BM25 forward tiles (counts always elided: every BM25 weight is > 0),
and the sparse phrase lane's matcher sums the BM25 posting weights. BM25
has no fused mixed lane (no supports_mixed): every phrase query takes the
sparse lane.

Sections combine as weighted field scores (BM25F-lite):
    final = title_boost * S_title + body_boost * S_body
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np
import torch

from ..index.snapshot import IndexSnapshot, SectionCSR
from ..ops import scoring as _scoring
from ..ops.kernels import membership as _k1
from ..utils.timing import TRACER


def bm25_posting_weights(
    csr: SectionCSR, n_docs: int, k1: float = 1.2, b: float = 0.75
) -> np.ndarray:
    """Per-posting BM25 weight array (padded slots stay 0)."""
    n_post = csr.n_postings
    p_pad = csr.doc_ids.shape[0]
    out = np.zeros(p_pad, np.float32)
    if n_post == 0 or n_docs == 0:
        return out
    tf = np.diff(csr.pos_offsets[: n_post + 1]).astype(np.float64)
    df = np.diff(csr.post_offsets).astype(np.float64)
    word_of_post = np.repeat(
        np.arange(df.shape[0], dtype=np.int64), np.diff(csr.post_offsets)
    )
    doc_len = np.zeros(n_docs + 1, np.float64)
    np.add.at(doc_len, csr.doc_ids[:n_post], tf)
    avgdl = max(doc_len[:n_docs].sum() / n_docs, 1e-9)
    idf = np.log((n_docs - df + 0.5) / (df + 0.5) + 1.0)
    dl = doc_len[csr.doc_ids[:n_post]]
    out[:n_post] = (
        idf[word_of_post] * tf * (k1 + 1.0) / (tf + k1 * (1.0 - b + b * dl / avgdl))
    ).astype(np.float32)
    return out


def _bm25_finalize(ts, bs, candidate, title_boost: float, body_boost: float):
    with TRACER.range("scoring.finalize"):
        final = title_boost * ts + body_boost * bs
        return torch.where(candidate, final, torch.full_like(final, -float("inf")))


@dataclass
class BM25Ranker:
    """Drop-in ranking model for QueryEngine(model=BM25Ranker()).

    PageRank/topic blending is intentionally absent: BM25 is the pure
    lexical alternative; use BlendedRanker for the reference formula."""

    k1: float = 1.2
    b: float = 0.75
    title_boost: float = 2.0
    body_boost: float = 1.0
    topk: int = 50
    _fwd: dict = field(default_factory=dict, repr=False)

    # -- engine hooks -------------------------------------------------- #
    def prepare(self, snapshot: IndexSnapshot, index, device=None) -> None:
        """Build BM25 forward weight tiles aligned with the DeviceIndex's
        doc layout (same snapshot => same doc/term slots; under the
        doc-sorted layout the index's doc permutation is applied so the doc
        axes line up). BM25 keeps the static-T sweep: its tiles carry their
        own T, padded by forward_with_postings alone."""
        from ..retrieval.device_index import ForwardArrays

        dev = index.device if device is None else torch.device(device)

        def put(x: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

        self._fwd = {}
        for name in ("title", "body"):
            csr: SectionCSR = getattr(snapshot, name)
            w = bm25_posting_weights(csr, snapshot.n_docs, self.k1, self.b)
            ft, fw, fj = replace(csr, weights=w).forward_with_postings(snapshot.n_docs)
            pad_rows = index.n_docs_padded - snapshot.n_docs
            ft = np.concatenate([ft, np.full((pad_rows, ft.shape[1]), -1, np.int32)])
            fw = np.concatenate([fw, np.zeros((pad_rows, fw.shape[1]), np.float32)])
            fj = np.concatenate(
                [fj, np.full((pad_rows, fj.shape[1]), csr.doc_ids.shape[0] - 1, np.int32)]
            )
            if index.doc_perm_np is not None:
                perm = index.doc_perm_np
                ft, fw, fj = ft[perm], fw[perm], fj[perm]
            self._fwd[name] = ForwardArrays(
                ft=put(ft), fw=put(fw), fj=put(fj), ftT=put(ft.T), fwT=put(fw.T),
            )
            # padded posting-weight vector for the phrase matcher
            self._fwd[name + "_w"] = put(w)

    def phrase_weights(self, index):
        """Posting-weight arrays the phrase matcher sums (ft/fj are
        weight-independent, so the engine keeps using the index's)."""
        return self._fwd["title_w"], self._fwd["body_w"]

    # -- scoring ------------------------------------------------------- #
    def _sections(self, term_ids, qn=None):
        """-> (title score, body score) [B, D]. BM25 weights are strictly
        positive (idf = ln(x+1) > 0, tf term > 0), so the counts are always
        elided (candidacy <=> score > 0); no hot split, no body_tmax."""
        t, b = self._fwd["title"], self._fwd["body"]
        with TRACER.range("scoring.kernel"):
            ts, _, bs, _ = _k1.forward_scores_2sec(
                t.ftT, t.fwT, b.ftT, b.fwT, term_ids, qn, emit_counts=False,
            )
        return ts, bs

    def score_keywords(self, index, term_ids, qlen, topic_probs, topk=None, qn=None):
        k = min(topk or self.topk, index.n_docs) or 1
        ts, bs = self._sections(term_ids, qn)
        with TRACER.range("scoring.counts"):
            candidate = ts + bs > 0
        final = _bm25_finalize(ts, bs, candidate, self.title_boost, self.body_boost)
        return _scoring.exact_top_k(final, k, doc_map=index.doc_perm)

    def score_csr(
        self, index, term_ids, qlen, topic_probs,
        ph_docs=None, ph_tw=None, ph_bw=None, ph_fl=None, topk=None,
    ):
        """Exact CSR scoring with BM25 posting weights (the production route
        when the dense forward view was truncated by doc_term_cap)."""
        k = min(topk or self.topk, index.n_docs) or 1
        if ph_docs is None:
            ph_docs, ph_tw, ph_bw, ph_fl = _scoring.empty_phrase_fold(
                term_ids.shape[0], index.match_pad, term_ids.device
            )
        ts, tc, bs, bc = _scoring.csr_scores(
            index.title.offsets, index.title.doc_ids, self._fwd["title_w"],
            index.body.offsets, index.body.doc_ids, self._fwd["body_w"],
            term_ids, ph_docs, ph_tw, ph_bw, ph_fl,
            posting_cap=index.posting_cap, n_docs=index.match_pad,
        )
        with TRACER.range("scoring.counts"):
            candidate = tc + bc > 0
        final = _bm25_finalize(ts, bs, candidate, self.title_boost, self.body_boost)
        return _scoring.exact_top_k(final, k, doc_map=index.doc_perm)

    def score_with_phrase(
        self, index, term_ids, qlen, topic_probs,
        ph_docs, ph_tw, ph_bw, ph_fl, topk=None, qn=None,
    ):
        k = min(topk or self.topk, index.n_docs) or 1
        ts, bs = self._sections(term_ids, qn)
        pacc = _scoring.phrase_fold(ts.shape[1], ph_docs, ph_tw, ph_bw, ph_fl)
        with TRACER.range("scoring.counts"):
            candidate = (ts + bs + pacc[:, :, 0] + pacc[:, :, 1] > 0) | (pacc[:, :, 2] > 0)
        with TRACER.range("scoring.fold"):
            ts, bs = ts + pacc[:, :, 0], bs + pacc[:, :, 1]
        final = _bm25_finalize(ts, bs, candidate, self.title_boost, self.body_boost)
        return _scoring.exact_top_k(final, k, doc_map=index.doc_perm)
