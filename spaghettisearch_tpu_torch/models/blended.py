"""The flagship ranking model: PageRank-blended vector-space cosine.

The counterpart of spaghettisearch_tpu/models/blended.py:
FinalRank = (w_pagerank*sqd + w_title*title + w_body*body) * scale,
cosine-normalized per section, candidates only. Device scoring goes to
ops/scoring.py: the reference blend on kernels K1 (keywords, with the sparse
phrase fold) and K2 (the fused mixed lane); custom blends score each section
with kernel K3 (_custom_score); score_csr is the exact CSR route for
dense-truncated indexes.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..config import MAX_RESULTS, SCORE_SCALE, W_BODY, W_PAGERANK, W_TITLE

from ..ops import scoring as _scoring
from ..ops.kernels import finalize as _fin
from ..ops.kernels import membership as _k1
from ..utils.timing import TRACER


@dataclass(frozen=True)
class BlendedRanker:
    w_pagerank: float = W_PAGERANK
    w_title: float = W_TITLE
    w_body: float = W_BODY
    scale: float = SCORE_SCALE
    topk: int = MAX_RESULTS

    def is_reference_blend(self) -> bool:
        return (
            self.w_pagerank == W_PAGERANK
            and self.w_title == W_TITLE
            and self.w_body == W_BODY
            and self.scale == SCORE_SCALE
        )

    def _weights(self) -> tuple[float, float, float, float]:
        return (self.w_pagerank, self.w_title, self.w_body, self.scale)

    def supports_hot(self, index) -> bool:
        """True when the hot-term dense body-weight cache can serve this
        (index, model): the cache exists and the blend is the reference."""
        return index.hot_body_w is not None and self.is_reference_blend()

    def _hot_args(self, index, term_ids, qn, qnb, hot_sids):
        """Normalize the hot-split arguments: when the index carries the hot
        cache, missing qnb/hot_sids default to the no-split values (qnb=qn
        or full width, hot_sids all -1)."""
        if not self.supports_hot(index):
            return None, None, None
        b, q = term_ids.shape
        dev = term_ids.device
        if qnb is None:
            qnb = qn if qn is not None else torch.full((b,), q, dtype=torch.int32, device=dev)
        if hot_sids is None:
            hot_sids = torch.full((b, q), -1, dtype=torch.int32, device=dev)
        return qnb, hot_sids, index.hot_body_w

    def score_keywords(
        self, index, term_ids, qlen, topic_probs, topk=None, qn=None,
        qnb=None, hot_sids=None,
    ):
        """Keyword batch -> (scores [B, K], doc ids [B, K]) on device. qn is
        the per-row active term count (batch sorted descending by it)."""
        k = min(topk or self.topk, index.n_docs) or 1
        if not self.is_reference_blend():
            return self._custom_forward(index, term_ids, qlen, topic_probs, k, qn)
        qnb, hot_sids, hot_w = self._hot_args(index, term_ids, qn, qnb, hot_sids)
        return _scoring.score_queries_forward(
            index.title.fwd, index.body.fwd,
            index.mag_title, index.mag_body, index.pagerank,
            term_ids, qlen, topic_probs, qn, qnb, hot_sids, hot_w,
            index.body.tmax_blocks, index.doc_perm, topk=k,
            emit_counts=index.has_zero_weight,
        )

    def score_with_phrase(
        self, index, term_ids, qlen, topic_probs,
        ph_docs, ph_tw, ph_bw, ph_fl, topk=None, qn=None,
        qnb=None, hot_sids=None,
    ):
        """Keyword batch + the sparse phrase lane's host-compressed matches
        (ph_* [B, E], pad doc n_docs_padded) folded in before finalize."""
        k = min(topk or self.topk, index.n_docs) or 1
        if not self.is_reference_blend():
            return self._custom_forward(
                index, term_ids, qlen, topic_probs, k, qn, (ph_docs, ph_tw, ph_bw, ph_fl)
            )
        qnb, hot_sids, hot_w = self._hot_args(index, term_ids, qn, qnb, hot_sids)
        return _scoring.score_queries_forward_phrase(
            index.title.fwd, index.body.fwd,
            index.mag_title, index.mag_body, index.pagerank,
            term_ids, qlen, topic_probs,
            ph_docs, ph_tw, ph_bw, ph_fl, qn, qnb, hot_sids, hot_w,
            index.body.tmax_blocks, index.doc_perm, topk=k,
            emit_counts=index.has_zero_weight,
        )

    def supports_mixed(self, index) -> bool:
        """True when the fused mixed lane can serve this (index, model): the
        index carries the doc-major position planes and the blend is the
        reference formula."""
        return index.pos_dense and not index.dense_truncated and self.is_reference_blend()

    def score_mixed(
        self, index, term_ids, qlen, topic_probs,
        ph_ids, ph_valid, topk=None, qn=None, pn=None,
        qnb=None, hot_sids=None,
    ):
        """Fused keyword + phrase lane: one mixed-kernel pass per batch
        (supports_mixed gates it on the reference blend)."""
        k = min(topk or self.topk, index.n_docs) or 1
        qnb, hot_sids, hot_w = self._hot_args(index, term_ids, qn, qnb, hot_sids)
        # no body_tmax: the engine's mixed lane runs the static sweep (the
        # JAX package measured the bounded variant regressing this lane)
        return _scoring.score_queries_mixed(
            index.title.fwd, index.body.fwd,
            index.title.posT, index.body.posT,
            index.mag_title, index.mag_body, index.pagerank,
            term_ids, qlen, topic_probs, ph_ids, ph_valid, qn, pn,
            qnb, hot_sids, hot_w, index.doc_perm,
            topk=k,
            emit_counts=index.has_zero_weight,
        )

    def score_csr(
        self, index, term_ids, qlen, topic_probs,
        ph_docs=None, ph_tw=None, ph_bw=None, ph_fl=None, topk=None,
    ):
        """Exact CSR gather/scatter scoring (with the optional phrase fold).

        The production route whenever the dense forward view was truncated
        (index.dense_truncated): the CSR holds every posting, so scores and
        candidacy of the >doc_term_cap documents stay exact."""
        k = min(topk or self.topk, index.n_docs) or 1
        if ph_docs is None:
            ph_docs, ph_tw, ph_bw, ph_fl = _scoring.empty_phrase_fold(
                term_ids.shape[0], index.match_pad, term_ids.device
            )
        blend = None if self.is_reference_blend() else self._weights()
        # doc-sorted layout: the device doc_ids live in permuted space over
        # [0, d_pad), so the scatter bound is match_pad and ids map back
        return _scoring.score_queries(
            index.title.offsets, index.title.doc_ids, index.title.weights,
            index.body.offsets, index.body.doc_ids, index.body.weights,
            index.mag_title, index.mag_body, index.pagerank,
            term_ids, qlen, topic_probs,
            ph_docs, ph_tw, ph_bw, ph_fl, blend, index.doc_perm,
            posting_cap=index.posting_cap, topk=k, n_docs=index.match_pad,
        )

    def _custom_forward(self, index, term_ids, qlen, topic_probs, k, qn=None, phrase=None):
        if phrase is None:
            phrase = _scoring.empty_phrase_fold(
                term_ids.shape[0], index.n_docs_padded, term_ids.device
            )
        return _custom_score(
            index.title.fwd, index.body.fwd, index.mag_title, index.mag_body,
            index.pagerank, self._weights(), term_ids, qlen, topic_probs, *phrase,
            index.doc_perm, qn=qn, topk=k,
        )


def _custom_score(
    title_fwd, body_fwd,  # ForwardArrays
    mag_t, mag_b, pagerank,
    weights,  # (w_pagerank, w_title, w_body, scale)
    term_ids, qlen, topic_probs,
    ph_docs, ph_tw, ph_bw, ph_fl,
    doc_map=None,
    *,
    qn=None,
    topk: int,
):
    """A custom blend's ranking: each section through kernel K3 (with
    counts) over the full term tile (no hot fold: custom blends never take
    the hot split), then the phrase fold's add, the weighted finalize
    (kernels/finalize.py) and the exact top-k."""
    with TRACER.range("scoring.kernel"):
        ts, tc = _k1.forward_scores(title_fwd.ftT, title_fwd.fwT, term_ids, qn)
        bs, bc = _k1.forward_scores(body_fwd.ftT, body_fwd.fwT, term_ids, qn)
    pacc = _scoring.phrase_fold(ts.shape[1], ph_docs, ph_tw, ph_bw, ph_fl)
    final, cmax = _fin.finalize_chunked(
        ts, tc, bs, bc, mag_t, mag_b, pagerank, qlen, topic_probs, weights, phrase=pacc,
    )
    return _scoring.exact_top_k(final, topk, doc_map=doc_map, cmax=cmax)
