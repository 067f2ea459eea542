"""Batched query scoring on torch: the device half of the online path.

The counterpart of spaghettisearch_tpu/ops/scoring.py. Three formulations
share one finalization (cosine normalize -> PageRank blend -> candidate
mask -> exact top-k), which runs with the hot fold's add, the candidacy
and the top-k's chunk maxima as one kernel on the card
(kernels/finalize.py finalize_chunked; finalize_scores is its plain
version's core):

1. forward membership: keyword batches (kernel K1), with the sparse phrase
   fold (score_queries_forward_phrase), and the fused mixed lane (kernel
   K2); score_queries_fused runs membership and finalization in one kernel
   (K4), off the production path;
2. CSR gather/scatter (score_queries): the exact route when the dense
   forward view was truncated, and an independent oracle for the forward
   path. Plain torch ops, as the JAX package computes it outside any
   Pallas kernel.

Scoring semantics match the reference exactly:
- per-doc title/body score = sum of the doc's posting weights over the
  query terms, duplicate query terms counted once per occurrence
  (main_retrieve.go:62-78);
- cosine: score /= magnitude * sqrt(query_len); NaN (0/0) -> 0 but +inf
  kept (get_metadata.go:53-66 only guards IsNaN);
- final = (0.33*sqd + 0.38*title + 0.29*body) * 100 (get_metadata.go:69);
- only candidate docs (>= 1 posting hit or a phrase match) are ranked;
  non-candidates come back as -inf.

Each device stage runs inside a TRACER.range (scoring.kernel, .hot,
.counts, .fold, .csr, .finalize with .sqd inside it, .topk), which a
torch.profiler trace uses to credit the device work to the stage that
launched it; with no profiler recording a range costs one flag read.
"""

from __future__ import annotations

import torch

from ..utils.timing import TRACER

from .kernels import finalize as _fin
from .kernels import fused as _k4
from .kernels import membership as _k1
from .kernels import mixed as _k2
from .kernels.finalize import REFERENCE_BLEND

_INT32_MAX = torch.iinfo(torch.int32).max


def set_exact_matmul() -> None:
    """True-f32 matmuls on the card: TF32 (or bf16 passes) flipped 0.8% of
    top-50 ids in the JAX package (scoring.py:231-237); the hot-term matmul
    and the topic blend must accumulate in full f32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


# ---------------------------------------------------------------------- #
# exact top-k
# ---------------------------------------------------------------------- #


def _top_k_lowest_index(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Row-wise top-k with lax.top_k's tie rule: values descending, equal
    values by ascending index, and at the k-th value the LOWEST tied
    indices are the ones kept. torch.topk promises no tie order, so it runs
    on unique int64 keys: the float's order-preserving int32 image in the
    high half, the complement of the index in the low half."""
    bits = x.contiguous().view(torch.int32)
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)
    idx = torch.arange(x.shape[1], dtype=torch.int64, device=x.device)
    _, top = torch.topk((ordered << 32) | (0xFFFFFFFF - idx), k, dim=1)
    return torch.gather(x, 1, top), top


def _sort_score_desc_id_asc(
    vals: torch.Tensor, ids: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Stable two-key sort of [B, k] rows: score descending, id ascending."""
    o = torch.sort(ids, dim=1, stable=True).indices
    vals, ids = torch.gather(vals, 1, o), torch.gather(ids, 1, o)
    o = torch.sort(vals, dim=1, descending=True, stable=True).indices
    return torch.gather(vals, 1, o), torch.gather(ids, 1, o)


def exact_top_k(
    scores: torch.Tensor, k: int, chunk: int = 128, chunk_min_docs: int = 1 << 18,
    doc_map: torch.Tensor | None = None, cmax: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over the doc axis -> (values [B, k], ids int32 [B, k]).

    Small D: one lowest-index top-k. Large D takes the chunk-max route of
    the JAX package: per-128-doc-chunk max, top-k over the chunk maxima,
    gather the k winning chunks, exact top-k over the candidates. Value-
    exact: every element above the k-th value lives in a chunk whose max
    is above it, and at most k chunks can have such a max. cmax [B, M]
    (kernels/finalize.py) gives the chunk maxima ready-made: scores is
    then the first D columns of a [B, M*chunk] buffer padded with -inf,
    whose chunks the route gathers in place. With doc_map (doc-sorted
    layout) the ids are mapped back to natural ids and the order is
    normalized to (score desc, natural id asc)."""
    with TRACER.range("scoring.topk"):
        b, d = scores.shape
        k = min(k, d)
        if d < chunk_min_docs or d < 2 * chunk * k:
            tv, tid = _top_k_lowest_index(scores, k)
        else:
            m = -(-d // chunk)
            if cmax is None:
                pad = m * chunk - d
                xp = torch.nn.functional.pad(scores, (0, pad), value=-float("inf")) if pad else scores
                ch = xp.view(b, m, chunk)
                cmax = ch.amax(dim=2)  # [B, M]
            else:
                rs = scores.stride(0)
                if cmax.shape != (b, m) or scores.stride(1) != 1 or rs < m * chunk:
                    raise ValueError(f"cmax {tuple(cmax.shape)} does not fit scores "
                                     f"{tuple(scores.shape)} in chunks of {chunk}")
                ch = scores.as_strided((b, m, chunk), (rs, chunk, 1))
            _, ci = _top_k_lowest_index(cmax, k)  # winning chunk ids
            cand = torch.gather(ch, 1, ci[:, :, None].expand(b, k, chunk)).reshape(b, k * chunk)
            tv, tp = _top_k_lowest_index(cand, k)
            tid = torch.gather(ci, 1, tp // chunk) * chunk + tp % chunk
        tid = tid.to(torch.int32)
        if doc_map is not None:
            tid = doc_map[tid.long()]
        return _sort_score_desc_id_asc(tv, tid)


# ---------------------------------------------------------------------- #
# shared finalization
# ---------------------------------------------------------------------- #


def finalize_scores(
    title_score, title_count, body_score, body_count,  # [B, D]
    mag_title, mag_body,  # [D]
    pagerank,  # [D, C]
    query_len,  # [B]
    topic_probs,  # [B, C]
    weights=REFERENCE_BLEND,  # (w_pagerank, w_title, w_body, scale)
) -> torch.Tensor:
    """(w_pr*sqd + w_title*title_n + w_body*body_n) * scale over
    candidates, -inf elsewhere; each weight enters as an f32 scalar, as
    both the reference constants and the JAX package's custom-blend array
    do."""
    w_pr, w_title, w_body, scale = weights
    with TRACER.range("scoring.finalize"):
        qmag = torch.sqrt(query_len)[:, None]
        title_n = title_score / (mag_title[None, :] * qmag)
        body_n = body_score / (mag_body[None, :] * qmag)
        title_n = torch.nan_to_num(title_n, nan=0.0, posinf=float("inf"), neginf=-float("inf"))
        body_n = torch.nan_to_num(body_n, nan=0.0, posinf=float("inf"), neginf=-float("inf"))
        # topic-sensitive importance: sqd[b, d] = topic_probs[b] . pagerank[d]
        with TRACER.range("scoring.sqd"):
            sqd = topic_probs @ pagerank.T
        final = (w_pr * sqd + w_title * title_n + w_body * body_n) * scale
        count = title_count + body_count
        return torch.where(count > 0, final, torch.full_like(final, -float("inf")))


# ---------------------------------------------------------------------- #
# forward-membership formulation
# ---------------------------------------------------------------------- #


def mask_cold(term_ids: torch.Tensor, qnb: torch.Tensor | None) -> torch.Tensor:
    """Replace slots past each row's cold-term count with the sentinel.

    The hot-split layout puts a query's COLD terms in slots [0, qnb) and
    its hot terms after (the title sweep reads all of them); the body sweep
    must see only the cold slots, or a row's hot slots below its block's
    loop bound would be swept AND matmul-added (double count)."""
    if qnb is None:
        return term_ids
    q = term_ids.shape[1]
    keep = torch.arange(q, dtype=torch.int32, device=term_ids.device)[None, :] < qnb[:, None]
    return torch.where(keep, term_ids, torch.full_like(term_ids, _INT32_MAX))


def hot_body_scores(hot_w: torch.Tensor, hot_sids: torch.Tensor) -> torch.Tensor:
    """Sum of a query's hot-term dense body-weight rows, as a one-hot f32
    matmul: [B, H] @ [H, D] -> [B, D]. hot_sids pads with -1 (never matches
    the iota). Exact per element (adding true zeros never changes an f32
    sum; duplicate query terms raise the one-hot entry to their
    multiplicity). Needs true-f32 accumulation (set_exact_matmul)."""
    h = hot_w.shape[0]
    iota = torch.arange(h, dtype=hot_sids.dtype, device=hot_sids.device)
    onehot = (hot_sids[:, :, None] == iota[None, None, :]).float().sum(dim=1)
    return onehot @ hot_w


def _hot(hot_w, hot_sids):
    """The hot fold's matmul [B, H] @ [H, D'] (finalize adds it to the body
    scores and counts a hot-only doc as a candidate), or None."""
    if hot_w is None or hot_sids is None:
        return None
    with TRACER.range("scoring.hot"):
        return hot_body_scores(hot_w, hot_sids)


def score_queries_fused(
    title_fwd, body_fwd,  # ForwardArrays
    mag_title, mag_body,  # f32 [D]
    pagerankT,  # f32 [C, D]
    term_ids,  # int32 [B, Q]
    query_len,  # f32 [B]
    topic_probs,  # f32 [B, C]
    *,
    topk: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Keyword-only path through one kernel (K4): membership scoring for
    both sections + finalization, then exact top-k. No qn bound, no hot
    split and no doc_map: under the doc-sorted layout the ids are
    permuted-space ids, as the JAX package's score_queries_fused returns."""
    with TRACER.range("scoring.kernel"):
        final = _k4.fused_final_scores(
            title_fwd.ftT, title_fwd.fwT, body_fwd.ftT, body_fwd.fwT,
            mag_title, mag_body, pagerankT, term_ids, query_len, topic_probs,
        )
    return exact_top_k(final, topk)


def empty_phrase_fold(b: int, pad_doc: int, device, e: int = 8):
    """An all-pad phrase fold (no matches): ph_docs, ph_tw, ph_bw, ph_fl."""
    zeros = torch.zeros((b, e), dtype=torch.float32, device=device)
    return torch.full((b, e), pad_doc, dtype=torch.int32, device=device), zeros, zeros, zeros


def phrase_fold(
    n_docs: int, ph_docs, ph_tw, ph_bw, ph_fl  # ph_docs int32 [B, E]
) -> torch.Tensor:
    """Scatter sparse phrase matches into [B, n_docs, 3] (title weight, body
    weight, match flag). Ids >= n_docs are pads and are dropped (the JAX
    package's scatter mode="drop" over an n_docs+1 wide accumulator)."""
    with TRACER.range("scoring.fold"):
        b = ph_docs.shape[0]
        acc = torch.zeros((b, n_docs + 1, 3), dtype=torch.float32, device=ph_docs.device)
        idx = ph_docs.long().clamp(max=n_docs)[:, :, None].expand(-1, -1, 3)
        acc.scatter_add_(1, idx, torch.stack([ph_tw, ph_bw, ph_fl], dim=-1))
        return acc[:, :n_docs]


def score_queries_forward(
    title_fwd, body_fwd,  # ForwardArrays
    mag_title, mag_body, pagerank,
    term_ids,  # int32 [B, Q]
    query_len,  # f32 [B]
    topic_probs,  # f32 [B, C]
    qn=None,  # int32 [B] active term counts (sorted desc)
    qnb=None,  # int32 [B] cold-term count (hot split)
    hot_sids=None,  # int32 [B, QH] hot slots, -1 pad
    hot_w=None,  # f32 [H, D] dense hot body weights
    body_tmax=None,  # int32 [D // 512] (doc-sorted layout)
    doc_map=None,  # int32 [D] permuted -> natural ids
    *,
    topk: int,
    emit_counts: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Keyword-only path (kernel K1). -> (top scores [B, K], doc ids [B, K])."""
    with TRACER.range("scoring.kernel"):
        ts, tc, bs, bc = _k1.forward_scores_2sec(
            title_fwd.ftT, title_fwd.fwT, body_fwd.ftT, body_fwd.fwT, term_ids, qn,
            emit_counts=emit_counts, qnb=qnb, body_tmax=body_tmax,
        )
    final, cmax = _fin.finalize_chunked(
        ts, tc, bs, bc, mag_title, mag_body, pagerank, query_len, topic_probs,
        hot=_hot(hot_w, hot_sids),
    )
    return exact_top_k(final, topk, doc_map=doc_map, cmax=cmax)


def score_queries_mixed(
    title_fwd, body_fwd,  # ForwardArrays
    title_posT, body_posT,  # [C*T, D] doc-major positions (f32 or int16)
    mag_title, mag_body, pagerank,
    term_ids,  # int32 [B, Q]
    query_len,  # f32 [B]
    topic_probs,  # f32 [B, C]
    ph_ids,  # int32 [B, P] phrase terms (sentinel pad)
    ph_valid,  # f32 [B, P]
    qn=None,
    pn=None,  # int32 [B] active phrase slots
    qnb=None,
    hot_sids=None,
    hot_w=None,
    doc_map=None,  # int32 [D] permuted -> natural ids
    body_tmax=None,  # int32 [D // 512] (doc-sorted layout)
    *,
    topk: int,
    emit_counts: bool = True,
    tmax_stage: str = "phrase",  # the K2 loops body_tmax bounds ("kw" / "phrase" / "both")
) -> tuple[torch.Tensor, torch.Tensor]:
    """The fused mixed lane (kernel K2): keyword membership scoring + dense
    phrase matching + fold + finalize + top-k. body_tmax (doc-sorted
    layout) bounds the kernel's body loops that tmax_stage picks
    (kernels/mixed.py); the plain version ignores it (result-identical)."""
    # candidacy comes AFTER the hot fold (inside finalize): a doc matched
    # only by a hot body term must still become a candidate
    with TRACER.range("scoring.kernel"):
        if pn is None:
            pn = ph_valid.sum(dim=1).to(torch.int32)
        ts, tc, bs, bc = _k2.mixed_scores_padded(
            title_fwd.ftT, title_fwd.fwT, body_fwd.ftT, body_fwd.fwT,
            title_posT, body_posT, term_ids, qn, ph_ids, ph_valid, pn,
            emit_counts=emit_counts, qnb=qnb, derive=False, body_tmax=body_tmax,
            tmax_stage=tmax_stage,
        )
    final, cmax = _fin.finalize_chunked(
        ts, tc, bs, bc, mag_title, mag_body, pagerank, query_len, topic_probs,
        hot=_hot(hot_w, hot_sids),
    )
    return exact_top_k(final, topk, doc_map=doc_map, cmax=cmax)


def score_queries_forward_phrase(
    title_fwd, body_fwd,  # ForwardArrays
    mag_title, mag_body, pagerank,
    term_ids,  # int32 [B, Q]
    query_len,  # f32 [B]
    topic_probs,  # f32 [B, C]
    phrase_doc_ids,  # int32 [B, E] host-compressed matches, pad >= n_docs
    phrase_title_w,  # f32 [B, E]
    phrase_body_w,  # f32 [B, E]
    phrase_flag,  # f32 [B, E]
    qn=None,
    qnb=None,
    hot_sids=None,
    hot_w=None,
    body_tmax=None,
    doc_map=None,
    *,
    topk: int,
    emit_counts: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward keyword scoring (kernel K1) + the sparse phrase lane's fold.
    Under the doc-sorted layout (doc_map set) phrase_doc_ids are already
    permuted-space ids: the matcher reads the index's remapped doc_ids."""
    n_docs = title_fwd.ftT.shape[1]
    with TRACER.range("scoring.kernel"):
        ts, tc, bs, bc = _k1.forward_scores_2sec(
            title_fwd.ftT, title_fwd.fwT, body_fwd.ftT, body_fwd.fwT, term_ids, qn,
            emit_counts=emit_counts, qnb=qnb, body_tmax=body_tmax,
        )
    hot = _hot(hot_w, hot_sids)
    pacc = phrase_fold(n_docs, phrase_doc_ids, phrase_title_w, phrase_body_w, phrase_flag)
    final, cmax = _fin.finalize_chunked(
        ts, tc, bs, bc, mag_title, mag_body, pagerank, query_len, topic_probs,
        hot=hot, phrase=pacc,
    )
    return exact_top_k(final, topk, doc_map=doc_map, cmax=cmax)


# ---------------------------------------------------------------------- #
# CSR gather/scatter formulation (exact route + parity oracle)
# ---------------------------------------------------------------------- #


def _gather_section(
    post_offsets,  # int32 [V+2] (sentinel empty row at V)
    doc_ids,  # int32 [P_pad], pad = n_docs
    weights,  # f32 [P_pad]
    term_ids,  # int32 [B, Q], pad = V (sentinel)
    posting_cap: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (docs [B, Q, L], w [B, Q, L], valid [B, Q, L])"""
    t = term_ids.long()
    start = post_offsets[t].long()
    end = post_offsets[t + 1].long()
    idx = start[..., None] + torch.arange(posting_cap, device=t.device)
    valid = idx < end[..., None]
    idx = torch.where(valid, idx, doc_ids.shape[0] - 1)
    docs = doc_ids[idx]
    w = torch.where(valid, weights[idx], 0.0)
    return docs, w, valid


def _scatter_scores(docs, w, valid, n_docs: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Scatter (weight, candidate count) per doc into [B, n_docs+1, 2] and
    drop the pad column. -> (scores [B, D], count [B, D])"""
    b = docs.shape[0]
    flat = docs.reshape(b, -1).long().clamp(max=n_docs)
    payload = torch.stack([w.reshape(b, -1), valid.reshape(b, -1).to(w.dtype)], dim=-1)
    acc = torch.zeros((b, n_docs + 1, 2), dtype=w.dtype, device=w.device)
    acc.scatter_add_(1, flat[:, :, None].expand(-1, -1, 2), payload)
    return acc[:, :n_docs, 0], acc[:, :n_docs, 1]


def csr_scores(
    title_offsets, title_doc_ids, title_weights,
    body_offsets, body_doc_ids, body_weights,
    term_ids,  # int32 [B, Q], pad = V
    phrase_doc_ids,  # int32 [B, E], pad = n_docs
    phrase_title_w, phrase_body_w, phrase_flag,
    *,
    posting_cap: int,
    n_docs: int,
):
    """Per-section (score, count) [B, n_docs] through the CSR formulation,
    with the sparse phrase matches (weights + candidacy) folded in."""
    with TRACER.range("scoring.csr"):
        title_score, title_count = _scatter_scores(*_gather_section(
            title_offsets, title_doc_ids, title_weights, term_ids, posting_cap
        ), n_docs)
        body_score, body_count = _scatter_scores(*_gather_section(
            body_offsets, body_doc_ids, body_weights, term_ids, posting_cap
        ), n_docs)
        pacc = phrase_fold(n_docs, phrase_doc_ids, phrase_title_w, phrase_body_w, phrase_flag)
        return (
            title_score + pacc[:, :, 0], title_count + pacc[:, :, 2],
            body_score + pacc[:, :, 1], body_count,
        )


def score_dense(
    title_offsets, title_doc_ids, title_weights,
    body_offsets, body_doc_ids, body_weights,
    mag_title, mag_body, pagerank,
    term_ids, query_len, topic_probs,
    phrase_doc_ids, phrase_title_w, phrase_body_w, phrase_flag,
    *,
    posting_cap: int,
    n_docs: int,
    blend: tuple[float, float, float, float] | None = None,  # (w_pr, w_title, w_body, scale)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense final scores [B, n_docs] via the CSR formulation, with their
    chunk maxima (kernels/finalize.py finalize_chunked); folds the sparse
    phrase matches before normalization. Doc-level arrays may be padded
    beyond n_docs (sliced)."""
    ts, tc, bs, bc = csr_scores(
        title_offsets, title_doc_ids, title_weights,
        body_offsets, body_doc_ids, body_weights,
        term_ids, phrase_doc_ids, phrase_title_w, phrase_body_w, phrase_flag,
        posting_cap=posting_cap, n_docs=n_docs,
    )
    return _fin.finalize_chunked(
        ts, tc, bs, bc, mag_title[:n_docs], mag_body[:n_docs], pagerank[:n_docs],
        query_len, topic_probs, REFERENCE_BLEND if blend is None else blend,
    )


def score_queries(
    title_offsets, title_doc_ids, title_weights,
    body_offsets, body_doc_ids, body_weights,
    mag_title, mag_body, pagerank,
    term_ids, query_len, topic_probs,
    phrase_doc_ids, phrase_title_w, phrase_body_w, phrase_flag,
    blend=None,
    doc_map=None,
    *,
    posting_cap: int,
    topk: int,
    n_docs: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """CSR path with phrase folding. -> (top scores [B, K], doc ids [B, K]).

    The production keyword scorer routes here when the dense forward view
    was truncated (doc_term_cap): the CSR stays complete, so scores and
    candidacy remain exact for pathological documents. Under the doc-sorted
    layout pass n_docs = the padded doc count plus doc_map."""
    final, cmax = score_dense(
        title_offsets, title_doc_ids, title_weights,
        body_offsets, body_doc_ids, body_weights,
        mag_title, mag_body, pagerank,
        term_ids, query_len, topic_probs,
        phrase_doc_ids, phrase_title_w, phrase_body_w, phrase_flag,
        posting_cap=posting_cap, n_docs=n_docs, blend=blend,
    )
    return exact_top_k(final, topk, doc_map=doc_map, cmax=cmax)
