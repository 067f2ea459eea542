"""Phrase retrieval on torch: positional intersection over candidate docs.

The counterpart of spaghettisearch_tpu/ops/phrase.py, the sparse phrase
lane's matcher. One call evaluates a batch of phrases against all their
candidate documents at once (the JAX package vmaps one phrase; here the
batch is a leading tensor dimension, and loops run over the phrase terms so
the [B, E, T] and [B, E, C, C] intermediates are built one term at a time):

1. candidates = the doc lists (title+body) of a generator term, the
   phrase's rarest term, so every true match is covered;
2. per term and section, membership of each candidate (a compare against
   the candidate's forward row in match_phrase_fwd, a searchsorted into the
   term's posting window in match_phrase, the CSR oracle);
3. per term, the candidate's position list, shifted by the term's phrase
   offset (positions[i] -= i, reference: phrase.go:144-157);
4. the phrase matches where some shifted position of term 0 is in every
   valid term's list.

Semantics (evalPhraseOccurrence, reference phrase.go:53-109):
- a candidate counts only if every phrase term occurs in title OR body;
- the body contributes sum(term body weights) only when every term has a
  body entry and the body intersection is non-empty; title likewise;
- a single-term phrase matches wherever the term occurs (any position,
  sentinel -100 included).

These are plain torch ops, as the JAX package computes them outside any
Pallas kernel.
"""

from __future__ import annotations

import torch

_INT32_MAX = torch.iinfo(torch.int32).max


def _term_windows(offsets, doc_ids, term_ids, posting_cap: int):
    """term ids [...] -> (docs [..., L] with int32-max pad, start [...],
    valid [..., L]): each term's CSR posting window."""
    t = term_ids.long()
    start = offsets[t].long()
    end = offsets[t + 1].long()
    idx = start[..., None] + torch.arange(posting_cap, device=t.device)
    valid = idx < end[..., None]
    idx = torch.where(valid, idx, doc_ids.shape[0] - 1)
    docs = torch.where(valid, doc_ids[idx], _INT32_MAX)
    return docs, start, valid


def _candidates(t_docs, b_docs, n_docs: int):
    """Generator windows [B, L] x 2 -> (sorted candidates [B, E], first
    occurrence and real [B, E])."""
    cand = torch.sort(torch.cat([t_docs, b_docs], dim=1), dim=1).values
    first = torch.ones_like(cand, dtype=torch.bool)
    first[:, 1:] = cand[:, 1:] != cand[:, :-1]
    return cand, first & (cand < n_docs)


def _shifted_positions(pos_offsets, positions, post, found, shift: float, pos_cap: int):
    """Global posting indices [B, E] -> their positions [B, E, C] minus
    `shift` (inf where absent or past the list)."""
    j = torch.where(found, post, pos_offsets.shape[0] - 2).long()
    p_start = pos_offsets[j].long()
    p_end = torch.where(found, pos_offsets[j + 1].long(), p_start)
    pidx = p_start[..., None] + torch.arange(pos_cap, device=j.device)
    pvalid = pidx < p_end[..., None]
    pidx = torch.where(pvalid, pidx, positions.shape[0] - 1)
    return torch.where(pvalid, positions[pidx], float("inf")) - shift


def _intersect(pos, term_valid, pairwise: bool):
    """pos [B, P, E, C] shifted sorted positions (inf pad) -> [B, E]: some
    finite position of term 0 is in every valid term's list. Pairwise
    compares, or sorted-membership searches (the pairwise [E, C, C] compare
    grows quadratically in C; positions are stored sorted and the shift
    keeps the order)."""
    p0 = pos[:, 0]  # [B, E, C]
    all_terms = torch.isfinite(p0)
    for i in range(pos.shape[1]):
        pi = pos[:, i]
        if pairwise:
            hit = (p0[..., :, None] == pi[..., None, :]).any(-1)
        else:
            ss = torch.searchsorted(pi.contiguous(), p0.contiguous()).clamp(max=pi.shape[-1] - 1)
            hit = torch.gather(pi, -1, ss) == p0
        # invalid (padding) terms always match
        all_terms &= hit | ~term_valid[:, i, None, None]
    return all_terms.any(-1)


def _combine(cand, keep_slot, term_valid, t_found, b_found, t_w, b_w, t_match, b_match,
             n_docs: int):
    """Per-term membership/weights [B, P, E] + intersections [B, E] ->
    (doc_ids, title_w, body_w, flag), each [B, E], pad doc n_docs."""
    tv = term_valid[:, :, None]
    present_all = torch.where(tv, t_found | b_found, True).all(1)
    title_all = torch.where(tv, t_found, True).all(1)
    body_all = torch.where(tv, b_found, True).all(1)
    title_ok = present_all & title_all & t_match & keep_slot
    body_ok = present_all & body_all & b_match & keep_slot
    keep = title_ok | body_ok
    sum_t = torch.where(tv, t_w, 0.0).sum(1)
    sum_b = torch.where(tv, b_w, 0.0).sum(1)
    out_docs = torch.where(keep, cand, n_docs).to(torch.int32)
    return (
        out_docs,
        torch.where(title_ok, sum_t, 0.0),
        torch.where(body_ok, sum_b, 0.0),
        keep.to(torch.float32),
    )


def match_phrase_fwd_batch(
    title_ft, title_fj, title_weights, title_pos_offsets, title_positions,
    body_ft, body_fj, body_weights, body_pos_offsets, body_positions,
    title_offsets, title_doc_ids, body_offsets, body_doc_ids,
    term_ids,  # int32 [B, P]
    term_valid,  # bool [B, P]
    gen_idx,  # int32 [B]
    title_pos_mat=None,  # f32 [P_pad, pos_cap] (inf pad rows) or None
    body_pos_mat=None,
    *,
    posting_cap: int,  # covers the batch's generator dfs
    pos_cap: int,
    n_docs: int,
):
    """Forward-index phrase matcher for a batch: membership and posting
    lookup compare each candidate's forward row (ft/fj [D_pad, T]) against
    the phrase terms, so posting_cap only needs to cover the generator
    term. -> (doc_ids, title_w, body_w, flag), each [B, E=2*posting_cap],
    pad doc n_docs."""
    p = term_ids.shape[1]
    gen = torch.gather(term_ids, 1, gen_idx.long()[:, None])[:, 0]
    t_docs, _, _ = _term_windows(title_offsets, title_doc_ids, gen, posting_cap)
    b_docs, _, _ = _term_windows(body_offsets, body_doc_ids, gen, posting_cap)
    cand, keep_slot = _candidates(t_docs, b_docs, n_docs)
    d_pad = title_ft.shape[0]
    cand_row = torch.where(keep_slot, cand, d_pad - 1).long()

    def section(ft, fj, weights, pos_offsets, positions, pos_mat):
        ftc = ft[cand_row]  # [B, E, T] row gather
        fjc = fj[cand_row]
        found, w, pos = [], [], []
        for i in range(p):
            eq = ftc == term_ids[:, i, None, None]  # [B, E, T]
            f = eq.any(-1)
            # a doc's slots hold distinct terms: the first hit is the hit
            j = torch.gather(fjc, 2, eq.to(torch.uint8).argmax(-1, keepdim=True))[..., 0]
            w.append(torch.where(f, weights[j.clamp(max=weights.shape[0] - 1).long()], 0.0))
            if pos_mat is not None:
                jm = torch.where(f, j, pos_mat.shape[0] - 1).long()  # pad row: all inf
                pos.append(pos_mat[jm] - float(i))  # [B, E, C] row gather
            else:
                pos.append(_shifted_positions(pos_offsets, positions, j, f, float(i), pos_cap))
            found.append(f)
        return torch.stack(found, 1), torch.stack(w, 1), torch.stack(pos, 1)

    t_found, t_w, t_pos = section(
        title_ft, title_fj, title_weights, title_pos_offsets, title_positions, title_pos_mat
    )
    b_found, b_w, b_pos = section(
        body_ft, body_fj, body_weights, body_pos_offsets, body_positions, body_pos_mat
    )
    return _combine(
        cand, keep_slot, term_valid, t_found, b_found, t_w, b_w,
        _intersect(t_pos, term_valid, pos_cap <= 16), _intersect(b_pos, term_valid, pos_cap <= 16),
        n_docs,
    )


def _one_phrase(batch_fn, n_index: int, args, **static):
    """Run a batch matcher on one phrase: args are the n_index index arrays,
    term_ids [P], term_valid [P], a scalar gen_idx, then any pos_mats."""
    index, (term_ids, term_valid, gen_idx), rest = (
        args[:n_index], args[n_index : n_index + 3], args[n_index + 3 :]
    )
    gen = torch.as_tensor(gen_idx, device=term_ids.device).reshape(1)
    out = batch_fn(*index, term_ids[None], term_valid[None], gen, *rest, **static)
    return tuple(o[0] for o in out)


def match_phrase_fwd(*args, posting_cap: int, pos_cap: int, n_docs: int):
    """match_phrase_fwd_batch for one phrase (same positional arguments,
    term_ids/term_valid [P], gen_idx a scalar). -> (doc_ids, title_w,
    body_w, flag), each [E]."""
    return _one_phrase(match_phrase_fwd_batch, 14, args, posting_cap=posting_cap,
                       pos_cap=pos_cap, n_docs=n_docs)


def match_phrase_batch(
    title_offsets, title_doc_ids, title_weights, title_pos_offsets, title_positions,
    body_offsets, body_doc_ids, body_weights, body_pos_offsets, body_positions,
    term_ids,  # int32 [B, P] (pad = sentinel empty row)
    term_valid,  # bool [B, P]
    gen_idx,  # int32 [B]
    *,
    posting_cap: int,
    pos_cap: int,
    n_docs: int,
):
    """The exact CSR matcher: membership is a searchsorted of each candidate
    into every term's sorted posting window. The engine's route when a dense
    forward row was truncated (doc_term_cap), where the forward matcher
    could under-match; also the oracle for match_phrase_fwd_batch.
    -> (doc_ids, title_w, body_w, flag), each [B, E=2*posting_cap]."""
    p = term_ids.shape[1]
    t_docs, t_start, _ = _term_windows(title_offsets, title_doc_ids, term_ids, posting_cap)
    b_docs, b_start, _ = _term_windows(body_offsets, body_doc_ids, term_ids, posting_cap)
    g = gen_idx.long()[:, None, None].expand(-1, 1, posting_cap)
    cand, keep = _candidates(
        torch.gather(t_docs, 1, g)[:, 0], torch.gather(b_docs, 1, g)[:, 0], n_docs
    )
    cand = torch.where(keep, cand, _INT32_MAX)

    def section(docs, start, weights, pos_offsets, positions):
        c = cand[:, None, :].expand(-1, p, -1).contiguous()
        idx = torch.searchsorted(docs.contiguous(), c).clamp(max=docs.shape[2] - 1)
        found = torch.gather(docs, 2, idx) == c  # [B, P, E]
        post = start[:, :, None] + idx
        w = torch.where(found, weights[post.clamp(max=weights.shape[0] - 1)], 0.0)
        pos = torch.stack([
            _shifted_positions(pos_offsets, positions, post[:, i], found[:, i], float(i), pos_cap)
            for i in range(p)
        ], 1)
        return found, w, pos

    t_found, t_w, t_pos = section(t_docs, t_start, title_weights, title_pos_offsets, title_positions)
    b_found, b_w, b_pos = section(b_docs, b_start, body_weights, body_pos_offsets, body_positions)
    ones = torch.ones_like(cand, dtype=torch.bool)
    return _combine(
        cand, ones, term_valid, t_found, b_found, t_w, b_w,
        _intersect(t_pos, term_valid, False), _intersect(b_pos, term_valid, False),
        n_docs,
    )


def match_phrase(*args, posting_cap: int, pos_cap: int, n_docs: int):
    """match_phrase_batch for one phrase (same positional arguments,
    term_ids/term_valid [P], gen_idx a scalar). -> (doc_ids, title_w,
    body_w, flag), each [E]."""
    return _one_phrase(match_phrase_batch, 10, args, posting_cap=posting_cap,
                       pos_cap=pos_cap, n_docs=n_docs)
