#!/usr/bin/env python3
"""sparse_probe.py on the PyTorch port: sort-based sparse CSR scoring
against the dense membership scan.

    python3 experiments/torch_sparse_probe.py [--device cuda] [--docs 1000000] [--words 200000]

The original's corpus and draws: corpus.synth_snapshot(n_docs=1,000,000,
n_words=200,000, 48 body and 4 title terms per doc, max_df 32,768) on the
device; B=256 queries of Q=4 terms drawn proportional to body df (numpy
seed 1), query_len = Q, topics off. A query's windows are its terms'
title and body posting ranges in the concatenated (title ++ body) CSR.
Two exact sparse formulations, written here in torch ops (probes, not
kernels), as the original wrote them in jnp:
  score_sparse      gather the batch's windows into a static [B, N]
                    buffer, sort by doc id, segmented sums of the title
                    weight, body weight and count (a cumulative sum minus
                    its value before the segment's head), finalize at
                    each segment's tail, exact top-k over N;
  score_candidates  gather the windows' doc ids as candidates, score
                    each candidate against its forward rows in blocks of
                    512 (the dense membership on a gathered slice),
                    finalize, exact top-k over N with duplicates
                    (k_dup = 2 * k * Q), then host_dedup: per row the
                    first k unique docs by (-score, doc).
The entry of a window is found by a sorted search of the windows' ends
(the original counted the ends below it; the same index). Times each at
N = 16,384 ... 131,072 on the rows whose posting mass fits N, and the dense
scan (score_queries_forward: K1, finalize, top-10) at B = 32, 64, 256, by
CUDA events (host clock with --device cpu). The exactness check is the
original's: on up to 64 rows whose mass fits 32,768 entries,
score_candidates + host_dedup against the dense top-10, scores within
rtol 2e-5 / atol 1e-6, and ids equal where ranked except where the
scores tie (the original asked for every id; its synthetic weights, tf in
1-7 times a word's idf, give docs of equal score at 1M docs, which the
two paths may order apart at the k-th cut; the count of differing ids is
printed as the original's "id match"). score_sparse's
agreement with the dense top-10 on the same rows is printed beside it
(the original did not check it: its segment sums are differences of
float32 prefix sums over the whole buffer, so they carry the prefix's
rounding). Prints the original's lines, then one JSON line; main()
returns the same dict.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

#: the original's finalize constants (get_metadata.go:69)
W_PR, W_T, W_B, SCALE = 0.33, 0.38, 0.29, 100.0


def _entries(win_start, win_len, n: int, n_cat: int):
    """Per row the first n entries of its windows, in window order ->
    (global index into the concatenated CSR [B, n], valid [B, n], window
    of each entry [B, n])."""
    import torch

    b, w = win_start.shape
    cl = torch.cumsum(win_len, dim=1)  # [B, W] window ends
    cl0 = torch.nn.functional.pad(cl, (1, 0))  # [B, W+1] window starts
    j = torch.arange(n, dtype=cl.dtype, device=cl.device).expand(b, n).contiguous()
    t_of = torch.searchsorted(cl, j, right=True)  # windows ending at or below j
    valid = j < cl[:, -1:]
    t_of_c = t_of.clamp(max=w - 1)
    local = j - torch.gather(cl0, 1, t_of_c)
    g = torch.gather(win_start, 1, t_of_c) + local
    g = torch.where(valid, g, n_cat - 1)
    return g.long(), valid, t_of_c


def _finalize(ts, bs, mag_t, mag_b, pr, query_len, topic_probs):
    """The original's finalize on gathered docs: cosine per section (NaN to
    0), the topic PageRank term, the blend."""
    import torch

    qmag = torch.sqrt(query_len)[:, None]
    tn = torch.nan_to_num(ts / (mag_t * qmag), nan=0.0, posinf=float("inf"),
                          neginf=-float("inf"))
    bn = torch.nan_to_num(bs / (mag_b * qmag), nan=0.0, posinf=float("inf"),
                          neginf=-float("inf"))
    sqd = torch.einsum("bc,bjc->bj", topic_probs, pr)
    return (W_PR * sqd + W_T * tn + W_B * bn) * SCALE


def score_sparse(cat_doc_ids, cat_weights, mag_title, mag_body, pagerank, win_start, win_len,
                 win_title, query_len, topic_probs, *, topk: int, n_docs: int, n_entries: int):
    """-> (top scores [B, topk], doc ids [B, topk]) by sorting the batch's
    posting entries by doc and summing each doc's segment."""
    import torch

    from spaghettisearch_tpu_torch.ops.scoring import exact_top_k

    b = win_start.shape[0]
    n = n_entries
    g, valid, t_of = _entries(win_start, win_len, n, cat_doc_ids.shape[0])
    d = torch.where(valid, cat_doc_ids[g], n_docs)
    wgt = torch.where(valid, cat_weights[g], 0.0)
    is_t = win_title[t_of]
    wt, wb = wgt * is_t, wgt * (1.0 - is_t)
    cnt = valid.to(torch.float32)
    d_s, order = torch.sort(d, dim=1, stable=True)
    payload = torch.stack([torch.gather(x, 1, order) for x in (wt, wb, cnt)], -1)  # [B, N, 3]
    heads = torch.ones_like(d_s, dtype=torch.bool)
    heads[:, 1:] = d_s[:, 1:] != d_s[:, :-1]
    tails = torch.ones_like(d_s, dtype=torch.bool)
    tails[:, :-1] = d_s[:, 1:] != d_s[:, :-1]
    csum = torch.cumsum(payload, dim=1)
    jrow = torch.arange(n, device=d.device).expand(b, n)
    hidx = torch.cummax(torch.where(heads, jrow, -1), dim=1).values
    prev = torch.where((hidx > 0)[..., None],
                       torch.gather(csum, 1, (hidx - 1).clamp(min=0)[..., None].expand(-1, -1, 3)),
                       0.0)
    seg = csum - prev
    ts, bs, c = seg[..., 0], seg[..., 1], seg[..., 2]
    dg = d_s.clamp(max=n_docs - 1).long()
    final = _finalize(ts, bs, mag_title[dg], mag_body[dg], pagerank[dg], query_len, topic_probs)
    final = torch.where(tails & (c > 0) & (d_s < n_docs), final, -float("inf"))
    top_s, pos = exact_top_k(final, topk)
    return top_s, torch.gather(d_s, 1, pos.long())


def score_candidates(title_ft, title_fw, body_ft, body_fw, mag_title, mag_body, pagerank,
                     cat_doc_ids, win_start, win_len, term_ids, query_len, topic_probs, *,
                     topk: int, n_entries: int, n_block: int = 512):
    """-> (scores [B, k_dup], doc ids [B, k_dup]) over the windows' doc ids
    as candidates, duplicates included (host_dedup removes them)."""
    import torch

    from spaghettisearch_tpu_torch.ops.scoring import exact_top_k

    b = win_start.shape[0]
    n = n_entries
    pad_doc = title_ft.shape[0] - 1  # an all-pad forward row (mag 0, ft -1)
    g, valid, _ = _entries(win_start, win_len, n, cat_doc_ids.shape[0])
    cand = torch.where(valid, cat_doc_ids[g], pad_doc).clamp(max=pad_doc).long()  # [B, N]
    blocks = []
    for cb in cand.split(n_block, dim=1):  # [B, Nb]
        sums = []
        for ft, fw in ((title_ft, title_fw), (body_ft, body_fw)):
            f = ft[cb]  # [B, Nb, T]
            mult = (f[..., None] == term_ids[:, None, None, :]).sum(-1).to(torch.float32)
            sums.append(((mult * fw[cb]).sum(-1), mult.sum(-1)))
        (ts, tc), (bs, bc) = sums
        final = _finalize(ts, bs, mag_title[cb], mag_body[cb], pagerank[cb], query_len,
                          topic_probs)
        blocks.append(torch.where((tc + bc > 0) & (cb < pad_doc), final, -float("inf")))
    scores = torch.cat(blocks, 1)
    k_dup = min(topk * 2 * term_ids.shape[1], n)
    top_s, pos = exact_top_k(scores, k_dup)
    return top_s, torch.gather(cand, 1, pos.long())


def host_dedup(scores, ids, k):
    """[B, k_dup] -> per-row unique docs, first k by (-score, doc)."""
    out_s = np.full((scores.shape[0], k), -np.inf, np.float32)
    out_i = np.zeros((scores.shape[0], k), np.int32)
    for r in range(scores.shape[0]):
        _, first = np.unique(ids[r], return_index=True)
        s, i = scores[r][first], ids[r][first]
        order = np.lexsort((i, -s))[:k]
        out_s[r, : len(order)] = s[order]
        out_i[r, : len(order)] = i[order]
    return out_s, out_i


def windows(snap, terms: np.ndarray):
    """The original's host windows: per query its terms' title windows,
    then body windows (offset past the title postings) -> (ws, wl, title
    flags [2Q], cat doc ids, cat weights)."""
    q = terms.shape[1]
    t_off, b_off = snap.title.post_offsets, snap.body.post_offsets
    body_base = len(snap.title.doc_ids)
    ws = np.zeros((terms.shape[0], 2 * q), np.int32)
    wl = np.zeros_like(ws)
    ws[:, :q] = t_off[terms]
    wl[:, :q] = t_off[terms + 1] - t_off[terms]
    ws[:, q:] = b_off[terms] + body_base
    wl[:, q:] = b_off[terms + 1] - b_off[terms]
    flags = np.concatenate([np.ones(q, np.float32), np.zeros(q, np.float32)])
    cat_ids = np.concatenate([snap.title.doc_ids, snap.body.doc_ids])
    cat_w = np.concatenate([snap.title.weights, snap.body.weights])
    return ws, wl, flags, cat_ids, cat_w


def run(dev, n_docs: int = 1_000_000, n_words: int = 200_000, batch: int = 256,
        levels=(16384, 32768, 65536, 131072), check_n: int = 32768, reps: int = 20,
        say=print) -> dict:
    import torch

    from spaghettisearch_tpu_torch.corpus import synth_snapshot
    from spaghettisearch_tpu_torch.ops.kernels import check, membership
    from spaghettisearch_tpu_torch.ops.scoring import score_queries_forward
    from spaghettisearch_tpu_torch.retrieval.device_index import DeviceIndex

    say(f"device: {dev}")
    snap = synth_snapshot(n_docs=n_docs, n_words=n_words, body_terms_per_doc=48,
                          title_terms_per_doc=4, max_df=32_768)
    # the natural layout: the concatenated CSR's doc ids index the forward
    # rows and magnitudes directly (a doc-sorted index would permute them)
    idx = DeviceIndex.from_snapshot(snap, dev, doc_sort=False)
    rng = np.random.default_rng(1)
    p = np.diff(snap.body.post_offsets).astype(np.float64)
    p /= p.sum()
    q = 4
    terms = rng.choice(n_words, size=(batch, q), p=p).astype(np.int32)
    ws, wl, flags, cat_ids, cat_w = windows(snap, terms)
    mass = wl.sum(1)
    say(f"query mass: p50 {np.percentile(mass, 50)} p90 {np.percentile(mass, 90)} "
        f"max {mass.max()}")
    coverage = {}
    for n in (8192, 16384, 32768, 65536, 131072):
        coverage[n] = float((mass <= n).mean())
        say(f"coverage N={n}: {coverage[n]:.3f}")

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    cat_ids_t, cat_w_t, flags_t = t(cat_ids), t(cat_w), t(flags)
    terms_t = t(terms)
    qlen = torch.full((batch,), float(q), dtype=torch.float32, device=dev)
    tp = torch.zeros((batch, 1), dtype=torch.float32, device=dev)
    fwd_t, fwd_b = idx.title.fwd_device(), idx.body.fwd_device()
    pr = idx.pagerank[:, :1].contiguous()

    def cand_args(rows):
        return (fwd_t.ft, fwd_t.fw, fwd_b.ft, fwd_b.fw, idx.mag_title, idx.mag_body, pr,
                cat_ids_t, t(ws[rows]), t(wl[rows]), terms_t[rows], qlen[: len(rows)],
                tp[: len(rows)])

    def sparse_args(rows):
        return (cat_ids_t, cat_w_t, idx.mag_title, idx.mag_body, pr, t(ws[rows]), t(wl[rows]),
                flags_t, qlen[: len(rows)], tp[: len(rows)])

    def dense(rows, k=10):
        return score_queries_forward(idx.title.fwd, idx.body.fwd, idx.mag_title, idx.mag_body,
                                     pr, terms_t[rows], qlen[: len(rows)], tp[: len(rows)],
                                     topk=k)

    membership.reset_launches()
    small = np.where(mass <= check_n)[0][:64]
    ds, di = (x.cpu().numpy() for x in dense(small))
    cs, ci = (x.cpu().numpy() for x in score_candidates(*cand_args(small), topk=10,
                                                         n_entries=check_n))
    cs, ci = host_dedup(cs, ci, 10)
    ss, si = (x.cpu().numpy() for x in score_sparse(*sparse_args(small), topk=10,
                                                     n_docs=idx.n_docs, n_entries=check_n))
    fin = np.isfinite(ds)
    checks = {}
    for name, (gs, gi) in (("score_candidates", (cs, ci)), ("score_sparse", (ss, si))):
        ok_s = bool(np.allclose(ds, gs, rtol=2e-5, atol=1e-6))
        ok_i = bool(((di == gi) | ~fin).all())
        err = float(np.abs(np.where(fin, ds - gs, 0)).max(initial=0.0))
        ties = check.compare_topk(tuple(torch.from_numpy(np.asarray(a)) for a in (gs, gi)),
                                  (torch.from_numpy(ds), torch.from_numpy(di)),
                                  rtol=2e-5, atol=1e-6)
        checks[name] = {"score_match": ok_s, "id_match": ok_i, "ids_up_to_ties": ties["ok"],
                        "id_diffs": ties["id_diffs"], "max_abs_err": err}
        say(f"{name}: score match: {ok_s} id match: {ok_i} max |ds-cs|: {err} "
            f"(ids equal up to ties: {ties['ok']}, {ties['id_diffs']} differ)")
    say(f"({len(small)} rows checked, {int(fin.sum())} ranked)")

    timings = {"cand": {}, "sparse": {}, "dense": {}}
    for n in levels:
        elig = np.where(mass <= n)[0]
        bb = (len(elig) // 8) * 8 or 8
        sub = elig[:bb]
        if len(sub) == 0:
            continue
        for name, fn in (
            ("cand", lambda: score_candidates(*cand_args(sub), topk=10, n_entries=n)),
            ("sparse", lambda: score_sparse(*sparse_args(sub), topk=10, n_docs=idx.n_docs,
                                            n_entries=n)),
        ):
            ms = check.time_on(fn, dev, iters=reps, warmup=1)
            timings[name][n] = {"batch": len(sub), "ms": ms}
            say(f"{name:6s} N={n:6d} B={len(sub):3d}: {ms:8.4f} ms "
                f"({len(sub) / ms * 1e3:9.0f} qps)")
    for bsz in sorted({b for b in (32, 64, batch) if b <= batch}):
        rows = np.arange(bsz)
        ms = check.time_on(lambda: dense(rows), dev, iters=max(reps // 4, 1), warmup=1)
        timings["dense"][bsz] = ms
        say(f"dense B={bsz:3d}: {ms:8.4f} ms ({bsz / ms * 1e3:9.0f} qps)")
    ok = checks["score_candidates"]["score_match"] and checks["score_candidates"]["ids_up_to_ties"]
    return {"probe": "sparse", "docs": n_docs, "words": n_words, "batch": batch,
            "coverage": coverage, "checked_rows": int(len(small)), "checks": checks,
            "ms": timings, "ok": ok, "launches": {"K1": membership.LAUNCHES}}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--docs", type=int, default=1_000_000)
    ap.add_argument("--words", type=int, default=200_000)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--levels", default="16384,32768,65536,131072",
                    help="entry buffer sizes N to time")
    ap.add_argument("--checkN", type=int, default=32768, help="N of the exactness check")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)

    from spaghettisearch_tpu_torch.bench import card
    from spaghettisearch_tpu_torch.ops.kernels import check

    dev = check.probe_device(args.device)
    res = run(dev, args.docs, args.words, args.batch,
              tuple(int(x) for x in args.levels.split(",")), args.checkN, args.reps)
    res.update(card(dev))
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    raise SystemExit(0 if main()["ok"] else 1)
