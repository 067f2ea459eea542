#!/usr/bin/env python3
"""probe1m_decomp.py on the PyTorch port: the keyword scorer of a B=128
batch split into its parts on the card.

    python3 experiments/torch_probe1m_decomp.py [n] [--device cuda] [--seed 0] [--reps 8]

n is the benchmark corpus's page count (the original's default,
1,000,000; built under build/bench/corpus{n//1000}k when missing). The
original's batch: the first 128 of bench_queries(snap, 256,
phrase_every=0), Q=4, rows sorted by descending term count, topics off.
The question: how much of a keyword rank is the membership kernel (K1),
and how much the finalize, the top-k over [B, D] and the count outputs.
Times score_queries_forward (K1 without the hot split, finalize,
exact_top_k; the original's five variants) at (topk, counts) = (50, as
the index needs), (10, as needed), (1, as needed), (50, off), (1, off);
then the engine's hot split (QueryEngine._fill_keyword_rows: cold terms
in K1's body sweep, hot terms by one matmul) against the full sweep of the
same rows, and the hot configuration's parts one by one: K1 alone, the hot
matmul, finalize, exact_top_k at 50. CUDA events on the card (host clock
with --device cpu). The exactness check is the original's: the hot
split's top-50 scores within rtol 1e-5 / atol 1e-6 of the full sweep's
(ids agreement printed); and the topk=10 and topk=1 values are the first
columns of topk=50's. Prints the original's lines, then one JSON line;
main() returns the same dict (chip_smoke.py phase 17 calls run()).
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_probe_util as util  # noqa: E402


def run(snap, db, eng, reps: int = 8, say=print) -> dict:
    import torch

    from spaghettisearch_tpu_torch.ops.kernels import check
    from spaghettisearch_tpu_torch.ops.kernels import membership as k1
    from spaghettisearch_tpu_torch.ops.scoring import (
        exact_top_k, finalize_scores, hot_body_scores, score_queries_forward,
    )
    from spaghettisearch_tpu_torch.retrieval.engine import QueryEngine

    idx, dev = eng.index, eng.index.device
    say(f"facts: has_zero_weight={idx.has_zero_weight} title.ftT="
        f"{tuple(idx.title.fwd.ftT.shape)} body.ftT={tuple(idx.body.fwd.ftT.shape)} "
        f"D_pad={idx.n_docs_padded}")
    parsed = util.parsed_queries(snap, db, 256, phrase_every=0)[:128]
    b, q = 128, 4
    term_ids = np.full((b, q), snap.n_words, np.int32)
    qn = np.zeros(b, np.int32)
    qlen = np.zeros(b, np.float32)
    for i, p in enumerate(parsed):
        ids = snap.term_ids(p.keyword_hashes)[:q]
        term_ids[i, : len(ids)] = ids
        qn[i] = len(ids)
        qlen[i] = float(p.query_len)
    order = np.argsort(-qn, kind="stable")
    term_ids, qn, qlen = term_ids[order], qn[order], qlen[order]
    say(f"batch qn histogram: {np.bincount(qn, minlength=q + 1).tolist()}")

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    tids, jq, jqn = t(term_ids), t(qlen), t(qn)
    tp = torch.zeros((b, idx.n_categories), dtype=torch.float32, device=dev)
    hzw = idx.has_zero_weight

    def fwd(topk, counts, tq=tids, ql=jq, n=jqn, **hot):
        return score_queries_forward(
            idx.title.fwd, idx.body.fwd, idx.mag_title, idx.mag_body, idx.pagerank,
            tq, ql, tp, n, topk=topk, emit_counts=counts, **hot,
        )

    util.reset_launches()
    ms, outs = {}, {}
    for label, topk, counts in (
        ("engine config (topk=50, counts=hzw)", 50, hzw),
        ("topk=10", 10, hzw),
        ("topk=1", 1, hzw),
        ("counts off, topk=50", 50, False),
        ("counts off, topk=1", 1, False),
    ):
        outs[label] = fwd(topk, counts)
        ms[label] = check.time_on(lambda: fwd(topk, counts), dev, iters=reps, warmup=1)
        say(f"{label}: {ms[label]:.4f} ms ({b * 1e3 / ms[label]:.0f} qps)")
    base50 = outs["engine config (topk=50, counts=hzw)"][0]
    ok = all(torch.equal(outs[lab][0], base50[:, :k]) for lab, k in (("topk=10", 10),
                                                                       ("topk=1", 1)))
    say(f"topk=10 and topk=1 are topk=50's first columns: {ok}")

    hm = idx.hot_body_map
    say(f"hot terms cached: {0 if hm is None else len(hm)}")
    res = {"probe": "probe1m_decomp", "docs": idx.n_docs, "batch": b,
           "has_zero_weight": hzw, "ms": ms, "prefix_ok": ok}
    if hm is not None:
        t2, ql2, qn2, qnb2, sids2 = QueryEngine._fill_keyword_rows(parsed, b, q, snap, hm)
        o = np.lexsort((-qn2, -qnb2))
        jt2, jql2, jqn2, jqnb2, jsids2 = (t(a[o]) for a in (t2, ql2, qn2, qnb2, sids2))
        hot = {"qnb": jqnb2, "hot_sids": jsids2, "hot_w": idx.hot_body_w}
        say(f"hot-split qnb histogram: {np.bincount(qnb2, minlength=q + 1).tolist()}")

        def run_hot():
            return fwd(50, hzw, jt2, jql2, jqn2, **hot)

        def run_base():  # same rows and order, full sweep
            return fwd(50, hzw, jt2, jql2, jqn2)

        ms["HOT engine config"] = check.time_on(run_hot, dev, iters=reps, warmup=1)
        ms["full sweep, same rows"] = check.time_on(run_base, dev, iters=reps, warmup=1)
        say(f"HOT engine config: {ms['HOT engine config']:.4f} ms "
            f"({b * 1e3 / ms['HOT engine config']:.0f} qps); full sweep of the same rows "
            f"{ms['full sweep, same rows']:.4f} ms")
        hs, hi = run_hot()
        bs_, bi_ = run_base()
        close = bool(torch.allclose(hs, bs_, rtol=1e-5, atol=1e-6, equal_nan=True)
                     and torch.equal(torch.isfinite(hs), torch.isfinite(bs_)))
        same_ids = float((hi == bi_).float().mean())
        say(f"hot vs full-sweep: scores_close={close} id_agree={same_ids:.4f}")
        ok &= close
        res.update(hot_scores_close=close, hot_id_agree=same_ids)

        # the hot configuration's parts, one at a time on the same inputs
        f = idx.title.fwd, idx.body.fwd
        parts = {}

        def k1_call():
            return k1.forward_scores_2sec(f[0].ftT, f[0].fwT, f[1].ftT, f[1].fwT, jt2, jqn2,
                                          emit_counts=hzw, qnb=jqnb2)

        ts, tc, bs, bc = k1_call()
        hotm = hot_body_scores(idx.hot_body_w, jsids2)[:, : bs.shape[1]]
        bs2 = bs + hotm
        if tc is None:
            tc, bc = (ts + bs2 > 0).to(ts.dtype), torch.zeros_like(ts)
        final = finalize_scores(ts, tc, bs2, bc, idx.mag_title, idx.mag_body, idx.pagerank,
                                jql2, tp)
        for name, fn in (("K1", k1_call),
                         ("hot matmul", lambda: hot_body_scores(idx.hot_body_w, jsids2)),
                         ("finalize", lambda: finalize_scores(
                             ts, tc, bs2, bc, idx.mag_title, idx.mag_body, idx.pagerank, jql2,
                             tp)),
                         ("exact_top_k k=50", lambda: exact_top_k(final, 50,
                                                                  doc_map=idx.doc_perm))):
            parts[name] = check.time_on(fn, dev, iters=reps, warmup=1)
        say("parts of the HOT engine config (ms): " + ", ".join(
            f"{k} {v:.4f}" for k, v in parts.items()))
        res["parts_ms"] = parts
    res.update(ok=ok, launches=util.launches(), **util.card(dev))
    return res


def main(argv=None) -> dict:
    return util.main_with(run, __doc__, argv)


if __name__ == "__main__":
    raise SystemExit(0 if main()["ok"] else 1)
