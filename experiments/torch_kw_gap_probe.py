#!/usr/bin/env python3
"""kw_gap_probe.py on the PyTorch port: is there a gap between the engine's
keyword program and the same program composed by hand?

    python3 experiments/torch_kw_gap_probe.py [n] [--device cuda] [--reps 3]

On the benchmark corpus of n pages (the original's 1,000,000), in one
process, on the same keyword-only B=128 batch (the first 128 keyword
queries of bench_queries(snap, 1024, phrase_every=8)):
  - the engine's path: QueryEngine.rank_async (score_keywords ->
    score_queries_forward), 6 batches queued then finished, best of
    --reps;
  - the hand-composed program: K1 (forward_scores_2sec with the hot
    split's qnb and the doc-sorted body bound), the hot matmul fold,
    candidacy, finalize and the exact top-50 through doc_perm, one
    function taking the index arrays as arguments, on the rows the engine
    fills (QueryEngine._fill_keyword_rows), sorted by np.lexsort((-qn,
    -qnb)); 6 calls queued, one synchronization, best of --reps.
Both ms per batch on the host clock, and the gap. Counts are kept where
the index needs them (a zero weight), as the engine keeps them; the
original's call elided them.

The check, the original's (kw_gap_probe.py:123-124): the engine's rows
(request order) against the hand-composed rows (sort order, undone):
ids equal, scores within rtol 1e-6. Prints the original's lines, then one
JSON line; main() returns the same dict (chip_smoke.py phase 17 calls
run() on its own engine).
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_probe_util as util  # noqa: E402


def hand_composed(tftT, tfwT, bftT, bfwT, btmax, hot_w, magt, magb, pr, dperm,
                  ti, ql, tp, qn, qnb, hs, emit_counts: bool):
    """K1 + the hot fold + finalize + exact top-50, written out."""
    import torch

    from spaghettisearch_tpu_torch.ops.kernels.membership import forward_scores_2sec
    from spaghettisearch_tpu_torch.ops.scoring import (
        exact_top_k, finalize_scores, hot_body_scores,
    )

    ts, tc, bs, bc = forward_scores_2sec(tftT, tfwT, bftT, bfwT, ti, qn,
                                         emit_counts=emit_counts, qnb=qnb, body_tmax=btmax)
    if hot_w is not None:
        hot = hot_body_scores(hot_w, hs)[:, : bs.shape[1]]
        bs = bs + hot
        if bc is not None:
            bc = bc + (hot > 0).to(bs.dtype)
    if tc is None:
        tc = (ts + bs > 0).to(ts.dtype)
        bc = torch.zeros_like(tc)
    final = finalize_scores(ts, tc, bs, bc, magt, magb, pr, ql, tp)
    return exact_top_k(final, 50, doc_map=dperm)


def run(snap, db, eng, reps: int = 3, say=print) -> dict:
    import torch

    from spaghettisearch_tpu_torch.retrieval.engine import QueryEngine

    idx = eng.index
    dev = idx.device
    parsed = [p for p in util.parsed_queries(snap, db, 1024, 8) if not p.phrase_hashes]
    kw_batch = parsed[:128]
    b, q = len(kw_batch), 4

    util.reset_launches()
    a = util.pipelined_ms(eng, kw_batch, reps, chain=6)
    say(f"engine kw-{b} queued: {a:.4f} ms ({b * 1e3 / a:.0f} qps)")

    hot_map = idx.hot_body_map
    term_ids, qlen, qn, qnb, hot_sids = QueryEngine._fill_keyword_rows(
        kw_batch, b, q, snap, hot_map
    )
    perm = np.lexsort((-qn, -qnb))
    split = hot_map is not None
    idx_args = (idx.title.fwd.ftT, idx.title.fwd.fwT, idx.body.fwd.ftT, idx.body.fwd.fwT,
                idx.body.tmax_blocks, idx.hot_body_w if split else None, idx.mag_title,
                idx.mag_body, idx.pagerank, idx.doc_perm)
    jargs = (util.tensor(term_ids[perm], dev), util.tensor(qlen[perm], dev),
             torch.zeros((b, idx.n_categories), dtype=torch.float32, device=dev),
             util.tensor(qn[perm], dev),
             util.tensor(qnb[perm], dev) if split else None,
             util.tensor(hot_sids[perm], dev) if split else None)

    def fused():
        return hand_composed(*idx_args, *jargs, emit_counts=idx.has_zero_weight)

    def queued_fused(inner: int = 6) -> float:
        for _ in range(2):
            fused()
        util.sync(dev)
        best = float("inf")
        for _ in range(max(reps, 1)):
            t0 = time.perf_counter()
            outs = [fused() for _ in range(inner)]
            outs[-1][0][:, :1].cpu()
            outs[0][0][:, :1].cpu()
            best = min(best, (time.perf_counter() - t0) / inner)
        return best * 1e3

    c = queued_fused()
    launched = util.launches()
    say(f"hand-composed kw-{b} queued: {c:.4f} ms ({b * 1e3 / c:.0f} qps)")
    say(f"gap: {a - c:+.4f} ms ({(a - c) / a * 100:+.1f}%)")

    # exactness: engine rows are in request order, hand-composed rows in
    # sort order; undo the sort (inv = argsort(perm)) before comparing
    es, ei = eng.rank(kw_batch)
    fs, fi = (t.cpu().numpy() for t in fused())
    inv = np.argsort(perm)
    fs, fi = fs[inv], fi[inv]
    ids_equal = bool(np.array_equal(ei, fi))
    finite = np.isfinite(es)
    scores_close = bool(np.array_equal(finite, np.isfinite(fs))
                        and np.allclose(es[finite], fs[finite], rtol=1e-6))
    say(f"ids_equal: {ids_equal} scores_close: {scores_close}")
    return {"probe": "kw_gap_probe", "docs": idx.n_docs, "doc_sort": idx.doc_perm is not None,
            "hot_split": split, "ms": {"engine": a, "hand_composed": c},
            "gap_ms": a - c, "gap_pct": (a - c) / a * 100, "ids_equal": ids_equal,
            "scores_close": scores_close, "launches": launched,
            "ok": ids_equal and scores_close, **util.card(dev)}


def main(argv=None) -> dict:
    return util.main_with(run, __doc__, argv, reps=3)


if __name__ == "__main__":
    raise SystemExit(0 if main()["ok"] else 1)
