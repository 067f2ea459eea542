#!/usr/bin/env python3
"""phrase_delta_probe.py on the PyTorch port: the mixed lane split into K1
(keywords) plus the phrase stage alone (K6, csrc/phrase_delta.cu), against
the fused mixed kernel (K2), on the crawl-built benchmark corpus.

    python3 experiments/torch_phrase_delta_probe.py [n] [--device cuda] [--seed 0]

n is the corpus's page count (the original's default, 1,000,000; the
corpus is built by the port's bench under build/bench/corpus{n//1000}k
when missing, which at 1M takes ~14.5 minutes on an 8-core H100 host). The
original's batch: bench_queries(snap, 256, phrase_every=8), the first 128
parsed, Q=4, P=16, rows sorted phrase-first (np.lexsort((-qn, -qnb, -pn))),
topics off. Runs, timed by CUDA events on the card (host clock with
--device cpu, where every kernel is its plain version):
  - the control, score_queries_mixed (K2, hot fold, finalize, top-50);
  - the keyword-only program (K1 with the doc-sorted bound, hot fold,
    candidacy from scores, finalize, top-50);
  - the split program, the same plus K6 over the first bp=16 rows (the
    TPU kernel's phrase doc_block 256/512/1024 become K6's one geometry);
  - the split at the full width bp=128, the shape that never compiled on
    the TPU (rows without a phrase: tiles of K6 that hold none skip).
The original's exactness check: each split's ids equal the control's and
its scores are within rtol 1e-6. The split derives candidacy from scores,
so it assumes no zero index weight; a corpus with one is reported as a
failure. Prints the original's lines, then one JSON line; main() returns
the same dict (chip_smoke.py phase 17).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BP = 16  # phrase-row budget (batch sorted phrase-first)


def split_rank(idx, batch: dict, tp, bp: int, with_phrase: bool, topk: int = 50):
    """The split program: K1 (counts elided, the doc-sorted bound), K6's
    adds on the first bp rows, the hot-term fold, candidacy from scores,
    finalize and exact top-k through doc_perm. -> (scores, ids) [B, topk]."""
    import torch

    from spaghettisearch_tpu_torch.ops.kernels import membership, phrase_delta
    from spaghettisearch_tpu_torch.ops.scoring import (
        exact_top_k, finalize_scores, hot_body_scores,
    )

    t, bd = idx.title, idx.body
    ts, _, bs, _ = membership.forward_scores_2sec(
        t.fwd.ftT, t.fwd.fwT, bd.fwd.ftT, bd.fwd.fwT, batch["term_ids"], batch["qn"],
        emit_counts=False, qnb=batch["qnb"], body_tmax=bd.tmax_blocks,
    )
    if with_phrase:
        at, ab, _ = phrase_delta.phrase_delta(
            t.fwd.ftT, t.fwd.fwT, bd.fwd.ftT, bd.fwd.fwT, t.posT, bd.posT,
            batch["ph_ids"][:bp], batch["ph_valid"][:bp], batch["pn"][:bp],
        )
        ts[:bp] += at
        bs[:bp] += ab
    if idx.hot_body_w is not None:
        bs = bs + hot_body_scores(idx.hot_body_w, batch["hot_sids"])[:, : bs.shape[1]]
    tc = (ts + bs > 0).to(ts.dtype)
    final = finalize_scores(ts, tc, bs, torch.zeros_like(tc), idx.mag_title, idx.mag_body,
                            idx.pagerank, batch["qlen"], tp)
    return exact_top_k(final, topk, doc_map=idx.doc_perm)


def control_rank(idx, batch: dict, tp, topk: int = 50):
    """The fused mixed lane (K2) as the engine runs it."""
    from spaghettisearch_tpu_torch.ops.scoring import score_queries_mixed

    return score_queries_mixed(
        idx.title.fwd, idx.body.fwd, idx.title.posT, idx.body.posT, idx.mag_title,
        idx.mag_body, idx.pagerank, batch["term_ids"], batch["qlen"], tp, batch["ph_ids"],
        batch["ph_valid"], qn=batch["qn"], pn=batch["pn"], qnb=batch["qnb"],
        hot_sids=batch["hot_sids"], hot_w=idx.hot_body_w, doc_map=idx.doc_perm,
        topk=topk, emit_counts=idx.has_zero_weight,
    )


def probe_batch(snap, db, idx, dev, b: int = 128, q: int = 4, p: int = 16) -> dict:
    """The original's batch: the first b of bench_queries(256,
    phrase_every=8), keyword rows as the engine fills them, phrase slots,
    rows sorted phrase-first."""
    import torch

    from spaghettisearch_tpu_torch.corpus import bench_queries
    from spaghettisearch_tpu_torch.retrieval.engine import QueryEngine, parse_query

    queries = bench_queries(snap, 256, phrase_every=8, db=db)
    parsed = [parse_query(x) for x in queries[:b]]
    term_ids, qlen, qn, qnb, hot_sids = QueryEngine._fill_keyword_rows(
        parsed, b, q, snap, idx.hot_body_map
    )
    ph_ids = np.full((b, p), snap.n_words, np.int32)
    ph_valid = np.zeros((b, p), np.float32)
    pn = np.zeros(b, np.int32)
    for i, pq in enumerate(parsed):
        pids = snap.term_ids(pq.phrase_hashes)[:p]
        ph_ids[i, : len(pids)] = pids
        ph_valid[i, : len(pids)] = 1.0
        pn[i] = len(pids)
    perm = np.lexsort((-qn, -qnb, -pn))
    arrays = {"term_ids": term_ids, "qlen": qlen, "qn": qn, "qnb": qnb,
              "hot_sids": hot_sids, "ph_ids": ph_ids, "ph_valid": ph_valid, "pn": pn}
    return {k: torch.from_numpy(np.ascontiguousarray(v[perm])).to(dev)
            for k, v in arrays.items()}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n", nargs="?", type=int, default=1_000_000, help="corpus pages")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0, help="the corpus's seed")
    ap.add_argument("--reps", type=int, default=8)
    args = ap.parse_args(argv)

    import torch

    from spaghettisearch_tpu_torch.bench import ensure_bench_corpus, load_bench_corpus
    from spaghettisearch_tpu_torch.ops.kernels import check, membership, mixed, phrase_delta
    from spaghettisearch_tpu_torch.retrieval.device_index import DeviceIndex

    dev = check.probe_device(args.device)
    root = ensure_bench_corpus(args.n, device=str(dev), seed=args.seed)
    db, snap = load_bench_corpus(root)
    t0 = time.perf_counter()
    idx = DeviceIndex.from_snapshot(snap, dev)
    print(f"device index in {time.perf_counter() - t0:.1f}s  "
          f"doc_sort={idx.doc_perm is not None}", flush=True)
    batch = probe_batch(snap, db, idx, dev)
    b = batch["term_ids"].shape[0]
    n_ph = int((batch["pn"] > 0).sum())
    print(f"batch: phrase rows={n_ph}", flush=True)
    tp = torch.zeros((b, idx.n_categories), dtype=torch.float32, device=dev)
    problems = []
    if n_ph > BP:
        problems.append(f"{n_ph} phrase rows exceed the budget bp={BP}")
    if idx.has_zero_weight:
        problems.append("probe assumes the count-elided regime: the index has a zero weight")
    if not idx.pos_dense:
        problems.append("the index has no position planes (the mixed lane is off)")
    if problems:
        for msg in problems:
            print(f"FAILED: {msg}", flush=True)
        res = {"probe": "phrase_delta", "device": str(dev), "n": args.n, "ok": False,
               "problems": problems}
        print(json.dumps(res), flush=True)
        db.close()
        return res

    runs = [("mixed-128 (control)", lambda: control_rank(idx, batch, tp)),
            ("fused kw-only", lambda: split_rank(idx, batch, tp, BP, False)),
            (f"fused split bp={BP}", lambda: split_rank(idx, batch, tp, BP, True)),
            (f"fused split bp={b}", lambda: split_rank(idx, batch, tp, b, True))]
    results = {}
    for k in (membership, mixed, phrase_delta):
        k.reset_launches()
    for label, fn in runs:
        out = fn()  # the warm-up call's result is the one checked
        ms = check.time_on(fn, dev, iters=args.reps, warmup=0)
        results[label] = (ms, out)
        print(f"{label}: {ms:.4f} ms queued ({b * 1e3 / ms:.0f} qps)", flush=True)
    launches = {"K1": membership.LAUNCHES, "K2": mixed.LAUNCHES, "K6": phrase_delta.LAUNCHES}

    s128, i128 = (x.cpu().numpy() for x in results["mixed-128 (control)"][1])
    ok = True
    summary = {}
    for label, (ms, got) in results.items():
        summary[label] = {"ms": ms}
        if "split" not in label:
            continue
        s, i = (x.cpu().numpy() for x in got)
        exact = bool((i == i128).all() and np.allclose(s, s128, rtol=1e-6, equal_nan=True))
        nid = int((i != i128).sum())
        fin = np.isfinite(s128) & np.isfinite(s)
        rel = float(np.max(np.abs(s[fin] - s128[fin]) / np.maximum(np.abs(s128[fin]), 1e-30),
                           initial=0.0))
        print(f"{label}: exact={exact} (id diffs {nid}, score max rel {rel:.2e})", flush=True)
        summary[label].update(exact=exact, id_diffs=nid, max_rel=rel)
        ok &= exact
    res = {"probe": "phrase_delta", "device": str(dev), "n": args.n, "docs": idx.n_docs,
           "phrase_rows": n_ph, "doc_sort": idx.doc_perm is not None, "ok": ok,
           "runs": summary, "launches": launches}
    print(json.dumps(res), flush=True)
    db.close()
    return res


if __name__ == "__main__":
    raise SystemExit(0 if main()["ok"] else 1)
