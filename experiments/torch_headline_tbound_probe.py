#!/usr/bin/env python3
"""headline_tbound_probe.py on the PyTorch port: does K1's doc-sorted
bounded sweep pay on the bench headline's program?

    python3 experiments/torch_headline_tbound_probe.py [--pages 100000] [--device cuda] [--reps 3]
        [--batches 20]

The corpus is the benchmark corpus of --pages pages (the original's, 100k;
built under build/bench/corpus{n//1000}k when missing). The original's
program: bench.py's headline, B=256, Q=4, topk=10, --batches (20) seeded batches (numpy
seed 1: per row 1-4 terms drawn proportional to body df, rows sorted by
descending term count, query_len = the term count), queued back to back
and then fetched; score_queries_forward (K1, finalize, exact top-10, topics
off, counts as the index needs them). Two layouts of the same corpus,
built with doc_sort=False and doc_sort=True (the port's index sorts a
corpus this size by default, so both are forced): the natural layout's
static sweep, and the doc-sorted one with K1's body_tmax and the ids
mapped back through doc_perm. Timed by CUDA events (host clock with
--device cpu), best of --reps runs of the batches. The exactness check:
the two layouts' top-10 values equal and the ids equal except where the
values tie (each ordered by score, then natural id); id agreement and the
largest relative score difference printed, as the original prints them.
Prints the original's lines, then one JSON line; main() returns the same
dict (chip_smoke.py phase 17 calls run() on its own index).
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_probe_util as util  # noqa: E402


def run(snap, db, eng, reps: int = 3, say=print, n_batches: int = 20) -> dict:
    import torch

    from spaghettisearch_tpu_torch.ops.kernels import check
    from spaghettisearch_tpu_torch.ops.scoring import score_queries_forward
    from spaghettisearch_tpu_torch.retrieval.device_index import DeviceIndex

    dev = eng.index.device
    batch, q, topk = 256, 4, 10
    rng = np.random.default_rng(1)
    df = (snap.body.post_offsets[1:] - snap.body.post_offsets[:-1]).astype(np.float64)
    p = df / df.sum()
    term_batches = []
    for _ in range(n_batches):
        ks = rng.integers(1, q + 1, batch)
        ks[::-1].sort()
        tids = np.full((batch, q), snap.n_words, np.int32)
        for i, k in enumerate(ks):
            tids[i, :k] = rng.choice(snap.n_words, size=int(k), p=p)
        term_batches.append(tuple(torch.from_numpy(a).to(dev) for a in (
            tids, ks.astype(np.int32), ks.astype(np.float32))))

    util.reset_launches()
    ms, outs, layout = {}, {}, {}
    for label, ds in (("natural", False), ("doc_sort", True)):
        mine = eng.index if (eng.index.doc_perm is not None) == ds else None
        t0 = time.perf_counter()
        idx = mine if mine is not None else DeviceIndex.from_snapshot(snap, dev, doc_sort=ds)
        build_s = time.perf_counter() - t0
        tp = torch.zeros((batch, idx.n_categories), dtype=torch.float32, device=dev)
        extra = {}
        if ds:
            if idx.doc_perm is None:
                raise RuntimeError("doc_sort=True built no doc-sorted layout")
            tm = idx.body.tmax_blocks.cpu().numpy()
            tb = idx.body.fwd.ftT.shape[0]
            frac = float(tm.mean() / tb)
            say(f"doc_sort: T_pad={tb} tmax mean={tm.mean():.1f} swept_frac={frac:.3f}")
            layout.update(t_pad=tb, tmax_mean=float(tm.mean()), swept_frac=frac)
            extra = dict(body_tmax=idx.body.tmax_blocks, doc_map=idx.doc_perm)

        def one(tb_, idx=idx, tp=tp, extra=extra):
            tids, qn, qlen = tb_
            return score_queries_forward(
                idx.title.fwd, idx.body.fwd, idx.mag_title, idx.mag_body, idx.pagerank,
                tids, qlen, tp, qn, topk=topk, emit_counts=idx.has_zero_weight, **extra,
            )

        def all_batches(one=one):
            return [one(t) for t in term_batches]

        best = min(check.time_on(all_batches, dev, iters=1, warmup=int(i == 0))
                   for i in range(max(reps, 1)))
        ms[label] = best / n_batches
        say(f"{label}: {ms[label]:.4f} ms/batch ({batch / ms[label] * 1e3:.0f} qps)"
            + ("" if mine is not None else f"  (index built in {build_s:.1f}s)"))
        outs[label] = all_batches()
        del idx

    agree = float(np.mean([(a[1] == b[1]).float().mean().item()
                           for a, b in zip(outs["natural"], outs["doc_sort"])]))
    rel = max(float((a[0] - b[0]).abs().nan_to_num(0.0).max()
                    / max(float(a[0].abs().nan_to_num(0.0, posinf=0.0, neginf=0.0).max()), 1e-9))
              for a, b in zip(outs["natural"], outs["doc_sort"]))
    say(f"id_agree={agree:.4f}  score_max_rel={rel:.2e}")
    reps_ = [check.compare_topk(b, a, rtol=0.0, atol=0.0)
             for a, b in zip(outs["natural"], outs["doc_sort"])]
    ok = all(r["ok"] for r in reps_)
    say(f"top-10 of the two layouts equal up to ties: {ok} "
        f"(id differences at tied values: {sum(r['id_diffs'] for r in reps_)})")
    return {"probe": "headline_tbound", "docs": snap.n_docs, "batch": batch,
            "batches": n_batches, "ms_per_batch": ms, "speedup": ms["natural"] / ms["doc_sort"],
            "layout": layout, "id_agree": agree, "score_max_rel": rel, "ok": ok,
            "launches": util.launches(), **util.card(dev)}


def main(argv=None) -> dict:
    ap = util.parser(__doc__, 100_000, positional=False, reps=3)
    ap.add_argument("--batches", type=int, default=20, help="queued batches (the original's 20)")
    return util.main_with(run, __doc__, argv, ap=ap, doc_sort=None, n_batches="batches")


if __name__ == "__main__":
    raise SystemExit(0 if main()["ok"] else 1)
