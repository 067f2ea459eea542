#!/usr/bin/env python3
"""split_probe.py on the PyTorch port: a mixed B=128 batch split into a
16-row mixed program (its phrase rows, K2) and a 128-row keyword program
(the rest, K1), against the one mixed program.

    python3 experiments/torch_split_probe.py [n] [--device cuda] [--reps 8]

n is the benchmark corpus's page count (the original's default,
1,000,000; built under build/bench/corpus{n//1000}k when missing). The
original's batch: the first 128 of bench_queries(snap, 256,
phrase_every=8), Q=4, P=16, rows sorted phrase-first (so its at most 16
phrase rows are rows 0-15), topics off. Programs, each timed by CUDA
events (host clock with --device cpu):
  mixed-128    score_queries_mixed on the whole batch (K2, the hot fold,
               finalize, top-50; no bound);
  mixed-16     the same on rows 0-15;
  keyword-128  score_queries_forward (K1 with the doc-sorted bound, the
               hot fold, finalize, top-50 through doc_perm) on rows
               16-127, padded back to 128 with sentinel rows;
  the split pair, mixed-16 and keyword-128 queued back to back (one
  timed call issues both).
The exactness check is the original's: the split's rows, merged on the
host, against mixed-128's rows: ids equal, scores within rtol 1e-6. A
batch with more than 16 phrase rows fails (the keyword program would drop
their phrases). Prints the original's lines, then one JSON line; main()
returns the same dict (chip_smoke.py phase 17 calls run()).
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
    from spaghettisearch_tpu_torch.ops.scoring import score_queries_forward

    idx = eng.index
    dev = idx.device
    batch = util.mixed_batch(snap, idx, util.parsed_queries(snap, db, 256, 8)[:128])
    b = 128
    n_ph = int((batch["pn"] > 0).sum())
    say(f"batch: phrase rows={n_ph}")
    res = {"probe": "split", "docs": idx.n_docs, "phrase_rows": n_ph}
    if n_ph > 16:
        say(f"FAILED: {n_ph} phrase rows exceed the 16-row mixed program")
        return {**res, "ok": False, **util.card(dev)}

    def rows(sl):
        return {k: (v[sl] if k != "perm" else v) for k, v in batch.items()}

    ph = rows(slice(0, 16))
    kw_n = b - 16
    sel = torch.cat([torch.arange(16, b), torch.zeros(b - kw_n, dtype=torch.int64)]).to(dev)
    pad = torch.arange(b, device=dev) >= kw_n
    kw = {k: batch[k][sel].clone() for k in ("term_ids", "qlen", "qn", "qnb", "hot_sids")}
    kw["term_ids"][pad] = snap.n_words  # sentinel rows
    kw["qn"][pad] = 0
    kw["qnb"][pad] = 0
    kw["hot_sids"][pad] = -1

    def run128():
        return util.mixed_rank(idx, batch)

    def run16():
        return util.mixed_rank(idx, ph)

    def runkw():
        return score_queries_forward(
            idx.title.fwd, idx.body.fwd, idx.mag_title, idx.mag_body, idx.pagerank,
            kw["term_ids"], kw["qlen"], batch["tp"], kw["qn"], kw["qnb"], kw["hot_sids"],
            idx.hot_body_w, idx.body.tmax_blocks, idx.doc_perm, topk=50,
            emit_counts=idx.has_zero_weight,
        )

    util.reset_launches()
    ms = {}
    for label, fn in (("mixed-128", run128), ("mixed-16", run16), ("keyword-128", runkw)):
        ms[label] = check.time_on(fn, dev, iters=reps, warmup=1)
        say(f"{label}: {ms[label]:.4f} ms queued")
    ms["SPLIT pair"] = check.time_on(lambda: (run16(), runkw()), dev, iters=reps, warmup=1)
    say(f"SPLIT pair: {ms['SPLIT pair']:.4f} ms / effective 128-batch "
        f"({b * 1e3 / ms['SPLIT pair']:.0f} qps)")
    s128, i128 = (x.cpu().numpy() for x in run128())
    s16, i16 = (x.cpu().numpy() for x in run16())
    skw, ikw = (x.cpu().numpy() for x in runkw())
    ok_ph = bool((i128[:16] == i16).all() and np.allclose(s128[:16], s16, rtol=1e-6))
    ok_kw = bool((i128[16:] == ikw[:kw_n]).all()
                 and np.allclose(s128[16:], skw[:kw_n], rtol=1e-6, equal_nan=True))
    say(f"exactness: phrase_rows={ok_ph}  keyword_rows={ok_kw}")
    return {**res, "ms": ms, "exact": {"phrase_rows": ok_ph, "keyword_rows": ok_kw},
            "ok": ok_ph and ok_kw, "launches": util.launches(), **util.card(dev)}


def main(argv=None) -> dict:
    return util.main_with(run, __doc__, argv)


if __name__ == "__main__":
    raise SystemExit(0 if main()["ok"] else 1)
