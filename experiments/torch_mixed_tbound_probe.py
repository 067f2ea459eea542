#!/usr/bin/env python3
"""mixed_tbound_probe.py on the PyTorch port: the doc-sorted layout's body
bound (body_tmax) in the mixed kernel (K2), on the engine's mixed program.

    python3 experiments/torch_mixed_tbound_probe.py [n] [--natural] [--device cuda] [--reps 8]

n is the benchmark corpus's page count (the original's default,
1,000,000; built under build/bench/corpus{n//1000}k when missing); the
index is built doc-sorted (--natural: the natural layout, where there is
no bound and only the static program runs). The original's program: the
engine configuration of the mixed lane, score_queries_mixed with topk=50,
the hot split, counts as the index needs them, on the first 128 of
bench_queries(snap, 256, phrase_every=8) (Q=4, P=16, rows sorted
phrase-first, topics off). Variants on the same layout: static (no
body_tmax, the engine's own call) and body_tmax with each tmax_stage:
"kw" (the bound on K2's one sweep of the body slots), "phrase" (on the
rescan after a phrase-hit log overflow; score_queries_mixed's default)
and "both". The original's doc_block 256 / 512 variants have no
counterpart: K2 has one launch geometry. Timed by CUDA events (host clock
with --device cpu). The exactness check is the original's, made strict:
each bounded top-50 equal to the static one bit for bit (scores and ids).
Prints the original's lines, then one JSON line; main() returns the same
dict (chip_smoke.py phase 17 calls run(); the bounded launches are the
kernels line's mixed_tmax).
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_probe_util as util  # noqa: E402

STAGES = ("kw", "phrase", "both")


def run(snap, db, eng, reps: int = 8, say=print) -> dict:
    from spaghettisearch_tpu_torch.ops.kernels import check

    idx = eng.index
    dev = idx.device
    res = {"probe": "mixed_tbound", "docs": idx.n_docs, "doc_sort": idx.doc_perm is not None}
    if not idx.pos_dense:
        say("FAILED: the index has no position planes (the mixed lane is off)")
        return {**res, "ok": False, **util.card(dev)}
    tmax = idx.body.tmax_blocks
    if tmax is not None:
        tm = tmax.cpu().numpy()
        tb = idx.body.fwd.ftT.shape[0]
        say(f"body T_pad={tb}  tmax mean={tm.mean():.1f} max={tm.max()}  "
            f"swept_frac={tm.mean() / tb:.3f}")
        res.update(t_pad=tb, tmax_mean=float(tm.mean()), swept_frac=float(tm.mean() / tb))
    batch = util.mixed_batch(snap, idx, util.parsed_queries(snap, db, 256, 8)[:128])
    pn, qnb = batch["pn"].cpu().numpy(), batch["qnb"].cpu().numpy()
    say(f"batch: pn>0 rows={int((pn > 0).sum())}  "
        f"qnb hist={np.bincount(qnb, minlength=5).tolist()}")
    variants = [("static", {})]
    if tmax is not None:
        variants += [(f"dynamic {s}", {"body_tmax": tmax, "tmax_stage": s}) for s in STAGES]
    say("(doc_block 256 / 512 variants: no counterpart, K2 has one launch geometry)")
    util.reset_launches()
    ms, outs = {}, {}
    for label, kw in variants:
        outs[label] = util.mixed_rank(idx, batch, **kw)
        ms[label] = check.time_on(lambda kw=kw: util.mixed_rank(idx, batch, **kw), dev,
                                  iters=reps, warmup=1)
        say(f"{label}: {ms[label]:.4f} ms/128-batch ({128e3 / ms[label]:.0f} qps)")
    launches = util.launches()
    ok = tmax is not None or eng.index.doc_perm is None
    exact = {}
    ss, si = outs["static"]
    for label, (ds, di) in outs.items():
        if label == "static":
            continue
        exact[label] = util.equal((ds, di), (ss, si))
        say(f"exactness[{label}]: id_agree={float((si == di).float().mean()):.4f}  "
            f"bitwise={exact[label]}")
        ok &= exact[label]
    if not ok and tmax is None:
        say("FAILED: a doc-sorted index without body_tmax")
    return {**res, "phrase_rows": int((pn > 0).sum()), "ms": ms, "exact": exact, "ok": ok,
            "launches": launches, **util.card(dev)}


def main(argv=None) -> dict:
    ap = util.parser(__doc__)
    ap.add_argument("--natural", action="store_true", help="the natural layout (no bound)")
    natural = ap.parse_args(argv).natural
    return util.main_with(run, __doc__, argv, ap=ap, doc_sort=not natural)


if __name__ == "__main__":
    raise SystemExit(0 if main()["ok"] else 1)
