#!/usr/bin/env python3
"""headline_chain_probe.py on the PyTorch port: the headline program queued
batch by batch against its device time alone.

    python3 experiments/torch_headline_chain_probe.py [--pages 100000] [--device cuda]
        [--reps 3] [--batches 20]

The bench headline's shape on the benchmark corpus of --pages pages (the
original's 100k): --batches (20) batches of B=256 rows of 1-4 keywords
drawn proportional to body df (numpy seed 1, rows sorted by descending
term count, query_len the term count; bench._keyword_batches), each
ranked by the port's headline program (bench._forward_scorer:
score_queries_forward, K1 with the doc-sorted body bound where the layout
has it, finalize, exact top-10 through doc_perm; topics off). Timed five
ways (torch_probe_util timed_ways, ms per batch and QPS, best of
--reps): queued (every batch dispatched, one synchronization, host wall;
the original's "queued"), serial (each batch synchronized before the
next), device_only (CUDA events around each batch, queued
behind a spin kernel that holds the stream until the batch is queued:
the card's counterpart of the original's lax.scan chain), dispatch_only
(the host wall before the synchronization) and graph (one CUDA-graph
replay of the 20 batches; None with the call that broke the capture when
capture fails). The exactness check: each way's top-10 equals the queued
one's, bit for bit. Prints the original's lines, then one JSON line;
main() returns the same dict.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_probe_util as util  # noqa: E402


def run(snap, db, eng, reps: int = 3, say=print, n_batches: int = 20) -> dict:
    import torch

    from spaghettisearch_tpu_torch.bench import _forward_scorer, _keyword_batches

    idx = eng.index
    dev = idx.device
    batch, q, topk = 256, 4, 10
    batches = _keyword_batches(snap, n_batches, batch, q, seed=1, device=dev)
    score = _forward_scorer(idx, torch.zeros((batch, idx.n_categories), device=dev), topk)
    util.reset_launches()
    ms, outs, err = util.timed_ways([lambda b=b: score(b) for b in batches], dev, reps)
    launched = util.launches()
    same = util.same_outputs(outs)
    for way, v in ms.items():
        if v is not None:
            say(f"{way}: {v:.4f} ms/batch ({batch * 1e3 / v:.0f} qps)")
        elif dev.type != "cuda":
            say(f"{way}: not measured (no card)")
        else:
            say(f"{way}: not measured" + (f" (capture failed: {err})" if way == "graph"
                                          else " (a stream hold ended before a batch was queued)"))
    say(f"each way's top-10 equal to the queued one's: {same}")
    return {"probe": "headline_chain_probe", "docs": idx.n_docs, "batches": n_batches,
            "batch": batch, "topk": topk, "ms": ms,
            "qps": {k: None if v is None else batch * 1e3 / v for k, v in ms.items()},
            "equal": same, "graph_error": err, "launches": launched,
            "ok": all(same.values()), **util.card(dev)}


def main(argv=None) -> dict:
    ap = util.parser(__doc__, n_default=100_000, positional=False, reps=3)
    ap.add_argument("--batches", type=int, default=20)
    return util.main_with(run, __doc__, argv, positional=False, ap=ap, n_batches="batches")


if __name__ == "__main__":
    raise SystemExit(0 if main()["ok"] else 1)
