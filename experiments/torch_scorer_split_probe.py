#!/usr/bin/env python3
"""scorer_split_probe.py on the PyTorch port: how much of a serving batch's
queued time is the device, and how much the host's dispatch.

    python3 experiments/torch_scorer_split_probe.py [--pages 100000] [--device cuda] [--reps 3]
        [--batches 10]

The serving shapes of the original, on the benchmark corpus of --pages
pages (its 100k): the first 128 queries of bench_queries(snap, 256,
phrase_every=8) packed as the original packs them (Q=4 keyword slots and
P=16 phrase slots, no hot split, rows sorted by np.lexsort((-qn, -pn)),
topics off), ranked by the full mixed program (score_queries_mixed: K2,
finalize, exact top-50) and by the keyword program (score_queries_forward:
K1, finalize, exact top-50); the mixed lane must be live (position planes
on the device), as the original asserts. Each program runs --batches
(the original's REPS, 10) times, timed five ways (torch_probe_util
timed_ways, ms per batch, best of --reps):
  queued         the calls back to back, one synchronization, host wall;
  serial         each call synchronized before the next, host wall;
  device_only    CUDA events around each call, queued behind a spin kernel
                 that holds the stream until the call is queued (the card's
                 counterpart of the original's "chained" lax.scan);
  dispatch_only  the host wall of the calls before the synchronization;
  graph          one CUDA-graph replay of the calls (None, with the call
                 that broke the capture, when capture fails).
The original's per-component chains (kernel, finalize, top-k alone) are
torch_probe1m_decomp.py's parts on the port. The engine's own path is also
offered to a graph capture (QueryEngine.rank_async of the same queries);
the call that breaks it is reported.

queued >> device_only => dispatch-bound. The exactness check: each way's
top-50 equals the queued one's, bit for bit, for both programs. Prints
the original's lines, then one JSON line; main() returns the same dict.
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_probe_util as util  # noqa: E402


def serving_batch(snap, parsed: list, dev, q: int = 4, p: int = 16) -> dict:
    """The original's (term_ids, qn, ph_ids, ph_valid, pn, qlen) packing of
    a phrase_every=8 serving batch, as tensors on `dev`."""
    b = len(parsed)
    term_ids = np.full((b, q), snap.n_words, np.int32)
    qn = np.zeros(b, np.int32)
    ph_ids = np.full((b, p), snap.n_words, np.int32)
    ph_valid = np.zeros((b, p), np.float32)
    pn = np.zeros(b, np.int32)
    qlen = np.ones(b, np.float32)
    for i, pq in enumerate(parsed):
        ids = snap.term_ids(pq.keyword_hashes)[:q]
        term_ids[i, : len(ids)] = ids
        qn[i] = len(ids)
        pids = snap.term_ids(pq.phrase_hashes)[:p]
        ph_ids[i, : len(pids)] = pids
        ph_valid[i, : len(pids)] = 1.0
        pn[i] = len(pids)
        qlen[i] = max(pq.query_len, 1)
    perm = np.lexsort((-qn, -pn))
    return {k: util.tensor(v[perm], dev) for k, v in (
        ("term_ids", term_ids), ("qn", qn), ("ph_ids", ph_ids), ("ph_valid", ph_valid),
        ("pn", pn), ("qlen", qlen))}


def run(snap, db, eng, reps: int = 3, say=print, n_batches: int = 10) -> dict:
    import torch

    from spaghettisearch_tpu_torch.ops import scoring

    idx = eng.index
    dev = idx.device
    if not idx.pos_dense:
        raise RuntimeError("mixed lane not active on this corpus")
    parsed = util.parsed_queries(snap, db, 256, 8)[:128]
    x = serving_batch(snap, parsed, dev)
    b = x["term_ids"].shape[0]
    tp = torch.zeros((b, idx.n_categories), dtype=torch.float32, device=dev)
    counts = idx.has_zero_weight
    say(f"corpus: {idx.n_docs} docs, T_title={idx.title.fwd.ftT.shape[0]}, "
        f"T_body={idx.body.fwd.ftT.shape[0]}, b={b}, "
        f"phrase rows {int((x['pn'] > 0).sum())}")

    def run_mixed():
        return scoring.score_queries_mixed(
            idx.title.fwd, idx.body.fwd, idx.title.posT, idx.body.posT,
            idx.mag_title, idx.mag_body, idx.pagerank,
            x["term_ids"], x["qlen"], tp, x["ph_ids"], x["ph_valid"], x["qn"], x["pn"],
            topk=50, emit_counts=counts,
        )

    def run_kw():
        return scoring.score_queries_forward(
            idx.title.fwd, idx.body.fwd, idx.mag_title, idx.mag_body, idx.pagerank,
            x["term_ids"], x["qlen"], tp, x["qn"], topk=50, emit_counts=counts,
        )

    out = {"probe": "scorer_split_probe", "docs": idx.n_docs, "batches": n_batches, "ms": {},
           "equal": {}, "graph_error": {}}
    ok = True
    for name, fn in (("mixed full (K2+finalize+topk)", run_mixed), ("keyword full", run_kw)):
        util.reset_launches()
        ms, outs, err = util.timed_ways([fn] * n_batches, dev, reps)
        launched = util.launches()
        same = util.same_outputs(outs)
        ok &= all(same.values())
        out["ms"][name] = ms
        out["equal"][name] = same
        out["graph_error"][name] = err
        out.setdefault("launches", {})[name] = launched
        fmt = {k: "n/a" if v is None else f"{v:.4f}" for k, v in ms.items()}
        say(f"{name:32s} queued {fmt['queued']} ms/rep | device-only {fmt['device_only']} | "
            f"dispatch-only {fmt['dispatch_only']} | graph {fmt['graph']}"
            + (f" (capture failed: {err})" if err else ""))
    if dev.type == "cuda":
        batch = util.parsed_queries(snap, db, 256, 8)[:128]
        graph, err = util.capture_graph([lambda: eng.rank_async(batch)], dev)
        out["engine_graph_error"] = err
        say("the engine's rank_async under graph capture: "
            + ("captured" if graph is not None else f"failed: {err}"))
    out["ok"] = ok
    out.update(util.card(dev))
    return out


def main(argv=None) -> dict:
    ap = util.parser(__doc__, n_default=100_000, positional=False, reps=3)
    ap.add_argument("--batches", type=int, default=10, help="calls per timing (the original's 10)")
    return util.main_with(run, __doc__, argv, positional=False, ap=ap, n_batches="batches")


if __name__ == "__main__":
    raise SystemExit(0 if main()["ok"] else 1)
