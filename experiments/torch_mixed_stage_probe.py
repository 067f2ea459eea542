#!/usr/bin/env python3
"""mixed_stage_probe.py on the PyTorch port: where the time of a mixed
B=128 rank goes, by stage, and what the sparse phrase lane's matcher
costs.

    python3 experiments/torch_mixed_stage_probe.py [--pages 100000] [--device cuda] [--reps 5]

The corpus is the benchmark corpus of --pages pages (the original's, 100k;
built under build/bench/corpus{n//1000}k when missing), the engine warmed
first. The original's batch: the first 128 of bench_queries(snap, 256,
phrase_every=8). Stages, each timed on the host clock (best of --reps, the
work synchronized where the original blocked until ready):
  A  QueryEngine.rank() on the mixed batch (on this index, the fused
     mixed lane: K2, the hot fold, finalize, top-50, the fetch);
  A' rank() on a keyword-only batch (the batch's keyword-only queries,
     repeated to 128: K1);
  B  the sparse lane's matcher on the batch's phrase rows
     (QueryEngine._match_phrases_batch: matcher, compression, fetch), and
     the fold width it would need (the e level);
  the residual A - A' - B;
  and ops/phrase.py match_phrase_fwd_batch alone per posting-cap level x
  bp in {4, 16}, on a two-term phrase of terms whose df is near the level.
The exactness check (the original has none; this one ties the two phrase
lanes together): the sparse matcher's matches for the batch's phrase rows
equal the dense phrase stage's (ops/kernels/mixed.py plain_phrase_delta
on the position planes): the same docs, title and body weights within
rtol 1e-6. Prints the original's lines, then one JSON line; main()
returns the same dict (chip_smoke.py phase 17 calls run() on its
engine).
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_probe_util as util  # noqa: E402


def sparse_matches_dense(eng, snap, ph_rows: list, matches: list) -> dict:
    """The sparse matcher's per-row (docs, title_w, body_w, flag) against
    plain_phrase_delta on the same phrases (at most P_LEVELS[-1] terms)."""
    import torch

    from spaghettisearch_tpu_torch.ops.kernels.mixed import plain_phrase_delta
    from spaghettisearch_tpu_torch.retrieval.engine import P_LEVELS

    idx = eng.index
    dev = idx.device
    p = P_LEVELS[-1]
    ph_ids = np.full((len(ph_rows), p), snap.n_words, np.int32)
    ph_valid = np.zeros((len(ph_rows), p), np.float32)
    for i, hashes in enumerate(ph_rows):
        ids = snap.term_ids(hashes)[:p]
        ph_ids[i, : len(ids)] = ids
        ph_valid[i, : len(ids)] = 1.0
    t, bd = idx.title, idx.body
    add_t, add_b, flag = plain_phrase_delta(
        t.fwd.ftT, t.fwd.fwT, bd.fwd.ftT, bd.fwd.fwT, t.posT, bd.posT,
        torch.from_numpy(ph_ids).to(dev), torch.from_numpy(ph_valid).to(dev), emit_flag=True,
    )
    add_t, add_b, flag = (x.cpu().numpy() for x in (add_t, add_b, flag))
    ok, n_docs, max_rel = True, 0, 0.0
    for i, (d, tw, bw, _) in enumerate(matches):
        want = np.flatnonzero(flag[i] > 0)
        same = np.array_equal(np.sort(d), want)
        ok &= bool(same)
        n_docs += len(want)
        if same and len(d):
            o = np.argsort(d)
            for got, ref in ((tw[o], add_t[i, want]), (bw[o], add_b[i, want])):
                ok &= bool(np.allclose(got, ref, rtol=1e-6, atol=0.0))
                rel = np.abs(got - ref) / np.maximum(np.abs(ref), 1e-30)
                max_rel = max(max_rel, float(np.where(ref != 0, rel, np.abs(got - ref)).max()))
    return {"ok": ok, "matched_docs": n_docs, "max_rel": max_rel}


def run(snap, db, eng, reps: int = 5, say=print, warm: bool = True) -> dict:
    from spaghettisearch_tpu_torch.ops.phrase import match_phrase_fwd_batch
    from spaghettisearch_tpu_torch.retrieval import engine as E

    idx = eng.index
    dev = idx.device
    if warm:
        say("index on device; warming ...")
        eng.warmup()
    parsed = util.parsed_queries(snap, db, 256, 8)[:128]
    n_ph = sum(1 for p in parsed if p.phrase_hashes)
    say(f"batch: 128 queries, {n_ph} with phrases; fused lane "
        f"{eng.model.supports_mixed(idx)}")
    ms = {}
    util.reset_launches()
    ms["A rank() mixed"] = util.time_host(lambda: eng.rank(parsed), reps)
    say(f"A rank() mixed 128-batch: {ms['A rank() mixed']:.4f} ms")
    kw_only = [p for p in parsed if not p.phrase_hashes]
    kw_batch = (kw_only * 3)[:128]
    kw_ms = ms["A' rank() keyword-only"] = util.time_host(lambda: eng.rank(kw_batch), reps)
    say(f"A' rank() keyword-only 128-batch: {kw_ms:.4f} ms")
    launches = util.launches()
    ph_rows = [p.phrase_hashes for p in parsed if p.phrase_hashes]
    ms["B matcher"] = util.time_host(lambda: eng._match_phrases_batch(ph_rows), reps)
    say(f"B matcher+compress+fetch ({len(ph_rows)} phrases): {ms['B matcher']:.4f} ms")
    matches = eng._match_phrases_batch(ph_rows)
    e_real = max((len(m[0]) for m in matches), default=1)
    e = next(lvl for lvl in E._e_levels(idx.n_docs) if e_real <= lvl)
    say(f"e_real={e_real} -> e level {e}")
    residual = ms["A rank() mixed"] - ms["A' rank() keyword-only"] - ms["B matcher"]
    say(f"residual (A - A' - B) ~= {residual:.4f} ms")

    t_w, b_w = eng._phrase_weights(idx)
    t_fwd, b_fwd = idx.title.fwd_device(), idx.body.fwd_device()
    df = np.diff(np.asarray(snap.body.post_offsets[: snap.n_words + 1]))
    matcher = {}
    for cap in E._cap_levels(idx.posting_cap):
        for bp in (4, 16):
            ids = np.full((bp, 4), snap.n_words, np.int32)
            valid = np.zeros((bp, 4), bool)
            gens = np.zeros(bp, np.int32)
            cand = np.flatnonzero((df > cap // 4) & (df <= cap))
            if not cand.size:
                cand = np.flatnonzero(df > 0)
            ids[:, :2] = [int(cand[0]), int(cand[min(1, len(cand) - 1)])]
            valid[:, :2] = True
            args = [util.tensor(a, dev) for a in (ids, valid, gens)]

            def call(args=args, cap=cap):
                match_phrase_fwd_batch(
                    t_fwd.ft, t_fwd.fj, t_w, idx.title.pos_offsets, idx.title.positions,
                    b_fwd.ft, b_fwd.fj, b_w, idx.body.pos_offsets, idx.body.positions,
                    idx.title.offsets, idx.title.doc_ids, idx.body.offsets, idx.body.doc_ids,
                    *args, idx.title.pos_mat, idx.body.pos_mat,
                    posting_cap=cap, pos_cap=idx.pos_cap, n_docs=idx.match_pad,
                )
                util.sync(dev)

            matcher[f"cap={cap} bp={bp}"] = util.time_host(call, max(reps // 2, 1))
            say(f"  matcher cap={cap} bp={bp}: {matcher[f'cap={cap} bp={bp}']:.4f} ms "
                "(synchronized)")
    rep = sparse_matches_dense(eng, snap, ph_rows, matches)
    say(f"sparse matcher vs the dense phrase stage on {len(ph_rows)} phrases: {rep}")
    return {"probe": "mixed_stage", "docs": idx.n_docs, "phrase_rows": n_ph, "ms": ms,
            "residual_ms": residual, "e_real": e_real, "e_level": e, "matcher_ms": matcher,
            "vs_dense": rep, "ok": rep["ok"], "launches": launches, **util.card(dev)}


def main(argv=None) -> dict:
    return util.main_with(run, __doc__, argv, n_default=100_000, positional=False, reps=5)


if __name__ == "__main__":
    raise SystemExit(0 if main()["ok"] else 1)
