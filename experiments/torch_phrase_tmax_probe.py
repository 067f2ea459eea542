#!/usr/bin/env python3
"""phrase_tmax_probe.py on the PyTorch port: the doc-sorted body bound on
the mixed kernel's (K2's) phrase work, through the engine.

    python3 experiments/torch_phrase_tmax_probe.py [n] [--device cuda] [--reps 3] [--inner 6]

n is the benchmark corpus's page count (the original's default,
1,000,000; built under build/bench/corpus{n//1000}k when missing); the
engine's index is built doc-sorted. The original's batches, from
bench_queries(snap, 1024, phrase_every=8): the first 128 queries (the
mixed batch; its phrase rows counted) and 128 of the phrase queries
repeated (the all-phrase batch). Each is ranked through
QueryEngine.rank_async with the engine's model wrapped so that its
score_mixed passes the index's body_tmax at a stage (the original patched
the class; here the wrapper rides the call's live triple): static (no bound, the engine's
own call), tmax_stage="phrase" (the rescan after a phrase-hit log
overflow) and "both" (that and K2's one sweep of the body slots). The
original's chunk sizes tc16 and tc32 collapse into one variant each: K2
has no tc (a thread walks its own doc's slots). Timed on the host clock
around rank_async ... finish, queued --inner (6) deep, best of --reps. The
exactness check is the original's: each bounded top-50 equal to the
static one bit for bit (scores and ids). Prints the original's lines,
then one JSON line; main() returns the same dict (chip_smoke.py phase 17
calls run() on its engine).
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_probe_util as util  # noqa: E402


class StageRanker:
    """The engine's model, whose fused mixed lane bounds K2's body loops at
    `stage` (None: the static call); everything else is the model's."""

    def __init__(self, base, stage: str | None) -> None:
        self._base, self.stage = base, stage

    def __getattr__(self, name):
        return getattr(self._base, name)

    def score_mixed(self, index, term_ids, qlen, topic_probs, ph_ids, ph_valid, topk=None,
                    qn=None, pn=None, qnb=None, hot_sids=None):
        from spaghettisearch_tpu_torch.ops.scoring import score_queries_mixed

        k = min(topk or self._base.topk, index.n_docs) or 1
        qnb, hot_sids, hot_w = self._base._hot_args(index, term_ids, qn, qnb, hot_sids)
        bound = {} if self.stage is None else {"body_tmax": index.body.tmax_blocks,
                                               "tmax_stage": self.stage}
        return score_queries_mixed(
            index.title.fwd, index.body.fwd, index.title.posT, index.body.posT,
            index.mag_title, index.mag_body, index.pagerank, term_ids, qlen, topic_probs,
            ph_ids, ph_valid, qn, pn, qnb, hot_sids, hot_w, index.doc_perm, topk=k,
            emit_counts=index.has_zero_weight, **bound,
        )


def queued(eng, batch, live, reps: int, inner: int = 6):
    """ms per batch: best of reps runs of `inner` rank_async calls queued,
    then finished; after two untimed calls. -> (ms, the first result)."""
    out = eng.rank_async(batch, live=live).finish()
    eng.rank_async(batch, live=live).finish()
    best = float("inf")
    for _ in range(max(reps, 1)):
        t0 = time.perf_counter()
        hs = [eng.rank_async(batch, live=live) for _ in range(inner)]
        for h in hs:
            h.finish()
        best = min(best, (time.perf_counter() - t0) / inner)
    return best * 1e3, out


def run(snap, db, eng, reps: int = 3, say=print, inner: int = 6) -> dict:
    import numpy as np

    idx = eng.index
    dev = idx.device
    res = {"probe": "phrase_tmax", "docs": idx.n_docs}
    say(f"fused={eng.model.supports_mixed(idx)} doc_sorted={idx.doc_perm is not None} "
        f"tmax_blocks={'yes' if idx.body.tmax_blocks is not None else 'NO'}")
    if idx.body.tmax_blocks is None or not eng.model.supports_mixed(idx):
        say("FAILED: no doc-sorted layout or no fused mixed lane: the probe is moot")
        return {**res, "ok": False, **util.card(dev)}
    parsed = util.parsed_queries(snap, db, 1024, 8)
    mixed = parsed[:128]
    ph = [p for p in parsed if p.phrase_hashes]
    allph = (ph * ((127 + len(ph)) // len(ph)))[:128]
    n_ph = sum(1 for p in mixed if p.phrase_hashes)
    say("(tc16 / tc32: one variant each, K2 has no tc)")
    util.reset_launches()
    ms, exact = {}, {}
    ok = True
    for label, batch in (("mixed16", mixed), ("allph", allph)):
        outs = {}
        for stage in (None, "phrase", "both"):
            tag = f"{label}/{'static' if stage is None else stage}"
            live = (eng.snapshot, idx, StageRanker(eng.model, stage))
            ms[tag], outs[tag] = queued(eng, batch, live, reps, inner)
            say(f"{tag}: {ms[tag]:.4f} ms/128-batch ({128e3 / ms[tag]:.0f} qps)")
        s0, i0 = outs[f"{label}/static"]
        for tag, (s, i) in outs.items():
            if tag.endswith("static"):
                continue
            s_eq = bool(np.array_equal(s0, s))
            i_eq = bool(np.array_equal(i0, i))
            say(f"  {tag}: scores_bitwise={s_eq} ids_equal={i_eq}")
            exact[tag] = s_eq and i_eq
            ok &= exact[tag]
    say(f"(mixed batch carries {n_ph} phrase rows)")
    return {**res, "phrase_rows": n_ph, "ms": ms, "exact": exact, "ok": ok,
            "launches": util.launches(), **util.card(dev)}


def main(argv=None) -> dict:
    ap = util.parser(__doc__, reps=3)
    ap.add_argument("--inner", type=int, default=6, help="calls queued per timed run")
    return util.main_with(run, __doc__, argv, ap=ap, doc_sort=True, inner="inner")


if __name__ == "__main__":
    raise SystemExit(0 if main()["ok"] else 1)
