#!/usr/bin/env python3
"""post16_probe.py on the PyTorch port: int16 against f32 position planes
in the mixed program (K2 reads one or the other).

    python3 experiments/torch_post16_probe.py [n] [--device cuda] [--reps 8]

n is the benchmark corpus's page count (the original's default,
1,000,000; built under build/bench/corpus{n//1000}k when missing). The
index keeps its planes as int16 (quantize_posT, 32767 for the pad); the
f32 planes are their exact dequantization (ops/kernels/mixed.py deq_posT),
so no second index is built. The original's batches: the first 128 of
bench_queries(snap, 256, phrase_every=8) (the mixed batch, Q=4, P=16,
rows sorted phrase-first) and an all-phrase batch on the same keyword
rows, each row's phrase the phrase or the first two keywords of queries
128-255. Times score_queries_mixed (K2, the hot fold, finalize, top-50;
no bound) on both planes, by CUDA events (host clock with --device cpu),
and prints the share int16 saves. The exactness check is the original's:
scores and ids bit-equal between the two planes, in both batches. Prints
the original's lines, then one JSON line; main() returns the same dict
(chip_smoke.py phase 17 calls run()).
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch_probe_util as util  # noqa: E402


def run(snap, db, eng, reps: int = 8, say=print, f32_planes=None) -> dict:
    import torch

    from spaghettisearch_tpu_torch.ops.kernels import check
    from spaghettisearch_tpu_torch.ops.kernels.mixed import deq_posT

    idx = eng.index
    dev = idx.device
    res = {"probe": "post16", "docs": idx.n_docs}
    say(f"posT dtype={idx.body.posT.dtype if idx.pos_dense else None}")
    if not idx.pos_dense or idx.body.posT.dtype != torch.int16:
        say("FAILED: the probe expects the index's int16 planes")
        return {**res, "ok": False, **util.card(dev)}
    if f32_planes is None:
        f32_planes = (deq_posT(idx.title.posT).contiguous(), deq_posT(idx.body.posT).contiguous())
    i16_planes = (idx.title.posT, idx.body.posT)
    parsed = util.parsed_queries(snap, db, 256, 8)
    mixed = util.mixed_batch(snap, idx, parsed[:128])
    say(f"batch: phrase rows={int((mixed['pn'] > 0).sum())}")
    # the all-phrase batch: the mixed batch's keyword rows (in its order),
    # row i's phrase the phrase, else the first two keywords, of query 128 + i
    p = mixed["ph_ids"].shape[1]
    ph_ids = np.full((128, p), snap.n_words, np.int32)
    for i, pq in enumerate(parsed[128:256]):
        ids = list(snap.term_ids(pq.phrase_hashes or pq.keyword_hashes[:2])[:2])
        ph_ids[i, :2] = (ids + [0, 0])[:2]
    ph_valid = np.zeros((128, p), np.float32)
    ph_valid[:, :2] = 1.0
    allph = dict(mixed, ph_ids=torch.from_numpy(ph_ids).to(dev),
                 ph_valid=torch.from_numpy(ph_valid).to(dev),
                 pn=torch.full((128,), 2, dtype=torch.int32, device=dev))
    util.reset_launches()
    runs = {
        "mixed-128 f32": lambda: util.mixed_rank(idx, mixed, posT=f32_planes),
        "mixed-128 i16": lambda: util.mixed_rank(idx, mixed, posT=i16_planes),
        "allph-128 f32": lambda: util.mixed_rank(idx, allph, posT=f32_planes),
        "allph-128 i16": lambda: util.mixed_rank(idx, allph, posT=i16_planes),
    }
    ms = {}
    for label, fn in runs.items():
        ms[label] = check.time_on(fn, dev, iters=reps, warmup=1)
        say(f"{label}: {ms[label]:.4f} ms queued")
    saved = {}
    for tag in ("mixed-128", "allph-128"):
        f, i = ms[f"{tag} f32"], ms[f"{tag} i16"]
        saved[tag] = (f - i) / f
        say(f"{tag}: f32 {f:.4f} -> i16 {i:.4f} ms  ({saved[tag] * 100:+.1f}% saved)")
    ok = True
    exact = {}
    for tag in ("mixed-128", "allph-128"):
        exact[tag] = util.equal(runs[f"{tag} f32"](), runs[f"{tag} i16"]())
        say(f"exactness {tag}: {exact[tag]}")
        ok &= exact[tag]
    return {**res, "ms": ms, "saved": saved, "exact": exact, "ok": ok,
            "launches": util.launches(), **util.card(dev)}


def main(argv=None) -> dict:
    return util.main_with(run, __doc__, argv)


if __name__ == "__main__":
    raise SystemExit(0 if main()["ok"] else 1)
