#!/usr/bin/env python3
"""shard_scale_probe.py on the PyTorch port: the shard-local programs of a
doc-sharded serve1m, measured at true shard scale on one card.

    python3 experiments/torch_shard_scale_probe.py [n] [--device cuda] [--reps 3]
        [--serve1m RESULT.json]

n is the benchmark corpus's page count (the original's 1,000,000; built
under build/bench/corpus{n//1000}k when missing). For 8 and 4 shards, the
first shard_rows(n_docs, shards) docs (512-aligned, as
parallel/sharded.py lays the doc blocks out: 125,440 and 250,368 docs at
1M) are cut from the corpus's snapshot with index.snapshot.slice_snapshot,
which keeps the global term weights, so every kept doc scores as in the
whole corpus. A QueryEngine on the slice then ranks the original's three
batches of bench_queries(snap, 1024, phrase_every=8): kw-128 (keyword
queries only), merged-128 (64 phrase rows and 64 keyword rows, the
batcher's patience-merged cohort) and mixed-16 (16 phrase rows and 112
keyword rows), each pipelined through rank_async (three batches queued
before the first finish(), best of --reps). Batch rows are replicated and
docs sharded, so every card of an n-card mesh would score the same rows
over its own slice.

The projection keeps the original's formula (shard_scale_probe.py:90-95):
    device_cycle_ms        = (7 * kw128_ms + merged128_ms) / 8 + merge_ms
    device_ceiling_qps     = 128e3 / device_cycle_ms
    pipeline_projected_qps = mean_batch * 1e3 / max(device_cycle_ms,
                                                    assemble_ms, dispatch_ms)
with the card's own figures in place of the original's three TPU-era
constants: merge_ms is the port's merge (parallel/sharded.py _merge) of n
[128, 50] pieces, timed on the card by CUDA events; the batcher's dispatch
and assemble spans and its mean batch come from a result of the port's own
serve1m (--serve1m, the JSON line `bench --mode serve1m` prints); without
that file the probe projects nothing. The copies of the pieces between
cards (n - 1 of [128, 50] scores and ids to the first card, and the batch
to every card) cannot be measured on one card: their bytes are printed and
their time is "not measured", and the projection leaves them out.

The exactness check (the original has none): on each slice, the kw-128
batch's top-50 through the kernels equals the same rank on the kernels'
plain versions on the same device (check.compare_topk: scores within
1e-6 relative, ids equal except at tied scores). K1 and K2 launch on this path; their
counts per slice are printed. Prints the original's lines, then one JSON
line; main() returns the same dict (chip_smoke.py phase 17 calls run() on
its own corpus).
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_probe_util as util  # noqa: E402

#: the batch rows and top-k of a served batch (the merge's pieces)
ROWS, TOPK = 128, 50


def shard_rows(n_docs: int, n_shards: int) -> int:
    dl = -(-n_docs // n_shards)
    return -(-dl // 512) * 512  # parallel/sharded.py doc-block alignment


def projection(kw_ms: float, merged_ms: float, merge_ms: float,
               serve1m: dict | None) -> dict:
    """The original's serve cycle (7 of 8 batches keyword, 1 merged) plus
    the merge, and, given a serve1m result, the 3-stage pipeline's
    projected rate (the cycle is its slowest stage)."""
    device_ms = (7 * kw_ms + merged_ms) / 8 + merge_ms
    out = {"device_cycle_ms": device_ms, "device_ceiling_qps": ROWS * 1e3 / device_ms,
           "pipeline_projected_qps": None}
    if serve1m is not None:
        spans = serve1m["spans_ms"]
        cycle = max(device_ms, spans["assemble"], spans["dispatch"])
        out["pipeline_projected_qps"] = serve1m["mean_batch"] * 1e3 / cycle
    return out


def merge_ms(pieces: tuple, n_shards: int, dl: int, device) -> float:
    """The port's merge of n_shards [128, 50] pieces on `device`: the
    slice's own kw-128 top-50 as every shard's piece, ids offset by the
    shard's first doc (CUDA events on a card)."""
    import torch

    from spaghettisearch_tpu_torch.ops.kernels import check
    from spaghettisearch_tpu_torch.parallel.sharded import _merge

    scores, ids = (torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in pieces)
    parts = [(scores, ids + s * dl) for s in range(n_shards)]
    return check.time_on(lambda: _merge(parts, TOPK, device), device)


def run(snap, db, device, reps: int = 3, say=print, serve1m: dict | None = None,
        shards=(8, 4)) -> dict:
    from spaghettisearch_tpu_torch.index.snapshot import slice_snapshot
    from spaghettisearch_tpu_torch.retrieval.engine import QueryEngine

    parsed = util.parsed_queries(snap, db, 1024, 8)
    kw = [p for p in parsed if not p.phrase_hashes]
    ph = [p for p in parsed if p.phrase_hashes]
    kw_batch = (kw * 2)[:ROWS]
    # the patience-merged cohort: ~64 pooled phrase rows + keyword fill
    merge_batch = (ph * 2)[:64] + kw[:64]
    mixed16 = ph[:16] + kw[64:176]
    out = {"probe": "shard_scale_probe", "docs": snap.n_docs, "host_stages": None,
           "cross_card_ms": "not measured"}
    if serve1m is not None:
        out["host_stages"] = {"dispatch_ms": serve1m["spans_ms"]["dispatch"],
                              "assemble_ms": serve1m["spans_ms"]["assemble"],
                              "mean_batch": serve1m["mean_batch"],
                              "from": serve1m.get("metric"),
                              "nvidia_smi": serve1m.get("nvidia_smi")}
    ok = True
    for n_shards in shards:
        dl = shard_rows(snap.n_docs, n_shards)
        t0 = time.perf_counter()
        sl = slice_snapshot(snap, dl)
        eng = QueryEngine(db, snapshot=sl, device=device)
        say(f"[{n_shards}-shard] slice {sl.n_docs} docs: engine in "
            f"{time.perf_counter() - t0:.1f}s fused={eng.model.supports_mixed(eng.index)} "
            f"doc_sort={eng.index.doc_perm is not None}")
        util.reset_launches()
        t_kw = util.pipelined_ms(eng, kw_batch, reps, chain=3)
        t_merge = util.pipelined_ms(eng, merge_batch, reps, chain=3)
        t_mixed16 = util.pipelined_ms(eng, mixed16, reps, chain=3)
        util.sync(device)
        launched = util.launches()
        say(f"[{n_shards}-shard @{dl}] kw-128 {t_kw:.4f} ms | merged-128 (64 ph) "
            f"{t_merge:.4f} ms | mixed-128 (16 ph) {t_mixed16:.4f} ms")
        got = eng.rank(kw_batch)
        with util.plain_kernels():
            want = eng.rank(kw_batch)
        vs_plain = util.topk_agree(got, want)
        exact = vs_plain["ok"]
        ok &= exact
        t_coll = merge_ms(got, n_shards, dl, device)
        proj = projection(t_kw, t_merge, t_coll, serve1m)
        say(f"[{n_shards}-shard] merge of {n_shards} [{ROWS}, {TOPK}] pieces {t_coll:.4f} ms; "
            f"device cycle {proj['device_cycle_ms']:.4f} ms -> device ceiling "
            f"{proj['device_ceiling_qps']:.1f} qps; pipeline-projected "
            + (f"{proj['pipeline_projected_qps']:.1f} qps (host stages from serve1m on "
               f"{serve1m.get('nvidia_smi')})" if serve1m is not None
               else "not computed (no --serve1m result)")
            + f"; kw-128 top-50 equal to the plain path: {exact}")
        # per batch: the batch's inputs to each other card, every other
        # card's [128, 50] f32 scores + int32 ids to the first
        out[f"shards{n_shards}"] = {
            "local_docs": dl,
            "kw128_ms": t_kw,
            "merged128_ms": t_merge,
            "mixed16_ms": t_mixed16,
            "merge_ms": t_coll,
            **proj,
            "cross_card_bytes_per_batch": {
                "pieces_to_first_card": (n_shards - 1) * ROWS * TOPK * 8,
                "batch_to_other_cards": (n_shards - 1) * util.count_uploads(eng, kw_batch)["bytes"],
            },
            "kw128_vs_plain": vs_plain,
            "launches": launched,
        }
        del eng
    out["ok"] = ok
    return out


def main(argv=None) -> dict:
    ap = util.parser(__doc__, reps=3)
    ap.add_argument("--serve1m", metavar="RESULT.json",
                    help="a serve1m result of the port (its batcher spans and mean batch)")
    args = ap.parse_args(argv)
    from spaghettisearch_tpu_torch.bench import ensure_bench_corpus, load_bench_corpus
    from spaghettisearch_tpu_torch.ops.kernels import check

    dev = check.probe_device(args.device)
    serve1m = None
    if args.serve1m:
        with open(args.serve1m, encoding="utf-8") as f:
            serve1m = json.load(f)
    db, snap = load_bench_corpus(ensure_bench_corpus(args.n, device=str(dev), seed=args.seed))
    try:
        res = run(snap, db, dev, reps=args.reps, serve1m=serve1m)
    finally:
        db.close()
    res.update(n=args.n, **util.card(dev))
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    raise SystemExit(0 if main()["ok"] else 1)
