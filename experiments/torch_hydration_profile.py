#!/usr/bin/env python3
"""hydration_profile.py on the PyTorch port: per query on the benchmark
corpus, the rank on the card (QueryEngine.rank, B=64, 512 queries of
bench_queries(..., seed=5, phrase_every=8)) against host hydration
(hydrate_row_json), single-threaded.

    python3 experiments/torch_hydration_profile.py [--pages 100000] [--cprofile]
        [--device cuda] [--seed 0]

The rank is timed on the host clock around eng.rank, which returns host
arrays (the device's work included); the first pass includes the first
launches, the second is warm. Every 64-query batch of the mix holds a
phrase, so those take the mixed lane (K2); the mix's keyword-only queries
are then ranked on their own (warm), which takes the keyword lane (K1).
Hydration runs cold (the lazy record path: no prewarm, as the original)
and again warm. The result also gives the K1 and K2 launches of the rank
passes. Prints the original's lines, then one JSON line; main() returns
the same dict.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

B = 64
N_QUERIES = 512


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pages", type=int, default=100_000)
    ap.add_argument("--cprofile", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu, never a fallback")
    ap.add_argument("--seed", type=int, default=0, help="the corpus's seed")
    args = ap.parse_args(argv)

    from spaghettisearch_tpu_torch import bench
    from spaghettisearch_tpu_torch.corpus import bench_queries
    from spaghettisearch_tpu_torch.retrieval.engine import QueryEngine, parse_query

    device = bench._check_device(args.device)
    db, snap = bench.load_bench_corpus(bench.ensure_bench_corpus(args.pages, device=device,
                                                                 seed=args.seed))
    queries = bench_queries(snap, N_QUERIES, seed=5, phrase_every=8, db=db)
    eng = QueryEngine(db, snapshot=snap, device=device)
    parsed = [parse_query(q) for q in queries]
    live = eng._live
    n = len(parsed)

    def rank_all(qs: list) -> tuple[list, float]:
        t0 = time.perf_counter()
        out = []
        for i in range(0, len(qs), B):
            chunk = qs[i:i + B]
            out.append((chunk, *eng.rank(chunk, topk=50, live=live)))
        return out, time.perf_counter() - t0

    bench.reset_launches()
    ranked, rank_cold = rank_all(parsed)
    print(f"rank (first launches incl.): {rank_cold:.2f}s total, {rank_cold / n * 1e3:.2f} ms/query")
    _, rank_warm = rank_all(parsed)
    print(f"rank warm: {rank_warm:.2f}s total, {rank_warm / n * 1e3:.2f} ms/query")
    # every 64-query batch of the mix holds a phrase (the mixed lane, K2);
    # the keyword-only queries on their own take the keyword lane (K1)
    kw = [p for p in parsed if not p.phrase_hashes]
    rank_all(kw)
    _, rank_kw = rank_all(kw)
    launches = bench.launches()
    print(f"rank warm, the {len(kw)} keyword-only queries alone: {rank_kw:.2f}s total, "
          f"{rank_kw / len(kw) * 1e3:.2f} ms/query")

    def hydrate_all() -> int:
        total = 0
        for chunk, s, ids in ranked:
            for p, srow, irow in zip(chunk, s, ids):
                total += len(eng.hydrate_row_json(srow, irow, p, live))
        return total

    t0 = time.perf_counter()
    total = hydrate_all()
    hyd_cold = time.perf_counter() - t0
    print(f"hydrate cold: {hyd_cold:.2f}s, {hyd_cold / n * 1e3:.2f} ms/query, "
          f"{total / n / 1024:.1f} KiB/resp")
    t0 = time.perf_counter()
    hydrate_all()
    hyd_warm = time.perf_counter() - t0
    print(f"hydrate warm (doc caches hot): {hyd_warm:.2f}s, {hyd_warm / n * 1e3:.2f} ms/query "
          f"-> {n / hyd_warm:.0f} qps single-thread")
    if args.cprofile:
        import cProfile
        import pstats

        pr = cProfile.Profile()
        pr.enable()
        hydrate_all()
        pr.disable()
        pstats.Stats(pr).sort_stats("cumulative").print_stats(25)
    db.close()
    return {"rank_cold_ms_per_query": rank_cold / n * 1e3,
            "rank_warm_ms_per_query": rank_warm / n * 1e3,
            "rank_keyword_only_warm_ms_per_query": rank_kw / len(kw) * 1e3,
            "hydrate_cold_ms_per_query": hyd_cold / n * 1e3,
            "hydrate_warm_ms_per_query": hyd_warm / n * 1e3,
            "kib_per_response": total / n / 1024, "hydrate_warm_qps": n / hyd_warm,
            "queries": n, "batch": B, "launches": launches, "pages": snap.n_docs,
            "host_cores": os.cpu_count(), **bench.card(device)}


if __name__ == "__main__":
    print(json.dumps(main()), flush=True)
