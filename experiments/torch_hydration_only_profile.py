#!/usr/bin/env python3
"""hydration_only_profile.py on the PyTorch port: the host's wire cost
alone: hydrate_row_json on synthetic top-50 rows (50 distinct random doc
ids and sorted random scores per query; no rank at all), after
prewarm_hydration, on the benchmark corpus, with an optional cProfile.

    python3 experiments/torch_hydration_only_profile.py [--pages 100000] [--cprofile]
        [--device cuda] [--seed 0]

The engine's index is built on --device (no kernel runs). The result's
json_sha256 is the digest of every response in query order, so another
engine can be held to the same bytes on the same rows (synthetic_rows).
Prints the original's lines, then one JSON line; main() returns the same
dict.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N_QUERIES = 512


def synthetic_rows(n_docs: int, n_rows: int, seed: int = 0) -> list[tuple[np.ndarray, np.ndarray]]:
    """Per query, (scores [50] descending, ids [50] distinct), as the
    original draws them."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n_rows):
        ids = rng.choice(n_docs, size=50, replace=False).astype(np.int32)
        scores = np.sort(rng.random(50).astype(np.float32))[::-1]
        rows.append((scores, ids))
    return rows


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
    t0 = time.perf_counter()
    eng = QueryEngine(db, snapshot=snap, device=device)
    ctor_s = time.perf_counter() - t0
    print(f"engine ctor: {ctor_s:.1f}s")
    parsed = [parse_query(q) for q in queries]
    live = eng._live
    t0 = time.perf_counter()
    n_warm = eng.prewarm_hydration()
    prewarm_s = time.perf_counter() - t0
    print(f"prewarm_hydration: {n_warm} records in {prewarm_s:.1f}s")
    rows = [(p, s, i) for p, (s, i) in zip(parsed, synthetic_rows(snap.n_docs, len(parsed)))]

    def hydrate_all() -> list[bytes]:
        return [eng.hydrate_row_json(s, i, p, live) for p, s, i in rows]

    n = len(rows)
    out = hydrate_all()  # cold summaries
    t0 = time.perf_counter()
    hydrate_all()
    dt = time.perf_counter() - t0
    total = sum(map(len, out))
    print(f"hydrate warm: {dt:.2f}s, {dt / n * 1e3:.3f} ms/query, "
          f"{total / n / 1024:.1f} KiB/resp -> {n / dt:.0f} qps single-thread")
    if args.cprofile:
        import cProfile
        import pstats

        pr = cProfile.Profile()
        pr.enable()
        hydrate_all()
        pr.disable()
        pstats.Stats(pr).sort_stats("cumulative").print_stats(30)
    db.close()
    return {"hydrate_warm_ms_per_query": dt / n * 1e3, "hydrate_warm_qps": n / dt,
            "kib_per_response": total / n / 1024, "engine_ctor_s": ctor_s,
            "prewarm_s": prewarm_s, "prewarmed": n_warm, "queries": n,
            "json_sha256": hashlib.sha256(b"\n".join(out)).hexdigest(), "pages": snap.n_docs,
            "host_cores": os.cpu_count(), **bench.card(device)}


if __name__ == "__main__":
    print(json.dumps(main()), flush=True)
