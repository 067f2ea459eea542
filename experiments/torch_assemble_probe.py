#!/usr/bin/env python3
"""assemble_probe.py on the PyTorch port: the native batch assembler
(native/fastserve.cpp through retrieval/native_hydrate.py) alone, cold
(first pass: summary renders) against warm (the same (doc, query) pairs
again: cache-hit copies), ms per 128 x 50 batch, on the benchmark corpus;
then the warm time at k=10 and k=50, and the Python glue the batcher pays
around each call (summary.prepare_summary_query + _packed_query, and
parse_query).

    python3 experiments/torch_assemble_probe.py [--pages 100000] [--device cuda] [--seed 0]

The records come from QueryEngine.prewarm_hydration (its index is built
on --device; no kernel runs). Prints the original's lines, then one JSON
line; main() returns the same dict.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

B, K = 128, 50
N_BATCHES = 16


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pages", type=int, default=100_000)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu, never a fallback")
    ap.add_argument("--seed", type=int, default=0, help="the corpus's seed")
    args = ap.parse_args(argv)

    from spaghettisearch_tpu_torch import bench
    from spaghettisearch_tpu_torch.corpus import bench_queries
    from spaghettisearch_tpu_torch.retrieval.engine import QueryEngine, parse_query
    from spaghettisearch_tpu_torch.retrieval.summary import _packed_query, prepare_summary_query

    device = bench._check_device(args.device)
    db, snap = bench.load_bench_corpus(bench.ensure_bench_corpus(args.pages, device=device,
                                                                 seed=args.seed))
    queries = bench_queries(snap, B * N_BATCHES, seed=5, phrase_every=8, db=db)
    eng = QueryEngine(db, snapshot=snap, device=device)
    n = eng.prewarm_hydration()
    gen = getattr(eng.snapshot, "_native_hyd", None)
    print(f"prewarmed {n} docs; native gen: {gen is not None}")
    if gen is None:
        raise SystemExit("the native assembler is not built (make -C native)")

    rng = np.random.default_rng(0)
    ids = rng.integers(0, snap.n_docs, size=(B, K)).astype(np.int32)
    scores = np.sort(rng.random((B, K)).astype(np.float32), axis=1)[:, ::-1]

    def packed_for(batch_q):
        return [_packed_query(prepare_summary_query(p.stripped, p.phrases))
                for p in (parse_query(q) for q in batch_q)]

    # distinct batches (cold cache), then the same batches again (warm)
    batches = [(ids, scores, packed_for(queries[i * B:(i + 1) * B])) for i in range(N_BATCHES)]

    def run_all(k: int = K) -> float:
        i_k, s_k = ids[:, :k], np.ascontiguousarray(scores[:, :k])
        t0 = time.perf_counter()
        for _, _, p_ in batches:
            gen.assemble_batch(i_k, s_k, p_)
        return (time.perf_counter() - t0) / N_BATCHES * 1e3

    cold = run_all()
    warm = min(run_all() for _ in range(3))
    print(f"assemble_batch b={B} k={K}: cold {cold:.2f} ms, warm {warm:.2f} ms")
    warm_k = {}
    for k2 in (10, 50):
        warm_k[k2] = run_all(k2)
        print(f"  warm k={k2}: {warm_k[k2]:.2f} ms")
    t0 = time.perf_counter()
    for i in range(N_BATCHES):
        packed_for(queries[i * B:(i + 1) * B])
    prep = (time.perf_counter() - t0) / N_BATCHES * 1e3
    print(f"packed_query prep per batch: {prep:.2f} ms")
    t0 = time.perf_counter()
    for q in queries:
        parse_query(q)
    parse = (time.perf_counter() - t0) / N_BATCHES * 1e3
    print(f"parse_query per batch: {parse:.2f} ms")
    db.close()
    return {"assemble_cold_ms": cold, "assemble_warm_ms": warm, "warm_k10_ms": warm_k[10],
            "warm_k50_ms": warm_k[50], "packed_query_ms": prep, "parse_query_ms": parse,
            "batch": [B, K], "batches": N_BATCHES, "prewarmed": n, "pages": snap.n_docs,
            "host_cores": os.cpu_count(), **bench.card(device)}


if __name__ == "__main__":
    print(json.dumps(main()), flush=True)
