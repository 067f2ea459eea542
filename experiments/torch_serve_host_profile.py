#!/usr/bin/env python3
"""serve_host_profile.py on the PyTorch port: the host half of the serving
stack alone (fastloop + micro-batcher + native hydration + the bench's
selector client) with the rank replaced by an instant fake, on the
benchmark corpus. Gives the host's QPS ceiling and the batcher's spans per
batch (utils.timing TRACER), and optionally cProfiles the run.

    python3 experiments/torch_serve_host_profile.py [--pages 100000] [--conns 256]
        [--cprofile] [--device cuda] [--seed 0] [--warmS 3] [--seconds 10]

The fake rank is stable per query text, as the original's: a real rank's
top-50 is a function of the query, so repeated queries hit the native
assembler's (doc, query) summary cache. The index is still built on
--device (the engine needs one), but no kernel runs. The client is the
port's bench client (serve/loadclient.py): an answer without a
Content-Length is counted as a protocol error. Prints the original's lines,
then one JSON line; main() returns the same dict.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pages", type=int, default=100_000)
    ap.add_argument("--conns", type=int, default=256)
    ap.add_argument("--cprofile", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu, never a fallback")
    ap.add_argument("--seed", type=int, default=0, help="the corpus's seed")
    ap.add_argument("--warmS", type=float, default=3.0)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)

    from spaghettisearch_tpu_torch import bench
    from spaghettisearch_tpu_torch.corpus import bench_queries
    from spaghettisearch_tpu_torch.retrieval.engine import QueryEngine
    from spaghettisearch_tpu_torch.serve.loadclient import LoadClient, post_query
    from spaghettisearch_tpu_torch.serve.server import SearchServer
    from spaghettisearch_tpu_torch.utils.timing import TRACER

    device = bench._check_device(args.device)
    db, snap = bench.load_bench_corpus(bench.ensure_bench_corpus(args.pages, device=device,
                                                                 seed=args.seed))
    queries = bench_queries(snap, 2048, seed=5, phrase_every=8, db=db)
    eng = QueryEngine(db, snapshot=snap, device=device)
    eng.prewarm_hydration()

    rng = np.random.default_rng(0)
    fake_scores = np.sort(rng.random((128, 50)).astype(np.float32), axis=1)[:, ::-1]
    id_pool = rng.integers(0, snap.n_docs, size=(4096, 50)).astype(np.int32)

    class FakeHandle:
        def __init__(self, parsed):
            self.rows = np.asarray([hash(p.raw) % id_pool.shape[0] for p in parsed], np.int64)

        def finish(self):
            return fake_scores[: len(self.rows)], id_pool[self.rows]

    eng.rank = lambda parsed, topk=50, live=None: FakeHandle(parsed).finish()
    eng.rank_async = lambda parsed, topk=50, live=None: FakeHandle(parsed)

    server = SearchServer(eng, batching=True)
    _, port = server.start_background(port=0)
    bench._raise_open_files(args.conns)
    client = LoadClient(port, [post_query(q) for q in queries], args.conns)
    try:
        client.pump(args.warmS)
        client.reset()
        TRACER.reset()
        batches0 = server.batcher.stats.batches
        prof = None
        if args.cprofile:
            import cProfile

            prof = cProfile.Profile()
            prof.enable()
        dt = client.pump(args.seconds)
        if prof is not None:
            prof.disable()
        lats = client.all_latencies()
        nb = max(server.batcher.stats.batches - batches0, 1)
        spans = {name: 1e3 * s["total_s"] / nb for name, s in TRACER.report().items()
                 if name.startswith("batch.")}
        res = {
            "host_only_qps": client.done / dt,
            "p50_ms": 1e3 * lats[len(lats) // 2] if lats else None,
            "p99_ms": 1e3 * lats[int(len(lats) * 0.99)] if lats else None,
            "requests": client.done, "non_200": client.non_200,
            "protocol_errors": client.protocol_errors, "conns": args.conns,
            "batches": nb, "mean_batch": server.batcher.stats.mean_batch,
            "spans_ms_per_batch": spans, "window_s": dt, "pages": snap.n_docs,
            "host_cores": os.cpu_count(), **bench.card(device),
        }
    finally:
        client.close()
        server.shutdown()
        db.close()
    print(f"host-only serve: {res['host_only_qps']:.0f} qps, p50 {res['p50_ms']:.1f} ms, "
          f"conns={args.conns}, mean_batch={res['mean_batch']:.1f}")
    for name, ms in spans.items():
        s = TRACER.report()[name]
        print(f"  {name}: {ms:.2f} ms/batch (count {s['count']}, mean {s['mean_ms']:.2f} ms)")
    if prof is not None:
        import pstats

        pstats.Stats(prof).sort_stats("tottime").print_stats(20)
    return res


if __name__ == "__main__":
    print(json.dumps(main()), flush=True)
