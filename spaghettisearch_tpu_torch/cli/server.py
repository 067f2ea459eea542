"""Server CLI on the PyTorch/CUDA port (reference: cmd/server/server.go:87-125
with $PORT env).

    python -m spaghettisearch_tpu_torch.cli.server --db ./db_data [--device cuda]

--device defaults to cuda and the CLI refuses to start without CUDA;
--device cpu is an explicit choice (the plain-version CPU recipe), never a
fallback. --ranker bm25 serves Okapi BM25 (models/bm25.py) instead of the
reference blend. --meshShards N serves the doc-sharded mesh
(retrieval/sharded_engine.py): on --device cuda one shard per visible card,
and N above the card count exits with a message (the mesh never shrinks);
--device cuda:N puts every shard on that card, --device cpu every shard on
the CPU. --platform (a JAX backend switch) exits with a message.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

import torch

from ..store.tables import Database
from ..retrieval.engine import QueryEngine
from ..serve.server import SearchServer

_NOT_PORTED = "{} is not ported to the PyTorch package yet (see ROADMAP.md)"


#: the start-up line that says whether phrase-class segregation is on
SEGREGATION_LINE = "Phrase-class segregation: "


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description="SpaghettiSearch server (PyTorch/CUDA)")
    ap.add_argument("--db", default="./db_data")
    ap.add_argument("--port", type=int, default=int(os.environ.get("PORT") or 8080))
    ap.add_argument("--device", default="cuda",
                    help="torch device to rank on: cuda (default), cuda:N, or "
                         "cpu to serve with the kernels' plain versions")
    ap.add_argument("--topicModel", action="store_true",
                    help="enable the topic-sensitive PageRank blend "
                         "(repaired probability model)")
    ap.add_argument("--topicQuirk", action="store_true",
                    help="with --topicModel: reproduce the reference's "
                         "zero-seeded probability product, which always "
                         "yields 0 (retrieval/main_retrieve.go:142-145)")
    ap.add_argument("--snapshot", default=None,
                    help="load a saved columnar snapshot instead of walking the store")
    ap.add_argument("--ranker", choices=("blended", "bm25"), default="blended",
                    help="blended = the reference's TF-IDF/PageRank formula; "
                         "bm25 = Okapi BM25 with field boosts")
    ap.add_argument("--meshShards", type=int, default=0,
                    help="serve with the doc-sharded scorer over N mesh "
                         "shards (0 = single-device engine)")
    ap.add_argument("--meshBatch", type=int, default=1,
                    help="with --meshShards: query-data-parallel rows of a "
                         "2-D mesh")
    ap.add_argument("--platform", default=None)
    ap.add_argument("--bigBatch", action="store_true",
                    help="serve with a 256-row micro-batch ceiling "
                         "(single-device engine only)")
    ap.add_argument("--noBatching", action="store_true")
    ap.add_argument("--fetchers", type=int, default=1,
                    help="concurrent device->host fetch threads in the "
                         "micro-batcher")
    ap.add_argument("--phraseSegregate", default="auto",
                    choices=("auto", "on", "off"),
                    help="phrase-class batch segregation (see MicroBatcher)")
    ap.add_argument("--phrasePatienceMs", type=float, default=250.0,
                    help="max extra wait for a non-full phrase-class batch "
                         "while keyword work is pending")
    ap.add_argument("--phrasePoolMin", type=int, default=0,
                    help="merge the pooled phrase cohort into one mixed "
                         "batch once this many phrases wait (0 = off)")
    ap.add_argument("--phraseStale", choices=("merge", "pure"), default="merge",
                    help="patience-expired phrase cohort policy")
    ap.add_argument("--resultTimeoutS", type=float, default=300.0,
                    help="per-request batcher future timeout")
    ap.add_argument("--noWarmup", action="store_true",
                    help="skip the startup warmup (kernel build + one run "
                         "per batch shape)")
    ap.add_argument("--resultCache", type=int, default=0,
                    help="cache up to N finished /query responses per "
                         "refresh generation (0 = off)")
    args = ap.parse_args(argv)
    if args.platform is not None:
        sys.exit(_NOT_PORTED.format("--platform (a JAX backend switch)"))
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"--device {args.device}: CUDA is not available "
            "(pass --device cpu to serve on the CPU explicitly)"
        )
    n_mesh = args.meshShards * args.meshBatch
    if args.meshShards and device == torch.device("cuda") and n_mesh > torch.cuda.device_count():
        raise SystemExit(
            f"--meshShards {args.meshShards} --meshBatch {args.meshBatch} needs "
            f"{n_mesh} CUDA devices, {torch.cuda.device_count()} visible (pass "
            "--device cuda:N to put every shard on one card)"
        )

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    # the serving process must NOT run the store GC daemon (see the JAX
    # package's server CLI): compaction belongs to the single writer
    db = Database(args.db)
    snapshot = None
    if args.snapshot:
        from ..index.persist import load_snapshot

        snapshot = load_snapshot(args.snapshot)
    kwargs = {}
    if args.ranker == "bm25":
        from ..models.bm25 import BM25Ranker

        kwargs["model"] = BM25Ranker()
    cls = QueryEngine
    if args.meshShards:
        from ..retrieval.sharded_engine import ShardedQueryEngine

        cls = ShardedQueryEngine
        kwargs["n_shards"] = args.meshShards
        kwargs["n_query_rows"] = args.meshBatch
        if args.bigBatch:
            logging.getLogger("spaghettisearch.serve").warning(
                "--bigBatch is single-device only; ignoring with --meshShards"
            )
            args.bigBatch = False
    elif args.bigBatch:
        kwargs["big_batch"] = True
    if args.phraseStale == "pure" and not args.meshShards:
        kwargs["phrase_b32"] = True
    engine = cls(
        db, snapshot=snapshot, use_topic_model=args.topicModel,
        topic_model_fixed=args.topicModel and not args.topicQuirk,
        device=device, **kwargs,
    )
    print(f"Loaded index: {engine.index.n_docs} docs, {engine.index.n_words} "
          f"words on {device}")
    if not args.noWarmup:
        import time as _time

        t0 = _time.perf_counter()
        print("Warming up query shapes...", flush=True)
        engine.warmup()
        built = engine.prewarm_hydration()
        engine.prewarm_wordlist()
        print(f"Warmup done in {_time.perf_counter() - t0:.1f}s "
              f"({built} hydration records prebuilt)")
        from ..utils.timing import TRACER

        TRACER.reset()  # /stats should reflect live traffic, not warmup
    if not args.noBatching:
        # whether the micro-batcher cuts phrase-class batches apart ("auto"
        # asks the engine: large fused indexes only)
        active = args.phraseSegregate == "on" or (
            args.phraseSegregate == "auto" and engine.class_batching_pays())
        print(f"{SEGREGATION_LINE}{'active' if active else 'inactive'} "
              f"({args.phraseSegregate}, {engine.index.n_docs} docs)", flush=True)
    print(f"\nServer is running on port {args.port}")
    SearchServer(
        engine, batching=not args.noBatching, result_cache=args.resultCache,
        max_batch=256 if args.bigBatch else 128, n_fetchers=args.fetchers,
        segregate=args.phraseSegregate, ph_patience_ms=args.phrasePatienceMs,
        ph_pool_min=args.phrasePoolMin, ph_stale=args.phraseStale,
        result_timeout_s=args.resultTimeoutS,
    ).serve(port=args.port)


if __name__ == "__main__":
    main()
