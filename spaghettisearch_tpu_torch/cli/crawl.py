"""The crawl CLI of the PyTorch/CUDA port.

The port of the JAX package's cli/crawl.py (reference: the reference's
bin/crawl, cmd/crawl/start_crawl.go:25-181): flags
-numPages/-startURL/-domainOnly, one-time ODP topic scrape (skipped when
Topic_metadata is already populated), BFS crawl, then the post-crawl batch
jobs: topic-sensitive PageRank on the card followed by tf-idf term
weighting for title and body, and optionally the columnar snapshot that
the port's server loads with --snapshot.

Usage:
  python -m spaghettisearch_tpu_torch.cli.crawl [--numPages N] [--startURL URL]
      [--domainOnly {true,false}] [--db PATH] [--device cuda]

--device defaults to cuda and the CLI refuses to start without CUDA;
--device cpu runs PageRank on the CPU as an explicit choice, never as a
fallback. The JAX package's persistent compile cache has no counterpart.
"""

from __future__ import annotations

import argparse
import asyncio
import time

import torch

from ..config import (
    CRAWL_DEFAULT_DOMAIN_ONLY,
    CRAWL_DEFAULT_PAGES,
    CRAWL_DEFAULT_START,
    PAGERANK_CONVERGENCE,
    PAGERANK_DAMPING,
)
from ..crawl.fetch import UrllibFetcher
from ..crawl.frontier import crawl
from ..crawl.odp import parse_odp
from ..ops.pagerank import update_pagerank
from ..ops.weighting import update_term_weights
from ..store.tables import Database
from ..utils.timing import TRACER


def _bool(v: str) -> bool:
    return v.lower() not in ("false", "0", "no")


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description="SpaghettiSearch crawler (PyTorch/CUDA)")
    ap.add_argument("--numPages", type=int, default=CRAWL_DEFAULT_PAGES)
    ap.add_argument("--startURL", default=CRAWL_DEFAULT_START)
    ap.add_argument("--domainOnly", type=_bool, default=CRAWL_DEFAULT_DOMAIN_ONLY)
    ap.add_argument("--db", default="./db_data", help="store root directory")
    ap.add_argument("--odpURL", default="http://odp.org/")
    ap.add_argument("--skipODP", action="store_true")
    ap.add_argument("--damping", type=float, default=PAGERANK_DAMPING)
    ap.add_argument("--convergence", type=float, default=PAGERANK_CONVERGENCE)
    ap.add_argument("--topicPagerank", action="store_true",
                    help="repaired topic-sensitive PageRank: per-category "
                         "ODP teleport vectors, so categories converge to "
                         "genuinely different ranks (the reference's "
                         "category loop is decorative, pagerank.go:60-61); "
                         "serve with --topicModel to blend them")
    ap.add_argument("--saveSnapshot", default=None,
                    help="also export the columnar snapshot to this directory")
    ap.add_argument("--device", default="cuda",
                    help="torch device PageRank runs on: cuda (default), "
                         "cuda:N, or cpu")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"--device {args.device}: CUDA is not available "
            "(pass --device cpu to run PageRank on the CPU explicitly)"
        )

    print("Crawler started...")
    start = time.time()
    db = Database(args.db)

    async def run() -> None:
        # one-time topic scrape (reference: start_crawl.go:74-77)
        if not args.skipODP and len(db.topic_meta) == 0:
            t0 = time.time()
            async with UrllibFetcher() as fetcher:
                await parse_odp(db, fetcher, seed_url=args.odpURL)
            print(f"ODP topic scrape: {time.time() - t0:.1f}s")

        t0 = time.perf_counter()
        stats = await crawl(
            db,
            args.startURL,
            num_pages=args.numPages,
            domain_only=args.domainOnly,
        )
        crawl_s = time.perf_counter() - t0
        print(f"\nTotal visited length: {stats.visited} "
              f"(indexed {stats.indexed}, errors {stats.errors})")
        print(f"Crawl: {stats.indexed} pages indexed in {crawl_s:.3f}s = "
              f"{stats.indexed / max(crawl_s, 1e-9):.1f} pages/s")

    asyncio.run(run())
    print(f"\nTotal crawling and indexing time: {time.time() - start:.1f}s")

    timer = time.time()
    pr = update_pagerank(db, damping=args.damping, eps=args.convergence,
                         personalized=args.topicPagerank, device=device)
    print(f"PageRank on {device}: {pr['nodes']} nodes, {pr['edges']} edges, "
          f"{pr['categories']} categories, {pr['iterations']} iterations in "
          f"{pr['ms']:.3f} ms")
    update_term_weights(db, "title")
    update_term_weights(db, "body")
    print(f"Updating pagerank and idf takes {time.time() - timer:.1f}s")
    db.flush()
    if args.saveSnapshot:
        from ..index.persist import save_snapshot
        from ..index.snapshot import build_snapshot

        save_snapshot(build_snapshot(db), args.saveSnapshot)
        print(f"Snapshot saved to {args.saveSnapshot}")
    db.close()
    print(f"\nTotal elapsed time: {time.time() - start:.1f}s")
    print(TRACER.report())


if __name__ == "__main__":
    main()
