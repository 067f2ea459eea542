"""BFS crawl scheduler.

Equivalent of the reference's frontier loop (reference:
cmd/crawl/start_crawl.go:79-167): breadth-first over [parent, child] edges,
md5-visited set, page budget, depth-synchronized rounds, bounded fan-out, and
error re-crediting of the page budget. Go's 500-permit semaphore + goroutines
become an asyncio semaphore + tasks; the depth barrier (acquiring all 500
permits) becomes awaiting the round's task set. Indexing runs on a single
worker thread — the async analogue of the reference's global index mutex
(start_crawl.go:58) — so store writes never interleave.
"""

from __future__ import annotations

import asyncio
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from urllib.parse import urlsplit

from ..config import CRAWL_MAX_CONCURRENCY
from ..index.indexer import index_page
from ..store.tables import Database
from ..text.page import parse_page
from ..utils.hashing import md5_hex
from ..utils.timing import TRACER


@dataclass
class CrawlStats:
    visited: int = 0
    indexed: int = 0
    errors: int = 0
    depths: int = 0
    error_urls: list[str] = field(default_factory=list)


async def crawl(
    db: Database,
    start_url: str,
    num_pages: int = 500,
    domain_only: bool = True,
    fetcher=None,
    max_concurrency: int = CRAWL_MAX_CONCURRENCY,
    log=print,
) -> CrawlStats:
    """Breadth-first crawl from start_url into the store."""
    stats = CrawlStats()
    domain = urlsplit(start_url).hostname or ""
    visited: set[str] = set()
    budget = num_pages
    queue: list[tuple[str, str]] = [("", start_url)]  # [parent, child] edges
    sem = asyncio.Semaphore(max_concurrency)
    indexer_pool = ThreadPoolExecutor(max_workers=1)
    loop = asyncio.get_running_loop()

    own_fetcher = None
    if fetcher is None:
        from .fetch import UrllibFetcher

        own_fetcher = UrllibFetcher()
        fetcher = await own_fetcher.__aenter__()

    async def visit(parent_url: str, url: str) -> list[tuple[str, str]]:
        nonlocal budget
        async with sem:
            try:
                with TRACER.span("crawl.fetch"):
                    result = await fetcher(url)
            except Exception as e:  # fetch errors re-credit the page budget
                stats.errors += 1
                stats.error_urls.append(url)
                budget += 1
                log(f"fetch error {url}: {e}")
                return []
        page = parse_page(result.body, url)
        with TRACER.span("crawl.index"):
            await loop.run_in_executor(
                indexer_pool,
                index_page,
                db,
                result.body,
                url,
                result.last_modified,
                result.content_length,
                parent_url,
                page,
            )
        stats.indexed += 1
        return [(url, child) for child in page.links]

    try:
        for t in db.tables.values():  # write-back rows for the whole crawl
            t.enter_bulk()
        depth = 0
        while queue and len(visited) < budget:
            log(f"Depth: {depth} - Queued: {len(queue)}")
            tasks = []
            for parent_url, url in queue:
                if len(visited) >= budget:
                    break
                url_hash = md5_hex(url)
                if url_hash in visited:
                    continue
                host = urlsplit(url).hostname or ""
                if domain_only and not host.endswith(domain):
                    continue
                visited.add(url_hash)
                tasks.append(asyncio.create_task(visit(parent_url, url)))

            queue = []
            if not tasks:
                break
            for children in await asyncio.gather(*tasks):  # depth barrier
                queue.extend(children)
            depth += 1
            stats.depths = depth
            db.flush_bulk()  # durability checkpoint at each depth barrier
            db.flush()
    finally:
        indexer_pool.shutdown(wait=True)
        for t in db.tables.values():
            t.exit_bulk()
        if own_fetcher is not None:
            await own_fetcher.__aexit__(None, None, None)

    stats.visited = len(visited)
    return stats
