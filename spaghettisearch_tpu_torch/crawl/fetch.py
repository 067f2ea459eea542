"""HTTP fetching for the crawler.

Async fetcher with the reference's client behavior (reference:
cmd/crawl/start_crawl.go:34-44, crawler/crawler.go:119-126): 15 s timeout,
TLS verification disabled, Accept/Accept-Language headers, Last-Modified and
Content-Length capture. The fetcher is injectable so crawls are testable
offline against fixture corpora (SURVEY §4).

`FetchResult`, `parse_last_modified` and `DictFetcher` are the JAX
package's (crawl/fetch.py). Its aiohttp fetcher becomes `UrllibFetcher`:
the standard library's urllib in a bounded thread pool, called the same
way, with the aiohttp session's behaviour — the same headers plus
`Accept-Encoding: gzip, deflate` (bodies decompressed, Content-Length as
sent), redirects followed, no proxy from the environment, and an error on
any status >= 400 so that the crawl re-credits the page budget.
"""

from __future__ import annotations

import asyncio
import ssl
import urllib.request
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from datetime import datetime, timezone
from email.utils import parsedate_to_datetime

from ..config import CRAWL_TIMEOUT_S

HEADERS = {
    "Accept": "text/html, application/xhtml+xml, application/xml;q=0.9",
    "Accept-Language": "en",
}


@dataclass
class FetchResult:
    url: str
    body: bytes
    last_modified: datetime
    content_length: int | None  # from header; None when absent


def parse_last_modified(value: str | None) -> datetime:
    """Header value -> aware UTC datetime; absent/invalid -> now (reference:
    crawler/crawler.go:136-141)."""
    if value:
        try:
            dt = parsedate_to_datetime(value)
            if dt.tzinfo is None:
                dt = dt.replace(tzinfo=timezone.utc)
            return dt.astimezone(timezone.utc)
        except (TypeError, ValueError):
            pass
    return datetime.now(timezone.utc)


def _decompress(body: bytes, encoding: str | None) -> bytes:
    encoding = (encoding or "").strip().lower()
    if encoding == "gzip":
        return zlib.decompress(body, 16 + zlib.MAX_WBITS)
    if encoding == "deflate":
        try:
            return zlib.decompress(body)
        except zlib.error:  # raw deflate without the zlib header
            return zlib.decompress(body, -zlib.MAX_WBITS)
    return body


class UrllibFetcher:
    """Production fetcher: blocking urllib requests in a pool of WORKERS
    threads (the crawl's semaphore bounds the requests in flight). Use as
    `async with UrllibFetcher() as fetcher: await fetcher(url)`."""

    WORKERS = 64

    def __init__(self, timeout_s: float = CRAWL_TIMEOUT_S) -> None:
        self._timeout_s = timeout_s
        self._pool: ThreadPoolExecutor | None = None
        self._opener = None

    async def __aenter__(self) -> "UrllibFetcher":
        tls = ssl.create_default_context()
        tls.check_hostname = False
        tls.verify_mode = ssl.CERT_NONE
        self._opener = urllib.request.build_opener(
            urllib.request.ProxyHandler({}),  # aiohttp ignores proxy variables
            urllib.request.HTTPSHandler(context=tls),
        )
        self._pool = ThreadPoolExecutor(max_workers=self.WORKERS, thread_name_prefix="fetch")
        return self

    async def __aexit__(self, *exc) -> None:
        self._pool.shutdown(wait=True)

    def _get(self, url: str) -> FetchResult:
        req = urllib.request.Request(
            url, headers={**HEADERS, "Accept-Encoding": "gzip, deflate"}
        )
        # urllib follows redirects and raises HTTPError on status >= 400
        # (deliberate fix vs the reference, as in the JAX package: HTTP
        # errors are fetch failures, not documents)
        with self._opener.open(req, timeout=self._timeout_s) as resp:
            body = _decompress(resp.read(), resp.headers.get("Content-Encoding"))
            cl = resp.headers.get("Content-Length")
            return FetchResult(
                url=url,
                body=body,
                last_modified=parse_last_modified(resp.headers.get("Last-Modified")),
                content_length=int(cl) if cl else None,
            )

    async def __call__(self, url: str) -> FetchResult:
        loop = asyncio.get_running_loop()
        # the total time of one request, as aiohttp's ClientTimeout(total=)
        return await asyncio.wait_for(
            loop.run_in_executor(self._pool, self._get, url), self._timeout_s
        )


class DictFetcher:
    """Offline fetcher over an in-memory {url: html} site (for tests)."""

    def __init__(self, pages: dict[str, bytes], last_modified: datetime | None = None):
        self.pages = pages
        self.last_modified = last_modified or datetime.now(timezone.utc)
        self.fetched: list[str] = []

    async def __call__(self, url: str) -> FetchResult:
        if url not in self.pages:
            raise KeyError(f"404: {url}")
        self.fetched.append(url)
        body = self.pages[url]
        return FetchResult(
            url=url,
            body=body,
            last_modified=self.last_modified,
            content_length=len(body),
        )
