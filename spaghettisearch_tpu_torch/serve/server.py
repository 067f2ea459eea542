"""HTTP JSON API + static UI.

Route-compatible with the reference server (reference:
cmd/server/server.go:87-125):

  POST /query            {"query": "..."} -> [Rank_combined...]
  GET  /query/{terms}    -> same
  GET  /wordlist/{pre}   -> ["word", ...] (prefix-filtered vocabulary)
  GET  /*                -> static UI

Implemented on the stdlib threading HTTP server; query batches from
concurrent clients are micro-batched into one device program per tick by the
engine's batched path when the caller uses /query_batch.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import unquote, urlsplit

from ..retrieval.engine import QueryEngine
from ..utils.rwlock import RWLock
from ..utils.timing import TRACER


class _HTTPServer(ThreadingHTTPServer):
    # stdlib default backlog is 5: concurrent clients beyond it get
    # connection resets under load
    request_queue_size = 128
    daemon_threads = True


log = logging.getLogger("spaghettisearch.serve")

STATIC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "static")

_CONTENT_TYPES = {
    ".html": "text/html; charset=utf-8",
    ".js": "text/javascript",
    ".css": "text/css",
    ".png": "image/png",
    ".ico": "image/x-icon",
    ".svg": "image/svg+xml",
}


class SearchServer:
    def __init__(
        self,
        engine: QueryEngine,
        static_dir: str = STATIC_DIR,
        batching: bool = True,
        max_batch: int = 128,
        max_wait_ms: float = 25.0,
        n_fetchers: int = 1,  # concurrent device->host fetch threads
        # (overlapped relay RTTs — see MicroBatcher; >1 pays off only on
        # multi-core serving hosts)
        segregate: str = "auto",  # phrase-class batch segregation
        # ("auto"/"on"/"off"): class-pure batches keep keyword-only traffic
        # on the leveled keyword program (see MicroBatcher)
        ph_patience_ms: float = 250.0,  # max extra wait for a non-full
        # phrase-class batch while keyword work is pending
        ph_pool_min: int = 0,  # >0: merge the phrase cohort once this many
        # pooled — a phrase-latency-vs-qps trade, off by default (the 1M
        # A/B measured -37% qps at pool=16; see MicroBatcher)
        ph_stale: str = "merge",  # patience-expired cohort policy:
        # "merge" (default) or "pure" (standalone small phrase batch;
        # pair with engine.phrase_b32 — see MicroBatcher)
        result_timeout_s: float = 300.0,  # per-request future timeout; a
        # cold LAZY-compiled program family (--noWarmup on a CPU mesh) can
        # legitimately hold a batch for >10 min — raise it there
        http_impl: str = "fast",  # "fast": raw keep-alive loop (~85x the
        # stdlib handler's request throughput, serve/fastloop.py);
        # "stdlib": ThreadingHTTPServer (kept for comparison/debug)
        http_opts: dict | None = None,  # FastHTTPFrontend guard overrides
        # (read_timeout, max_header, max_body, max_connections)
        result_cache: int = 0,  # >0: LRU of finished /query response bytes,
        # keyed by (refresh generation, query text). Off by default so
        # benchmarks measure serving, not cache hits; production query
        # streams are heavily repeated and a hit skips rank+assembly
        # entirely. Invalidation is by generation: /refresh bumps it.
    ) -> None:
        self.engine = engine
        self.static_dir = static_dir
        self.http_impl = http_impl
        self.http_opts = dict(http_opts or {})
        self._fast = None
        self._httpd: ThreadingHTTPServer | None = None
        self._rcache_size = int(result_cache)
        self._rcache: "OrderedDict[tuple[int, str], bytes]" = OrderedDict()
        self._rcache_lock = threading.Lock()
        self._rcache_gen = 0
        self._rcache_hits = 0
        self._rcache_misses = 0
        # reader-writer serving lock: queries (rank dispatch + store
        # hydration + wordlist) are readers and run concurrently across
        # handler threads; /refresh is the writer, held only for the live
        # pointer swap (the rebuild happens off-lock)
        self._rank_lock = RWLock()
        # serializes concurrent /refresh REBUILDS (not queries)
        self._refresh_lock = threading.Lock()
        self.batcher = None
        if batching:
            from .batcher import MicroBatcher

            self.batcher = MicroBatcher(
                engine, max_batch=max_batch, max_wait_ms=max_wait_ms,
                lock=self._rank_lock, n_fetchers=n_fetchers,
                segregate=segregate, ph_patience_ms=ph_patience_ms,
                ph_pool_min=ph_pool_min, ph_stale=ph_stale,
                result_timeout_s=result_timeout_s,
            )

    # ------------------------------------------------------------------ #
    def handle_query_json(self, query: str) -> bytes:
        """The wire fast path: ranked rows hydrate straight into response
        bytes from the per-doc JSON fragment cache (no per-request dict
        building / re-serialization of static fields)."""
        if self._rcache_size:
            key = (self._rcache_gen, query)
            with self._rcache_lock:
                hit = self._rcache.get(key)
                if hit is not None:
                    self._rcache.move_to_end(key)
                    self._rcache_hits += 1
                    return hit
                self._rcache_misses += 1
            body = self._query_json_uncached(query)
            with self._rcache_lock:
                self._rcache[key] = body
                while len(self._rcache) > self._rcache_size:
                    self._rcache.popitem(last=False)
            return body
        return self._query_json_uncached(query)

    def _query_json_uncached(self, query: str) -> bytes:
        with TRACER.span("serve.query"):
            t0 = time.perf_counter()
            if self.batcher is not None:
                body, scores, ids, parsed, live = self.batcher.query_raw(query)
                if body is not None:  # assembled natively on the batch worker
                    log.debug("query %r -> %d bytes in %.1f ms",
                              query, len(body),
                              1e3 * (time.perf_counter() - t0))
                    return body
            else:
                with self._rank_lock.read():
                    from ..retrieval.engine import parse_query

                    parsed = parse_query(query)
                    live = self.engine._live
                    if parsed.is_empty or live[1].n_docs == 0:
                        scores = ids = None
                    else:
                        s, i = self.engine.rank([parsed], live=live)
                        scores, ids = s[0], i[0]
            if scores is None:
                body = b"[]"
            else:
                with self._rank_lock.read():
                    body = self.engine.hydrate_row_json(scores, ids, parsed, live)
            log.debug("query %r -> %d bytes in %.1f ms",
                      query, len(body), 1e3 * (time.perf_counter() - t0))
            return body

    def handle_query(self, query: str) -> list[dict]:
        with TRACER.span("serve.query"):
            t0 = time.perf_counter()
            if self.batcher is not None:
                results = self.batcher.query(query)
            else:
                with self._rank_lock.read():
                    results = self.engine.query(query)
            log.debug("query %r -> %d results in %.1f ms",
                      query, len(results), 1e3 * (time.perf_counter() - t0))
            return results

    def handle_query_batch(self, queries: list[str]) -> list[list[dict]]:
        with self._rank_lock.read(), TRACER.span("serve.query_batch"):
            return self.engine.query_batch(queries)

    def handle_wordlist(self, prefix: str) -> list[str]:
        with self._rank_lock.read():  # cache rebuild reads the store
            return self.engine.wordlist(prefix)

    def handle_refresh(self) -> dict:
        """Pick up a crawl that ran while serving: rebuild the snapshot +
        device index OFF the serving lock (a multi-minute job at crawl
        scale), then swap the live state under the write lock — queries
        stall only for the O(pointer) swap, never the rebuild."""
        with TRACER.span("serve.refresh"), self._refresh_lock:
            t0 = time.perf_counter()
            state = self.engine.prepare_refresh()
            built = time.perf_counter()
            with self._rank_lock.write():
                old_db = self.engine.commit_refresh(state)
                # response cache: new generation, old entries age out of
                # the LRU (their keys can never match again)
                self._rcache_gen += 1
            lock_held = time.perf_counter() - built
            if old_db is not None:
                # closing a crawl-scale store takes seconds (flush + free,
                # measured 5.5 s at 512k docs) — never under the lock
                old_db.close()
            dt = time.perf_counter() - t0
            log.info(
                "index refreshed in %.1f ms (lock held %.1f ms)",
                1e3 * dt, 1e3 * lock_held,
            )
            return {
                "ok": True,
                "docs": self.engine.index.n_docs,
                "words": self.engine.index.n_words,
                "seconds": round(dt, 3),
                "lock_seconds": round(lock_held, 4),
            }

    # ------------------------------------------------------------------ #
    def make_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                log.debug("%s " + fmt, self.address_string(), *args)

            def _send_json_bytes(self, body: bytes, status: int = 200) -> None:
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Access-Control-Allow-Origin", "*")
                self.send_header(
                    "Access-Control-Allow-Headers",
                    "Origin, X-Requested-With, Content-Type, Accept",
                )
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _send_json(self, obj, status: int = 200) -> None:
                body = json.dumps(obj).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Access-Control-Allow-Origin", "*")
                self.send_header(
                    "Access-Control-Allow-Headers",
                    "Origin, X-Requested-With, Content-Type, Accept",
                )
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _send_static(self, path: str) -> None:
                rel = path.lstrip("/") or "index.html"
                full = os.path.normpath(os.path.join(server.static_dir, rel))
                if not full.startswith(os.path.abspath(server.static_dir)):
                    self.send_error(403)
                    return
                if not os.path.isfile(full):
                    # SPA fallback
                    full = os.path.join(server.static_dir, "index.html")
                    if not os.path.isfile(full):
                        self.send_error(404)
                        return
                with open(full, "rb") as f:
                    body = f.read()
                ext = os.path.splitext(full)[1]
                self.send_response(200)
                self.send_header(
                    "Content-Type", _CONTENT_TYPES.get(ext, "application/octet-stream")
                )
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_OPTIONS(self):
                self._send_json({})

            def do_POST(self):
                parts = urlsplit(self.path)
                length = int(self.headers.get("Content-Length") or 0)
                raw = self.rfile.read(length) if length else b"{}"
                try:
                    payload = json.loads(raw or b"{}")
                except json.JSONDecodeError:
                    self._send_json({"error": "bad json"}, 400)
                    return
                if not isinstance(payload, dict):
                    self._send_json(
                        {"error": "payload must be a JSON object"}, 400)
                    return
                if parts.path == "/query":
                    self._send_json_bytes(
                        server.handle_query_json(str(payload.get("query", "")))
                    )
                elif parts.path == "/query_batch":
                    raw_queries = payload.get("queries", [])
                    if not isinstance(raw_queries, list):
                        self._send_json({"error": "queries must be a list"}, 400)
                        return
                    queries = [str(q) for q in raw_queries]
                    self._send_json(server.handle_query_batch(queries))
                elif parts.path == "/refresh":
                    self._send_json(server.handle_refresh())
                else:
                    self._send_json({"error": "not found"}, 404)

            def do_GET(self):
                parts = urlsplit(self.path)
                path = parts.path
                if path.startswith("/query/"):
                    self._send_json_bytes(
                        server.handle_query_json(unquote(path[len("/query/"):]))
                    )
                elif path.startswith("/wordlist/"):
                    self._send_json(
                        server.handle_wordlist(unquote(path[len("/wordlist/"):]))
                    )
                elif path == "/healthz":
                    self._send_json({"ok": True, "docs": server.engine.index.n_docs})
                elif path == "/stats":
                    stats = dict(TRACER.report())
                    if server.batcher is not None:
                        stats["microbatcher"] = {
                            "batches": server.batcher.stats.batches,
                            "queries": server.batcher.stats.queries,
                            "ph_batches": server.batcher.stats.ph_batches,
                            "segregate": server.batcher._segregate,
                            "mean_batch": round(server.batcher.stats.mean_batch, 2),
                            "queue_age": server.batcher.queue_age_quantiles(),
                        }
                    if server._rcache_size:
                        stats["result_cache"] = {
                            "size": len(server._rcache),
                            "capacity": server._rcache_size,
                            "hits": server._rcache_hits,
                            "misses": server._rcache_misses,
                        }
                    self._send_json(stats)
                else:
                    self._send_static(path)

        return Handler

    def serve(self, port: int = 8080, host: str = "0.0.0.0") -> None:
        if self.http_impl == "fast":
            from .fastloop import FastHTTPFrontend

            self._fast = FastHTTPFrontend(
                self, self.static_dir, _CONTENT_TYPES, **self.http_opts
            )
            self._fast.start(host, port)
            log.info("Server is running on port %d", port)
            self._fast.serve_forever()
            return
        self._httpd = _HTTPServer((host, port), self.make_handler())
        log.info("Server is running on port %d", port)
        self._httpd.serve_forever()

    def start_background(self, port: int = 8080, host: str = "127.0.0.1"):
        if self.http_impl == "fast":
            from .fastloop import FastHTTPFrontend

            self._fast = FastHTTPFrontend(
                self, self.static_dir, _CONTENT_TYPES, **self.http_opts
            )
            return self._fast.start(host, port)
        self._httpd = _HTTPServer((host, port), self.make_handler())
        t = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        t.start()
        return self._httpd.server_address

    def shutdown(self) -> None:
        if self._fast is not None:
            self._fast.shutdown()
            self._fast = None
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd = None
        if self.batcher is not None:
            self.batcher.shutdown()
