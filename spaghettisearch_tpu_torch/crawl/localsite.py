"""A web site on 127.0.0.1 for crawls that must not touch the network.

`LocalSite(pages)` serves fixed pages from a `ThreadingHTTPServer` on a free
port of 127.0.0.1 in a background thread, so the real crawler
(`crawl.frontier.crawl` over `UrllibFetcher`, or the crawl CLI) can run end
to end offline: the tests and chip_smoke.py crawl it. Besides pages it can
answer redirects and error statuses.
"""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    request_queue_size = 1024  # the crawler opens hundreds of connections at once


class LocalSite:
    """Serve `pages` ({path: body}) as text/html, each with `last_modified`
    (an HTTP date) when given; `redirects` ({path: location}) answer 301,
    `statuses` ({path: code}) answer that code with a short body, and any
    other path 404. Use as a context manager: `base` is
    "http://127.0.0.1:PORT"; `requests` counts the requests served."""

    def __init__(
        self,
        pages: dict[str, bytes],
        last_modified: str | None = None,
        redirects: dict[str, str] | None = None,
        statuses: dict[str, int] | None = None,
    ) -> None:
        self.pages = pages
        self.last_modified = last_modified
        self.redirects = redirects or {}
        self.statuses = statuses or {}
        self.requests = 0
        self._lock = threading.Lock()
        self._server: _Server | None = None
        self._thread: threading.Thread | None = None
        self.base = ""

    def _handler(self):
        site = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self) -> None:  # noqa: N802 (http.server's name)
                with site._lock:
                    site.requests += 1
                path = self.path
                if path in site.redirects:
                    self.send_response(301)
                    self.send_header("Location", site.redirects[path])
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                code = site.statuses.get(path, 200 if path in site.pages else 404)
                body = site.pages[path] if code == 200 else f"status {code}".encode()
                self.send_response(code)
                self.send_header("Content-Type", "text/html")
                self.send_header("Content-Length", str(len(body)))
                if site.last_modified and code == 200:
                    self.send_header("Last-Modified", site.last_modified)
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args) -> None:
                pass

        return Handler

    def __enter__(self) -> "LocalSite":
        self._server = _Server(("127.0.0.1", 0), self._handler())
        self.base = f"http://127.0.0.1:{self._server.server_address[1]}"
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name="localsite", daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join()
