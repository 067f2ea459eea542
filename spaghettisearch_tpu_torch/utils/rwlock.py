"""Reader-writer lock for the serving path.

Queries (device rank + store hydration + wordlist) are READERS — many run
concurrently across the micro-batcher and HTTP handler threads. /refresh is
the single WRITER: it swaps the engine's (snapshot, index, db) live state and
closes the old native store handles, which must never happen under a running
reader (the round-1 soak found exactly that use-after-free).

Writer-preference: once a writer is waiting, new readers queue behind it so
a busy query stream cannot starve /refresh. Writers are rare (one per crawl
cycle) and hold the lock only for the pointer swap, so reader stalls are
bounded by the swap, not the snapshot rebuild.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager


class RWLock:
    def __init__(self) -> None:
        self._cv = threading.Condition()
        self._readers = 0
        self._writers_waiting = 0
        self._writer = False

    def acquire_read(self) -> None:
        with self._cv:
            while self._writer or self._writers_waiting:
                self._cv.wait()
            self._readers += 1

    def release_read(self) -> None:
        with self._cv:
            self._readers -= 1
            if self._readers == 0:
                self._cv.notify_all()

    def acquire_write(self) -> None:
        with self._cv:
            self._writers_waiting += 1
            try:
                while self._writer or self._readers:
                    self._cv.wait()
            finally:
                self._writers_waiting -= 1
            self._writer = True

    def release_write(self) -> None:
        with self._cv:
            self._writer = False
            self._cv.notify_all()

    @contextmanager
    def read(self):
        self.acquire_read()
        try:
            yield
        finally:
            self.release_read()

    @contextmanager
    def write(self):
        self.acquire_write()
        try:
            yield
        finally:
            self.release_write()

    # drop-in compatibility with threading.Lock users (treated as writers:
    # exclusive)
    def __enter__(self):
        self.acquire_write()
        return self

    def __exit__(self, *exc) -> None:
        self.release_write()
