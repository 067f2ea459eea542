"""Embedded key-value backends.

This plays the role BadgerDB plays for the reference (L0 storage engine,
reference: database/database.go). Two backends share one interface:

- MemBackend: plain dict, for tests and ephemeral indexes.
- LogBackend: durable snapshot + append-only WAL (JSON lines), compacted on
  demand. All reads are RAM-resident — the reference also loads tables to RAM
  for serving (database/database.go:105,197-204).

A native C++ backend can be slotted in behind the same interface (see
native/); values are opaque strings at this layer, typed codecs live in
tables.py.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Iterator, Protocol


class KVBackend(Protocol):
    def get(self, key: str) -> str | None: ...
    def set(self, key: str, value: str) -> None: ...
    def delete(self, key: str) -> None: ...
    def set_many(self, items: list[tuple[str, str]]) -> None: ...
    def items(self) -> Iterator[tuple[str, str]]: ...
    def __len__(self) -> int: ...
    def close(self) -> None: ...


class MemBackend:
    def __init__(self) -> None:
        self._data: dict[str, str] = {}

    def get(self, key: str) -> str | None:
        return self._data.get(key)

    def set(self, key: str, value: str) -> None:
        self._data[key] = value

    def delete(self, key: str) -> None:
        self._data.pop(key, None)

    def set_many(self, items: list[tuple[str, str]]) -> None:
        self._data.update(items)

    def items(self) -> Iterator[tuple[str, str]]:
        return iter(list(self._data.items()))

    def __len__(self) -> int:
        return len(self._data)

    def close(self) -> None:
        pass


class LogBackend:
    """Snapshot + WAL file pair under a directory; whole table RAM-resident.

    WAL records are JSON lines ["s", key, value] / ["d", key]; compaction
    rewrites the snapshot and truncates the WAL (the GC analogue of the
    reference's value-log GC daemon, database/database.go:315-332).
    """

    WAL_COMPACT_BYTES = 64 << 20

    def __init__(self, path: str) -> None:
        self.path = path
        os.makedirs(path, exist_ok=True)
        self._snap_path = os.path.join(path, "snapshot.jsonl")
        self._wal_path = os.path.join(path, "wal.jsonl")
        self._data: dict[str, str] = {}
        self._lock = threading.Lock()
        self._load()
        self._wal = open(self._wal_path, "a", encoding="utf-8")
        # this handle's view of the WAL size; compaction refuses to run when
        # the on-disk file has diverged (a foreign process appended)
        try:
            self._wal_bytes = os.path.getsize(self._wal_path)
        except OSError:
            self._wal_bytes = 0

    def _load(self) -> None:
        if os.path.exists(self._snap_path):
            with open(self._snap_path, encoding="utf-8") as f:
                for line in f:
                    if line.strip():
                        k, v = json.loads(line)
                        self._data[k] = v
        if os.path.exists(self._wal_path):
            with open(self._wal_path, encoding="utf-8") as f:
                for line in f:
                    if not line.strip():
                        continue
                    rec = json.loads(line)
                    if rec[0] == "s":
                        self._data[rec[1]] = rec[2]
                    else:
                        self._data.pop(rec[1], None)

    def get(self, key: str) -> str | None:
        return self._data.get(key)

    def set(self, key: str, value: str) -> None:
        with self._lock:
            self._data[key] = value
            self._wal_bytes += self._wal.write(json.dumps(["s", key, value]) + "\n")

    def delete(self, key: str) -> None:
        with self._lock:
            self._data.pop(key, None)
            self._wal_bytes += self._wal.write(json.dumps(["d", key]) + "\n")

    def set_many(self, items: list[tuple[str, str]]) -> None:
        with self._lock:
            lines = []
            for k, v in items:
                self._data[k] = v
                lines.append(json.dumps(["s", k, v]))
            if lines:
                self._wal_bytes += self._wal.write("\n".join(lines) + "\n")

    def items(self) -> Iterator[tuple[str, str]]:
        with self._lock:
            return iter(list(self._data.items()))

    def __len__(self) -> int:
        return len(self._data)

    def flush(self) -> None:
        with self._lock:
            self._wal.flush()

    def compact(self) -> bool:
        """Rewrite snapshot + truncate WAL. Refuses (returns False) when the
        on-disk WAL no longer matches this handle's view — another process
        appended since open, and rewriting from our in-RAM map would silently
        revert its rows. Compaction is a single-writer operation."""
        with self._lock:
            self._wal.flush()
            try:
                disk = os.path.getsize(self._wal_path)
            except OSError:
                disk = -1
            if disk != self._wal_bytes:
                import logging

                logging.getLogger("spaghettisearch.store").warning(
                    "skipping compaction of %s: WAL was modified by another "
                    "process since open", self.path,
                )
                return False
            tmp = self._snap_path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                for k, v in self._data.items():
                    f.write(json.dumps([k, v]) + "\n")
            os.replace(tmp, self._snap_path)
            self._wal.close()
            self._wal = open(self._wal_path, "w", encoding="utf-8")
            self._wal_bytes = 0
            return True

    def maybe_compact(self) -> None:
        try:
            if os.path.getsize(self._wal_path) > self.WAL_COMPACT_BYTES:
                self.compact()
        except OSError:
            pass

    def close(self) -> None:
        with self._lock:
            self._wal.flush()
            self._wal.close()
