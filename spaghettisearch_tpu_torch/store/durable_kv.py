"""Torn-tail repair for the store's two append-only logs, which the JAX
package's store (and this package's copies of it, store/native_kv.py and
store/tables.py) lack.

A process killed mid-write leaves a torn record at the end of a log. The
readers already skip it: fastkv's replay (native/fastkv.cpp Store::open)
stops at a short record, and the docs pack's index load skips a short
line. But the next writer appends behind the torn bytes, so the next
replay reads the torn header's length across the new records: the torn key
gets a garbage value and the records after it are misread or lost; in the
docs pack's index the first new line is glued to the torn one and its page
drops out. (Found by experiments/torch_crash_recovery.py: a bulk indexer
SIGKILLed mid-flush at 100k pages, then one append, then a reopen.)

So each writer cuts a torn tail off before its first append. Only the
single writer may cut a log (a reader can open it while the writer is
mid-record), which is why the cut waits for a handle's first write and
never happens at open.
"""

from __future__ import annotations

import mmap
import os
import struct

from .native_kv import NativeBackend as _NativeBackend
from .native_kv import native_available  # noqa: F401  (the backend's probe, for tables.py)

_HEAD = struct.Struct("<BII")  # fastkv's record header: op, klen, vlen


def log_good_end(path: str) -> tuple[int, int]:
    """(the end of the last whole record, the file's size) of a fastkv
    data.log, read as its replay reads it: a set record carries its value,
    any other op only its key."""
    try:
        size = os.path.getsize(path)
    except FileNotFoundError:
        return 0, 0
    pos = 0
    if size:
        with open(path, "rb") as f, mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as mm:
            while pos + _HEAD.size <= size:
                op, klen, vlen = _HEAD.unpack_from(mm, pos)
                end = pos + _HEAD.size + klen + (vlen if op == 0 else 0)
                if end > size:
                    break
                pos = end
    return pos, size


def cut_torn_line(path: str) -> None:
    """Cut a last line that has no newline (a writer died mid-line) off a
    line-oriented log."""
    try:
        with open(path, "rb+") as f:
            size = f.seek(0, os.SEEK_END)
            if not size:
                return
            f.seek(size - 1)
            if f.read(1) == b"\n":
                return
            keep = size
            while keep > 0:
                step = min(keep, 1 << 16)
                f.seek(keep - step)
                nl = f.read(step).rfind(b"\n")
                if nl >= 0:
                    keep = keep - step + nl + 1
                    break
                keep -= step
            f.truncate(keep)
    except FileNotFoundError:
        pass


class NativeBackend(_NativeBackend):
    """store/native_kv.py's backend, cutting a torn tail off data.log before
    this handle's first write (then replaying the cut log)."""

    def __init__(self, path: str) -> None:
        super().__init__(path)
        self._tail_cut = False

    def _cut_torn_tail(self) -> None:
        self._tail_cut = True
        log = os.path.join(self.path, "data.log")
        good, size = log_good_end(log)
        if good == size:
            return
        self._lib.fastkv_close(self._hh)
        self._h = None
        os.truncate(log, good)
        self._h = self._lib.fastkv_open(self.path.encode())
        if not self._h:
            raise RuntimeError(f"fastkv_open failed for {self.path}")

    def set(self, key: str, value: str) -> None:
        if not self._tail_cut:
            self._cut_torn_tail()
        super().set(key, value)

    def delete(self, key: str) -> None:
        if not self._tail_cut:
            self._cut_torn_tail()
        super().delete(key)

    def set_many(self, items: list[tuple[str, str]]) -> None:
        if items and not self._tail_cut:
            self._cut_torn_tail()
        super().set_many(items)

    def apply_term_weights(self, raw_backend, word_hashes, idfs):
        if not self._tail_cut:
            self._cut_torn_tail()
        return super().apply_term_weights(raw_backend, word_hashes, idfs)
