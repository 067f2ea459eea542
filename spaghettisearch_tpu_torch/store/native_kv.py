"""ctypes binding for the native C++ KV store (native/fastkv.cpp).

Drop-in KVBackend implementation: binary WAL + RAM-resident hash map with
compaction, built on demand with `make -C native` (g++). Falls back cleanly
when the shared library can't be built (store/tables.py picks the Python
LogBackend instead).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Iterator

def _copy_native(ptr, nbytes: int, dtype, count: int):
    """Copy `nbytes` from a ctypes pointer into a numpy array.

    NOT ctypes.string_at: its size parameter is a C int, so any buffer
    >= 2 GiB raises "Negative size passed to PyBytes_FromStringAndSize"
    (hit by export_postings at the 1M-doc tier — 77M postings x 32-byte
    doc hashes is 2.5 GB). A from_address char-array view has no such
    limit and frombuffer(...).copy() is the same single memcpy."""
    import numpy as np

    buf = (ctypes.c_char * nbytes).from_address(
        ctypes.cast(ptr, ctypes.c_void_p).value
    )
    return np.frombuffer(buf, dtype=dtype, count=count).copy()


_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)
_SO_PATH = os.path.join(_NATIVE_DIR, "libfastkv.so")
_lib = None
_lib_lock = threading.Lock()


def _load_lib():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_SO_PATH):
            try:
                subprocess.run(
                    ["make", "-C", _NATIVE_DIR, "-s"],
                    check=True,
                    capture_output=True,
                    timeout=120,
                )
            except (subprocess.SubprocessError, OSError) as e:
                raise RuntimeError(f"could not build libfastkv.so: {e}") from e
        lib = ctypes.CDLL(_SO_PATH)
        lib.fastkv_open.restype = ctypes.c_void_p
        lib.fastkv_open.argtypes = [ctypes.c_char_p]
        lib.fastkv_close.argtypes = [ctypes.c_void_p]
        lib.fastkv_get.restype = ctypes.c_int
        lib.fastkv_get.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_char)),
            ctypes.POINTER(ctypes.c_uint32),
        ]
        lib.fastkv_free.argtypes = [ctypes.POINTER(ctypes.c_char)]
        lib.fastkv_set.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32,
            ctypes.c_char_p, ctypes.c_uint32,
        ]
        lib.fastkv_delete.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32]
        lib.fastkv_set_many.argtypes = [
            ctypes.c_void_p, ctypes.c_uint32, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_uint32), ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_uint32),
        ]
        lib.fastkv_len.restype = ctypes.c_uint64
        lib.fastkv_len.argtypes = [ctypes.c_void_p]
        lib.fastkv_log_bytes.restype = ctypes.c_uint64
        lib.fastkv_log_bytes.argtypes = [ctypes.c_void_p]
        lib.fastkv_flush.argtypes = [ctypes.c_void_p]
        lib.fastkv_compact.restype = ctypes.c_int
        lib.fastkv_compact.argtypes = [ctypes.c_void_p]
        lib.fastkv_iter_new.restype = ctypes.c_void_p
        lib.fastkv_iter_new.argtypes = [ctypes.c_void_p]
        lib.fastkv_iter_next.restype = ctypes.c_int
        lib.fastkv_iter_next.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_char)),
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_char)),
            ctypes.POINTER(ctypes.c_uint32),
        ]
        lib.fastkv_iter_free.argtypes = [ctypes.c_void_p]
        _pp_char = ctypes.POINTER(ctypes.POINTER(ctypes.c_char))
        _pp_u64 = ctypes.POINTER(ctypes.POINTER(ctypes.c_uint64))
        _pp_f64 = ctypes.POINTER(ctypes.POINTER(ctypes.c_double))
        lib.fastkv_export_postings.restype = ctypes.c_int64
        lib.fastkv_export_postings.argtypes = [
            ctypes.c_void_p, _pp_char, _pp_u64, _pp_char, _pp_f64,
            _pp_u64, _pp_f64,
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.fastkv_apply_term_weights.restype = ctypes.c_int64
        lib.fastkv_apply_term_weights.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_uint64, ctypes.c_char_p, ctypes.POINTER(ctypes.c_double),
            _pp_char, _pp_f64,
        ]
        _lib = lib
        return lib


def native_available() -> bool:
    try:
        _load_lib()
        return True
    except RuntimeError:
        return False


class NativeBackend:
    """KVBackend over libfastkv (str keys/values, utf-8)."""

    WAL_COMPACT_BYTES = 256 << 20

    def __init__(self, path: str) -> None:
        self._lib = _load_lib()
        os.makedirs(path, exist_ok=True)
        self._h = self._lib.fastkv_open(path.encode())
        if not self._h:
            raise RuntimeError(f"fastkv_open failed for {path}")
        self.path = path

    @property
    def _hh(self):
        """Live handle; a closed backend raises instead of passing NULL into
        C (a superseded-then-used Database segfaulted here — r3)."""
        h = self._h
        if not h:
            raise RuntimeError(f"fastkv backend is closed: {self.path}")
        return h

    def get(self, key: str) -> str | None:
        out = ctypes.POINTER(ctypes.c_char)()
        out_len = ctypes.c_uint32()
        kb = key.encode()
        if not self._lib.fastkv_get(self._hh, kb, len(kb), ctypes.byref(out), ctypes.byref(out_len)):
            return None
        try:
            return ctypes.string_at(out, out_len.value).decode()
        finally:
            self._lib.fastkv_free(out)

    def set(self, key: str, value: str) -> None:
        kb, vb = key.encode(), value.encode()
        self._lib.fastkv_set(self._hh, kb, len(kb), vb, len(vb))

    def delete(self, key: str) -> None:
        kb = key.encode()
        self._lib.fastkv_delete(self._hh, kb, len(kb))

    def set_many(self, items: list[tuple[str, str]]) -> None:
        if not items:
            return
        keys = [k.encode() for k, _ in items]
        vals = [v.encode() for _, v in items]
        klens = (ctypes.c_uint32 * len(items))(*[len(k) for k in keys])
        vlens = (ctypes.c_uint32 * len(items))(*[len(v) for v in vals])
        self._lib.fastkv_set_many(
            self._hh, len(items), b"".join(keys), klens, b"".join(vals), vlens
        )

    def items(self) -> Iterator[tuple[str, str]]:
        it = self._lib.fastkv_iter_new(self._hh)
        k = ctypes.POINTER(ctypes.c_char)()
        v = ctypes.POINTER(ctypes.c_char)()
        klen = ctypes.c_uint32()
        vlen = ctypes.c_uint32()
        try:
            while self._lib.fastkv_iter_next(
                it, ctypes.byref(k), ctypes.byref(klen), ctypes.byref(v), ctypes.byref(vlen)
            ):
                yield (
                    ctypes.string_at(k, klen.value).decode(),
                    ctypes.string_at(v, vlen.value).decode(),
                )
        finally:
            self._lib.fastkv_iter_free(it)

    def __len__(self) -> int:
        return int(self._lib.fastkv_len(self._hh))

    def flush(self) -> None:
        self._lib.fastkv_flush(self._hh)

    def compact(self) -> bool:
        """Rewrite the WAL from the live map. Returns False when the engine
        refused: another process appended to data.log since this handle
        opened, and rewriting would silently drop its rows (the crawl-
        subprocess-then-/refresh workflow). Compact only from the single
        writer process."""
        ok = bool(self._lib.fastkv_compact(self._hh))
        if not ok:
            import logging

            logging.getLogger("spaghettisearch.store").warning(
                "skipping compaction of %s: data.log was modified by "
                "another process since open", self.path,
            )
        return ok

    def maybe_compact(self) -> None:
        if self._lib.fastkv_log_bytes(self._hh) > self.WAL_COMPACT_BYTES:
            self.compact()

    def export_postings(self):
        """One-pass native parse of an inverted/raw table into flat arrays
        -> (row_keys S32 [R], row_offsets u64 [R+1], doc_hashes S32 [P],
        weights f64 [P], pos_offsets u64 [P+1], positions f64 [L]), or None
        when a row doesn't match the posting shape (caller falls back to the
        Python path). The batch-job building block behind snapshot builds
        and term weighting (O(total postings) was a Python hot loop)."""
        import numpy as np

        c = ctypes
        row_keys = c.POINTER(c.c_char)()
        row_offsets = c.POINTER(c.c_uint64)()
        doc_hashes = c.POINTER(c.c_char)()
        weights = c.POINTER(c.c_double)()
        pos_offsets = c.POINTER(c.c_uint64)()
        positions = c.POINTER(c.c_double)()
        n_post = c.c_uint64()
        n_pos = c.c_uint64()
        n_rows = self._lib.fastkv_export_postings(
            self._hh, c.byref(row_keys), c.byref(row_offsets),
            c.byref(doc_hashes), c.byref(weights),
            c.byref(pos_offsets), c.byref(positions),
            c.byref(n_post), c.byref(n_pos),
        )
        if n_rows < 0:
            return None
        np_, pp = int(n_post.value), int(n_pos.value)

        def arr(ptr, dtype, count, itemsize):
            out = (
                _copy_native(ptr, count * itemsize, dtype, count)
                if count else np.zeros(0, dtype)
            )
            self._lib.fastkv_free(c.cast(ptr, c.POINTER(c.c_char)))
            return out

        return (
            arr(row_keys, "S32", n_rows, 32),
            arr(row_offsets, np.uint64, n_rows + 1, 8),
            arr(doc_hashes, "S32", np_, 32),
            arr(weights, np.float64, np_, 8),
            arr(pos_offsets, np.uint64, np_ + 1, 8),
            arr(positions, np.float64, pp, 8),
        )

    def apply_term_weights(self, raw_backend, word_hashes, idfs):
        """Native TF-IDF pass: vals[0] = f32(raw normTF) * f32(idf) for every
        posting (raw from `raw_backend`'s shadow row when present), rows
        rewritten in place + WAL'd. -> (doc_hashes S32 [D], sq_sums f64 [D])
        per-doc sum of squared weights, or None on shape mismatch."""
        import numpy as np

        c = ctypes
        keys = np.ascontiguousarray(np.asarray(word_hashes, dtype="S32"))
        vals = np.ascontiguousarray(np.asarray(idfs, dtype=np.float64))
        out_docs = c.POINTER(c.c_char)()
        out_sums = c.POINTER(c.c_double)()
        n = self._lib.fastkv_apply_term_weights(
            self._hh, raw_backend._hh,
            len(keys), keys.tobytes(),
            vals.ctypes.data_as(c.POINTER(c.c_double)),
            c.byref(out_docs), c.byref(out_sums),
        )
        if n < 0:
            return None
        docs = (_copy_native(out_docs, 32 * n, "S32", n)
                if n else np.zeros(0, "S32"))
        sums = (_copy_native(out_sums, 8 * n, np.float64, n)
                if n else np.zeros(0, np.float64))
        self._lib.fastkv_free(out_docs)
        self._lib.fastkv_free(c.cast(out_sums, c.POINTER(c.c_char)))
        return docs, sums

    def close(self) -> None:
        if self._h:
            self._lib.fastkv_close(self._h)
            self._h = None
