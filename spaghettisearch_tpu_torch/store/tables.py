"""The nine-table database schema.

Mirrors the reference's table layout exactly (reference:
database/database.go:85-122 and SURVEY.md §2.3) so a user of the reference
finds the same logical contract:

inverted tables
  inv_title   (invKeyword_title) wordHash -> {docHash: [normTF*idf, pos...]}
  inv_body    (invKeyword_body)  wordHash -> same, body positions
  inv_topic   (invTopic_PR)      wordHash -> {category: freq}
forward tables
  word        (WordHash_word)      wordHash -> word
  doc_info    (DocHash_docInfo)    docHash  -> DocInfo
  doc_children(DocHash_children)   docHash  -> [child docHash]
  doc_rank    (DocHash_rank)       docHash  -> {category: pagerank}
  doc_magnitude(DocHash_magnitude) docHash  -> {"title"/"body": magnitude}
  topic_meta  (Topic_metadata)     category -> {"numPages","wordCount"}

The raw-HTML cache lives under <root>/docs/<docHash> (reference:
indexer/indexer.go:21,342-347).
"""

from __future__ import annotations

import itertools
import json
import os
from dataclasses import dataclass
from typing import Any, Callable, Iterator

from .docinfo import DocInfo
from .kv import KVBackend, LogBackend, MemBackend


def _ident(v: Any) -> Any:
    return v


def _dump_posting_row(row: dict) -> str:
    """json.dumps-byte-identical serializer for posting-shaped rows
    ({md5hex: [float, ...]} or {md5hex: float}): keys are hex digests (no
    escaping possible) and values are finite floats/ints, whose json
    encoding IS repr(). The stock C encoder measured ~29% of the whole
    bulk-index CPU budget; this is ~3x faster on these shapes and the
    stored bytes are unchanged (decode stays json.loads)."""
    if not row:
        return "{}"
    parts = []
    ap = parts.append
    for k, v in row.items():
        if type(v) is list:
            ap('"%s": [%s]' % (k, ", ".join(map(repr, v))))
        else:
            ap('"%s": %s' % (k, repr(v)))
    out = "{" + ", ".join(parts) + "}"
    if "inf" in out or "nan" in out:
        # non-finite weights DO occur (term weighting multiplies idf into
        # rows in place, and degenerate dfs yield +/-inf); json spells them
        # Infinity/-Infinity/NaN, repr() does not. Keys are hex digests, so
        # the letters 'i'/'n' in the output can only come from a value.
        return json.dumps(row)
    return out


@dataclass(frozen=True)
class TableSpec:
    name: str
    reference_name: str
    encode: Callable[[Any], Any] = _ident  # value -> JSON-compatible
    decode: Callable[[Any], Any] = _ident  # JSON-compatible -> value
    #: optional value -> stored-string fast path; MUST produce the exact
    #: bytes json.dumps(encode(value)) would (the decode side is json.loads)
    dumps: Callable[[Any], str] | None = None


def _enc_docinfo(v: DocInfo) -> dict:
    return v.to_json()


def _dec_docinfo(v: dict) -> DocInfo:
    return DocInfo.from_json(v)


TABLE_SPECS: tuple[TableSpec, ...] = (
    TableSpec("inv_title", "invKeyword_title", dumps=_dump_posting_row),
    TableSpec("inv_body", "invKeyword_body", dumps=_dump_posting_row),
    TableSpec("inv_topic", "invTopic_PR"),
    # shadow rows of RAW normTF per (word, doc): makes term weighting a pure
    # function of raw data, i.e. idempotent across re-crawls — the reference
    # multiplies idf into the stored value in place, so its repeated crawls
    # silently inflate every weight (term_weighting.go:42, run per crawl by
    # start_crawl.go:176-177). Additive table; the 9 reference tables keep
    # their exact contract.
    TableSpec("inv_title_raw", "invKeyword_title_rawTF", dumps=_dump_posting_row),
    TableSpec("inv_body_raw", "invKeyword_body_rawTF", dumps=_dump_posting_row),
    # summary-visible words (space-joined), extracted at INDEX time from the
    # same DOM parse: the serving path's dynamic summaries read this instead
    # of re-parsing docs/<hash> per result per query, which is what the
    # reference does (get_metadata.go:85-115) and what capped end-to-end
    # QPS. Additive table; stores without it fall back to the HTML cache.
    TableSpec("doc_summary", "DocHash_summaryText"),
    TableSpec("word", "WordHash_word"),
    TableSpec("doc_info", "DocHash_docInfo", _enc_docinfo, _dec_docinfo),
    TableSpec("doc_children", "DocHash_children"),
    TableSpec("doc_rank", "DocHash_rank"),
    TableSpec("doc_magnitude", "DocHash_magnitude"),
    TableSpec("topic_meta", "Topic_metadata"),
)


_DELETED = object()  # bulk-cache tombstone


class Table:
    """Typed view over a KV backend: values are JSON-encoded via the spec.

    Bulk mode (enter_bulk/exit_bulk, via Database.bulk()) keeps decoded
    values in a write-back cache and serializes each dirty row ONCE at
    flush. Per-page read-modify-write of hot posting rows is O(df) decodes
    + encodes per row without it (quadratic in total postings per crawl —
    the reference pays exactly this, indexer.go:357-402); with it, a bulk
    crawl pays one decode and one encode per row per flush epoch."""

    def __init__(self, spec: TableSpec, backend: KVBackend) -> None:
        self.spec = spec
        self._kv = backend
        self._dumps = spec.dumps or (lambda v, _e=spec.encode: json.dumps(_e(v)))
        self._cache: dict[str, Any] | None = None
        self._dirty: set[str] | None = None

    # --- bulk write-back mode ---
    def enter_bulk(self) -> None:
        if self._cache is None:
            self._cache = {}
            self._dirty = set()

    def flush_bulk(self) -> None:
        """Persist dirty rows; keep the read cache warm."""
        if self._cache is None or not self._dirty:
            return
        dump = self._dumps
        puts: list[tuple[str, str]] = []
        for k in self._dirty:
            v = self._cache[k]
            if v is _DELETED:
                self._kv.delete(k)
            else:
                puts.append((k, dump(v)))
        if puts:
            self._kv.set_many(puts)
        self._dirty.clear()

    def exit_bulk(self) -> None:
        if self._cache is None:
            return
        self.flush_bulk()
        self._cache = None
        self._dirty = None

    def get(self, key: str) -> Any | None:
        if self._cache is not None:
            v = self._cache.get(key)
            if v is _DELETED:
                return None
            if v is not None:
                return v
        raw = self._kv.get(key)
        if raw is None:
            return None
        val = self.spec.decode(json.loads(raw))
        if self._cache is not None:
            self._cache[key] = val
        return val

    def __contains__(self, key: str) -> bool:
        if self._cache is not None and key in self._cache:
            return self._cache[key] is not _DELETED
        return self._kv.get(key) is not None

    def set(self, key: str, value: Any) -> None:
        if self._cache is not None:
            self._cache[key] = value
            self._dirty.add(key)
            return
        self._kv.set(key, self._dumps(value))

    def get_row_for_update(self, key: str) -> Any:
        """Bulk-mode fast path for read-modify-write rows: fetch-or-create
        the mutable dict row and mark it dirty in ONE call (the indexer's
        per-word loop paid four Table dispatches per posting). Outside bulk
        mode the caller must still write the returned row back with set()."""
        c = self._cache
        if c is None:
            return self.get(key) or {}
        row = c.get(key)
        if type(row) is not dict:  # absent or _DELETED: load/create
            row = self.get(key) or {}
            c[key] = row
        self._dirty.add(key)
        return row

    def delete(self, key: str) -> None:
        if self._cache is not None:
            self._cache[key] = _DELETED
            self._dirty.add(key)
            return
        self._kv.delete(key)

    def items(self) -> Iterator[tuple[str, Any]]:
        self.flush_bulk()  # iteration sees every bulk write
        dec = self.spec.decode
        for k, raw in self._kv.items():
            yield k, dec(json.loads(raw))

    def keys(self) -> list[str]:
        self.flush_bulk()
        return [k for k, _ in self._kv.items()]

    def __len__(self) -> int:
        self.flush_bulk()
        return len(self._kv)

    def batch(self) -> "BatchWriter":
        return BatchWriter(self)


class BatchWriter:
    """Buffered bulk writer (reference: database/batchwriter.go:9-52)."""

    def __init__(self, table: Table) -> None:
        self._table = table
        self._buf: list[tuple[str, str]] = []

    def set(self, key: str, value: Any) -> None:
        if self._table._cache is not None:
            # bulk mode: the write-back cache IS the batch
            self._table.set(key, value)
            return
        self._buf.append((key, self._table._dumps(value)))

    def flush(self) -> None:
        if self._buf:
            self._table._kv.set_many(self._buf)
            self._buf = []

    def cancel(self) -> None:
        self._buf = []

    def __enter__(self) -> "BatchWriter":
        return self

    def __exit__(self, exc_type, *a) -> None:
        if exc_type is None:
            self.flush()
        else:
            self.cancel()


class _DocsPack:
    """Append-only raw-document log + offset index — the value-log analogue
    of the reference's BadgerDB (badger keeps large values in a vlog,
    database/database.go:85-122 opens one store per table): new documents
    append to <root>/docs.pack with an offset line in <root>/docs.pki,
    instead of one file per doc under docs/. A 1M-page crawl costs 1M file
    creates the buffered-append path avoids; rows are last-writer-wins (a
    re-crawl appends again and the index points at the newest copy).
    Pre-pack per-file entries under docs/ stay readable via the caller's
    fallback. Torn tails are safe on both files: an index line whose
    payload extends past the pack's size is dropped at load."""

    def __init__(self, root: str) -> None:
        self.pack_path = os.path.join(root, "docs.pack")
        self.idx_path = os.path.join(root, "docs.pki")
        self.index: dict[str, tuple[int, int]] = {}
        self._w = None  # lazy append handles (pack, index)
        self._iw = None
        self._r = None  # lazy read handle
        self._unflushed = False
        self.load()

    def load(self) -> None:
        """(Re-)read the index; called at open and on Database.reopen so
        appends from another process become visible, matching table
        semantics."""
        self.close()
        self.index.clear()
        try:
            size = os.path.getsize(self.pack_path)
        except OSError:
            return
        try:
            with open(self.idx_path, encoding="utf-8") as f:
                for line in f:
                    parts = line.split()
                    if len(parts) != 3:
                        continue  # torn index tail
                    try:
                        off, ln = int(parts[1]), int(parts[2])
                    except ValueError:
                        continue
                    if off + ln <= size:
                        self.index[parts[0]] = (off, ln)
        except OSError:
            pass

    def append(self, doc_hash: str, raw: bytes) -> None:
        if self._w is None:
            os.makedirs(os.path.dirname(self.pack_path), exist_ok=True)
            self._w = open(self.pack_path, "ab")
            # offsets come from this handle's tell(): a second writer
            # process would silently interleave and corrupt the offset
            # index, so the append handle is exclusive per pack
            try:
                import fcntl

                fcntl.flock(self._w.fileno(), fcntl.LOCK_EX | fcntl.LOCK_NB)
            except OSError:
                self._w.close()
                self._w = None
                raise RuntimeError(
                    f"docs pack {self.pack_path} is already open for append "
                    "by another process (single-writer log)"
                ) from None
            self._iw = open(self.idx_path, "a", encoding="utf-8")
        off = self._w.tell()
        self._w.write(raw)
        self.index[doc_hash] = (off, len(raw))
        # pack bytes land before the index line vouching for them (flush
        # order in flush() preserves this on disk)
        self._iw.write(f"{doc_hash} {off} {len(raw)}\n")
        self._unflushed = True

    def get(self, doc_hash: str) -> bytes | None:
        ent = self.index.get(doc_hash)
        if ent is None:
            return None
        if self._unflushed:
            self.flush()
        if self._r is None:
            try:
                self._r = open(self.pack_path, "rb")
            except OSError:
                return None
        try:
            self._r.seek(ent[0])
            return self._r.read(ent[1])
        except OSError:
            return None

    def flush(self) -> None:
        if self._w is not None:
            self._w.flush()  # payload first, then the lines vouching for it
            self._iw.flush()
        self._unflushed = False

    def close(self) -> None:
        for h in (self._w, self._iw, self._r):
            if h is not None:
                try:
                    h.close()
                except OSError:
                    pass
        self._w = self._iw = self._r = None
        self._unflushed = False


class Database:
    """The full 9-table store plus the raw-HTML document cache.

    backend: "auto" (native C++ fastkv when buildable, else Python log),
    "native", "log", or "mem". In-memory when root is None."""

    _GEN = itertools.count(1)

    def __init__(self, root: str | None = None, backend: str = "auto") -> None:
        self.root = root
        # monotonically unique per open handle: serving caches key on
        # (generation, row key) so rows read through ONE handle never need
        # re-validation (appends from other processes only become visible
        # through a fresh open — see prepare_refresh)
        self.generation = next(Database._GEN)
        self.doc_version = 0
        use_mem = root is None or backend == "mem"
        make_kv = None
        if not use_mem:
            if backend in ("auto", "native"):
                try:
                    from .native_kv import NativeBackend, native_available

                    if native_available():
                        make_kv = NativeBackend
                    elif backend == "native":
                        raise RuntimeError("native backend requested but unavailable")
                except (ImportError, RuntimeError):
                    if backend == "native":
                        raise
            if make_kv is None:
                make_kv = LogBackend
        self.backend_kind = "mem" if use_mem else (
            "native" if make_kv is not LogBackend else "log"
        )
        self._use_mem = use_mem
        self._make_kv = make_kv
        self.tables: dict[str, Table] = {}
        for spec in TABLE_SPECS:
            if use_mem:
                kv: KVBackend = MemBackend()
            else:
                kv = make_kv(os.path.join(root, spec.name))
            self.tables[spec.name] = Table(spec, kv)
        self._docs_dir = os.path.join(root, "docs") if root else None
        self._docs_pack = _DocsPack(root) if root else None
        self._mem_docs: dict[str, bytes] = {}

    def reopen(self) -> None:
        """Re-read the on-disk state: backends load their WAL into RAM at
        open, so writes made by ANOTHER process (e.g. a crawl while the
        server runs) are invisible until reopened. No-op for in-memory
        stores. Table objects stay valid; only their backends swap."""
        if self._use_mem:
            return
        if self._docs_pack is not None:
            self._docs_pack.flush()
            self._docs_pack.load()  # appends from other processes
        for spec in TABLE_SPECS:
            t = self.tables[spec.name]
            t.exit_bulk()
            old = t._kv
            # flush FIRST: backends buffer appends (stdio in the native
            # engine), and the fresh backend reads the file before the old
            # one closes — unflushed tail rows would vanish from the re-read
            if hasattr(old, "flush"):
                old.flush()
            # swap in the fresh backend before closing the old one: callers
            # must still serialize reopen vs reads (the server holds its
            # rank lock), this just shrinks the close hazard window
            t._kv = self._make_kv(os.path.join(self.root, spec.name))
            old.close()

    # --- typed accessors ---
    @property
    def inv_title(self) -> Table:
        return self.tables["inv_title"]

    @property
    def inv_body(self) -> Table:
        return self.tables["inv_body"]

    @property
    def inv_topic(self) -> Table:
        return self.tables["inv_topic"]

    @property
    def word(self) -> Table:
        return self.tables["word"]

    @property
    def doc_info(self) -> Table:
        return self.tables["doc_info"]

    @property
    def doc_children(self) -> Table:
        return self.tables["doc_children"]

    @property
    def doc_rank(self) -> Table:
        return self.tables["doc_rank"]

    @property
    def doc_magnitude(self) -> Table:
        return self.tables["doc_magnitude"]

    @property
    def topic_meta(self) -> Table:
        return self.tables["topic_meta"]

    @property
    def doc_summary(self) -> Table:
        return self.tables["doc_summary"]

    def inverted(self, section: str) -> Table:
        return self.tables["inv_title" if section == "title" else "inv_body"]

    def inverted_raw(self, section: str) -> Table:
        """Shadow raw-normTF rows: {wordHash: {docHash: rawNormTF}}."""
        return self.tables[
            "inv_title_raw" if section == "title" else "inv_body_raw"
        ]

    def note_doc_write(self) -> None:
        """Bump the doc-content version: summary caches key on
        (generation, doc_version) so in-process mutations (crawler, tests)
        invalidate without per-read store revalidation."""
        self.doc_version += 1

    # --- raw HTML cache (reference DocsDir; new writes go to the pack) ---
    def cache_doc(self, doc_hash: str, raw: bytes) -> None:
        self.note_doc_write()
        if self._docs_pack is None:
            self._mem_docs[doc_hash] = raw
            return
        self._docs_pack.append(doc_hash, raw)

    def cached_doc(self, doc_hash: str) -> bytes | None:
        if self._docs_pack is None:
            return self._mem_docs.get(doc_hash)
        raw = self._docs_pack.get(doc_hash)
        if raw is not None:
            return raw
        # pre-pack stores kept one file per doc under docs/<hash>
        try:
            with open(os.path.join(self._docs_dir, doc_hash), "rb") as f:
                return f.read()
        except OSError:
            return None

    def flush(self) -> None:
        if self._docs_pack is not None:
            self._docs_pack.flush()
        for t in self.tables.values():
            kv = t._kv
            if hasattr(kv, "flush"):
                kv.flush()
            if hasattr(kv, "maybe_compact"):
                kv.maybe_compact()

    # --- bulk indexing mode ---
    def bulk(self) -> "_BulkSession":
        """Write-back caching across all tables for crawl-scale indexing:
        decoded rows stay in memory, each dirty row is serialized once per
        flush_bulk() epoch instead of once per page touching it."""
        return _BulkSession(self)

    def flush_bulk(self) -> None:
        for t in self.tables.values():
            t.flush_bulk()
        _BulkSession.checkpoint()

    def start_gc(self, interval_s: float = 7200.0) -> None:
        """Background compaction daemon (the analogue of the reference's
        BadgerDB value-log GC goroutine, database/database.go:20-25,315-332)."""
        import threading

        def loop() -> None:
            while not self._gc_stop.wait(interval_s):
                for t in self.tables.values():
                    kv = t._kv
                    if hasattr(kv, "maybe_compact"):
                        kv.maybe_compact()

        self._gc_stop = threading.Event()
        t = threading.Thread(target=loop, daemon=True, name="store-gc")
        t.start()
        self._gc_thread = t

    def stop_gc(self) -> None:
        if hasattr(self, "_gc_stop"):
            self._gc_stop.set()

    def close(self) -> None:
        if self._docs_pack is not None:
            self._docs_pack.flush()
            self._docs_pack.close()
        for t in self.tables.values():
            t.exit_bulk()
            t._kv.close()


class _BulkSession:
    # The cycle collector's pause time scales with live heap: a crawl-scale
    # bulk cache holds tens of millions of posting lists (35 GB at 1M docs)
    # and gen-2 sweeps over it measurably throttle indexing (+20% pages/s
    # at 10k docs with collection off; the gap grows with the heap). Rows
    # are acyclic dict/list/float structures, so refcounting alone frees
    # everything transient; collection pauses while ANY bulk session is
    # open (process-wide — the crawler drives exactly one).
    _depth = 0
    _was_enabled = False

    def __init__(self, db: Database) -> None:
        self._db = db

    def __enter__(self) -> "Database":
        import gc

        for t in self._db.tables.values():
            t.enter_bulk()
        cls = _BulkSession
        if cls._depth == 0:
            cls._was_enabled = gc.isenabled()
            if cls._was_enabled:
                gc.disable()
                gc.freeze()  # pre-existing heap out of future sweeps
        cls._depth += 1
        return self._db

    def __exit__(self, *exc) -> None:
        import gc

        for t in self._db.tables.values():
            t.exit_bulk()
        cls = _BulkSession
        cls._depth -= 1
        if cls._depth == 0 and cls._was_enabled:
            gc.unfreeze()
            gc.enable()

    @classmethod
    def checkpoint(cls) -> None:
        """Free cyclic garbage accumulated while collection is paused.

        Handled exceptions during a crawl (fetch/parse errors) pin
        frame/traceback cycles that refcounting cannot free, so a long
        bulk session would otherwise grow without bound. Collect-then-
        freeze at each flush_bulk epoch: the collect only scans objects
        allocated since the previous checkpoint (everything older —
        including the bulk cache itself — is frozen), so the pause tracks
        the epoch's allocations, not the whole heap."""
        import gc

        if cls._depth > 0 and cls._was_enabled:
            gc.collect()
            gc.freeze()
