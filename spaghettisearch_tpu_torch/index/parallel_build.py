"""The benchmark corpus's store, built by several processes.

`build_store` writes what one process writes when it indexes the same
pages, one after another, through `index_page` inside one bulk session and
then runs PageRank and the term weighting (corpus.py `write_corpus`): every
table value for value, the docs pack byte for byte. Only `doc_magnitude`
differs, in the last bits: a doc's magnitude is a float64 sum of squared
weights, and its order of summation follows the store's row order, which
differs between any two builds (PERF.md states the bar, 1e-12 relative).

`index_page` reads state that earlier pages wrote, so page ranges cannot
be indexed apart and concatenated. The build keeps the indexer as it is
and gives each range the state that matters to it instead:

1. Scan (parallel over chunks of pages): tokenize each page for its raw
   title and its links, the two things a later page reads of it.
2. Index (parallel over chunks): each chunk runs `index_page` on its pages
   in order, in a fresh in-memory store seeded with the DocInfo state its
   pages read: for a linked page of an earlier chunk, a record holding
   that page's title (an anchor posting merges the child's title words
   once the child is indexed); for a page of this chunk that an earlier
   chunk links to, a stub (the record the page finds as its `old`). Word
   rows do not depend on what a row held before, so each chunk's rows are
   its pages' writes. Every row is spilled to one file per key bucket.
3. Merge (parallel over buckets): each bucket's rows, chunk by chunk in
   page order, as one dict per row (`dict.update`: the first write sets a
   key's place, the last its value, as in one process). A page's DocInfo
   gets the parents that earlier chunks' pages added to its stub before
   it, and those that later chunks add after it. The rows go into a store
   of the bucket's own, where `ops/weighting.py update_term_weights`
   weights them (idf over the PageRank node census; the bucket holds
   every posting of its words). The bucket then writes its part of the
   snapshot: its words' weighted postings as `SectionCSR.from_flat`
   orders them (by word, then doc id in the sorted census), and each
   doc's sum of squared weights over its words, by census id.
4. The parent joins the buckets' table logs into one store (disjoint keys,
   so the logs concatenate), appends the pages to the docs pack in page
   order, writes the topic rows, runs PageRank on `device`, and writes
   each doc's magnitude: the root of its buckets' sums (the same squared
   weights, summed in another order).
5. The snapshot (`build_snapshot` of the joined store, array for array):
   the buckets are ranges of the keys' 32-bit prefix, so their sorted
   words are contiguous runs of the global sorted word list and their
   parts concatenate in bucket order, with the offsets shifted and the
   pads added once; the magnitudes and ranks are the float32 of the
   numbers the parent writes to the store.

Workers are forked (they share the rendered pages) and never touch CUDA;
PageRank runs in the parent after the merge. A worker that raises or dies
fails the build: nothing is redone in one process.
"""

from __future__ import annotations

import concurrent.futures as cf
import json
import math
import multiprocessing
import os
import pickle
import resource
import shutil
import threading
import time
from datetime import datetime

import numpy as np

from ..ops.weighting import update_term_weights
from ..store.docinfo import ZERO_TIME, DocInfo
from ..store.tables import _DELETED, TABLE_SPECS, Database
from ..text.htmlparse import tokenize_page
from ..utils.hashing import md5_hex, md5_str
from .indexer import index_page
from .persist import _SECTION_FIELDS
from .snapshot import IndexSnapshot, SectionCSR, _pad_to, export_postings

#: tables the parent writes itself, after the merge (the indexer leaves them alone)
PARENT_TABLES = ("inv_topic", "doc_rank", "doc_magnitude", "topic_meta")
#: tables built per key bucket by the merge workers
BUCKET_TABLES = tuple(s.name for s in TABLE_SPECS if s.name not in PARENT_TABLES)
#: posting rows merged per key as dicts (anchor postings: several chunks write one doc's key)
_ROW_TABLES = ("inv_title", "inv_title_raw")
#: posting rows keyed by the page that writes them (body postings): a chunk's
#: part of a row is its stored text, and a row is its parts joined in page order
_TEXT_ROWS = ("inv_body", "inv_body_raw")
SECTIONS = ("title", "body")

# the read-only state forked workers inherit: set by build_store before each pool starts
_S: dict = {}


def default_chunk_pages(n_pages: int, workers: int) -> int:
    """Pages per index task: four tasks per worker, at most 10,000 pages
    (a task holds its pages' rows in memory until it spills them)."""
    return max(1, min(10_000, math.ceil(n_pages / (4 * workers))))


def default_buckets(n_pages: int, workers: int) -> int:
    """Key buckets: a multiple of the workers, about 30,000 pages' rows
    each (a merge task holds its bucket's rows in memory)."""
    return workers * max(1, math.ceil(max(2 * workers, n_pages / 30_000) / workers))


def _bucket(key: str, n_buckets: int) -> int:
    """A range of the key's 32-bit prefix: bucket b holds the keys that sort
    between bucket b-1's and bucket b+1's."""
    return int(key[:8], 16) * n_buckets >> 32


#: hex digit -> its value (255 for any other byte)
_NIBBLE = np.full(256, 255, np.uint8)
_NIBBLE[np.frombuffer(b"0123456789", np.uint8)] = np.arange(10)
_NIBBLE[np.frombuffer(b"abcdef", np.uint8)] = np.arange(10, 16)


def _prefix64(hashes: np.ndarray) -> np.ndarray:
    """uint64 of each S32 hex hash's first 16 digits: for lowercase hex, the
    order of the hashes themselves."""
    nib = _NIBBLE[np.frombuffer(hashes.tobytes(), np.uint8).reshape(-1, hashes.itemsize)[:, :16]]
    packed = np.ascontiguousarray((nib[:, 0::2] << 4) | nib[:, 1::2])
    return packed.view(">u8").ravel().astype(np.uint64)


def _census_ids(hashes: np.ndarray) -> np.ndarray:
    """Each doc hash's index in the sorted census (_S["census"]), as
    SectionCSR.from_flat's searchsorted finds it: a search on the 64-bit
    prefixes, each hit checked against the whole hash, and the misses (a
    prefix two census docs share) searched again on the whole hash. A hash
    outside the census raises KeyError. -> int32 [len(hashes)]."""
    census, keys = _S["census"], _S["census_keys"]
    if not len(hashes):
        return np.zeros(0, np.int32)
    if not len(census):
        raise KeyError(hashes[0].decode())
    idx = np.minimum(np.searchsorted(keys, _prefix64(hashes)), len(census) - 1)
    miss = np.flatnonzero(census[idx] != hashes)
    if len(miss):
        idx[miss] = np.minimum(np.searchsorted(census, hashes[miss]), len(census) - 1)
        bad = census[idx[miss]] != hashes[miss]
        if bad.any():
            raise KeyError(hashes[miss][bad][0].decode())
    return idx.astype(np.int32)


def _rss_mb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def _meminfo() -> dict[str, int]:
    out = {}
    try:
        with open("/proc/meminfo", encoding="ascii") as f:
            for line in f:
                name, rest = line.split(":", 1)
                out[name] = int(rest.split()[0]) * 1024
    except OSError:
        pass
    return out


class _MemWatch:
    """The host's MemAvailable low-water mark while the build runs (every
    worker's pages included, which per-process peaks count twice where
    forked pages are shared)."""

    def __init__(self, period_s: float = 0.5) -> None:
        self.start = _meminfo().get("MemAvailable", 0)
        self.low = self.start
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, args=(period_s,), daemon=True)
        self._t.start()

    def _run(self, period_s: float) -> None:
        while not self._stop.wait(period_s):
            self.low = min(self.low, _meminfo().get("MemAvailable", self.low))

    def stop(self) -> int:
        self._stop.set()
        self._t.join()
        return self.start - self.low


# ---------------------------------------------------------------------- #
# workers
# ---------------------------------------------------------------------- #


def _scan_chunk(s: int, e: int) -> tuple[int, list, list, float]:
    """Raw title words and link hashes of pages [s, e): what index_page
    stores as a page's `page_title` and `children`."""
    urls, raws = _S["urls"], _S["raws"]
    titles, kids = [], []
    for i in range(s, e):
        tp = tokenize_page(raws[i], urls[i])
        titles.append(tp.title.split())
        kids.append([md5_str(u) for u in tp.links])
    return s, titles, kids, _rss_mb()


def _index_chunk(c: int, s: int, e: int) -> tuple[int, float, float, float]:
    """index_page over pages [s, e) in order, in a fresh in-memory store
    seeded with the DocInfo state those pages read; spill every row.
    -> (c, seconds indexing, seconds spilling, rss MB)."""
    t0 = time.perf_counter()
    urls, raws, hashes = _S["urls"], _S["raws"], _S["hashes"]
    titles, kids, page_of = _S["titles"], _S["kids"], _S["page_of"]
    first_linker, ts, n_buckets = _S["first_linker"], _S["ts"], _S["n_buckets"]
    db = Database(None)
    with db.bulk():
        info = db.doc_info
        for i in range(s, e):
            for kid in kids[i]:
                j = page_of.get(kid)
                if j is not None and j < s and kid not in info._cache:
                    info.set(kid, DocInfo(url=urls[j], page_title=list(titles[j]), mod_date=ts))
            if first_linker[i] < s:
                info.set(hashes[i], DocInfo(url=urls[i], mod_date=ZERO_TIME))
        for i in range(s, e):
            index_page(db, raws[i], urls[i], last_modified=ts)
        t_index = time.perf_counter() - t0
        parts: list[dict] = [{name: [] for name in BUCKET_TABLES} for _ in range(n_buckets)]
        for name, table in db.tables.items():
            cache = table._cache
            if name in PARENT_TABLES:
                if cache:
                    raise RuntimeError(f"index_page wrote {name}, which the parallel build "
                                       "leaves to the parent")
                continue
            text = name in _TEXT_ROWS
            dump = table._dumps
            for k, v in cache.items():
                if v is _DELETED:
                    raise RuntimeError(f"index_page deleted {name}[{k}]: the parallel build "
                                       "indexes each page once")
                if text:
                    for dh in v:
                        j = page_of.get(dh)
                        if j is None or not s <= j < e:
                            raise RuntimeError(f"{name}[{k}] holds {dh}, not a page of the chunk")
                    v = dump(v)[1:-1]
                elif name == "doc_info":
                    j = page_of.get(k)
                    v = (s <= j < e if j is not None else False, v)
                parts[_bucket(k, n_buckets)][name].append((k, v))
        for table in db.tables.values():
            table._dirty.clear()  # harvested: nothing for the in-memory store
    spill = _S["spill"]
    for b, part in enumerate(parts):
        with open(os.path.join(spill, f"c{c:05d}.b{b:04d}.pkl"), "wb") as f:
            pickle.dump(part, f, protocol=pickle.HIGHEST_PROTOCOL)
    return c, t_index, time.perf_counter() - t0 - t_index, _rss_mb()


def _merge_bucket(b: int) -> tuple:
    """Every chunk's rows of key bucket b, merged in page order, written
    into the bucket's own store and weighted there; the bucket's part of
    the snapshot written beside it (_snapshot_part). -> (b, the part's
    path and sizes, seconds merging, writing, weighting and writing the
    part, rss MB)."""
    t0 = time.perf_counter()
    spill, n_chunks, n = _S["spill"], _S["n_chunks"], _S["n_nodes"]
    rows = {name: {} for name in _ROW_TABLES}
    texts = {name: {} for name in _TEXT_ROWS}
    words: dict = {}
    flat: dict = {"doc_children": {}, "doc_summary": {}}
    docs: dict = {}  # doc hash -> [DocInfo, parents in page order]
    for c in range(n_chunks):
        path = os.path.join(spill, f"c{c:05d}.b{b:04d}.pkl")
        with open(path, "rb") as f:
            part = pickle.load(f)
        os.remove(path)
        for name in _ROW_TABLES:
            merged = rows[name]
            for k, row in part[name]:
                cur = merged.get(k)
                if cur is None:
                    merged[k] = row
                else:
                    cur.update(row)
        for name in _TEXT_ROWS:
            merged = texts[name]
            for k, frag in part[name]:
                cur = merged.get(k)
                if cur is None:
                    merged[k] = [frag]
                else:
                    cur.append(frag)
        words.update(part["word"])
        for name, into in flat.items():
            for k, v in part[name]:
                if k in into:
                    raise RuntimeError(f"{name}[{k}] written by two chunks")
                into[k] = v
        for k, (own, info) in part["doc_info"]:
            rec = docs.get(k)
            if rec is None:
                docs[k] = rec = [info, {}]
            elif own:
                rec[0] = info
            rec[1].update(info.parents)
    for info, parents in docs.values():
        info.parents = parents
    t_merge = time.perf_counter() - t0
    db = Database(os.path.join(_S["shards"], f"b{b:04d}"))
    with db.bulk():
        for name in _ROW_TABLES:
            table = db.tables[name]
            for k, v in rows[name].items():
                table.set(k, v)
        for name in _TEXT_ROWS:
            db.tables[name]._kv.set_many(
                [(k, "{" + ", ".join(frags) + "}") for k, frags in texts[name].items()])
        for k, v in words.items():
            db.word.set(k, v)
        for name, into in flat.items():
            table = db.tables[name]
            for k, v in into.items():
                table.set(k, v)
        for k, (info, _) in docs.items():
            db.doc_info.set(k, info)
    del rows, texts, words, flat, docs
    t_write = time.perf_counter() - t0 - t_merge
    # the bucket holds every posting of its words, so each weight is exact
    sums = {section: _weigh(db, section, n) for section in ("title", "body")}
    for name in ("inv_title", "inv_body"):
        compact = getattr(db.tables[name]._kv, "compact", None)
        if compact is not None and compact() is False:
            raise RuntimeError(f"could not compact the bucket's {name}")
    t_weigh = time.perf_counter() - t0 - t_merge - t_write
    part = _snapshot_part(db, b, sums)
    db.close()
    t_part = time.perf_counter() - t0 - t_merge - t_write - t_weigh
    return (b, part, t_merge, t_write, t_weigh, t_part, _rss_mb())


def _section_part(flat: tuple, words: np.ndarray) -> dict[str, np.ndarray]:
    """SectionCSR.from_flat's arithmetic on one bucket's export, without the
    pads: per word of `words` (the bucket's sorted words) its posting
    count, and the postings ordered by (word, census id) with their
    positions sorted ascending within each posting."""
    row_keys, row_offsets, doc_hashes, weights, pos_offsets, positions = flat
    n_post = len(weights)
    word_of_post = np.repeat(np.searchsorted(words, row_keys),
                             np.diff(row_offsets.astype(np.int64)))
    doc_of_post = _census_ids(doc_hashes)
    order = np.lexsort((doc_of_post, word_of_post))
    pos_offsets64 = pos_offsets.astype(np.int64)
    pos_len_o = np.diff(pos_offsets64)[order]
    total = int(pos_len_o.sum())
    pos = np.zeros(0, np.float64)
    if total:
        shift = np.repeat(np.cumsum(pos_len_o) - pos_len_o, pos_len_o)
        src = np.arange(total, dtype=np.int64) - shift + np.repeat(pos_offsets64[:-1][order],
                                                                    pos_len_o)
        pos = positions[src]
        seg = np.repeat(np.arange(n_post, dtype=np.int64), pos_len_o)
        pos = pos[np.lexsort((pos, seg))]
    return {"counts": np.bincount(word_of_post, minlength=len(words)).astype(np.int64),
            "doc_ids": doc_of_post[order], "weights": weights[order].astype(np.float32),
            "pos_counts": pos_len_o, "positions": pos.astype(np.float32)}


def _snapshot_part(db: Database, b: int, sums: dict) -> dict:
    """Bucket b's part of the snapshot, from its weighted store: its sorted
    words, each section's postings (_section_part) and each doc's sum of
    squared weights over the bucket's words by census id, in one
    uncompressed .npz under the build's work directory. -> {"path",
    "words", and per section "post" and "pos", the part's sizes}."""
    flats = {s: export_postings(db.inverted(s)) for s in ("title", "body")}
    words = np.union1d(flats["title"][0], flats["body"][0])
    arrays: dict[str, np.ndarray] = {"words": words}
    out: dict = {"words": len(words)}
    for section, flat in flats.items():
        for k, v in _section_part(flat, words).items():
            arrays[f"{section}.{k}"] = v
        out[section] = {"post": len(arrays[f"{section}.doc_ids"]),
                        "pos": len(arrays[f"{section}.positions"])}
        dh, sq = sums[section]
        arrays[f"{section}.mag_ids"] = _census_ids(dh)
        arrays[f"{section}.mag_sq"] = np.asarray(sq, np.float64)
    out["path"] = os.path.join(_S["parts"], f"b{b:04d}.npz")
    np.savez(out["path"], **arrays)
    return out


def _weigh(db: Database, section: str, n: float) -> tuple[np.ndarray, np.ndarray]:
    """update_term_weights(db, section, total_docs=n) on a bucket's store,
    less its doc_magnitude rows (a doc's magnitude sums over every bucket).
    -> (doc hashes S32, each doc's sum of squared weights over the bucket's
    words)."""
    inv, raw = db.inverted(section), db.inverted_raw(section)
    flat = None
    if hasattr(inv._kv, "apply_term_weights") and hasattr(raw._kv, "_h"):
        flat = export_postings(inv)
    if flat is not None:  # update_term_weights' native pass, as it calls it
        row_keys, row_offsets = flat[0], flat[1]
        if not len(row_keys):
            return np.zeros(0, "S32"), np.zeros(0, np.float64)
        df = np.diff(row_offsets.astype(np.int64))
        idf = np.log2(np.float64(n) / df.astype(np.float64)).astype(np.float32)
        out = inv._kv.apply_term_weights(raw._kv, row_keys, idf.astype(np.float64))
        if out is None:
            raise RuntimeError(f"the native term weighting refused the bucket's {section} rows")
        return out
    # the Python store: the pass itself; its magnitudes squared back (2 ulp)
    update_term_weights(db, section, total_docs=n)
    mags = [(k, m[section]) for k, m in db.doc_magnitude.items() if section in m]
    return (np.asarray([k for k, _ in mags], dtype="S32"),
            np.square(np.asarray([m for _, m in mags], np.float64)))


def _concat_tables(shards: list[str], root: str) -> None:
    """Join each table's log files across bucket stores (disjoint keys:
    one store's log followed by another's replays to their union)."""
    def join(name: str) -> None:
        dst_dir = os.path.join(root, name)
        os.makedirs(dst_dir, exist_ok=True)
        for shard in shards:
            src_dir = os.path.join(shard, name)
            for fn in sorted(os.listdir(src_dir)):
                src = os.path.join(src_dir, fn)
                with open(src, "rb") as fi, open(os.path.join(dst_dir, fn), "ab") as fo:
                    shutil.copyfileobj(fi, fo, 16 << 20)
                os.remove(src)

    with cf.ThreadPoolExecutor(4) as pool:
        list(pool.map(join, BUCKET_TABLES))


def _run_pool(workers: int, fn, tasks: list[tuple]) -> list:
    """fn(*task) for every task in forked processes; the first failure
    (an exception, or a worker that died) fails the build."""
    ctx = multiprocessing.get_context("fork")
    out = []
    with cf.ProcessPoolExecutor(max_workers=workers, mp_context=ctx) as pool:
        futures = [pool.submit(fn, *t) for t in tasks]
        try:
            for fut in cf.as_completed(futures):
                out.append(fut.result())
        except BaseException:
            for fut in futures:
                fut.cancel()
            raise
    return out


def _join_parts(parts: list[dict], census: np.ndarray) -> tuple:
    """The buckets' snapshot parts, in bucket order, joined: the sorted
    words, each section's SectionCSR padded as from_flat pads it, and per
    section each doc's sum of squared weights over every bucket and
    whether a bucket saw it. -> (words S32, {section: SectionCSR},
    {section: f64 [D]}, {section: bool [D]}, seconds adding the sums)."""
    n_docs, n_words = len(census), sum(p["words"] for p in parts)
    words = np.empty(n_words, "S32")
    out: dict = {}
    for section in SECTIONS:
        n_post = sum(p[section]["post"] for p in parts)
        n_pos = sum(p[section]["pos"] for p in parts)
        if max(n_post, n_pos) >= 2**31:
            raise OverflowError(f"{section}: {n_post} postings, {n_pos} positions overflow "
                                "the snapshot's int32 offsets")
        p_pad = _pad_to(n_post)
        # counts and pos_counts one slot right, zero past the last posting:
        # their running sums are the offsets, pads included
        out[section] = {"counts": np.zeros(n_words + 1, np.int64),
                        "doc_ids": np.full(p_pad, n_docs, np.int32),
                        "weights": np.zeros(p_pad, np.float32),
                        "pos_counts": np.zeros(p_pad + 1, np.int64),
                        "positions": np.full(_pad_to(n_pos), np.inf, np.float32)}
    sq = {s: np.zeros(n_docs, np.float64) for s in SECTIONS}
    seen = {s: np.zeros(n_docs, bool) for s in SECTIONS}
    t_add = 0.0
    w0, p0, l0 = 0, dict.fromkeys(SECTIONS, 0), dict.fromkeys(SECTIONS, 0)
    for part in parts:
        nw = part["words"]
        with np.load(part["path"]) as z:
            words[w0 : w0 + nw] = z["words"]
            for section in SECTIONS:
                a, np_, nl = out[section], part[section]["post"], part[section]["pos"]
                a["counts"][1 + w0 : 1 + w0 + nw] = z[f"{section}.counts"]
                a["doc_ids"][p0[section] : p0[section] + np_] = z[f"{section}.doc_ids"]
                a["weights"][p0[section] : p0[section] + np_] = z[f"{section}.weights"]
                a["pos_counts"][1 + p0[section] : 1 + p0[section] + np_] = \
                    z[f"{section}.pos_counts"]
                a["positions"][l0[section] : l0[section] + nl] = z[f"{section}.positions"]
                p0[section] += np_
                l0[section] += nl
                t = time.perf_counter()
                ids = z[f"{section}.mag_ids"]
                sq[section][ids] += z[f"{section}.mag_sq"]
                seen[section][ids] = True
                t_add += time.perf_counter() - t
        w0 += nw
    if n_words > 1 and not (words[1:] > words[:-1]).all():
        raise RuntimeError("the buckets' words are not contiguous runs of the sorted word list")
    csr = {}
    for section, a in out.items():
        csr[section] = SectionCSR(
            post_offsets=np.cumsum(a["counts"]).astype(np.int32),
            doc_ids=a["doc_ids"],
            weights=a["weights"],
            pos_offsets=np.cumsum(a["pos_counts"]).astype(np.int32),
            positions=a["positions"],
            n_postings=p0[section],
            max_df=int(a["counts"].max(initial=0)),
            max_positions=int(a["pos_counts"].max(initial=0)),
        )
    return words, csr, sq, seen, t_add


def save_snapshot_uncompressed(snap: IndexSnapshot, path: str) -> None:
    """index/persist.py save_snapshot's layout (`arrays.npz` with the same
    keys, `meta.json`), written by np.savez, not np.savez_compressed: the
    same atomic write (a temporary sibling directory renamed into place),
    and persist.load_snapshot reads it unchanged."""
    final = os.path.abspath(path)
    tmp = f"{final}.tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    arrays = {f"{name}.{f}": getattr(snap.section(name), f)
              for name in SECTIONS for f in _SECTION_FIELDS}
    arrays.update(mag_title=snap.mag_title, mag_body=snap.mag_body)
    if snap.pagerank is not None:
        arrays["pagerank"] = snap.pagerank
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    meta = {"doc_hashes": snap.doc_hashes, "word_hashes": snap.word_hashes,
            "categories": snap.categories}
    for name in SECTIONS:
        csr = snap.section(name)
        meta[name] = {"n_postings": csr.n_postings, "max_df": csr.max_df,
                      "max_positions": csr.max_positions}
    with open(os.path.join(tmp, "meta.json"), "w", encoding="utf-8") as f:
        json.dump(meta, f)
    old = f"{final}.old-{os.getpid()}"
    if os.path.exists(final):
        os.rename(final, old)
    os.rename(tmp, final)
    shutil.rmtree(old, ignore_errors=True)


# ---------------------------------------------------------------------- #
# the build
# ---------------------------------------------------------------------- #


def build_store(
    root: str,
    pages: list[tuple[str, bytes]],
    last_modified: datetime,
    topic_meta: list[tuple[str, dict]],
    workers: int,
    device: str = "cuda",
    log=None,
) -> tuple[Database, IndexSnapshot, dict]:
    """Index `pages` ((url, raw HTML) in crawl order, each url once) into a
    fresh store at `root` with `workers` processes, run PageRank on
    `device` and weight the terms: the store one process writes with
    index_page over the same pages in one bulk session, then
    update_pagerank and update_term_weights. -> (the open Database, its
    snapshot, equal to index/snapshot.py build_snapshot of it, the build's
    seconds per step and memory)."""
    from ..ops.pagerank import update_pagerank

    say = log or (lambda msg: None)
    if workers < 2:
        raise ValueError("build_store runs two or more workers; one worker is write_corpus's loop")
    n = len(pages)
    chunk_pages = default_chunk_pages(n, workers)
    n_buckets = default_buckets(n, workers)
    stats: dict = {"workers": workers, "pages": n, "chunk_pages": chunk_pages,
                   "buckets": n_buckets, "seconds": {}, "magnitude_spans": {},
                   "worker_rss_mb": 0.0}
    sec, spans = stats["seconds"], stats["magnitude_spans"]
    work = root.rstrip("/") + ".parts"
    shutil.rmtree(work, ignore_errors=True)
    shutil.rmtree(root, ignore_errors=True)
    spill, shards, parts = (os.path.join(work, d) for d in ("spill", "shards", "parts"))
    for d in (spill, shards, parts):
        os.makedirs(d)
    watch = _MemWatch()
    chunks = [(c, s, min(n, s + chunk_pages)) for c, s in enumerate(range(0, n, chunk_pages))]
    urls = [u for u, _ in pages]
    _S.clear()
    _S.update(urls=urls, raws=[r for _, r in pages], ts=last_modified, n_buckets=n_buckets,
              spill=spill, shards=shards, parts=parts, n_chunks=len(chunks))

    def note_rss(rss) -> None:
        stats["worker_rss_mb"] = max(stats["worker_rss_mb"], *rss)

    try:
        t = time.perf_counter()
        hashes = [md5_hex(u) for u in urls]
        page_of = {h: i for i, h in enumerate(hashes)}
        if len(page_of) != n:
            raise ValueError("build_store indexes each url once")
        titles: list = [None] * n
        kids: list = [None] * n
        scans = _run_pool(workers, _scan_chunk, [(s, e) for _, s, e in chunks])
        for s, ts_, ks, rss in scans:
            titles[s : s + len(ts_)] = ts_
            kids[s : s + len(ks)] = ks
            note_rss([rss])
        first_linker = np.full(n, n, dtype=np.int64)
        nodes = set(hashes)
        for i, ks in enumerate(kids):
            nodes.update(ks)
            for k in ks:
                j = page_of.get(k)
                if j is not None and i < first_linker[j]:
                    first_linker[j] = i
        sec["scan"] = time.perf_counter() - t
        say(f"scan: {n} pages' titles and links in {sec['scan']:.1f}s "
            f"({len(chunks)} chunks of {chunk_pages})")

        t = time.perf_counter()
        census = np.asarray(sorted(nodes), dtype="S32")
        spans["census_sort"] = time.perf_counter() - t

        t = time.perf_counter()
        _S.update(hashes=hashes, page_of=page_of, titles=titles, kids=kids,
                  first_linker=first_linker.tolist(), n_nodes=float(len(nodes)))
        res = _run_pool(workers, _index_chunk, chunks)
        note_rss([r[3] for r in res])
        sec["index"] = time.perf_counter() - t
        stats["worker_index_s"] = sum(r[1] for r in res)
        stats["worker_spill_s"] = sum(r[2] for r in res)
        say(f"index: {n} pages in {sec['index']:.1f}s ({n / max(sec['index'], 1e-9):.1f} "
            f"pages/s over {workers} workers; worker seconds: index_page "
            f"{stats['worker_index_s']:.1f}, spill {stats['worker_spill_s']:.1f})")

        t = time.perf_counter()
        _S.update(census=census, census_keys=_prefix64(census))
        res = sorted(_run_pool(workers, _merge_bucket, [(b,) for b in range(n_buckets)]))
        note_rss([r[6] for r in res])
        sec["merge"] = time.perf_counter() - t
        for i, step in ((2, "merge"), (3, "write"), (4, "weighting"), (5, "snapshot_part")):
            stats[f"worker_{step}_s"] = sum(r[i] for r in res)
        say(f"merge: {n_buckets} buckets in {sec['merge']:.1f}s (worker seconds: merge "
            f"{stats['worker_merge_s']:.1f}, write {stats['worker_write_s']:.1f}, "
            f"weighting {stats['worker_weighting_s']:.1f}, snapshot parts "
            f"{stats['worker_snapshot_part_s']:.1f})")

        t = time.perf_counter()
        words, csr, sq, seen, spans["accumulate"] = _join_parts([r[1] for r in res], census)
        del res
        sec["snapshot"] = time.perf_counter() - t
        say(f"snapshot: {n_buckets} buckets' parts joined in {sec['snapshot']:.1f}s "
            f"({len(words)} words, {csr['title'].n_postings} title + "
            f"{csr['body'].n_postings} body postings; the magnitudes' sums added in "
            f"{spans['accumulate']:.1f}s)")

        t = time.perf_counter()
        _concat_tables([os.path.join(shards, f"b{b:04d}") for b in range(n_buckets)], root)
        shutil.rmtree(work, ignore_errors=True)
        db = Database(root)
        if len(db.doc_info) != len(census):
            raise RuntimeError(f"the store holds {len(db.doc_info)} docs, the census "
                               f"{len(census)}")
        for name, row in topic_meta:
            db.topic_meta.set(name, row)
        for h, (_, raw) in zip(hashes, pages):
            db.cache_doc(h, raw)
        sec["join"] = time.perf_counter() - t
        say(f"join: the buckets' logs joined, the store opened and the docs pack written in "
            f"{sec['join']:.1f}s")

        t = time.perf_counter()
        pr = update_pagerank(db, device=device, keep_ranks=True)
        node_list, ranks = pr.pop("node_list"), pr.pop("ranks")
        if not np.array_equal(np.asarray(node_list, dtype="S32"), census):
            raise RuntimeError(f"PageRank's {pr['nodes']} nodes are not the scan's "
                               f"{len(census)}")
        sec["pagerank"] = time.perf_counter() - t
        stats["pagerank"] = pr
        say(f"pagerank ({pr['nodes']} nodes, {pr['edges']} edges, {pr['iterations']} "
            f"iterations on {device}) in {sec['pagerank']:.1f}s")

        t = time.perf_counter()
        # a doc's squared magnitude is its squared weights summed over every
        # word; each bucket's part holds its words' share
        roots = {s: np.sqrt(sq[s]) for s in SECTIONS}
        cols = [(s, seen[s].tolist(), roots[s].tolist()) for s in SECTIONS]
        any_seen = seen["title"] | seen["body"]
        with db.doc_magnitude.batch() as bw:
            for i in np.flatnonzero(any_seen).tolist():
                bw.set(census[i].decode(), {s: root[i] for s, has, root in cols if has[i]})
        del cols
        spans["rows"] = time.perf_counter() - t
        t1 = time.perf_counter()
        # Database.flush() without its compaction pass: these logs hold each
        # row once, and rewriting the largest tables would only cost time
        db._docs_pack.flush()
        for table in db.tables.values():
            table._kv.flush()
        spans["flush"] = time.perf_counter() - t1
        sec["weighting"] = time.perf_counter() - t
        say(f"term weighting: magnitudes of {int(any_seen.sum())} docs written in "
            f"{sec['weighting']:.1f}s (the rows were weighted per bucket; census sort "
            f"{spans['census_sort']:.1f}s, sums added {spans['accumulate']:.1f}s, rows "
            f"{spans['rows']:.1f}s, the tables' flush {spans['flush']:.1f}s)")

        t = time.perf_counter()
        # the numbers the store now holds, as float32: the rows' JSON floats
        # read back to the same doubles
        categories = sorted(db.topic_meta.keys())
        doc_hashes = [h.decode() for h in census.tolist()]
        word_hashes = [w.decode() for w in words.tolist()]
        snap = IndexSnapshot(
            doc_hashes=doc_hashes,
            word_hashes=word_hashes,
            doc_id={h: i for i, h in enumerate(doc_hashes)},
            word_id={h: i for i, h in enumerate(word_hashes)},
            title=csr["title"],
            body=csr["body"],
            mag_title=roots["title"].astype(np.float32),
            mag_body=roots["body"].astype(np.float32),
            categories=categories,
            pagerank=np.ascontiguousarray(ranks.T, dtype=np.float32) if categories else None,
        )
        sec["snapshot"] += time.perf_counter() - t
    except BaseException:
        watch.stop()
        _S.clear()
        shutil.rmtree(work, ignore_errors=True)
        raise
    _S.clear()
    stats["parent_rss_mb"] = _rss_mb()
    stats["host_used_mb"] = watch.stop() / 2**20
    say(f"peak RSS: parent {stats['parent_rss_mb']:.0f} MB, workers up to "
        f"{stats['worker_rss_mb']:.0f} MB; "
        f"host memory in use rose by up to {stats['host_used_mb']:.0f} MB")
    return db, snap, stats
