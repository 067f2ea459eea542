"""The seeded benchmark corpus, with neither lxml nor jax.

`render_pages` renders the pages of the benchmark corpus (bench.py
build_bench_corpus) as bench.py does: the same seeded draws in the same
order —

  - a vocabulary of n_vocab words `w%05d`, Zipf s=1.05 with the top 40
    terms dropped (the stopword-filtered head);
  - bodies of 40-120 tokens and titles of 2-6;
  - 0-7 links per page to uniformly drawn pages, anchor text = a body word;
  - topic categories General and Science.

`write_corpus` builds the corpus as bench.py does: every rendered page
through this package's indexer (index/indexer.py index_page, a copy of the
JAX package's) inside one bulk session, in page order, with a fixed
Last-Modified of 2026-01-01; then this package's update_pagerank (the
reference model, on `device`) and the term weighting pass
(ops/weighting.py). Into a directory it runs in several processes
(index/parallel_build.py), which write the same store;
`write_corpus_with_snapshot` returns the corpus's snapshot beside it (the
parallel build assembles it from its key buckets). So the store holds
what bench.py's does, anchor text included: a link's text is a body word
of the linking page and a title posting of its target at the -100
sentinel position.

`bench_queries` is bench.py's query mix over a built corpus (df-weighted
keywords, a 2-gram mined from a cached page in every `phrase_every`-th
query).

The small fixture corpus of the JAX package's tests (tests/corpus.py) is
here too, so that the port's graft entry points, soaks and tests need no
file of the JAX package: `VOCAB`, `make_page` and `build_corpus_db` draw
from `random.Random` exactly as the original and index through this
package's indexer, PageRank (on `device`) and term weighting. And
`synth_snapshot` is bench.py's synthetic Zipf index (the same numpy draws
in the same order), returned as this package's IndexSnapshot.
"""

from __future__ import annotations

import os
import random
import resource
import time
from datetime import datetime, timezone

import numpy as np

from .index.indexer import index_page
from .index.snapshot import IndexSnapshot, SectionCSR, _pad_to, build_snapshot
from .ops.pagerank import update_pagerank
from .ops.weighting import update_term_weights
from .store.tables import Database

BASE_URL = "http://bench.local"


def zipf_probs(n_vocab: int, head_drop: int = 40, s: float = 1.05) -> np.ndarray:
    p = 1.0 / np.arange(1, n_vocab + 1) ** s
    p[:head_drop] = 0.0
    return p / p.sum()


def _draws(n_pages: int, n_vocab: int, seed: int) -> tuple:
    """The seeded draws of bench.py build_bench_corpus, in its order: the
    vocabulary, body and title lengths, body and title word ids, link
    counts and link targets."""
    rng = np.random.default_rng(seed)
    vocab = [f"w{i:05d}" for i in range(n_vocab)]
    probs = zipf_probs(n_vocab)
    body_lens = rng.integers(40, 120, n_pages)
    title_lens = rng.integers(2, 6, n_pages)
    body_words = rng.choice(n_vocab, size=int(body_lens.sum()), p=probs)
    title_words = rng.choice(n_vocab, size=int(title_lens.sum()), p=probs)
    n_links = rng.integers(0, 8, n_pages)
    link_targets = rng.integers(0, n_pages, int(n_links.sum()))
    return vocab, body_lens, title_lens, body_words, title_words, n_links, link_targets


def render_pages(n_pages: int = 100_000, n_vocab: int = 30_000, seed: int = 0) -> dict[str, bytes]:
    """The HTML pages bench.py build_bench_corpus indexes, by path: page i
    is `/p{i}`, its title and body are the seeded draws, and its k-th link
    goes to `/p{j}` with the page's body word k mod len as anchor text."""
    vocab, body_lens, title_lens, body_words, title_words, n_links, link_targets = (
        _draws(n_pages, n_vocab, seed)
    )
    pages = {}
    bo = to = lo = 0
    for i in range(n_pages):
        bw = body_words[bo : bo + int(body_lens[i])]
        tw = title_words[to : to + int(title_lens[i])]
        links = link_targets[lo : lo + int(n_links[i])]
        bo += int(body_lens[i])
        to += int(title_lens[i])
        lo += int(n_links[i])
        anchors = "".join(
            f'<a href="/p{j}">{vocab[bw[k % len(bw)]]}</a>\n' for k, j in enumerate(links)
        )
        pages[f"/p{i}"] = (
            f"<html><head><title>{' '.join(vocab[w] for w in tw)}</title>"
            f"</head><body><p>{' '.join(vocab[w] for w in bw)}</p>\n"
            f"{anchors}</body></html>"
        ).encode()
    return pages


def write_corpus(
    root: str | None,
    n_pages: int = 100_000,
    n_vocab: int = 30_000,
    seed: int = 0,
    log=None,
    device: str = "cuda",
    workers: int | None = None,
) -> Database:
    """Build the seeded corpus into a fresh Database at `root` (None = in
    memory): index every rendered page, run PageRank on `device`, weight
    the terms. Returns the open Database.

    `workers` processes index the pages (index/parallel_build.py; the same
    store). It defaults to the cores this process may use when `root` is a
    directory; an in-memory store, and workers=1, take the one-process loop
    below. Each step's seconds and the peak RSS go to `log`."""
    return _write(root, n_pages, n_vocab, seed, log, device, workers, snapshot=False)[0]


def write_corpus_with_snapshot(
    root: str,
    n_pages: int = 100_000,
    n_vocab: int = 30_000,
    seed: int = 0,
    log=None,
    device: str = "cuda",
    workers: int | None = None,
) -> tuple[Database, IndexSnapshot, dict]:
    """write_corpus into `root`, and the corpus's snapshot: with several
    workers the parallel build's (assembled from its key buckets, equal to
    index/snapshot.py build_snapshot of the store), in one process
    build_snapshot itself. -> (the open Database, the snapshot, the build's
    seconds per step under "seconds")."""
    return _write(root, n_pages, n_vocab, seed, log, device, workers, snapshot=True)


def _write(root, n_pages, n_vocab, seed, log, device, workers, snapshot: bool) -> tuple:
    say = log or (lambda msg: None)
    if workers is None:
        workers = len(os.sched_getaffinity(0)) if root is not None else 1
    if workers > 1 and root is None:
        raise ValueError("write_corpus: a build in several processes needs a root directory")
    t0 = time.perf_counter()
    pages = render_pages(n_pages, n_vocab, seed)
    t_render = time.perf_counter() - t0
    say(f"render: {n_pages} pages in {t_render:.1f}s")
    topics = [("General", {"numPages": float(n_pages), "wordCount": 1.0}),
              ("Science", {"numPages": float(n_pages // 2), "wordCount": 1.0})]
    ts = datetime(2026, 1, 1, tzinfo=timezone.utc)
    if workers > 1:
        from .index.parallel_build import build_store

        db, snap, stats = build_store(root, [(BASE_URL + path, raw) for path, raw in pages.items()],
                                      ts, topics, workers, device=device, log=say)
        stats["seconds"] = {"render": t_render, **stats["seconds"]}
        return db, snap, stats
    db = Database(root)
    for name, row in topics:
        db.topic_meta.set(name, row)
    t1 = time.perf_counter()
    with db.bulk():
        for i in range(n_pages):
            index_page(db, pages[f"/p{i}"], f"{BASE_URL}/p{i}", last_modified=ts)
            if (i + 1) % 20_000 == 0:
                say(f"indexed {i + 1}/{n_pages} pages")
    t_index = time.perf_counter() - t1
    say(f"index: {n_pages} pages in {t_index:.1f}s ({n_pages / max(t_index, 1e-9):.1f} pages/s, "
        "one process, the bulk flush included)")
    t1 = time.perf_counter()
    pr = update_pagerank(db, device=device)
    say(f"pagerank ({pr['nodes']} nodes, {pr['edges']} edges, {pr['iterations']} "
        f"iterations on {device}) in {time.perf_counter() - t1:.1f}s")
    t1 = time.perf_counter()
    update_term_weights(db, "title")
    update_term_weights(db, "body")
    db.flush()
    say(f"term weighting in {time.perf_counter() - t1:.1f}s; peak RSS "
        f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024:.0f} MB")
    if not snapshot:
        return db, None, None
    t1 = time.perf_counter()
    snap = build_snapshot(db)
    t_snap = time.perf_counter() - t1
    say(f"snapshot: build_snapshot of the store in {t_snap:.1f}s")
    return db, snap, {"workers": 1, "seconds": {"render": t_render, "snapshot": t_snap}}


def bench_queries(snap, n_queries: int, seed: int = 1, phrase_every: int = 4,
                  db=None) -> list[str]:
    """The benchmark query mix (bench.py bench_queries): 1-4 keywords drawn
    proportional to body df, and every `phrase_every`-th query led by an
    adjacent 2-gram mined from a random cached page body (so phrases
    actually match). Without `db` the keywords are word hashes and no
    phrase is mined."""
    rng = np.random.default_rng(seed)
    df = (snap.body.post_offsets[1:] - snap.body.post_offsets[:-1]).astype(np.float64)
    p = df / df.sum()
    words = snap.word_hashes
    word_of = None
    if db is not None:
        word_of = {wh: db.word.get(wh) for wh in words}
    out = []
    n_words = len(words)
    for i in range(n_queries):
        k = int(rng.integers(1, 5))
        ids = rng.choice(n_words, size=k, p=p)
        terms = []
        for wid in ids:
            w = word_of[words[int(wid)]] if word_of else words[int(wid)]
            if w:
                terms.append(w)
        q = " ".join(terms) if terms else "w00100"
        if phrase_every and i % phrase_every == 0 and db is not None:
            for _ in range(3):
                doc = snap.doc_hashes[int(rng.integers(0, snap.n_docs))]
                raw = db.cached_doc(doc)
                if not raw:
                    continue
                body = raw.decode().split("<p>", 1)[-1].split("</p>", 1)[0].split()
                if len(body) >= 2:
                    j = int(rng.integers(0, len(body) - 1))
                    q = f'"{body[j]} {body[j + 1]}" ' + q
                    break
        out.append(q)
    return out


# --------------------------------------------------------------------- #
# the JAX package's test fixture corpus (tests/corpus.py)
# --------------------------------------------------------------------- #
VOCAB = (
    "algorithm database retrieval ranking crawler spider index engine "
    "vector cosine matrix tensor gradient neural network graph node edge "
    "compiler kernel memory bandwidth latency throughput query document "
    "cluster shard replica partition stream batch pipeline schedule "
    "quantum physics chemistry biology astronomy galaxy planet orbit "
    "history culture music painting sculpture poetry novel theater"
).split()


def make_page(rng: random.Random, i: int, n_pages: int, base: str) -> tuple[str, bytes]:
    url = f"{base}/page{i}"
    title_words = rng.sample(VOCAB, rng.randint(1, 4))
    body_words = [rng.choice(VOCAB) for _ in range(rng.randint(20, 80))]
    n_links = rng.randint(0, min(5, n_pages - 1))
    links = rng.sample([j for j in range(n_pages) if j != i], n_links)
    anchors = "".join(
        f'<a href="/page{j}">{" ".join(rng.sample(VOCAB, rng.randint(1, 3)))}</a>\n'
        for j in links
    )
    meta = ""
    if rng.random() < 0.3:
        meta = f'<meta name="description" content="{" ".join(rng.sample(VOCAB, 3))}">'
    html = f"""<html><head><title>{' '.join(title_words)}</title>{meta}</head>
<body><h1>Page {i}</h1>
<p>{' '.join(body_words)}</p>
{anchors}
</body></html>"""
    return url, html.encode()


def build_corpus_db(n_pages: int = 20, seed: int = 0, root: str | None = None,
                    device: str = "cuda") -> Database:
    """Index a random small site, then run PageRank (on `device`) + term
    weighting (the reference's post-crawl batch jobs,
    cmd/crawl/start_crawl.go:174-177)."""
    rng = random.Random(seed)
    db = Database(root)
    base = "http://test.local"
    # a couple of topic categories so the rank table has category keys
    db.topic_meta.set("Science", {"numPages": float(n_pages), "wordCount": 100.0})
    db.topic_meta.set("Arts", {"numPages": float(2 * n_pages), "wordCount": 80.0})

    ts = datetime(2026, 1, 1, tzinfo=timezone.utc)
    with db.bulk():
        for i in range(n_pages):
            url, html = make_page(rng, i, n_pages, base)
            index_page(db, html, url, last_modified=ts)

    update_pagerank(db, device=device)
    update_term_weights(db, "title")
    update_term_weights(db, "body")
    return db


# --------------------------------------------------------------------- #
# bench.py's synthetic index (synth_snapshot)
# --------------------------------------------------------------------- #
def synth_snapshot(
    n_docs: int = 100_000,
    n_words: int = 50_000,
    body_terms_per_doc: int = 64,
    title_terms_per_doc: int = 6,
    max_df: int = 16_384,
    seed: int = 0,
) -> IndexSnapshot:
    """Synthesize a Zipf-distributed CSR index directly (no host store):
    equivalent in shape/statistics to a crawled 100k-page corpus after
    stopword filtering (which bounds the hottest term's df)."""
    rng = np.random.default_rng(seed)

    def make_section(terms_per_doc: int) -> SectionCSR:
        # sample word ids with a Zipf-ish distribution
        probs = 1.0 / np.arange(1, n_words + 1) ** 1.05
        probs /= probs.sum()
        total = n_docs * terms_per_doc
        words = rng.choice(n_words, size=total, p=probs).astype(np.int32)
        docs = np.repeat(np.arange(n_docs, dtype=np.int32), terms_per_doc)
        # unique (word, doc), then truncate hot rows to max_df
        key = words.astype(np.int64) * n_docs + docs
        key = np.unique(key)
        words = (key // n_docs).astype(np.int32)
        docs = (key % n_docs).astype(np.int32)
        # truncate per-word postings at max_df (order is word-major, doc asc)
        counts = np.bincount(words, minlength=n_words)
        offsets = np.concatenate([[0], np.cumsum(counts)])
        rank_in_row = np.arange(len(words)) - offsets[words]
        keep = rank_in_row < max_df
        words, docs = words[keep], docs[keep]
        counts = np.bincount(words, minlength=n_words)
        post_offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
        n_post = len(words)

        tf = rng.integers(1, 8, n_post).astype(np.float32)
        idf = np.log2(n_docs / np.maximum(counts, 1)).astype(np.float32)
        weights = (tf / 8.0) * idf[words]

        p_pad = _pad_to(n_post)
        doc_ids = np.full(p_pad, n_docs, np.int32)
        doc_ids[:n_post] = docs
        w = np.zeros(p_pad, np.float32)
        w[:n_post] = weights
        # single position per posting (keyword bench doesn't exercise phrase)
        pos_offsets = np.arange(p_pad + 1, dtype=np.int32)
        pos_offsets[n_post:] = n_post
        l_pad = _pad_to(n_post)
        positions = np.full(l_pad, np.inf, np.float32)
        positions[:n_post] = rng.integers(0, 500, n_post).astype(np.float32)
        return SectionCSR(
            post_offsets=post_offsets,
            doc_ids=doc_ids,
            weights=w,
            pos_offsets=pos_offsets,
            positions=positions,
            n_postings=n_post,
            max_df=int(counts.max()),
            max_positions=1,
        )

    body = make_section(body_terms_per_doc)
    title = make_section(title_terms_per_doc)

    # magnitudes consistent with the weights
    def mags(csr) -> np.ndarray:
        m = np.zeros(n_docs + 1, np.float64)
        np.add.at(m, csr.doc_ids[: csr.n_postings], csr.weights[: csr.n_postings] ** 2)
        return np.sqrt(m[:n_docs]).astype(np.float32)

    doc_hashes = [f"d{i:07d}" for i in range(n_docs)]
    word_hashes = [f"w{i:07d}" for i in range(n_words)]
    return IndexSnapshot(
        doc_hashes=doc_hashes,
        word_hashes=word_hashes,
        doc_id={},
        word_id={},
        title=title,
        body=body,
        mag_title=mags(title),
        mag_body=mags(body),
        categories=["general"],
        pagerank=np.abs(rng.normal(size=(n_docs, 1))).astype(np.float32) / n_docs,
    )
