"""The PyTorch port's offline build path against the JAX package's: the
indexer (`index_page` sequences with re-indexing), the BFS crawl and the
ODP scrape through DictFetcher (every store table equal, and the engines'
top-50 on the crawled store), the standard-library fetcher against a local
http.server, and the crawl CLI end to end (`--device cpu`) over a local
site. Tables are compared exactly; ranks within the float32 rtol 1e-5 of
the two PageRank implementations."""

from __future__ import annotations

import asyncio
import gzip
import random
import urllib.error
from datetime import datetime, timedelta, timezone

import numpy as np
import pytest
import torch

import test_crawl
from corpus import make_page
from spaghettisearch_tpu.crawl import odp as jodp
from spaghettisearch_tpu.crawl.fetch import DictFetcher as JaxDictFetcher
from spaghettisearch_tpu.crawl.frontier import crawl as jcrawl
from spaghettisearch_tpu.index.indexer import index_page as jindex
from spaghettisearch_tpu.ops.pagerank import update_pagerank as jpagerank
from spaghettisearch_tpu.ops.weighting import update_term_weights as jweights
from spaghettisearch_tpu.retrieval.engine import QueryEngine as JaxEngine
from spaghettisearch_tpu.retrieval.engine import parse_query as jax_parse
from spaghettisearch_tpu.store.tables import TABLE_SPECS as JSPECS
from spaghettisearch_tpu.store.tables import Database as JaxDatabase
from spaghettisearch_tpu_torch.cli import crawl as crawl_cli
from spaghettisearch_tpu_torch.corpus import render_pages
from spaghettisearch_tpu_torch.crawl import odp as todp
from spaghettisearch_tpu_torch.crawl.fetch import DictFetcher, UrllibFetcher
from spaghettisearch_tpu_torch.crawl.frontier import crawl as tcrawl
from spaghettisearch_tpu_torch.crawl.localsite import LocalSite
from spaghettisearch_tpu_torch.index.indexer import index_page as tindex
from spaghettisearch_tpu_torch.index.persist import load_snapshot
from spaghettisearch_tpu_torch.ops.pagerank import update_pagerank as tpagerank
from spaghettisearch_tpu_torch.ops.weighting import update_term_weights as tweights
from spaghettisearch_tpu_torch.retrieval.engine import QueryEngine, parse_query
from spaghettisearch_tpu_torch.store.tables import TABLE_SPECS, Database

torch.set_num_threads(1)

T0 = datetime(2026, 1, 1, tzinfo=timezone.utc)
HTTP_DATE = "Thu, 01 Jan 2026 00:00:00 GMT"
QUIET = {"log": lambda *a: None}


def run(coro):
    return asyncio.new_event_loop().run_until_complete(coro)


def _table(db, specs, name) -> dict:
    spec = next(s for s in specs if s.name == name)
    return {k: spec.encode(v) for k, v in db.tables[name].items()}


def assert_same_store(tdb, jdb, skip=(), rank_rtol=1e-5) -> None:
    """Every table of the two stores equal (doc_rank within rank_rtol), and
    the cached pages too."""
    names = [s.name for s in TABLE_SPECS]
    assert names == [s.name for s in JSPECS] and len(names) == 12
    for name in names:
        if name in skip:
            continue
        got, want = _table(tdb, TABLE_SPECS, name), _table(jdb, JSPECS, name)
        assert got.keys() == want.keys(), name
        if name == "doc_rank":
            for k in want:
                assert got[k].keys() == want[k].keys()
                for c in want[k]:
                    assert got[k][c] == pytest.approx(want[k][c], rel=rank_rtol, abs=0), (k, c)
        else:
            for k in want:
                assert got[k] == want[k], (name, k)
    for h in _table(jdb, JSPECS, "doc_info"):
        assert tdb.cached_doc(h) == jdb.cached_doc(h)


def _both(fn_t, fn_j):
    tdb, jdb = Database(None), JaxDatabase(None)
    fn_t(tdb)
    fn_j(jdb)
    return tdb, jdb


# --- the indexer -------------------------------------------------------------

LAB = test_crawl.BASE.replace("site", "lab")
PAGE = b"""<html><head><title>Quantum Research Lab</title></head>
<body><p>quantum computing research quantum hardware</p>
<a href="/students">bright students</a>
</body></html>"""


def _lab_sequence(index_page):
    """The re-indexing steps of tests/test_indexer.py on one store."""
    t2 = T0 + timedelta(days=31)

    def steps(db):
        index_page(db, PAGE, LAB + "/index", last_modified=T0, parent_url=LAB + "/root")
        index_page(db, b"<html><title>changed</title></html>", LAB + "/index", last_modified=T0)
        index_page(db, b"<html><head><title>student portal</title></head><body>x</body></html>",
                   LAB + "/students", last_modified=T0)
        index_page(db, PAGE.replace(b"quantum hardware", b"quantum devices"), LAB + "/index",
                   last_modified=t2)
        v1 = (b'<html><head><title>stable title</title><meta name="description" '
              b'content="ephemeral keyword"></head><body><p>body words</p></body></html>')
        index_page(db, v1, LAB + "/meta", last_modified=T0)
        index_page(db, v1.replace(b"ephemeral keyword", b"replacement"), LAB + "/meta",
                   last_modified=t2)
        index_page(db, b"<html><head><title>Fusion Lab</title></head><body><p>fusion energy "
                   b"research</p></body></html>", LAB + "/index", last_modified=t2 + timedelta(1))
    return steps


def _mutation_sequence(index_page, seed: int):
    """tests/test_indexer.py's randomized re-index: a crawled corpus, then
    six pages changed (three of them with new <meta> terms) re-indexed."""
    def steps(db):
        rng = random.Random(seed)
        n, base = 18, "http://mut.local"
        pages = dict(make_page(rng, i, n, base) for i in range(n))
        with db.bulk():
            for url, html in pages.items():
                index_page(db, html, url, last_modified=T0)
            rng2 = random.Random(seed + 1)
            for k, url in enumerate(rng.sample(sorted(pages), 6)):
                _, html = make_page(rng2, int(url.rsplit("page", 1)[1]), n, base)
                if k < 3:
                    html = html.replace(b"</title>", b'</title><meta name="description" '
                                        b'content="zanzibar melody">', 1)
                index_page(db, html, url, last_modified=T0 + timedelta(days=1))
    return steps


def test_indexer_reindex_sequence():
    assert_same_store(*_both(_lab_sequence(tindex), _lab_sequence(jindex)))


@pytest.mark.parametrize("seed", [99, 5])
def test_indexer_mutation_sequence(seed):
    assert_same_store(*_both(_mutation_sequence(tindex, seed), _mutation_sequence(jindex, seed)))


def test_indexer_bench_pages():
    """bench.py's pages through both indexers (the bulk fast path), plus
    PageRank and term weighting; the link graph and summaries also equal
    the corpus writer's (which runs the same indexer)."""
    pages = render_pages(n_pages=120, n_vocab=900, seed=2)

    def build(index_page, pagerank, weights, **kw):
        def steps(db):
            db.topic_meta.set("General", {"numPages": 120.0, "wordCount": 1.0})
            with db.bulk():
                for path, html in pages.items():
                    index_page(db, html, "http://bench.local" + path, last_modified=T0)
            pagerank(db, **kw)
            weights(db, "title")
            weights(db, "body")
        return steps

    tdb, jdb = _both(build(tindex, tpagerank, tweights, device="cpu"),
                     build(jindex, jpagerank, jweights))
    assert_same_store(tdb, jdb)
    from spaghettisearch_tpu_torch.corpus import write_corpus

    ref = write_corpus(None, n_pages=120, n_vocab=900, seed=2, device="cpu")
    for name in ("doc_children", "doc_summary"):
        assert _table(tdb, TABLE_SPECS, name) == _table(ref, TABLE_SPECS, name), name


def test_render_pages_rebuild_bench_corpus(tmp_path):
    """bench.py's own corpus build (its HTML through the JAX indexer, the
    JAX PageRank and weighting) equals the port's indexer, PageRank and
    weighting over `corpus.render_pages`: every table, and the cached HTML
    byte for byte."""
    import bench

    root = bench.build_bench_corpus(str(tmp_path / "bench"), n_pages=150, n_vocab=900, seed=2,
                                    quiet=True)
    jdb = JaxDatabase(str(tmp_path / "bench" / "store"))
    tdb = Database(None)
    tdb.topic_meta.set("General", {"numPages": 150.0, "wordCount": 1.0})
    tdb.topic_meta.set("Science", {"numPages": 75.0, "wordCount": 1.0})
    with tdb.bulk():
        for path, html in render_pages(n_pages=150, n_vocab=900, seed=2).items():
            tindex(tdb, html, "http://bench.local" + path, last_modified=T0)
    tpagerank(tdb, device="cpu")
    tweights(tdb, "title")
    tweights(tdb, "body")
    assert root and len(tdb.doc_info) >= 150
    # magnitudes sum a doc's weights in the order the store yields rows,
    # which differs between bench.py's on-disk store and this one: 1 ulp
    assert_same_store(tdb, jdb, skip=("doc_magnitude",))
    got, want = _table(tdb, TABLE_SPECS, "doc_magnitude"), _table(jdb, JSPECS, "doc_magnitude")
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12, abs=0), k
    jdb.close()


def test_write_corpus_equals_bench_corpus(tmp_path):
    """corpus.write_corpus, the smoke's corpus, writes what bench.py's own
    build writes at 300 pages: every table, the anchor postings in titles
    (the -100 sentinel) and the anchor words in bodies included."""
    import bench
    from spaghettisearch_tpu_torch.corpus import write_corpus

    bench.build_bench_corpus(str(tmp_path / "bench"), n_pages=300, seed=0, quiet=True)
    jdb = JaxDatabase(str(tmp_path / "bench" / "store"))
    tdb = write_corpus(None, n_pages=300, seed=0, device="cpu")
    assert len(tdb.doc_info) >= 300
    assert_same_store(tdb, jdb, skip=("doc_magnitude",))
    got, want = _table(tdb, TABLE_SPECS, "doc_magnitude"), _table(jdb, JSPECS, "doc_magnitude")
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12, abs=0), k
    anchors = sum(-100.0 in v[1:] for _, row in tdb.inv_title.items() for v in row.values())
    assert anchors > 100
    jdb.close()


# --- crawl + ODP through DictFetcher -------------------------------------------

def _crawl_both(pages, start, **kw):
    def t(db):
        run(tcrawl(db, start, fetcher=DictFetcher(pages, T0), **kw, **QUIET))

    def j(db):
        run(jcrawl(db, start, fetcher=JaxDictFetcher(pages, T0), **kw, **QUIET))

    return _both(t, j)


def _error_site():
    pages = test_crawl.make_site()
    base = test_crawl.BASE
    pages[base + "/b"] = pages[base + "/b"].replace(b"</body>", b'<a href="/c">gamma</a></body>')
    del pages[base + "/a"]
    return pages


@pytest.mark.parametrize("site,kw", [
    ("fixture", {"num_pages": 10, "domain_only": True}),
    ("fixture", {"num_pages": 2, "domain_only": True}),
    ("fixture", {"num_pages": 10, "domain_only": False}),
    ("errors", {"num_pages": 3, "domain_only": True}),
])
def test_crawl_matches_jax(site, kw):
    pages = test_crawl.make_site() if site == "fixture" else _error_site()
    tdb, jdb = _crawl_both(pages, test_crawl.BASE, **kw)
    assert_same_store(tdb, jdb)


def _corpus_site(n: int, seed: int) -> dict[str, bytes]:
    """tests/corpus.py's pages, plus a home page that links the first 20."""
    rng = random.Random(seed)
    site = dict(make_page(rng, i, n, "http://test.local") for i in range(n))
    links = "".join(f'<a href="/page{i}">page {i}</a>' for i in range(20))
    site["http://test.local"] = f"<html><body><h1>Home</h1>{links}</body></html>".encode()
    return site


QUERIES = ["algorithm database", '"quantum physics"', "poetry galaxy", 'ranking "matrix tensor"',
           "history culture music", "kernel memory bandwidth latency", "nonexistentzz"]


@pytest.fixture(scope="module")
def crawled_200():
    """A 200-page tests/corpus site crawled by both packages, then ODP-less
    topics, PageRank and term weighting as the crawl CLI runs them."""
    pages = _corpus_site(200, seed=4)

    def finish(db, pagerank, weights, **kw):
        db.topic_meta.set("Science", {"numPages": 200.0, "wordCount": 10.0})
        db.topic_meta.set("Arts", {"numPages": 400.0, "wordCount": 10.0})
        pagerank(db, **kw)
        weights(db, "title")
        weights(db, "body")

    tdb, jdb = _crawl_both(pages, "http://test.local", num_pages=201)
    finish(tdb, tpagerank, tweights, device="cpu")
    finish(jdb, jpagerank, jweights)
    return tdb, jdb


def test_crawl_200_pages_tables(crawled_200):
    tdb, jdb = crawled_200
    assert len(tdb.doc_rank) > 150
    assert_same_store(tdb, jdb)


def _ranked(eng, parse, queries):
    parsed = [parse(q) for q in queries]
    s, i = eng.rank(parsed)
    return [[(int(d), float(x)) for x, d in zip(s[r], i[r]) if np.isfinite(x)] for r in range(len(queries))]


def test_crawl_200_pages_engines_top50(crawled_200):
    tdb, jdb = crawled_200
    got = _ranked(QueryEngine(tdb, device="cpu"), parse_query, QUERIES)
    want = _ranked(JaxEngine(jdb), jax_parse, QUERIES)
    for q, g, w in zip(QUERIES, got, want):
        assert len(g) == len(w), q
        ref = dict(w)
        for (dg, sg), (dw, sw) in zip(g, w):
            assert sg == pytest.approx(sw, rel=1e-6), q
            if dg != dw:  # ties at equal scores aside
                assert ref.get(dg, w[-1][1]) == pytest.approx(sw, rel=1e-6), q


def test_parse_odp_matches_jax():
    def t(db):
        run(todp.parse_odp(db, DictFetcher(test_crawl.make_odp_site()), seed_url=test_crawl.ODP,
                           **QUIET))

    def j(db):
        run(jodp.parse_odp(db, JaxDictFetcher(test_crawl.make_odp_site()),
                           seed_url=test_crawl.ODP, **QUIET))

    tdb, jdb = _both(t, j)
    assert len(tdb.topic_meta) == 2 and len(tdb.inv_topic) > 0
    assert_same_store(tdb, jdb)


ODP_PAGES = [
    # nested triples, li without links, several links in one li
    b"""<html><body><div id="triple"><ul><li>none</li><li><a href="/A">A</a><a href="/A2">A2</a>
    </li><li><div id="triple"><ul><li><a href="B">B</a></li></ul></div></li></ul></div>
    <ul id="triple"><li><span><a href="http://x.example/C">C</a></span></li></ul></body></html>""",
    # class substrings, links outside the container, a missing href
    b"""<html><body><div class="xcontainerx main"><ul id="triple"><li><a href="/T/sub">s</a>
    <a>no href</a><a href="/T/sub2">s2</a><a href="/other">o</a></li></ul>
    <ul><li class="listings big"><h4><a href="http://r.example/1">r1</a></h4><h4>
    <b><a href="/r2">r2</a></b></h4></li><li class="listing"><h4><a href="/no">n</a></h4></li>
    </ul></div><ul id="triple"><li><a href="/T/out">out</a></li></ul></body></html>""",
    # a fragment, no body element in the source
    b"""<div class="container"><ul id="triple"><li><a href="/T/frag">f</a></li></ul>
    <ul><li class="listings"><h4><a href="/res">res</a></h4></li></ul></div>""",
]


@pytest.mark.parametrize("i", range(len(ODP_PAGES)))
def test_odp_extractors_match_jax(i):
    body, url = ODP_PAGES[i], "http://odp.local/T"
    assert todp.extract_top_categories(body, url) == jodp.extract_top_categories(body, url)
    assert todp.extract_subcategories(body, url, "/T") == jodp.extract_subcategories(body, url, "/T")
    assert todp.extract_resources(body, url) == jodp.extract_resources(body, url)
    assert todp.extract_top_categories(body, url) or todp.extract_resources(body, url)


# --- the fetcher against a local http.server ----------------------------------

def test_urllib_fetcher_statuses_and_headers():
    page = b"<html><body>hello</body></html>"
    site = LocalSite({"/ok": page, "/target": b"<p>moved</p>"}, last_modified=HTTP_DATE,
                     redirects={"/old": "/target"}, statuses={"/boom": 500})

    async def fetch_all(base):
        async with UrllibFetcher(timeout_s=5) as fetcher:
            ok = await fetcher(base + "/ok")
            moved = await fetcher(base + "/old")
            errors = []
            for path in ("/missing", "/boom"):
                try:
                    await fetcher(base + path)
                except urllib.error.HTTPError as e:
                    errors.append(e.code)
            return ok, moved, errors

    with site:
        ok, moved, errors = run(fetch_all(site.base))
    assert ok.body == page and ok.content_length == len(page) and ok.url.endswith("/ok")
    assert ok.last_modified == T0
    assert moved.body == b"<p>moved</p>" and moved.url.endswith("/old")
    assert errors == [404, 500]
    assert site.requests == 5  # the redirect costs one more


def test_urllib_fetcher_gzip_and_missing_headers():
    from spaghettisearch_tpu_torch.crawl.fetch import _decompress

    body = b"<p>zipped</p>" * 20
    assert _decompress(gzip.compress(body), "gzip") == body
    assert _decompress(body, None) == body
    with LocalSite({"/x": body}) as site:  # no Last-Modified: now
        before = datetime.now(timezone.utc)

        async def go():
            async with UrllibFetcher() as fetcher:
                return await fetcher(site.base + "/x")

        got = run(go())
    assert got.body == body and got.last_modified >= before


def test_crawl_over_http_fetches_every_page():
    """The default fetcher (UrllibFetcher) crawls a local site: every page
    fetched once, no errors, body rows equal a DictFetcher crawl's (body
    rows do not depend on the order pages finish)."""
    pages = render_pages(n_pages=60, n_vocab=800, seed=5)
    with LocalSite(pages, last_modified=HTTP_DATE) as site:
        tdb = Database(None)
        stats = run(tcrawl(tdb, site.base + "/p0", num_pages=60, **QUIET))
        served = site.requests
        dict_pages = {site.base + p: b for p, b in pages.items()}
    ref = Database(None)
    ref_stats = run(tcrawl(ref, site.base + "/p0", num_pages=60,
                           fetcher=DictFetcher(dict_pages, T0), **QUIET))
    assert stats.errors == 0 and stats.indexed == ref_stats.indexed == served
    for name in ("inv_body", "inv_body_raw", "doc_children", "doc_summary", "word"):
        assert _table(tdb, TABLE_SPECS, name) == _table(ref, TABLE_SPECS, name), name


# --- the crawl CLI end to end --------------------------------------------------

def _odp_sites(resource_base: str, n_cat: int = 4) -> dict[str, bytes]:
    """A directory site shaped like tests/test_crawl.py's: a seed page of
    categories, each with a subcategory and listings that point at pages of
    the crawled site (resource_base)."""
    cats = [f"Cat{c}" for c in range(n_cat)]
    seed = "".join(f'<li><a href="/{c}">{c}</a></li>' for c in cats)
    site = {"/": f'<html><body><div class="container"><ul id="triple">{seed}</ul></div>'
                 f"</body></html>".encode()}
    for k, c in enumerate(cats):
        res = "".join(f'<li class="listings"><h4><a href="{resource_base}/p{j}">r</a></h4></li>'
                      for j in range(k, 40, n_cat + 1))
        site[f"/{c}"] = (f'<html><body><div class="container"><ul id="triple"><li>'
                         f'<a href="/{c}/Sub">Sub</a></li></ul><ul>{res}</ul></div></body>'
                         f"</html>").encode()
        site[f"/{c}/Sub"] = (f'<html><body><div class="container"><ul><li class="listings">'
                             f'<h4><a href="{resource_base}/p{k + 40}">r</a></h4></li></ul>'
                             f"</div></body></html>").encode()
    return site


@pytest.mark.parametrize("topic", [False, True])
def test_crawl_cli_end_to_end(tmp_path, topic):
    """`python -m spaghettisearch_tpu_torch.cli.crawl --device cpu` over a
    local site and a local ODP directory: the store equals the JAX
    package's crawl + ODP scrape + PageRank + weighting of the same pages
    (through DictFetcher) in every order-independent table, and the saved
    snapshot serves."""
    pages = render_pages(n_pages=80, n_vocab=900, seed=7)
    with LocalSite(pages, last_modified=HTTP_DATE) as site:
        with LocalSite(_odp_sites(site.base)) as odp:
            argv = ["--startURL", site.base + "/p0", "--numPages", "80", "--db",
                    str(tmp_path / "db"), "--odpURL", odp.base + "/", "--device", "cpu",
                    "--saveSnapshot", str(tmp_path / "snap")]
            crawl_cli.main(argv + (["--topicPagerank"] if topic else []))
            site_pages = {site.base + p: b for p, b in pages.items()}
            odp_pages = {odp.base + p: b for p, b in odp.pages.items()}
            base = site.base

    jdb = JaxDatabase(None)
    run(jodp.parse_odp(jdb, JaxDictFetcher({**site_pages, **odp_pages}), seed_url=odp.base + "/",
                       **QUIET))
    run(jcrawl(jdb, base + "/p0", num_pages=80, fetcher=JaxDictFetcher(site_pages, T0), **QUIET))
    jpagerank(jdb, personalized=topic)
    jweights(jdb, "title")
    jweights(jdb, "body")
    tdb = Database(str(tmp_path / "db"))
    assert len(tdb.topic_meta) == 4 and len(tdb.doc_rank) > 60
    # the order pages finish fetching decides anchor rows (title section,
    # stub parents) and what depends on them; the rest must be equal
    assert_same_store(tdb, jdb, skip=("inv_title", "inv_title_raw", "doc_info", "doc_magnitude"))
    ti, ji = _table(tdb, TABLE_SPECS, "doc_info"), _table(jdb, JSPECS, "doc_info")
    assert ti.keys() == ji.keys()
    for k in ji:
        for field in ("url", "page_title", "children", "words_mapping"):
            assert ti[k].get(field) == ji[k].get(field), (k, field)
    snap = load_snapshot(str(tmp_path / "snap"))
    eng = QueryEngine(tdb, snapshot=snap, device="cpu", use_topic_model=topic)
    word = next(w for w in (tdb.word.get(h) for h in snap.word_hashes) if w)
    assert eng.query(word)
    tdb.close()
