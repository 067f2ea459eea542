"""ODP (Open Directory) topic scraper for topic-sensitive PageRank.

Equivalent of the reference's colly-based scraper (reference:
crawler/ODP-scraper.go:55-235): scrape the directory's top categories, fan
out per-topic crawls over subcategory pages (same host, path-prefixed) and
listed external resource pages, aggregate per-category term frequencies, and
store:

  topic_meta[category]   = {"numPages": pages visited, "wordCount": #terms}
  inv_topic[wordHash]    = {category: frequency}

The three XPath queries of the JAX package's copy (lxml) are walks of this
package's element tree (`text/dom.py`, `_select`) that select the same
elements in the same order; everything else is the original's.

Parity notes:
- like the reference (ODP-scraper.go:201-208), only *title* terms of external
  resource pages feed the category term vector (its body aggregation is dead
  code);
- deliberate fix: the reference keys invTopic_PR by the raw stemmed word but
  queries it by md5 hash (retrieval/main_retrieve.go:30,120), so its topic
  model could never match; we key by md5 hash so the (optional) topic model
  actually works.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass, field
from urllib.parse import urljoin, urlsplit

from ..store.tables import Database
from ..text import dom
from ..text.page import parse_page
from ..utils.hashing import md5_hex


@dataclass
class TopicData:
    category: str
    values: dict[str, int] = field(default_factory=dict)
    num_pages: int = 0


def _dom(body: bytes):
    try:
        return dom.fromstring(body)
    except Exception:
        return None


def _has(name: str, value: str | None = None, contains: bool = False):
    """An XPath step's test: the element has attribute `name` (equal to,
    or with `contains`, holding `value`)."""
    def test(el) -> bool:
        v = el.get(name)
        if value is None:
            return v is not None
        return (v or "").find(value) >= 0 if contains else v == value
    return test


def _select(root, steps) -> list:
    """XPath `//s1//s2//...//sk` evaluated on root's document (or, with
    root itself as the first step's tag `.`, on root's descendants): the
    elements matching sk below a chain of ancestors matching s1..sk-1, in
    document order, each once. A step is (tag or "*", test or None)."""
    out: list = []
    last = len(steps) - 1

    def visit(el, k: int) -> None:
        tag, test = steps[k]
        if isinstance(el.tag, str) and tag in ("*", el.tag) and (test is None or test(el)):
            if k == last:
                out.append(el)
            else:
                k += 1
        for child in el:
            visit(child, k)

    if steps[0][0] == ".":
        steps = steps[1:]
        last -= 1
        for child in root:
            visit(child, 0)
    else:
        visit(root.getroot(), 0)
    return out


def extract_top_categories(body: bytes, base_url: str) -> list[str]:
    """First link of each <li> under #triple (reference: ODP-scraper.go:64-75)."""
    root = _dom(body)
    if root is None:
        return []
    out = []
    for el in _select(root, [("*", _has("id", "triple")), ("li", None)]):  # //*[@id="triple"]//li
        links = _select(el, [(".", None), ("a", _has("href"))])  # .//a[@href]
        if links:
            out.append(urljoin(base_url, links[0].get("href")))
    return out


def extract_subcategories(body: bytes, page_url: str, topic_path: str) -> list[str]:
    """Same-host subcategory links whose path extends the topic's
    (reference: ODP-scraper.go:169-179)."""
    root = _dom(body)
    if root is None:
        return []
    # netloc, not hostname: keep the port so :port directory sites
    # distinguish their own pages from external resources (same deliberate
    # fix as resolve_href; the reference uses Hostname(), ODP-scraper.go:169)
    host = urlsplit(page_url).netloc
    out = []
    # //body//div[contains(@class,"container")]//ul[@id="triple"]//li//a[@href]
    for a in _select(root, [("body", None), ("div", _has("class", "container", True)),
                            ("ul", _has("id", "triple")), ("li", None), ("a", _has("href"))]):
        link = a.get("href")
        if link and link.startswith(topic_path):
            u = urljoin(page_url, link)
            if urlsplit(u).netloc == host:
                out.append(u)
    return out


def extract_resources(body: bytes, page_url: str) -> list[str]:
    """External resource links from listing entries
    (reference: ODP-scraper.go:182-188)."""
    root = _dom(body)
    if root is None:
        return []
    out = []
    # //body//div[contains(@class,"container")]//ul//li[contains(@class,"listings")]//h4//a[@href]
    for a in _select(root, [("body", None), ("div", _has("class", "container", True)), ("ul", None),
                            ("li", _has("class", "listings", True)), ("h4", None),
                            ("a", _has("href"))]):
        out.append(urljoin(page_url, a.get("href")))
    return out


async def crawl_topic(
    fetcher,
    topic_url: str,
    parallelism: int = 100,
    max_pages: int = 1000,
) -> TopicData:
    parts = urlsplit(topic_url)
    category = parts.path.replace("/", "")
    data = TopicData(category=category)
    host = parts.netloc
    sem = asyncio.Semaphore(parallelism)
    visited: set[str] = set()
    lock = asyncio.Lock()

    async def visit(url: str) -> None:
        async with sem:
            data.num_pages += 1  # counts every request (ODP-scraper.go:212-218)
            try:
                result = await fetcher(url)
            except Exception:
                return
        if urlsplit(url).netloc == host:
            children = []
            if data.num_pages <= max_pages:
                children += extract_subcategories(result.body, url, parts.path)
                children += extract_resources(result.body, url)
            tasks = []
            async with lock:
                for c in children:
                    if c not in visited:
                        visited.add(c)
                        tasks.append(asyncio.create_task(visit(c)))
            for t in tasks:
                await t
        else:
            page = parse_page(result.body, url)
            async with lock:
                for term, freq in page.title.freq.items():
                    data.values[term] = data.values.get(term, 0) + freq

    visited.add(topic_url)
    await visit(topic_url)
    return data


async def parse_odp(
    db: Database,
    fetcher,
    seed_url: str = "http://odp.org/",
    parallelism: int = 100,
    log=print,
) -> list[TopicData]:
    """Scrape all topics and populate topic_meta + inv_topic
    (reference: ODP-scraper.go:55-142)."""
    try:
        seed = await fetcher(seed_url)
    except Exception as e:
        log(f"ODP seed fetch failed ({e}); skipping topic scrape")
        return []
    topics = extract_top_categories(seed.body, seed_url)
    results = await asyncio.gather(
        *(crawl_topic(fetcher, t, parallelism) for t in topics)
    )

    final: dict[str, dict[str, int]] = {}
    with db.topic_meta.batch() as bw:
        for data in results:
            bw.set(
                data.category,
                {"numPages": float(data.num_pages), "wordCount": float(len(data.values))},
            )
            for term, freq in data.values.items():
                final.setdefault(term, {})[data.category] = freq

    with db.inv_topic.batch() as bw:
        for term, cats in final.items():
            bw.set(md5_hex(term), cats)
    return list(results)
