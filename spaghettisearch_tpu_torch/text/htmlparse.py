"""HTML tokenization and link extraction.

A copy of the JAX package's text/htmlparse.py (host-side analogue of the
reference DOM walk, reference: parser/parser.go:49-158 `tokenize`,
crawler/crawler.go:21-109 `EnqueueChildren`) on this package's own element
tree (`dom.py`) instead of lxml: `dom.fromstring` builds the tree lxml's
`lxml.html.fromstring` builds, so the walks below are the original's line
for line. One pass extracts:

- the page <title> (last one wins, trimmed),
- body words (text nodes whose parent is not title/script/style/noscript/iframe),
- meta description/keywords/author contents,
- anchor ("fancy") texts keyed by resolved+cleaned target URL,
- the ordered set of outgoing links (crawl frontier edges).

URL handling parity notes:
- skip empty/#/javascript/mailto hrefs, strip one trailing '/', skip media
  extensions, resolve relative hrefs against scheme://host or base+'/',
  drop spaces/newlines from the final URL. The reference's cleaning regex
  (crawler/crawler.go:25) is malformed (a '[]' inside the character class) and
  in practice only strips spaces and newlines — we reproduce that effective
  behavior directly.
- Deliberate deviation: the reference's anchor-text capture only fires when
  href is the *first* attribute of <a> (parser/parser.go:78-146 breaks out of
  the attribute loop after one iteration); we accept href anywhere, matching
  the crawler-side extractor (crawler/crawler.go:23-104).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from urllib.parse import urljoin

from . import dom

from ..config import MEDIA_EXTENSIONS

# Effective behavior of the reference's URL-cleaning regex: remove blanks.
_URL_WS = re.compile(r"\r?\n| ")

_SKIP_TEXT_PARENTS = frozenset(("title", "script", "style", "noscript", "iframe"))
_META_NAMES = frozenset(("description", "keywords", "author"))

# Tags whose entire subtree is excluded from summaries
# (reference: retrieval/get_metadata.go:96-115 prunes these elements' children).
_SUMMARY_PRUNE = _SKIP_TEXT_PARENTS | {"a", "nav"}


def clean_url(u: str) -> str:
    return _URL_WS.sub("", u)


from functools import lru_cache


@lru_cache(maxsize=1 << 12)
def _base_authority(base_url: str) -> str:
    """scheme://host[:port] of a base URL (one entry per crawled site)."""
    from urllib.parse import urlsplit

    p = urlsplit(base_url)
    return f"{p.scheme}://{p.netloc}"


@lru_cache(maxsize=1 << 16)
def resolve_href(href: str, base_url: str) -> str | None:
    """Resolve an <a href> into a cleaned absolute-ish URL, or None to skip.
    Cached: pages repeat hrefs (nav bars, footers) and urljoin measured
    ~20% of the tokenizer profile."""
    if not href or href[0] == "#" or href.startswith(("javascript", "mailto")):
        return None
    if href.endswith("/"):
        href = href[:-1]
    if not href:
        return None
    low = href.lower()
    for ext in MEDIA_EXTENSIONS:
        if low.endswith(ext):
            return None
    if len(href) < 4 or (href[:4] != "http" and href[:4] != "www."):
        # deliberate fixes vs the reference: (a) RFC-3986 resolution — the
        # reference appends base+"/"+href (crawler.go:82-83), which mangles
        # any base URL carrying a file segment (http://h/a.html + b.html ->
        # http://h/a.html/b.html); (b) keep the port (crawler.go:78 uses
        # Hostname(), which drops non-default ports and would break any
        # crawl of a :port site)
        if href[0] == "/" and not href.startswith("//") and "./" not in href:
            # root-relative with no dot segments: RFC resolution is just
            # scheme://authority + href — urljoin measured ~70 us per cache
            # miss, ~25% of the tokenizer profile on link-dense pages
            return clean_url(_base_authority(base_url) + href)
        return clean_url(urljoin(base_url, href))
    if href == base_url:
        return None
    return clean_url(href)


@dataclass
class TokenizedPage:
    title: str = ""
    words: list[str] = field(default_factory=list)
    meta: list[str] = field(default_factory=list)
    #: (resolved_url, trimmed_anchor_text) in document order
    fancy: list[tuple[str, str]] = field(default_factory=list)
    #: ordered unique outgoing links (resolved+cleaned)
    links: list[str] = field(default_factory=list)
    #: summary-visible words (a/nav/... subtrees pruned), extracted from the
    #: SAME parsed DOM so index time pays one lxml parse, not two
    summary: list[str] = field(default_factory=list)


def _parse_dom(doc: bytes | str):
    if isinstance(doc, str):
        doc = doc.encode("utf-8", "replace")
    if not doc.strip():
        return None
    try:
        return dom.fromstring(doc)
    except dom.ParserError:
        return None


def tokenize_page(
    doc: bytes | str, base_url: str, with_summary: bool = False
) -> TokenizedPage:
    page = TokenizedPage()
    root = _parse_dom(doc)
    if root is None:
        return page
    if with_summary:
        page.summary = extract_summary_text(None, root=root)
    seen_links: set[str] = set()

    def handle_text(parent, text: str) -> None:
        tag = parent.tag if isinstance(parent.tag, str) else ""
        cleaned = text.strip()
        if tag == "title":
            return
        if tag in _SKIP_TEXT_PARENTS or not cleaned:
            return
        if tag == "a":
            href = parent.get("href")
            if href is not None:
                resolved = resolve_href(href, base_url)
                if resolved:
                    page.fancy.append((resolved, cleaned))
        page.words.append(cleaned)

    def visit(el) -> None:
        if not isinstance(el.tag, str):  # comments / processing instructions
            return  # (tail text is handled by the parent's child loop)
        tag = el.tag
        if tag == "title":
            text = (el.text or "").strip()
            if el.text is not None:
                page.title = text
        elif tag == "meta":
            if el.get("name") in _META_NAMES:
                page.meta.append(el.get("content") or "")
        elif tag == "a":
            href = el.get("href")
            if href is not None:
                resolved = resolve_href(href, base_url)
                if resolved and resolved not in seen_links:
                    seen_links.add(resolved)
                    page.links.append(resolved)
        if el.text:
            handle_text(el, el.text)
        for child in el:
            visit(child)
            if child.tail:
                handle_text(el, child.tail)

    visit(root)
    return page


def extract_summary_text(doc: bytes | str | None, root=None) -> list[str]:
    """Visible words for summaries: prunes a/nav/title/script/... subtrees
    entirely, then splits on whitespace (reference: get_metadata.go:94-119).
    Pass `root` to reuse an already-parsed DOM."""
    if root is None:
        root = _parse_dom(doc)
    if root is None:
        return []
    pieces: list[str] = []

    def visit(el) -> None:
        if not isinstance(el.tag, str):
            return
        if el.tag in _SUMMARY_PRUNE:
            return
        if el.text and el.text.strip():
            pieces.append(el.text.strip())
        for child in el:
            visit(child)
            if child.tail and child.tail.strip():
                # tail text belongs to the parent element, which is not pruned
                pieces.append(child.tail.strip())

    visit(root)
    return " ".join(pieces).split()
