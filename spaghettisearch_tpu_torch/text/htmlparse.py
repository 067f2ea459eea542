"""Summary-text extraction for stores that predate the doc_summary table.

A copy of the JAX package's `extract_summary_text` and the helpers it
calls (text/htmlparse.py); only the import lines differ. lxml, which a GPU
host may not have, is imported where the DOM is parsed, at call time,
never when this module is imported. Every store this package writes (and
every store the JAX indexer writes) carries the doc_summary table, so only
older stores reach this code.
"""

from __future__ import annotations

_SKIP_TEXT_PARENTS = frozenset(("title", "script", "style", "noscript", "iframe"))

# Tags whose entire subtree is excluded from summaries
# (reference: retrieval/get_metadata.go:96-115 prunes these elements' children).
_SUMMARY_PRUNE = _SKIP_TEXT_PARENTS | {"a", "nav"}


def _parse_dom(doc: bytes | str):
    from lxml import etree, html as lxml_html

    if isinstance(doc, str):
        doc = doc.encode("utf-8", "replace")
    if not doc.strip():
        return None
    try:
        return lxml_html.fromstring(doc)
    except etree.ParserError:
        return None


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
