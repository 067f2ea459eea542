"""Full page parse: tokenize -> clean -> per-section term statistics.

Equivalent of the reference's parser.Parse (reference: parser/parser.go:22-47):
produces title/body/anchor term stats plus the raw title and outgoing links.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..utils.hashing import md5_hex
from .htmlparse import TokenizedPage, tokenize_page
from .laundry import laundry, term_stats


@dataclass
class SectionStats:
    freq: dict[str, int] = field(default_factory=dict)
    pos: dict[str, list[float]] = field(default_factory=dict)

    @property
    def max_freq(self) -> int:
        return max(self.freq.values(), default=0)


@dataclass
class ParsedPage:
    #: raw (untokenized) <title> text; DocInfo stores its whitespace fields
    #: (reference: indexer/indexer.go:82)
    title_text: str
    title: SectionStats
    body: SectionStats
    #: child urlHash -> anchor-text term stats
    fancy: dict[str, SectionStats]
    #: child urlHash -> cleaned anchor tokens (order preserved, with repeats)
    clean_fancy: dict[str, list[str]]
    #: ordered unique outgoing links (cleaned URLs)
    links: list[str]
    raw: TokenizedPage


def parse_page(doc: bytes | str, base_url: str) -> ParsedPage:
    # with_summary: the indexer persists the summary-visible words so the
    # serving path never re-parses HTML (one lxml parse total per page)
    tp = tokenize_page(doc, base_url, with_summary=True)
    clean_title = laundry(tp.title)
    clean_body = laundry(" ".join(tp.words))
    clean_meta = laundry(" ".join(tp.meta))

    clean_fancy: dict[str, list[str]] = {}
    for target_url, text in tp.fancy:
        clean_fancy.setdefault(md5_hex(target_url), []).extend(laundry(text))

    t_freq, t_pos = term_stats(clean_title, clean_meta)
    b_freq, b_pos = term_stats(clean_body)
    fancy = {}
    for url_hash, tokens in clean_fancy.items():
        f_freq, f_pos = term_stats(tokens)
        fancy[url_hash] = SectionStats(f_freq, f_pos)

    return ParsedPage(
        title_text=tp.title,
        title=SectionStats(t_freq, t_pos),
        body=SectionStats(b_freq, b_pos),
        fancy=fancy,
        clean_fancy=clean_fancy,
        links=tp.links,
        raw=tp,
    )
