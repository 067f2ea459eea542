"""Token cleaning pipeline and per-section term statistics.

`laundry` reproduces the reference pipeline exactly (reference:
parser/parser.go:177-193): strip non-alphanumerics -> split on whitespace ->
lowercase -> Porter2 stem -> drop stopwords (checked on the *stemmed* form).

`term_stats` reproduces getWordInfo (reference: parser/parser.go:195-207):
per-term frequency and position lists, with meta terms assigned the sentinel
position -100.
"""

from __future__ import annotations

import re
from functools import lru_cache

from ..config import META_POSITION
from .porter2 import stem
from .stopwords import is_stopword

#: one pass: tokens are exactly the alphanumeric runs — identical to the
#: reference's substitute-non-alnum-then-split (parser.go:177-193), without
#: materializing the substituted copy of the whole text
_ALNUM_RUN = re.compile(r"[a-zA-Z0-9]+")

@lru_cache(maxsize=1 << 17)
def _clean_token(raw: str) -> str | None:
    """lowercase -> Porter2 stem -> stopword gate, one cache entry per raw
    token (None = dropped). Collapses three per-token steps into one dict
    hit on the Zipf-repeated path."""
    s = stem(raw.lower())
    return None if is_stopword(s) else s


def laundry(text: str) -> list[str]:
    """Clean raw text into a list of stemmed, stopword-filtered tokens."""
    clean = _clean_token
    return [c for raw in _ALNUM_RUN.findall(text) if (c := clean(raw)) is not None]


def term_stats(
    words: list[str], meta: list[str] | None = None
) -> tuple[dict[str, int], dict[str, list[float]]]:
    """Frequency and position lists per term.

    Body/title words get their 0-based position; meta words append the
    sentinel META_POSITION and still count toward frequency.
    """
    pos: dict[str, list[float]] = {}
    setdefault = pos.setdefault
    for p, w in enumerate(words):
        setdefault(w, []).append(float(p))
    for w in meta or ():
        setdefault(w, []).append(META_POSITION)
    # freq is derivable: one count per recorded position (meta included),
    # and dict comprehension order matches the old insertion order
    freq = {w: len(ps) for w, ps in pos.items()}
    return freq, pos
