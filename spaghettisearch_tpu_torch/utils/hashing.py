"""Hash helpers.

Words and URLs are addressed by the hex MD5 of their UTF-8 bytes, matching
the reference key scheme (reference: indexer/indexer.go:38-39, parser/parser.go:30-31)
so that an index built here is row-compatible with one built by the reference.
"""

from __future__ import annotations

import hashlib
from functools import lru_cache


@lru_cache(maxsize=1 << 17)
def _md5_str(s: str) -> str:
    return hashlib.md5(s.encode("utf-8")).hexdigest()


#: str-only fast form for hot loops (indexer postings/anchors): skips the
#: isinstance dispatch below, ~0.6 us per call over millions of calls
md5_str = _md5_str


def md5_hex(s: str | bytes) -> str:
    if isinstance(s, str):
        # words/URLs repeat Zipf-style across pages — measured ~2.4% of the
        # bulk-index profile in hashing alone; bytes inputs (raw page
        # bodies, change detection) are unique blobs and stay uncached
        return _md5_str(s)
    return hashlib.md5(s).hexdigest()
