"""Engine-wide constants.

These mirror the compile-time constants of the reference implementation so
that ranking output is comparable (reference file:line cited per constant).
"""

from __future__ import annotations

import dataclasses

# Score blend: FinalRank = (W_PAGERANK*sqd + W_TITLE*title + W_BODY*body) * 100
# (reference: retrieval/get_metadata.go:69)
W_PAGERANK = 0.33
W_TITLE = 0.38
W_BODY = 0.29
SCORE_SCALE = 100.0

# Result cut after ranking (reference: retrieval/main_retrieve.go:99-103)
MAX_RESULTS = 50

# PageRank defaults (reference: cmd/crawl/start_crawl.go:175)
PAGERANK_DAMPING = 0.75
PAGERANK_CONVERGENCE = 1e-20

# Sentinel position used for meta/anchor-text terms
# (reference: parser/parser.go:203, indexer/indexer.go:190)
META_POSITION = -100.0

# Crawler defaults (reference: cmd/crawl/start_crawl.go:26-28,53,37-44)
CRAWL_DEFAULT_PAGES = 500
CRAWL_DEFAULT_START = "https://www.cse.ust.hk"
CRAWL_DEFAULT_DOMAIN_ONLY = True
CRAWL_MAX_CONCURRENCY = 500
CRAWL_TIMEOUT_S = 15.0

# Top-N metadata hydration in results (reference: retrieval/util.go:56-149)
MAX_LINKED_DOCS = 5
MAX_KEYWORDS = 5

# Media extensions the link extractor skips (reference: crawler/crawler.go:45-49)
MEDIA_EXTENSIONS = (
    ".mp3", ".pdf", ".png", ".jpg", ".mp4", ".avi",
    ".zip", ".pptx", ".ppt", ".rar", ".doc", ".docx",
    ".tar", ".gz", ".xz", ".bz", ".7z",
)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Tunables of the device-side query engine (no reference analogue:
    the Go engine is row-at-a-time so it has no batching/padding knobs)."""

    # Max query terms scored per query row (keyword terms); longer queries
    # are scored in several passes.
    max_query_terms: int = 8
    # Max phrase terms per phrase.
    max_phrase_terms: int = 8
    # Default query batch rows per device program invocation.
    batch_size: int = 64
    # Results kept per query on device before host hydration.
    topk: int = MAX_RESULTS
