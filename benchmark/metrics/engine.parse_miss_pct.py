"""Misses of the parse's token cache (the port's text.laundry
_clean_token, an lru_cache: lowercase, stem and stopword gate per raw
token) over its lookups, in %, over the run's parses (the warm-up's with
the window's; nothing else in the run parses)."""

UNIT = "%"
TRACE = True


def read(run):
    from spaghettisearch_tpu_torch.text.laundry import _clean_token

    info = _clean_token.cache_info()
    lookups = info.hits + info.misses
    return 100.0 * info.misses / lookups if lookups else None
