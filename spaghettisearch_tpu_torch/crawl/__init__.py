from .frontier import CrawlStats, crawl  # noqa: F401
