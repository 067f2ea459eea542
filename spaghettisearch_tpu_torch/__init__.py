"""spaghettisearch_tpu_torch — the search engine on PyTorch and CUDA.

A port of `spaghettisearch_tpu` (JAX on a TPU) to an NVIDIA Hopper GPU. The
JAX package stays beside it as the reference: the host-side modules this
package needs (config, store, text cleaning, the indexer, utils, snapshot,
summaries, hydration, micro-batcher, HTTP front end, the crawl frontier)
are copies of the JAX package's, and the device path is rewritten on torch
with hand-written CUDA kernels (`csrc/`) where the JAX package used Pallas,
and tensor ops on the card for PageRank. The package never imports jax,
lxml, aiohttp or anything of the JAX package: HTML is parsed by its own
element tree (`text/dom.py`, the standard library's html.parser with
libxml2's rules) and pages are fetched with urllib (`crawl/fetch.py`).

Layout mirrors the JAX package: `index/`, `ops/` (+ `ops/kernels/`),
`models/`, `retrieval/`, `serve/`, `crawl/`, `cli/` (server, crawl and the
debug CLIs), plus `csrc/` for the CUDA sources and `corpus.py`, a seeded
store writer and page renderer for bench.py's corpus.
"""

__version__ = "0.1.0"
