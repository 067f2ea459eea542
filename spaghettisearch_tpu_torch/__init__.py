"""spaghettisearch_tpu_torch — the search engine on PyTorch and CUDA.

A port of `spaghettisearch_tpu` (JAX on a TPU) to an NVIDIA Hopper GPU. The
JAX package stays beside it as the reference: the host-side modules this
package needs (config, store, text cleaning, utils, snapshot, summaries,
hydration, micro-batcher, HTTP front end) are copies of the JAX package's,
and the device path is rewritten on torch with hand-written CUDA kernels
(`csrc/`) where the JAX package used Pallas. The package never imports
jax, lxml (except at call time, for stores without summaries) or anything
of the JAX package.

Layout mirrors the JAX package: `index/`, `ops/` (+ `ops/kernels/`),
`models/`, `retrieval/`, `serve/`, `cli/`, plus `csrc/` for the CUDA
sources and `corpus.py`, a seeded store writer that needs neither lxml
nor jax.
"""

__version__ = "0.1.0"
