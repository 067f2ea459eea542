"""Tiny cells for the CPU tests: the cells' own files, cut in scale."""

from __future__ import annotations

from benchmark import run

CELLS = ("lucene-mixed", "nq-questions")


def tiny_cell(name: str, n_docs: int = 2500, vocab: int = 20000, body_words: int | None = 60):
    """A cell as run.load_cell reads it, with the shard cut to n_docs over a
    smaller vocabulary and one warm-up block. Shorter bodies keep the top
    word out of some docs, so idf > 0 everywhere and the port keeps its hot
    split, as at full size."""
    cell = run.load_cell(name)
    cell["warm_blocks"] = 1
    cfg = cell["config_data"]
    cfg.update(n_docs=n_docs, vocab_size=vocab)
    if body_words is not None:
        cfg["body_words"] = body_words
    return cell
