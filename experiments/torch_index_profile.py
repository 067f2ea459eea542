#!/usr/bin/env python3
"""index_profile.py on the PyTorch port: the per-page cost of the benchmark
corpus's build (bench.build_bench_corpus -> corpus.write_corpus: every page
through index/indexer.py index_page inside one bulk session), split by
stage:

  render_tokenize  text/page.py's tokenize_page (the port's DOM, text/dom.py,
                   and text/htmlparse.py's walk);
  laundry          text/laundry.py laundry (stopwords, stemming) of the title,
                   body, meta and anchor texts;
  term_stats       per-section frequencies and positions;
  postings         _set_section_postings (title and body rows);
  anchors          _index_anchors (anchor postings into the title table,
                   child stubs);
  cache_doc        the raw page into the docs pack;
  index_other      the rest of index_page (hashes, DocInfo, the children and
                   summary rows);
  bulk_flush       the bulk session's exit: every cached row into the
                   store's logs (the WAL);
  flush_close      db.flush() + close().

    python3 experiments/torch_index_profile.py [n_pages] [--mem] [--profile]
        [--root DIR] [--device cuda] [--seed 0]

The pages are the benchmark corpus's (corpus.render_pages: its vocabulary
and Zipf draws, corpus.zipf_probs), n_pages of them (default 20,000, the
original's). --mem indexes into an in-memory store, else into --root
(build/index_profile_store by default); --profile adds a cProfile of the run (which
inflates the Python stages). Stage times come from wrappers on those
functions (host clock). Nothing runs on a device: --device names the card
of the host in the result. Prints the original's lines, then one JSON line;
main() returns the same dict.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import shutil
import sys
import time
from datetime import datetime, timezone

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


class StageTimer:
    """Wraps module functions so each call adds its wall time to a stage."""

    def __init__(self) -> None:
        self.s: dict[str, float] = {}
        self._undo: list[tuple[object, str, object]] = []

    def wrap(self, owner, name: str, stage: str) -> None:
        fn = getattr(owner, name)
        self.s.setdefault(stage, 0.0)

        def timed(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                self.s[stage] += time.perf_counter() - t0

        setattr(owner, name, timed)
        self._undo.append((owner, name, fn))

    def restore(self) -> None:
        for owner, name, fn in reversed(self._undo):
            setattr(owner, name, fn)
        self._undo.clear()


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n_pages", type=int, nargs="?", default=20_000)
    ap.add_argument("--mem", action="store_true", help="an in-memory store")
    ap.add_argument("--root", default=os.path.join(REPO, "build", "index_profile_store"),
                    help="the store's directory (emptied first) when not --mem")
    ap.add_argument("--profile", action="store_true", help="cProfile the run")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu, never a fallback")
    ap.add_argument("--seed", type=int, default=0, help="the corpus's seed")
    args = ap.parse_args(argv)

    from spaghettisearch_tpu_torch import bench
    from spaghettisearch_tpu_torch.corpus import BASE_URL, render_pages
    from spaghettisearch_tpu_torch.index import indexer
    from spaghettisearch_tpu_torch.store.tables import Database
    from spaghettisearch_tpu_torch.text import page

    device = bench._check_device(args.device)
    n = args.n_pages
    pages = render_pages(n, 30_000, args.seed)
    root = None if args.mem else args.root
    if root:
        shutil.rmtree(root, ignore_errors=True)
    db = Database(root)
    ts = datetime(2026, 1, 1, tzinfo=timezone.utc)
    timer = StageTimer()
    for owner, name, stage in ((page, "tokenize_page", "render_tokenize"),
                               (page, "laundry", "laundry"), (page, "term_stats", "term_stats"),
                               (indexer, "_set_section_postings", "postings"),
                               (indexer, "_index_anchors", "anchors"),
                               (db, "cache_doc", "cache_doc")):
        timer.wrap(owner, name, stage)
    index_s = 0.0
    prof = None
    if args.profile:
        import cProfile

        prof = cProfile.Profile()
    t0, c0 = time.perf_counter(), time.process_time()
    try:
        if prof is not None:
            prof.enable()
        session = db.bulk()
        session.__enter__()
        try:
            for i in range(n):
                t1 = time.perf_counter()
                indexer.index_page(db, pages[f"/p{i}"], f"{BASE_URL}/p{i}", last_modified=ts)
                index_s += time.perf_counter() - t1
        finally:
            t1 = time.perf_counter()
            session.__exit__(None, None, None)
            bulk_flush_s = time.perf_counter() - t1
        if prof is not None:
            prof.disable()
    finally:
        timer.restore()
    dt, cdt = time.perf_counter() - t0, time.process_time() - c0
    print(f"{n} pages in {dt:.2f}s wall / {cdt:.2f}s cpu = {n / dt:.0f} wall-pages/s, "
          f"{n / cdt:.0f} cpu-pages/s ({'mem' if args.mem else 'disk'})")
    if prof is not None:
        import pstats

        s = io.StringIO()
        pstats.Stats(prof, stream=s).sort_stats("cumulative").print_stats(30)
        print(s.getvalue())
    t1 = time.perf_counter()
    db.flush()
    db.close()
    flush_close_s = time.perf_counter() - t1
    print(f"flush+close {flush_close_s:.2f}s")
    stages = dict(timer.s)
    stages["index_other"] = index_s - sum(stages.values())
    stages["bulk_flush"] = bulk_flush_s
    stages["flush_close"] = flush_close_s
    per_page_ms = {k: 1e3 * v / n for k, v in stages.items()}
    for k, v in per_page_ms.items():
        print(f"  {k}: {v:.4f} ms/page")
    return {"pages": n, "wall_s": dt, "cpu_s": cdt, "wall_pages_per_s": n / dt,
            "cpu_pages_per_s": n / cdt, "store": "mem" if args.mem else "disk",
            "per_page_ms": per_page_ms, "host_cores": os.cpu_count(), **bench.card(device)}


if __name__ == "__main__":
    print(json.dumps(main()), flush=True)
