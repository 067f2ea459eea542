"""Standalone query REPL / debug server (reference: cmd/debug_retrieval.go).

The port of the JAX package's cli/debug_retrieval.py. Interactive mode
prints ranked results for typed queries; --serve starts the GET-only query
server on :8080 like the reference's debug binary. --device defaults to
cuda and the CLI refuses to start without CUDA; --device cpu ranks with
the kernels' plain versions, as an explicit choice.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from ..retrieval.engine import QueryEngine
from ..store.tables import Database


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description="Debug retrieval (PyTorch/CUDA)")
    ap.add_argument("--db", default="./db_data")
    ap.add_argument("--serve", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device to rank on: cuda (default), cuda:N, or cpu")
    ap.add_argument("query", nargs="*", help="one-shot query")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"--device {args.device}: CUDA is not available "
            "(pass --device cpu to rank on the CPU explicitly)"
        )

    engine = QueryEngine(Database(args.db), device=device)
    if args.serve:
        from ..serve.server import SearchServer

        SearchServer(engine).serve(port=8080)
        return

    def run(q: str) -> None:
        t0 = time.perf_counter()
        results = engine.query(q)
        dt = 1e3 * (time.perf_counter() - t0)
        print(f"# {len(results)} results in {dt:.1f} ms")
        for r in results:
            print(json.dumps(r)[:500])

    if args.query:
        run(" ".join(args.query))
        return
    while True:
        try:
            q = input("query> ").strip()
        except (EOFError, KeyboardInterrupt):
            break
        if q in ("exit", "quit", r"\q"):
            break
        if q:
            run(q)


if __name__ == "__main__":
    main()
