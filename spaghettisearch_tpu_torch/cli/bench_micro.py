"""Micro-benchmarks (reference: cmd/benchmarks_test.go:24-144).

Covers the same operations the reference benchmarks: md5 hashing, word
get/set against the store, a DocInfo with 200 children, and a comparison of
positional-intersection implementations (the reference compares three Go
set-intersection libraries; here: pure-Python sort-merge, numpy, and the
vectorized device op).

    python -m spaghettisearch_tpu_torch.cli.bench_micro [--db DIR] [--device [cuda|cpu]]

The counterpart of the JAX package's bench_micro: the same rows, timed on
the host clock. --device (bare: cuda) adds the device row:
torch.searchsorted membership on that device, one host read per call.
"""

from __future__ import annotations

import argparse
import time
from datetime import datetime, timezone

import numpy as np

from ..store.docinfo import DocInfo
from ..store.tables import Database
from ..utils.hashing import md5_hex


def bench(name: str, fn, n: int = 10000, unit: str = "op") -> float:
    fn()  # warmup
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = (time.perf_counter() - t0) / n
    print(f"{name:42s} {dt*1e6:10.2f} us/{unit}")
    return dt


def py_intersect(a: list[float], b: list[float]) -> list[float]:
    a, b = sorted(a), sorted(b)
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        if a[i] == b[j]:
            out.append(a[i])
            i += 1
            j += 1
        elif a[i] > b[j]:
            j += 1
        else:
            i += 1
    return out


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--db", default=None, help="store root (default: in-memory)")
    ap.add_argument("--backend", default="auto")
    ap.add_argument("--device", nargs="?", const="cuda", default=None,
                    help="include the device row on this torch device (bare: cuda)")
    args = ap.parse_args(argv)

    db = Database(args.db, backend=args.backend)
    print(f"store backend: {db.backend_kind}")

    # --- md5 (reference BenchmarkMD5) ---
    bench("md5 hex of a word", lambda: md5_hex("supercalifragilistic"))
    bench("md5 hex of a URL", lambda: md5_hex("https://www.cse.ust.hk/admin/about"))

    # --- word get/set (reference BenchmarkGetWord/BenchmarkSetWord) ---
    wh = md5_hex("benchword")
    db.word.set(wh, "benchword")
    bench("word table set", lambda: db.word.set(wh, "benchword"))
    bench("word table get", lambda: db.word.get(wh))

    # --- DocInfo with 200 children and 200 words ---
    info = DocInfo(
        url="https://example.com/big",
        page_title=["Big", "Doc"],
        mod_date=datetime(2026, 1, 1, tzinfo=timezone.utc),
        page_size=12345,
        children=[md5_hex(f"child{i}") for i in range(200)],
        parents={md5_hex("p"): ["anchor"]},
        words_mapping={md5_hex(f"w{i}"): i for i in range(200)},
    )
    dh = md5_hex("https://example.com/big")
    db.doc_info.set(dh, info)
    bench("DocInfo(200 children) set", lambda: db.doc_info.set(dh, info), n=2000)
    bench("DocInfo(200 children) get", lambda: db.doc_info.get(dh), n=2000)

    # --- posting row get/set ---
    row = {md5_hex(f"d{i}"): [0.5, float(i), float(i + 7)] for i in range(100)}
    db.inv_body.set(wh, row)
    bench("posting row (100 docs) set", lambda: db.inv_body.set(wh, row), n=2000)
    bench("posting row (100 docs) get", lambda: db.inv_body.get(wh), n=2000)

    # --- intersection comparison (reference benchmarks 3 Go libraries) ---
    rng = np.random.default_rng(0)
    a = sorted(rng.choice(10000, 500, replace=False).astype(float).tolist())
    b = sorted(rng.choice(10000, 500, replace=False).astype(float).tolist())
    an, bn = np.array(a), np.array(b)
    bench("intersect: python sort-merge (500x500)", lambda: py_intersect(a, b), n=1000)
    bench("intersect: numpy intersect1d", lambda: np.intersect1d(an, bn), n=1000)

    if args.device:
        import torch

        dev = torch.device(args.device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise SystemExit(f"--device {args.device}: CUDA is not available")
        at = torch.as_tensor(an, device=dev)
        bt = torch.as_tensor(bn, device=dev)

        def device_member() -> int:
            idx = torch.searchsorted(bt, at).clamp_(max=bt.shape[0] - 1)
            return int((bt[idx] == at).sum())  # the one host read

        device_member()
        bench("intersect: device searchsorted", device_member, n=200)

    db.close()


if __name__ == "__main__":
    main()
