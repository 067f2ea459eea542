"""Sharded-serving soak at half-million-doc scale (the counterpart of the
repo's experiments/soak_sharded.py): a ShardedQueryEngine over 8 doc shards
served by `cli.server --meshShards 8`, concurrent HTTP queries + wordlist
polling + an append-subprocess -> /refresh loop.

    python -m spaghettisearch_tpu_torch.cli.soak_sharded [--seconds 180]
        [--docs 524288] [--device cuda] [--root /tmp/soak_sharded_db]
        [--port 8799] [--corpus PATH] [--startFile PATH]

The corpus is written straight into the store (synthetic rows, not crawled
HTML): this soak exercises SERVING at scale — snapshot/ShardedIndex
rebuild, scorer reuse across refreshes, hydration at >prewarm scale, the
rank/refresh lock dance — not the indexer (cli.soak covers that end). A
store at --root with a BUILT marker for the same --docs is reused.

--device cuda takes one card per shard; --device cuda:N puts all 8 shards
on card N; --device cpu all on the CPU.

--corpus PATH soaks a built store of this package (e.g. the 100k benchmark
corpus that corpus.write_corpus writes) instead of the synthetic one: the
store is COPIED to --root first (the append + /refresh never dirty PATH),
2,000 synthetic docs are appended before the load starts, and one /refresh
runs under load.

--startFile PATH holds the load back, after the store, the server and the
warm pass are ready, until PATH exists: a caller can set the soak up while
it does other work, and then run the load and the refreshes on their own.

The last line is a JSON object {"counts", "errors", "n_errors", "p50_s",
"p99_s", "docs_final", "segregation"}; "segregation" is the server's
start-up word for phrase-class batch segregation ("active" from 2^19 docs
on a fused index). Any error exits 1. The server's log is
ROOT.server.log.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import threading
import time
import urllib.request

from .soak import REPO, wait_for_server

N_WORDS = 20_000


def build_synth_store(root: str, n_docs: int, start: int = 0,
                      seed: int = 0, db=None) -> None:
    """Write `n_docs` synthetic docs (ids start..start+n_docs) directly into
    the store: Zipf body/title postings, DocInfo, magnitudes, rank rows,
    summaries. Weight = normTF (idf omitted — serving math doesn't require
    weighted rows, and the soak checks behavior, not ranking quality)."""
    from datetime import datetime, timezone

    import numpy as np

    from ..store.docinfo import DocInfo
    from ..store.tables import Database
    from ..utils.hashing import md5_hex

    rng = np.random.default_rng(seed + start)
    own_db = db is None
    if own_db:
        db = Database(root)
    ts = datetime(2026, 1, 1, tzinfo=timezone.utc)

    vocab = [f"w{i:05d}" for i in range(N_WORDS)]
    whash = [md5_hex(w) for w in vocab]
    probs = 1.0 / np.arange(1, N_WORDS + 1) ** 1.05
    probs /= probs.sum()

    k_body, k_title = 10, 2
    body = rng.choice(N_WORDS, size=(n_docs, k_body), p=probs)
    title = rng.choice(N_WORDS, size=(n_docs, k_title), p=probs)
    doc_urls = [f"http://synth.local/d{start + i}" for i in range(n_docs)]
    doc_hash = [md5_hex(u) for u in doc_urls]

    t0 = time.perf_counter()
    with db.bulk():
        if start == 0:
            db.topic_meta.set("General", {"numPages": float(n_docs), "wordCount": 1.0})
            with db.word.batch() as bw:
                for wh, w in zip(whash, vocab):
                    bw.set(wh, w)

        # cap per-word df like a stopword-filtered crawl (synth_snapshot's
        # max_df rationale): an uncapped Zipf head word reaches df ~293k at
        # 512k docs, which makes every phrase-matcher shape (E = 2*max_df)
        # intractable and unrealistic vs real corpora
        max_df = 16_384
        mag_t = np.zeros(n_docs)
        mag_b = np.zeros(n_docs)
        for section, mat, mag in (("title", title, mag_t), ("body", body, mag_b)):
            rows: dict[str, dict] = {}
            full: set[int] = set()
            inv = db.inverted(section)
            for i in range(n_docs):
                terms, counts = np.unique(mat[i], return_counts=True)
                max_f = counts.max()
                dh = doc_hash[i]
                for wid, c in zip(terms, counts):
                    wid = int(wid)
                    w = float(c) / float(max_f)
                    mag[i] += w * w
                    if wid in full:
                        continue
                    row = rows.setdefault(wid, {})
                    if len(row) >= max_df:
                        full.add(wid)
                        continue
                    row[dh] = [w, float(i % 50)]
            with inv.batch() as bw:
                for wid, row in rows.items():
                    old = inv.get(whash[wid])
                    if old:
                        old.update(row)
                        row = old
                    bw.set(whash[wid], row)
        np.sqrt(mag_t, out=mag_t)
        np.sqrt(mag_b, out=mag_b)

        with db.doc_info.batch() as bi, db.doc_magnitude.batch() as bm, \
                db.doc_rank.batch() as br, db.doc_summary.batch() as bs, \
                db.doc_children.batch() as bc:
            for i in range(n_docs):
                dh = doc_hash[i]
                terms, counts = np.unique(body[i], return_counts=True)
                bi.set(dh, DocInfo(
                    url=doc_urls[i],
                    page_title=[vocab[int(t)] for t in title[i]],
                    mod_date=ts,
                    page_size=512,
                    children=[],
                    parents={},
                    words_mapping={
                        whash[int(t)]: int(c) for t, c in zip(terms, counts)
                    },
                ))
                bm.set(dh, {"title": float(mag_t[i]), "body": float(mag_b[i])})
                br.set(dh, {"General": 1.0 / max(n_docs, 1)})
                bs.set(dh, " ".join(vocab[int(t)] for t in body[i]))
                bc.set(dh, [])
    if own_db:
        db.flush()
        db.close()
    print(f"wrote {n_docs} docs (start={start}) in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)


def ensure_synth_store(root: str, n_docs: int) -> None:
    """build_synth_store(root, n_docs) unless `root` already holds that
    build (its BUILT marker names n_docs)."""
    marker = os.path.join(root, "BUILT")
    if os.path.exists(marker) and open(marker).read() == str(n_docs):
        return
    shutil.rmtree(root, ignore_errors=True)
    build_synth_store(root, n_docs)
    with open(marker, "w") as f:
        f.write(str(n_docs))


APPEND_SNIPPET = """
import sys
sys.path.insert(0, {repo!r})
from spaghettisearch_tpu_torch.cli.soak_sharded import build_synth_store
build_synth_store({root!r}, {count}, start={start})
"""


def _post(port: int, path: str, payload: dict, timeout: float):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.load(resp)


def server_segregation(log_path: str) -> str | None:
    """"active" or "inactive", as the server's start-up line says."""
    from .server import SEGREGATION_LINE

    with open(log_path, errors="replace") as f:
        for line in f:
            if line.startswith(SEGREGATION_LINE):
                return line[len(SEGREGATION_LINE):].split()[0]
    return None


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seconds", type=float, default=180.0)
    ap.add_argument("--docs", type=int, default=524_288)
    ap.add_argument("--device", default="cuda",
                    help="the server's --device: cuda (one card per shard), cuda:N "
                         "(every shard on card N) or cpu")
    ap.add_argument("--root", default="/tmp/soak_sharded_db", help="the served store")
    ap.add_argument("--port", type=int, default=8799)
    ap.add_argument("--corpus", default=None,
                    help="soak a copy of this built store instead of the synthetic one")
    ap.add_argument("--startFile", default=None,
                    help="after the warm pass, wait until this file exists before the load")
    args = ap.parse_args(argv)
    root, port, n_docs = os.path.abspath(args.root), args.port, args.docs

    if args.corpus:
        shutil.rmtree(root, ignore_errors=True)
        t0 = time.perf_counter()
        shutil.copytree(args.corpus, root)
        print(f"store copied in {time.perf_counter() - t0:.0f}s", flush=True)
        from ..store.tables import Database

        db = Database(root)
        n_docs = len(db.doc_info)  # appended ids start past the corpus's
        db.close()
    else:
        ensure_synth_store(root, n_docs)
    print("fixture store ready", flush=True)

    log_path = root + ".server.log"
    log = open(log_path, "wb")
    cmd = [sys.executable, "-m", "spaghettisearch_tpu_torch.cli.server",
           "--db", root, "--port", str(port), "--device", args.device,
           "--meshShards", "8", "--noWarmup", "--resultTimeoutS", "1500"]
    proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, cwd=REPO)
    lat: list[float] = []
    try:
        wait_for_server(proc, log_path, 3000, 5)
        print("server up", flush=True)
        segregation = server_segregation(log_path)

        errors: list[str] = []
        counts = {"queries": 0, "wordlists": 0, "refreshes": 0}
        stop = threading.Event()
        terms = ["w00001", "w00040 w00100", "w00002 w01000 w12345",
                 '"w00003 w00007"', "w19999", "nonexistentzz",
                 '"w00005" w00050']
        if args.corpus:
            # the benchmark vocabulary drops the Zipf head (<w00040 have df
            # 0): keep a couple of zero-hit probes, weight the live terms
            terms = ["w00040", "w00100 w00055", '"w00041 w00077"',
                     "w12345 w00300", "w19999", "nonexistentzz",
                     '"w00050" w00060', "w00042 w00043 w00044 w00045"]

        def qworker(i: int) -> None:
            import random as _r

            r = _r.Random(i)
            while not stop.is_set():
                q = r.choice(terms)
                try:
                    t0 = time.monotonic()
                    _post(port, "/query", {"query": q}, 1800)
                    lat.append(time.monotonic() - t0)
                    counts["queries"] += 1
                except Exception as e:  # noqa: BLE001
                    errors.append(f"query {q!r}: {type(e).__name__}: {e}")

        def wworker() -> None:
            while not stop.is_set():
                try:
                    with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/wordlist/w0001", timeout=1800
                    ) as resp:
                        json.load(resp)
                    counts["wordlists"] += 1
                except Exception as e:  # noqa: BLE001
                    errors.append(f"wordlist: {type(e).__name__}: {e}")
                stop.wait(5.0)

        # a sequential pass before the concurrent load (the server runs
        # --noWarmup: each shape's first batch builds its kernels and
        # buffers with nothing else in flight), then a /query_batch pass
        # for the combined keyword+phrase batch shapes
        for q in terms:
            try:
                _post(port, "/query", {"query": q}, 1800)
                print(f"warm {q!r} ok", flush=True)
            except Exception as e:  # noqa: BLE001
                errors.append(f"warm {q!r}: {type(e).__name__}: {e}")
        try:
            _post(port, "/query_batch", {"queries": terms}, 1800)
            print("warm batch ok", flush=True)
        except Exception as e:  # noqa: BLE001
            errors.append(f"warm batch: {type(e).__name__}: {e}")
        print("shape-warm pass done", flush=True)
        if args.startFile:
            print(f"waiting for {args.startFile}", flush=True)
            t_wait = time.monotonic()
            while not os.path.exists(args.startFile):
                time.sleep(0.2)
            print(f"load starts after {time.monotonic() - t_wait:.1f}s of waiting", flush=True)

        def append(count: int, start: int, timeout: float) -> bool:
            code = APPEND_SNIPPET.format(repo=REPO, root=root, count=count, start=start)
            try:
                out = subprocess.run(
                    [sys.executable, "-c", code], capture_output=True,
                    text=True, timeout=timeout, cwd=REPO,
                )
            except subprocess.TimeoutExpired:
                errors.append("append timed out")
                return False
            if out.returncode != 0:
                errors.append("append failed: " + out.stderr[-500:])
                return False
            return True

        base = n_docs
        if args.corpus:
            # append BEFORE the load starts: the discipline under test is
            # the refresh under load, not the append under load
            if append(2000, base, 3600):
                base += 2000
                print("append done (pre-load)", flush=True)

        threads = [threading.Thread(target=qworker, args=(i,)) for i in range(6)]
        threads.append(threading.Thread(target=wworker))
        for t in threads:
            t.start()

        t_end = time.monotonic() + args.seconds

        def one_refresh() -> bool:
            try:
                r = _post(port, "/refresh", {}, 9000 if args.corpus else 2500)
                assert r.get("ok"), r
                counts["refreshes"] += 1
                print(f"refresh #{counts['refreshes']}: docs={r['docs']} "
                      f"seconds={r['seconds']} lock={r['lock_seconds']}s "
                      f"queries={counts['queries']}", flush=True)
                return True
            except Exception as e:  # noqa: BLE001
                errors.append(f"refresh: {type(e).__name__}: {e}")
                return False

        if args.corpus:
            # one refresh under load over the appended store; the query
            # threads hammer the server through the whole rebuild window
            one_refresh()
            while time.monotonic() < t_end:
                time.sleep(1.0)
        else:
            while time.monotonic() < t_end:
                if not append(2000, base, 900):
                    break
                base += 2000
                if not one_refresh():
                    break

        stop.set()
        for t in threads:
            t.join(timeout=1850)
        lat.sort()
        p50 = lat[len(lat) // 2] if lat else None
        p99 = lat[int(len(lat) * 0.99)] if lat else None
        print(json.dumps({
            "counts": counts, "errors": errors[:10], "n_errors": len(errors),
            "p50_s": round(p50, 3) if p50 else None,
            "p99_s": round(p99, 3) if p99 else None,
            "docs_final": base,
            "segregation": segregation,
        }), flush=True)
        if errors:
            sys.exit(1)
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=15)
        except Exception:  # noqa: BLE001
            proc.kill()
        log.close()


if __name__ == "__main__":
    main()
