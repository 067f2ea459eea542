"""Serving soak: concurrent queries + wordlist polling + crawl-subprocess ->
/refresh loop against a disk-backed store (the invariant check after
touching serve/, store/ or refresh paths; the counterpart of the repo's
experiments/soak.py).

    python -m spaghettisearch_tpu_torch.cli.soak [--seconds 150] [--device cuda]
        [--root /tmp/soakdb] [--port 8797]

A 120-page fixture store (corpus.make_page, PageRank on --device, term
weights) is served by `cli.server --device DEVICE` in a subprocess; 12
threads POST /query over nine queries and one polls /wordlist/a every 2 s,
while an append subprocess indexes 10 more pages through index_page and
then POST /refresh swaps them in, in a loop until --seconds have passed.
The last line is a JSON object {"counts", "errors", "n_errors"}; any error
exits 1. The server's log is ROOT.server.log.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import shutil
import subprocess
import sys
import threading
import time
import urllib.request

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

APPEND_SNIPPET = """
import sys, random
sys.path.insert(0, {repo!r})
from datetime import datetime, timezone
from spaghettisearch_tpu_torch.corpus import make_page
from spaghettisearch_tpu_torch.index.indexer import index_page
from spaghettisearch_tpu_torch.store.tables import Database
db = Database({root!r})
rng = random.Random({seed})
ts = datetime(2026, 2, 1, tzinfo=timezone.utc)
base = {base}
for i in range(base, base + 10):
    url, html = make_page(rng, i, 10_000, "http://soak.local")
    index_page(db, html, url, last_modified=ts)
db.flush(); db.close()
print("appended", base)
"""


def build_fixture(root: str, device: str) -> None:
    """The soak's store: 120 make_page pages, PageRank on `device`, term
    weights."""
    from datetime import datetime, timezone

    from ..corpus import make_page
    from ..index.indexer import index_page
    from ..ops.pagerank import update_pagerank
    from ..ops.weighting import update_term_weights
    from ..store.tables import Database

    shutil.rmtree(root, ignore_errors=True)
    rng = random.Random(3)
    db = Database(root)
    db.topic_meta.set("G", {"numPages": 100.0, "wordCount": 1.0})
    ts = datetime(2026, 1, 1, tzinfo=timezone.utc)
    for i in range(120):
        url, html = make_page(rng, i, 10_000, "http://soak.local")
        index_page(db, html, url, last_modified=ts)
    update_pagerank(db, device=device)
    update_term_weights(db, "title")
    update_term_weights(db, "body")
    db.flush()
    db.close()


def wait_for_server(proc: subprocess.Popen, log_path: str, timeout_s: float, poll_s: float) -> None:
    """Until the server's log says it is running; raises if the server dies
    or never comes up."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            raise RuntimeError(f"server died; see {log_path}")
        with open(log_path, "rb") as f:
            if b"Server is running" in f.read():
                return
        time.sleep(poll_s)
    raise RuntimeError("server never came up")


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seconds", type=float, default=150.0)
    ap.add_argument("--device", default="cuda",
                    help="the server's device (cuda, cuda:N, or cpu); PageRank of "
                         "the fixture store runs there too")
    ap.add_argument("--root", default="/tmp/soakdb", help="the store (rebuilt)")
    ap.add_argument("--port", type=int, default=8797)
    args = ap.parse_args(argv)
    root, port = os.path.abspath(args.root), args.port

    build_fixture(root, args.device)
    print("fixture store built", flush=True)

    log_path = root + ".server.log"
    log = open(log_path, "wb")
    cmd = [sys.executable, "-m", "spaghettisearch_tpu_torch.cli.server",
           "--db", root, "--port", str(port), "--device", args.device]
    proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, cwd=REPO)
    try:
        wait_for_server(proc, log_path, 1500, 3)
        print("server up", flush=True)

        errors: list[str] = []
        counts = {"queries": 0, "wordlists": 0, "refreshes": 0}
        stop = threading.Event()
        terms = ["algorithm", "quantum", "matrix", "galaxy poetry",
                 '"document gradient"', "database theater", "nonexistentzz",
                 "music novel physics", '"quantum poetry"']

        def qworker(i: int) -> None:
            r = random.Random(i)
            while not stop.is_set():
                q = r.choice(terms)
                try:
                    req = urllib.request.Request(
                        f"http://127.0.0.1:{port}/query",
                        data=json.dumps({"query": q}).encode(),
                        headers={"Content-Type": "application/json"},
                    )
                    with urllib.request.urlopen(req, timeout=300) as resp:
                        json.load(resp)
                    counts["queries"] += 1
                except Exception as e:  # noqa: BLE001
                    errors.append(f"query {q!r}: {type(e).__name__}: {e}")

        def wworker() -> None:
            while not stop.is_set():
                try:
                    with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/wordlist/a", timeout=300
                    ) as resp:
                        json.load(resp)
                    counts["wordlists"] += 1
                except Exception as e:  # noqa: BLE001
                    errors.append(f"wordlist: {type(e).__name__}: {e}")
                stop.wait(2.0)

        threads = [threading.Thread(target=qworker, args=(i,)) for i in range(12)]
        threads.append(threading.Thread(target=wworker))
        for t in threads:
            t.start()

        t_end = time.monotonic() + args.seconds
        base = 1000
        while time.monotonic() < t_end:
            code = APPEND_SNIPPET.format(repo=REPO, root=root, seed=base, base=base)
            out = subprocess.run(
                [sys.executable, "-c", code], capture_output=True, text=True,
                timeout=600, cwd=REPO,
            )
            if out.returncode != 0:
                errors.append("append failed: " + out.stderr[-500:])
                break
            base += 10
            try:
                req = urllib.request.Request(
                    f"http://127.0.0.1:{port}/refresh", data=b"{}",
                    headers={"Content-Type": "application/json"},
                )
                with urllib.request.urlopen(req, timeout=900) as resp:
                    r = json.load(resp)
                    assert r.get("ok"), r
                counts["refreshes"] += 1
                print(f"refresh #{counts['refreshes']}: docs={r['docs']} "
                      f"seconds={r['seconds']} lock={r['lock_seconds']}s "
                      f"queries={counts['queries']}", flush=True)
            except Exception as e:  # noqa: BLE001
                errors.append(f"refresh: {type(e).__name__}: {e}")

        stop.set()
        for t in threads:
            t.join(timeout=320)
        print(json.dumps({"counts": counts, "errors": errors[:10],
                          "n_errors": len(errors)}), flush=True)
        if errors:
            sys.exit(1)
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=10)
        except Exception:  # noqa: BLE001
            proc.kill()
        log.close()


if __name__ == "__main__":
    main()
