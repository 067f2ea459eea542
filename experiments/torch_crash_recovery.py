#!/usr/bin/env python3
"""crash_recovery.py on the PyTorch port: kill -9 in the middle of a bulk
flush and in the middle of a /refresh, on a copy of the benchmark corpus,
and check what the store and the server recover.

    python3 experiments/torch_crash_recovery.py [--phase a|b|all] [--pages 1000000]
        [--seed 0] [--device cuda] [--work DIR] [--skip-copy] [--killAfterS 20]
        [--checkQueries N]

The corpus is the port's benchmark corpus of --pages pages
(bench.ensure_bench_corpus: reused when built, else built); the phases run
on a copy of its store/ (and snapshot/ for phase B) under --work
(build/crash/corpus{N}k by default).

  phase A: a bulk indexer in a subprocess (the port's make_page pages through
           index_page inside db.bulk(), 50 pages then flush_bulk() + flush()
           per cycle) is SIGKILLed 0.35 s into its third cycle. The store is
           reopened and probed: it holds at least the copy's own doc count
           before the indexer plus 50 per committed flush, every committed
           page is a full doc with its cached page, the last rows decode;
           then one more page is appended and flushed, and a fresh open of
           the store reads back every row and page the writer holds, the
           new page among them (the log tail stays writable: a torn record
           left by the kill must not swallow what is written after it).
  phase B: the port's server (cli.server --db --snapshot --device) comes up
           on the copy and writes its hydration sidecar (hydration.npz);
           50 pages are appended from a subprocess; POST /refresh is fired
           and the server SIGKILLed --killAfterS seconds later
           (killed_mid_refresh: the call had not returned when the kill
           landed). Then the sidecar must be stale (its fingerprint differs
           from retrieval/hydration_sidecar.py store_fingerprint of the
           recovered store, and load_sidecar refuses it), and a decoy
           `hydration.npz.tmp-decoy` that carries the recovered store's
           fingerprint and marked records is planted beside it: a loader
           that took a temporary file would serve the marks. The server is
           restarted and queried (every answer 200 JSON, some results, no
           mark); its sidecar must then carry the recovered store's
           fingerprint (sidecar_rebuilt). With --checkQueries N the
           restarted server also answers the first N queries of
           chip_smoke.py's serving mix from CHECK_CLIENTS threads, and
           after phase B a QueryEngine on --device over the recovered store
           and snapshot ranks them through the kernels (K1 and K2 must
           launch on a card) and through their plain versions: every answer
           must be well-formed and equal both (restart_check).

holds() turns main()'s phases into the soak's pass/fail list (phase A's
committed pages and append, phase B's kill, stale and rebuilt sidecar, and
the restart check): chip_smoke.py phase 18 and torch_tiers.py 1m hold it.

Differences from the original: the pages' link targets are drawn from
100,000 page ids, not 10,000,000 (make_page lists every candidate id, which
at ten million costs ~0.5 s per page); phase B appends pages of its own ids
(the original reused phase A's, which a store that ran phase A skips as
not newer, so the sidecar never went stale); and the original's checks
that passed without looking (n_docs >= 1M, sidecar_rebuilt when no sidecar
existed) are the checks above. Each server's log is under --work. The
last line is {"crash_recovery": [one object per phase]}, each with the
card's name and power limit; main() returns the same dict. A failed check
raises (exit 1); killed_mid_refresh is reported, and the caller holds it.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import threading
import time
import urllib.request

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_probe_util as util  # noqa: E402

PAGES_PER_FLUSH = 50
CHECK_CLIENTS = 8  # concurrent clients of --checkQueries, as chip_smoke.py's serving phases
LINK_PAGES = 100_000  # the population make_page draws link targets from
BASE = "http://crash.local"
FIRST_PAGE_A = 5_000_000  # the original's first page id
FIRST_PAGE_B = 7_000_000
APPEND_PAGE = 6_000_000  # phase A's post-recovery page (the original's)
DECOY = "decoy-tmp-sidecar"

CRAWLER_SNIPPET = """
import sys
sys.path.insert(0, {repo!r})
import random
from datetime import datetime, timezone
from spaghettisearch_tpu_torch.corpus import make_page
from spaghettisearch_tpu_torch.index.indexer import index_page
from spaghettisearch_tpu_torch.store.tables import Database

db = Database({root!r})
rng = random.Random({seed})
ts = datetime(2026, 3, 1, tzinfo=timezone.utc)
i = {first}
with db.bulk():
    {loop}
        for _ in range({per_flush}):
            url, html = make_page(rng, i, {links}, {base!r})
            index_page(db, html, url, last_modified=ts)
            i += 1
        db.flush_bulk()
        db.flush()
        print("flushed", i, flush=True)
"""


def crawler(root: str, first: int, seed: int, cycles: int | None) -> str:
    """The bulk indexer's code: `cycles` flush cycles, or until killed."""
    loop = "while True:" if cycles is None else f"for _cycle in range({cycles}):"
    return CRAWLER_SNIPPET.format(repo=REPO, root=root, seed=seed, first=first, loop=loop,
                                  per_flush=PAGES_PER_FLUSH, links=LINK_PAGES, base=BASE)


def page_hash(i: int) -> str:
    from spaghettisearch_tpu_torch.utils.hashing import md5_hex

    return md5_hex(f"{BASE}/page{i}")


def _copy(src: str, work: str, with_snapshot: bool) -> None:
    t0 = time.perf_counter()
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    shutil.copytree(os.path.join(src, "store"), os.path.join(work, "store"))
    if with_snapshot:
        shutil.copytree(os.path.join(src, "snapshot"), os.path.join(work, "snapshot"))
    print(f"copied {src} -> {work} in {time.perf_counter() - t0:.1f}s", flush=True)


def _count_docs(store: str) -> int:
    from spaghettisearch_tpu_torch.store.tables import Database

    db = Database(store)
    try:
        return len(db.doc_info.keys())
    finally:
        db.close()


def store_digest(db) -> dict:
    """Per table, (rows, an order-free digest of every raw key and value),
    and the docs pack's index: what a fresh open must read back."""
    import hashlib

    out = {}
    for name, table in db.tables.items():
        acc = n = 0
        for k, v in table._kv.items():
            acc += int.from_bytes(hashlib.md5(f"{k}\0{v}".encode()).digest(), "little")
            n += 1
        out[name] = (n, acc % (1 << 128))
    out["docs_pack"] = dict(db._docs_pack.index)
    return out


def phase_a(work: str, card: dict) -> dict:
    import random
    from datetime import datetime, timezone

    from spaghettisearch_tpu_torch.corpus import make_page
    from spaghettisearch_tpu_torch.index.indexer import index_page
    from spaghettisearch_tpu_torch.store.tables import Database

    store = os.path.join(work, "store")
    docs_before = _count_docs(store)
    proc = subprocess.Popen(
        [sys.executable, "-c", crawler(store, FIRST_PAGE_A, 77, None)],
        stdout=subprocess.PIPE, text=True, cwd=REPO,
    )
    flushes = 0
    t_dead = time.monotonic() + 600
    last = ""
    try:
        while flushes < 2 and time.monotonic() < t_dead:
            line = proc.stdout.readline()
            if not line:
                break
            last = line.strip()
            if line.startswith("flushed"):
                flushes += 1
        if flushes < 2:
            raise RuntimeError(f"the indexer never flushed twice: {last!r}")
        # kill -9 a beat into the next flush cycle: the bulk cache is mid-write
        time.sleep(0.35)
    finally:
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait()
    print(f"indexer SIGKILLed after {flushes} flushes", flush=True)

    t0 = time.perf_counter()
    db = Database(store)
    reopen_s = time.perf_counter() - t0
    try:
        keys = db.doc_info.keys()
        n_docs = len(keys)
        committed = flushes * PAGES_PER_FLUSH
        if n_docs < docs_before + committed:
            raise RuntimeError(f"doc_info lost rows: {n_docs} < {docs_before} + {committed}")
        for i in range(FIRST_PAGE_A, FIRST_PAGE_A + committed):
            info = db.doc_info.get(page_hash(i))
            if info is None or info.is_stub or not db.cached_doc(page_hash(i)):
                raise RuntimeError(f"committed page {i} is not a full doc after the crash")
        docs_pack_ok = sum(1 for h in keys[:50] if db.cached_doc(h))
        for h in keys[-20:]:  # the last committed rows decode
            if db.doc_info.get(h) is None:
                raise RuntimeError(f"doc_info row {h} does not decode")
        # the log tail stays appendable after recovery
        url, html = make_page(random.Random(99), APPEND_PAGE, LINK_PAGES, BASE)
        index_page(db, html, url, last_modified=datetime(2026, 3, 2, tzinfo=timezone.utc))
        db.flush()
        written = store_digest(db)
    finally:
        db.close()
    db = Database(store)
    try:
        appended = db.doc_info.get(page_hash(APPEND_PAGE))
        if appended is None or appended.is_stub or db.cached_doc(page_hash(APPEND_PAGE)) != html:
            raise RuntimeError("the post-recovery append is not in the reopened store")
        bad = [name for name, d in store_digest(db).items() if d != written[name]]
        if bad:
            raise RuntimeError(f"a fresh open reads other rows than the writer wrote: {bad}")
        n_after = len(db.doc_info.keys())
    finally:
        db.close()
    res = {"phase": "a", "flushes_before_kill": flushes, "docs_before": docs_before,
           "docs": n_docs, "docs_after_append": n_after, "committed_pages_ok": committed,
           "reopen_s": round(reopen_s, 2), "docs_pack_ok": docs_pack_ok,
           "post_recovery_append": True, "appended_url": url, **card}
    print(json.dumps(res), flush=True)
    return res


def _sidecar_fp(path: str) -> str | None:
    import numpy as np

    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        return z["fp"].tobytes().decode()


def _plant_decoy(snap_dir: str, fp: str, n_docs: int) -> str:
    """A sidecar under a temporary name (hydration.npz.tmp-decoy) that would
    pass the loader's fingerprint check on the recovered store, with every
    record marked: a loader that took it would serve DECOY as each Url."""
    import numpy as np

    from spaghettisearch_tpu_torch.retrieval.hydration_sidecar import (
        FLAG_FRAG, FLAG_TEXT, SIDECAR_NAME, save_sidecar,
    )

    path = os.path.join(snap_dir, f"{SIDECAR_NAME}.tmp-decoy")
    frag = ('{"Url":"%s","Page_title":"%s"' % (DECOY, DECOY)).encode()
    save_sidecar(path, fp, np.full(n_docs, FLAG_FRAG | FLAG_TEXT, np.uint8),
                 [frag] * n_docs, [DECOY.encode()] * n_docs, True)
    return path


class Server:
    """The port's server on `store`/`snap_dir` in a process of its own, its
    output in `log`."""

    def __init__(self, store: str, snap_dir: str, port: int, device: str, log: str,
                 n_pages: int) -> None:
        from spaghettisearch_tpu_torch import bench

        self.port, self.log = port, log
        t0 = time.monotonic()
        with open(log, "wb") as out:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "spaghettisearch_tpu_torch.cli.server", "--db", store,
                 "--snapshot", snap_dir, "--port", str(port), "--device", device],
                stdout=out, stderr=subprocess.STDOUT, cwd=REPO,
            )
        try:
            # the bench's start-up wait: a tenfold margin, linear in the pages
            bench._wait_up(self.proc, log, port, t0 + 60.0 + n_pages * 3e-3)
        except BaseException:
            self.kill()
            raise
        self.up_s = time.monotonic() - t0

    def kill(self) -> None:
        if self.proc.poll() is None:
            os.kill(self.proc.pid, signal.SIGKILL)
        self.proc.wait()

    def stop(self) -> None:
        self.proc.terminate()
        try:
            self.proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            self.kill()


def post(base: str, path: str, payload: dict, timeout: float) -> bytes:
    req = urllib.request.Request(base + path, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        if resp.status != 200:
            raise RuntimeError(f"{path} answered {resp.status}")
        return resp.read()


def phase_b(work: str, card: dict, device: str, kill_after_s: float, n_pages: int,
            on_restart=None) -> dict:
    from spaghettisearch_tpu_torch import bench
    from spaghettisearch_tpu_torch.corpus import bench_queries
    from spaghettisearch_tpu_torch.index.persist import load_snapshot
    from spaghettisearch_tpu_torch.retrieval.hydration_sidecar import (
        SIDECAR_NAME, load_sidecar, store_fingerprint,
    )
    from spaghettisearch_tpu_torch.store.tables import Database

    store, snap_dir = os.path.join(work, "store"), os.path.join(work, "snapshot")
    sidecar = os.path.join(snap_dir, SIDECAR_NAME)
    port = bench._free_port()
    base = f"http://127.0.0.1:{port}"
    server = Server(store, snap_dir, port, device, os.path.join(work, "server.log"), n_pages)
    try:
        up_s = server.up_s
        print(f"server up in {up_s:.1f}s", flush=True)
        fp_before = _sidecar_fp(sidecar)
        if fp_before is None:
            raise RuntimeError(f"the server wrote no {SIDECAR_NAME} at start-up")
        # a real append: the refresh has new rows, and the store's
        # fingerprint moves away from the sidecar's
        out = subprocess.run([sys.executable, "-c", crawler(store, FIRST_PAGE_B, 78, 1)],
                             capture_output=True, text=True, timeout=900, cwd=REPO)
        if out.returncode != 0:
            raise RuntimeError(f"the append failed: {out.stderr[-800:]}")
        print(f"appended {PAGES_PER_FLUSH} docs", flush=True)

        answered = threading.Event()  # set only by a whole /refresh answer

        def fire() -> None:
            try:
                post(base, "/refresh", {}, timeout=3600)
                answered.set()
            except OSError:
                pass  # the kill cut the call

        th = threading.Thread(target=fire, daemon=True)
        t_fire = time.perf_counter()
        th.start()
        time.sleep(kill_after_s)  # inside the off-lock rebuild at 100k
        server.kill()
        th.join(timeout=60)
        killed_mid_refresh = not answered.is_set()
        print(f"server SIGKILLed {time.perf_counter() - t_fire:.1f}s after POST /refresh "
              f"(mid-refresh: {killed_mid_refresh})", flush=True)
    except BaseException:
        server.kill()
        raise
    tmp_after_kill = sorted(f for f in os.listdir(snap_dir) if f.startswith(SIDECAR_NAME + ".tmp-"))

    # the recovered store's fingerprint against the sidecar's; then the decoy
    db = Database(store)
    try:
        snap = load_snapshot(snap_dir)
        fp_now = store_fingerprint(db, snap)
        queries = bench_queries(snap, 8, seed=11, phrase_every=4, db=db)
    finally:
        db.close()
    stale = fp_now != fp_before and load_sidecar(sidecar, fp_now, need_texts=False) is None
    if not stale:
        raise RuntimeError("the sidecar is not stale against the recovered store")
    decoy = _plant_decoy(snap_dir, fp_now, snap.n_docs)

    server = Server(store, snap_dir, port, device, os.path.join(work, "server_restart.log"),
                    n_pages)
    try:
        print(f"server restarted in {server.up_s:.1f}s", flush=True)
        answered = 0
        for q in queries:
            body = post(base, "/query", {"query": q}, timeout=600)
            if DECOY.encode() in body:
                raise RuntimeError("the restarted server served the temporary sidecar's records")
            answered += bool(json.loads(body))
        if not answered:
            raise RuntimeError("no results after the crash and restart")
        with urllib.request.urlopen(base + "/healthz", timeout=60) as resp:
            docs_served = json.loads(resp.read()).get("docs")
        fp_after = _sidecar_fp(sidecar)
        rebuilt = fp_after == fp_now and fp_after != fp_before
        if not rebuilt or not os.path.exists(decoy):
            raise RuntimeError(f"the sidecar was not rebuilt for the recovered store "
                               f"(fingerprint {fp_after}, want {fp_now})")
        if on_restart is not None:
            on_restart(base)
    finally:
        server.stop()
    res = {"phase": "b", "killed_mid_refresh": killed_mid_refresh, "kill_after_s": kill_after_s,
           "server_up_s": round(up_s, 1), "restart_up_s": round(server.up_s, 1),
           "docs_served": docs_served, "queries_with_results": answered,
           "sidecar_stale_detected": stale, "sidecar_rebuilt": rebuilt,
           "tmp_sidecars_after_kill": tmp_after_kill, "tmp_sidecar_loaded": False,
           "sidecar_fingerprint": fp_after, **card}
    print(json.dumps(res), flush=True)
    return res


def check_queries(work: str, n: int, seed: int) -> list[str]:
    """The first n distinct queries of chip_smoke.py's serving mix
    (bench_queries(snap, 320, seed=seed + 1, phrase_every=4)) on the
    copy's snapshot and store."""
    from spaghettisearch_tpu_torch.corpus import bench_queries
    from spaghettisearch_tpu_torch.index.persist import load_snapshot
    from spaghettisearch_tpu_torch.store.tables import Database

    db = Database(os.path.join(work, "store"))
    try:
        qs = bench_queries(load_snapshot(os.path.join(work, "snapshot")), 320, seed=seed + 1,
                           phrase_every=4, db=db)
    finally:
        db.close()
    return list(dict.fromkeys(qs[:n]))


def ask(queries: list[str], answers: dict, then=None):
    """An on_restart that POSTs the queries to the restarted server from
    CHECK_CLIENTS threads and keeps each answer in `answers`, then calls
    `then` (or nothing)."""
    from concurrent.futures import ThreadPoolExecutor

    def on_restart(base: str) -> None:
        with ThreadPoolExecutor(CHECK_CLIENTS) as pool:
            bodies = list(pool.map(
                lambda q: json.loads(post(base, "/query", {"query": q}, timeout=600)), queries))
        answers.update(zip(queries, bodies))
        if then is not None:
            then(base)
    return on_restart


def restart_check(work: str, device: str, answers: dict) -> dict:
    """The restarted server's answers against a QueryEngine on the same
    recovered store and snapshot, ranked through the kernels (K1 and K2
    must launch on a card) and through their plain versions on the same
    device: every answer's FinalRanks finite and descending, and equal to
    both (FinalRank within 1e-6 relative, Urls equal except at tied
    scores). Raises on a difference."""
    from spaghettisearch_tpu_torch.index.persist import load_snapshot
    from spaghettisearch_tpu_torch.retrieval.engine import QueryEngine
    from spaghettisearch_tpu_torch.store.tables import Database

    qs = list(answers)
    kw = [q for q in qs if '"' not in q]
    ph = [q for q in qs if '"' in q]
    db = Database(os.path.join(work, "store"))
    try:
        eng = QueryEngine(db, snapshot=load_snapshot(os.path.join(work, "snapshot")),
                          device=device)
        util.reset_launches()
        got = dict(zip(kw + ph, eng.query_batch(kw) + eng.query_batch(ph)))
        util.sync(device)
        launched = util.launches()
        with util.plain_kernels():
            ref = dict(zip(kw + ph, eng.query_batch(kw) + eng.query_batch(ph)))
    finally:
        db.close()
    if device.startswith("cuda") and min(launched["K1"], launched["K2"]) == 0:
        raise RuntimeError(f"restart check: K1 or K2 never launched: {launched}")
    for q in qs:
        ranks = [r["FinalRank"] for r in answers[q]]
        if ranks != sorted(ranks, reverse=True) or not all(
                isinstance(x, float) and math.isfinite(x) for x in ranks):
            raise RuntimeError(f"the restarted server's answer to {q!r}: bad FinalRank "
                               "order or values")
    for what, want in (("the kernel path", got), ("the plain path", ref)):
        bad = [q for q in qs if not util.same_results(answers[q], want[q])]
        if bad:
            raise RuntimeError(f"the restarted server's answer to {bad[0]!r} differs from "
                               f"{what} on the recovered store")
    res = {"queries": len(qs), "keyword": len(kw), "phrase": len(ph),
           "results": sum(len(a) for a in answers.values()), "launches": launched,
           "equal_kernel_path": True, "equal_plain_path": True}
    print(f"the restarted server's {len(qs)} answers equal the kernel and the plain path on "
          f"the recovered store: {json.dumps(res)}", flush=True)
    return res


def holds(results: list[dict]) -> list[tuple[bool, str]]:
    """main()'s phases ["crash_recovery"], A then B -> [(held, what)]: the
    soak's pass/fail list, which its callers hold."""
    a, b = results
    c = b.get("restart_check") or {}
    committed = a["committed_pages_ok"]
    return [
        (a["phase"] == "a" and a["post_recovery_append"]
         and committed == PAGES_PER_FLUSH * a["flushes_before_kill"] >= 2 * PAGES_PER_FLUSH
         and a["docs"] >= a["docs_before"] + committed,
         f"phase A: {committed} pages of {a['flushes_before_kill']} committed flushes intact, "
         "the append after the recovery read back"),
        (b["phase"] == "b" and b["killed_mid_refresh"], "phase B: killed mid-/refresh"),
        (b["sidecar_stale_detected"] and b["sidecar_rebuilt"] and not b["tmp_sidecar_loaded"],
         "phase B: the stale sidecar detected and rebuilt, the temporary one not loaded"),
        (c.get("equal_kernel_path") is True and c.get("equal_plain_path") is True,
         f"phase B: the restarted server's {c.get('queries')} answers equal the kernel and "
         "plain paths"),
    ]


def main(argv: list[str] | None = None, on_restart=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phase", choices=("a", "b", "all"), default="a")
    ap.add_argument("--pages", type=int, default=1_000_000,
                    help="the benchmark corpus's size (the original's 1M by default)")
    ap.add_argument("--seed", type=int, default=0, help="the corpus's seed")
    ap.add_argument("--device", default="cuda",
                    help="where the servers rank and the corpus's PageRank runs: cuda "
                         "(default) or cpu, never a fallback")
    ap.add_argument("--work", default=None, help="the copy's directory")
    ap.add_argument("--skip-copy", action="store_true", help="reuse the copy in --work")
    ap.add_argument("--killAfterS", type=float, default=20.0,
                    help="seconds from POST /refresh to the kill (phase B)")
    ap.add_argument("--checkQueries", type=int, default=0,
                    help="phase B: ask the restarted server this many queries of the serving "
                         "mix and hold its answers against the kernel and plain paths")
    args = ap.parse_args(argv)

    from spaghettisearch_tpu_torch import bench

    device = bench._check_device(args.device)
    card = bench.card(device)
    work = args.work or os.path.join(REPO, "build", "crash", f"corpus{args.pages // 1000}k")
    if not args.skip_copy:
        src = bench.ensure_bench_corpus(args.pages, device=device, seed=args.seed)
        _copy(src, work, with_snapshot=args.phase in ("b", "all"))
    results = []
    if args.phase in ("a", "all"):
        results.append(phase_a(work, card))
    if args.phase in ("b", "all"):
        answers: dict = {}
        if args.checkQueries:
            on_restart = ask(check_queries(work, args.checkQueries, args.seed), answers,
                             on_restart)
        results.append(phase_b(work, card, str(device), args.killAfterS, args.pages, on_restart))
        if args.checkQueries:
            results[-1]["restart_check"] = restart_check(work, str(device), answers)
    return {"crash_recovery": results}


if __name__ == "__main__":
    print(json.dumps(main()), flush=True)
