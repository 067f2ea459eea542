"""experiments/torch_crash_recovery.py on the CPU, against the JAX package.

Phase A (kill -9 of a bulk indexer mid-flush) on a 200-page benchmark
corpus: the JAX package's Database and the port's open the recovered store
alike (doc_info keys and rows, cached pages), and the JAX Database reads the
page the port appended after the recovery. Phase B (kill -9 of the port's
server mid-/refresh, --device cpu): the restarted server's answers equal the
JAX engine's on the same store and snapshot (FinalRank within 1e-6
relative, ties aside), and its rebuilt sidecar carries the JAX package's
store_fingerprint of the recovered store. At this size the refresh may end
before the kill: killed_mid_refresh is printed, not required. And the torn
tails a kill leaves in the store's two logs (a fastkv data.log record, a
docs-pack index line), which the port's store cuts before its next write."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import struct
import urllib.request

import pytest
import torch

from spaghettisearch_tpu.index.persist import load_snapshot as jax_load_snapshot
from spaghettisearch_tpu.retrieval.engine import QueryEngine as JaxEngine
from spaghettisearch_tpu.retrieval.hydration_sidecar import store_fingerprint as jax_fingerprint
from spaghettisearch_tpu.store.tables import Database as JaxDatabase
from spaghettisearch_tpu_torch import bench
from spaghettisearch_tpu_torch.corpus import bench_queries
from spaghettisearch_tpu_torch.index.persist import load_snapshot
from spaghettisearch_tpu_torch.store.durable_kv import NativeBackend, log_good_end
from spaghettisearch_tpu_torch.store.tables import Database
from spaghettisearch_tpu_torch.utils.hashing import md5_hex

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAGES = 200


def _script():
    path = os.path.join(REPO, "experiments", "torch_crash_recovery.py")
    spec = importlib.util.spec_from_file_location("torch_crash_recovery", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def bench_dir(tmp_path_factory):
    """A benchmark corpus of PAGES pages where ensure_bench_corpus finds it."""
    d = str(tmp_path_factory.mktemp("bench"))
    saved = bench.BENCH_DIR
    bench.BENCH_DIR = d
    try:
        bench.build_bench_corpus(bench.corpus_root(PAGES), n_pages=PAGES, device="cpu",
                                 quiet=True)
    finally:
        bench.BENCH_DIR = saved
    return d


def _run(bench_dir, monkeypatch, phase: str, work, **kw) -> dict:
    monkeypatch.setattr(bench, "BENCH_DIR", bench_dir)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the servers' plain versions
    res = _script().main(["--phase", phase, "--pages", str(PAGES), "--device", "cpu",
                          "--work", str(work), "--killAfterS", "1"], **kw)
    (out,) = res["crash_recovery"]
    assert out["phase"] == phase and out["device"] == "cpu"
    return out


def test_phase_a_recovered_store_reads_alike(bench_dir, tmp_path, monkeypatch):
    a = _run(bench_dir, monkeypatch, "a", tmp_path / "work")
    flushed = 50 * a["flushes_before_kill"]
    assert a["flushes_before_kill"] >= 2 and a["committed_pages_ok"] == flushed
    assert a["docs"] >= a["docs_before"] + flushed and a["post_recovery_append"]
    store = str(tmp_path / "work" / "store")
    jdb, tdb = JaxDatabase(store), Database(store)
    try:
        keys = tdb.doc_info.keys()
        assert keys == jdb.doc_info.keys() and len(keys) == a["docs_after_append"]
        for k in keys:
            assert dataclasses.asdict(tdb.doc_info.get(k)) == dataclasses.asdict(jdb.doc_info.get(k))
        for k in keys[::7]:
            assert tdb.cached_doc(k) == jdb.cached_doc(k)
        appended = md5_hex(a["appended_url"])
        info = jdb.doc_info.get(appended)
        assert info is not None and not info.is_stub
        assert jdb.cached_doc(appended) == tdb.cached_doc(appended) and jdb.cached_doc(appended)
    finally:
        jdb.close()
        tdb.close()


def _post(base: str, q: str) -> list[dict]:
    req = urllib.request.Request(base + "/query", data=json.dumps({"query": q}).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as resp:
        assert resp.status == 200
        return json.loads(resp.read())


def _same_up_to_ties(got: list[dict], want: list[dict], rtol: float = 1e-6) -> bool:
    """FinalRank position by position within rtol; where the Urls differ the
    scores tie; where they agree, the same record."""
    if len(got) != len(want):
        return False
    ref = {r["Url"]: r["FinalRank"] for r in want}
    close = lambda a, b: abs(a - b) <= rtol * max(abs(b), 1e-9)  # noqa: E731
    for g, w in zip(got, want):
        if not close(g["FinalRank"], w["FinalRank"]):
            return False
        if g["Url"] != w["Url"]:
            if not close(ref.get(g["Url"], want[-1]["FinalRank"]), w["FinalRank"]):
                return False
        elif any(g[k] != w[k] for k in ("Page_title", "Summary", "Children", "Parents")):
            return False
    return True


def test_phase_b_restarted_server_answers_like_jax(bench_dir, tmp_path, monkeypatch):
    src = os.path.join(bench_dir, os.path.basename(bench.corpus_root(PAGES)))
    db = Database(os.path.join(src, "store"))
    try:
        queries = bench_queries(load_snapshot(os.path.join(src, "snapshot")), 24, seed=3,
                                phrase_every=4, db=db)
    finally:
        db.close()
    answers: list[list[dict]] = []
    b = _run(bench_dir, monkeypatch, "b", tmp_path / "work",
             on_restart=lambda base: answers.extend(_post(base, q) for q in queries))
    print(f"killed_mid_refresh at {PAGES} pages: {b['killed_mid_refresh']}")
    assert b["sidecar_stale_detected"] and b["sidecar_rebuilt"] and not b["tmp_sidecar_loaded"]
    assert b["docs_served"] == PAGES and len(answers) == len(queries)
    store, snap_dir = str(tmp_path / "work" / "store"), str(tmp_path / "work" / "snapshot")
    jdb = JaxDatabase(store)
    try:
        jsnap = jax_load_snapshot(snap_dir)
        assert b["sidecar_fingerprint"] == jax_fingerprint(jdb, jsnap)
        want = JaxEngine(jdb, snapshot=jsnap).query_batch(queries)
    finally:
        jdb.close()
    assert sum(map(len, want)) > 0
    for q, got, w in zip(queries, answers, want):
        assert _same_up_to_ties(got, w), q


def test_check_queries_held_by_holds(bench_dir, tmp_path, monkeypatch):
    """--phase all --checkQueries: the restarted server's answers to the
    smoke's mix, from several clients, equal the kernel and plain paths on
    the recovered store, and holds() passes every hold but the kill's
    timing, which this size cannot promise."""
    monkeypatch.setattr(bench, "BENCH_DIR", bench_dir)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    script = _script()
    res = script.main(["--phase", "all", "--pages", str(PAGES), "--device", "cpu",
                       "--work", str(tmp_path / "work"), "--killAfterS", "1",
                       "--checkQueries", "16"])
    a, b = res["crash_recovery"]
    c = b["restart_check"]
    assert c["queries"] == 16 and c["keyword"] > 0 and c["phrase"] > 0 and c["results"] > 0
    failed = [what for ok, what in script.holds([a, b]) if not ok]
    assert failed == ([] if b["killed_mid_refresh"] else ["phase B: killed mid-/refresh"])


_A = {"phase": "a", "post_recovery_append": True, "flushes_before_kill": 2,
      "committed_pages_ok": 100, "docs_before": 200, "docs": 300}
_B = {"phase": "b", "killed_mid_refresh": True, "sidecar_stale_detected": True,
      "sidecar_rebuilt": True, "tmp_sidecar_loaded": False,
      "restart_check": {"queries": 64, "equal_kernel_path": True, "equal_plain_path": True}}


@pytest.mark.parametrize("phase,change,failed", [
    ("a", {}, []),
    ("a", {"committed_pages_ok": 99}, [0]),
    ("a", {"flushes_before_kill": 1, "committed_pages_ok": 50, "docs": 250}, [0]),
    ("a", {"docs": 299}, [0]),
    ("a", {"post_recovery_append": False}, [0]),
    ("b", {"killed_mid_refresh": False}, [1]),
    ("b", {"sidecar_stale_detected": False}, [2]),
    ("b", {"sidecar_rebuilt": False}, [2]),
    ("b", {"tmp_sidecar_loaded": True}, [2]),
    ("b", {"restart_check": None}, [3]),
    ("b", {"restart_check": {"queries": 64, "equal_kernel_path": True,
                             "equal_plain_path": False}}, [3]),
], ids=["all_held", "a_lost_page", "a_one_flush", "a_lost_doc", "a_no_append", "b_not_mid",
        "b_not_stale", "b_not_rebuilt", "b_tmp_loaded", "b_no_check", "b_plain_differs"])
def test_holds_fail_exactly_where_a_phase_fails(phase, change, failed):
    a, b = dict(_A), dict(_B)
    (a if phase == "a" else b).update(change)
    got = [i for i, (ok, _) in enumerate(_script().holds([a, b])) if not ok]
    assert got == failed


def test_torn_log_record_is_cut_before_the_next_write(tmp_path):
    """A record torn by a kill (its header and part of its value) is
    dropped at open, and the next writer's records land after the last
    whole one, so a later open reads them all (fastkv alone appends behind
    the torn bytes, and the next replay reads them as one garbage record)."""
    path = str(tmp_path / "table")
    rows = {"a": "1" * 100, "b": "2" * 100}
    kv = NativeBackend(path)
    kv.set_many(list(rows.items()))
    kv.close()
    log = os.path.join(path, "data.log")
    whole = os.path.getsize(log)
    with open(log, "ab") as f:
        f.write(struct.pack("<BII", 0, 1, 100) + b"c" + b"3" * 40)
    assert log_good_end(log) == (whole, whole + 50)
    reader = NativeBackend(path)  # a reader never cuts: the writer may be mid-record
    assert dict(reader.items()) == rows
    reader.close()
    assert os.path.getsize(log) == whole + 50
    kv = NativeBackend(path)
    kv.set("d", "4" * 100)
    kv.delete("a")
    kv.close()
    kv = NativeBackend(path)
    try:
        assert dict(kv.items()) == {"b": "2" * 100, "d": "4" * 100}
    finally:
        kv.close()
    assert log_good_end(log) == (os.path.getsize(log),) * 2


def test_torn_docs_pack_line_is_skipped_and_cut(tmp_path):
    """A docs-pack index line torn by a kill (no newline) is not read, even
    when what is left of it parses, and the next page's line is not glued
    onto it."""
    root = str(tmp_path / "store")
    db = Database(root)
    db.cache_doc("h1", b"x" * 50)
    db.flush()
    db.close()
    with open(os.path.join(root, "docs.pack"), "ab") as f:
        f.write(b"y" * 100)
    with open(os.path.join(root, "docs.pki"), "a", encoding="utf-8") as f:
        f.write("h2 50 1")  # "h2 50 100" cut by the kill
    db = Database(root)
    assert db.cached_doc("h1") == b"x" * 50 and db.cached_doc("h2") is None
    db.cache_doc("h3", b"z" * 30)
    db.flush()
    db.close()
    db = Database(root)
    try:
        assert db.cached_doc("h3") == b"z" * 30 and db.cached_doc("h2") is None
        assert db.cached_doc("h1") == b"x" * 50
    finally:
        db.close()
