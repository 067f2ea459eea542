"""The port's host-side tools of experiments/ on the CPU: each profiler runs
to its result on a tiny benchmark corpus with a short window; every tool
(the crash soak too) refuses --device cuda without CUDA instead of falling
back; torch_hydration_only_profile's responses are byte for byte the JAX
engine's hydrate_row_json on the same rows; and the load client behind
them and bench.py --mode serve counts an answer without a Content-Length
as a protocol error instead of reading past it."""

from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import socket
import threading

import pytest
import torch

from spaghettisearch_tpu.index.persist import load_snapshot as jax_load_snapshot
from spaghettisearch_tpu.retrieval.engine import QueryEngine as JaxEngine
from spaghettisearch_tpu.retrieval.engine import parse_query as jax_parse
from spaghettisearch_tpu.store.tables import Database as JaxDatabase
from spaghettisearch_tpu_torch import bench
from spaghettisearch_tpu_torch.corpus import bench_queries
from spaghettisearch_tpu_torch.serve.loadclient import LoadClient, parse_head

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAGES = 120


def _script(name: str):
    path = os.path.join(REPO, "experiments", f"torch_{name}.py")
    spec = importlib.util.spec_from_file_location(f"torch_{name}", path)
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


CORPUS = ["--pages", str(PAGES)]
#: (script, argv on the CPU, keys its result must carry)
PROFILERS = [
    ("serve_host_profile", CORPUS + ["--conns", "8", "--warmS", "0.5", "--seconds", "1.5"],
     ("host_only_qps", "p50_ms", "spans_ms_per_batch", "protocol_errors")),
    ("http_echo_probe", ["--conns", "8", "--warmS", "0.3", "--seconds", "1"],
     ("http_echo_rps", "body_bytes", "protocol_errors")),
    ("assemble_probe", CORPUS, ("assemble_cold_ms", "assemble_warm_ms", "packed_query_ms")),
    ("hydration_profile", CORPUS, ("rank_warm_ms_per_query", "rank_keyword_only_warm_ms_per_query",
                                   "hydrate_warm_ms_per_query", "launches")),
    ("hydration_only_profile", CORPUS, ("hydrate_warm_ms_per_query", "json_sha256")),
    ("index_profile", ["150", "--mem"], ("wall_pages_per_s", "per_page_ms")),
    ("index_profile", ["150"], ("wall_pages_per_s", "per_page_ms")),
]


@pytest.mark.parametrize("name,argv,keys", PROFILERS,
                         ids=[f"{p[0]}-{i}" for i, p in enumerate(PROFILERS)])
def test_profiler_runs_on_the_cpu(name, argv, keys, bench_dir, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(bench, "BENCH_DIR", bench_dir)
    if name == "index_profile" and "--mem" not in argv:
        argv = argv + ["--root", str(tmp_path / "store")]
    res = _script(name).main(argv + ["--device", "cpu"])
    assert set(keys) <= set(res) and res["device"] == "cpu" and res["host_cores"] >= 1
    assert json.loads(json.dumps(res)) == res  # the result line is plain JSON
    assert capsys.readouterr().out.strip()  # the original's lines
    if "protocol_errors" in res:
        assert res["protocol_errors"] == 0 and res["non_200"] == 0
    if name == "index_profile":
        stages = res["per_page_ms"]
        assert {"render_tokenize", "laundry", "postings", "anchors", "bulk_flush"} <= set(stages)
        assert all(v >= 0 for v in stages.values())
    if name == "hydration_profile":  # the plain versions on the CPU: no launch
        assert res["launches"] == {"K1": 0, "K2": 0, "K3": 0, "K4": 0}


TOOLS = ["crash_recovery", "serve_host_profile", "http_echo_probe", "assemble_probe",
         "hydration_profile", "hydration_only_profile", "index_profile"]


@pytest.mark.parametrize("name", TOOLS)
def test_tool_refuses_cuda_without_cuda(name, monkeypatch, tmp_path):
    """--device cuda (the default) exits before any work where CUDA is
    absent: no corpus is built and nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(bench, "BENCH_DIR", str(tmp_path))
    mod = _script(name)
    for argv in ([], ["--device", "cuda"]):
        with pytest.raises(SystemExit) as e:
            mod.main(argv)
        assert "CUDA is not available" in str(e.value)
    assert os.listdir(tmp_path) == []


def test_hydration_only_json_equals_jax(bench_dir, monkeypatch):
    monkeypatch.setattr(bench, "BENCH_DIR", bench_dir)
    mod = _script("hydration_only_profile")
    res = mod.main(CORPUS + ["--device", "cpu"])
    root = os.path.join(bench_dir, os.path.basename(bench.corpus_root(PAGES)))
    jdb = JaxDatabase(os.path.join(root, "store"))
    try:
        jsnap = jax_load_snapshot(os.path.join(root, "snapshot"))
        queries = bench_queries(jsnap, mod.N_QUERIES, seed=5, phrase_every=8, db=jdb)
        eng = JaxEngine(jdb, snapshot=jsnap)
        eng.prewarm_hydration()
        live = eng._live
        out = [eng.hydrate_row_json(s, i, jax_parse(q), live)
               for q, (s, i) in zip(queries, mod.synthetic_rows(jsnap.n_docs, len(queries)))]
    finally:
        jdb.close()
    assert res["queries"] == len(out) == mod.N_QUERIES
    assert hashlib.sha256(b"\n".join(out)).hexdigest() == res["json_sha256"]


@pytest.mark.parametrize("head,want", [
    (b"HTTP/1.1 200 OK\r\nContent-Type: x\r\nContent-Length: 12", (b"200", 12)),
    (b"HTTP/1.1 404 Not Found\r\ncontent-length:0\r\nServer: y", (b"404", 0)),
    (b"HTTP/1.1 200 OK\r\nContent-Type: x", (b"200", None)),
    (b"HTTP/1.1 200 OK\r\nX-Content-Length: 5", (b"200", None)),
    (b"HTTP/1.1 200 OK\r\nContent-Length: -3", (b"200", None)),
    (b"HTTP/1.1 200 OK\r\nContent-Length: 1e3", (b"200", None)),
])
def test_parse_head(head, want):
    assert parse_head(head) == want


def _raw_server(response: bytes):
    """A server that answers every request on a connection with `response`
    (until the client closes). -> (port, stop)."""
    ls = socket.socket()
    ls.bind(("127.0.0.1", 0))
    ls.listen(64)
    stop = threading.Event()

    def serve(conn):
        with conn:
            while not stop.is_set():
                try:
                    if not conn.recv(1 << 16):
                        return
                    conn.sendall(response)
                except OSError:
                    return

    def accept():
        while not stop.is_set():
            try:
                conn, _ = ls.accept()
            except OSError:
                return
            threading.Thread(target=serve, args=(conn,), daemon=True).start()

    threading.Thread(target=accept, daemon=True).start()

    def close():
        stop.set()
        ls.close()
    return ls.getsockname()[1], close


@pytest.mark.parametrize("framed", [True, False])
def test_load_client_counts_unframed_answers(framed):
    """Without a Content-Length the answer cannot be framed: it is counted
    as a protocol error and its connection replaced, never parsed."""
    body = b'{"ok": true}'
    head = b"HTTP/1.1 200 OK\r\nContent-Type: application/json\r\n"
    if framed:
        head += b"Content-Length: " + str(len(body)).encode() + b"\r\n"
    port, close = _raw_server(head + b"\r\n" + body)
    try:
        client = LoadClient(port, [b"GET /x HTTP/1.1\r\nHost: b\r\n\r\n"], 4)
        client.pump(0.5)
        client.close()
    finally:
        close()
    if framed:
        assert client.done > 0 and client.protocol_errors == 0 and client.non_200 == 0
    else:
        assert client.done == 0 and client.protocol_errors > 0
