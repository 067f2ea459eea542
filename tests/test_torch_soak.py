"""The port's serving soaks on the CPU: cli.soak_sharded's synthetic store
writer against experiments/soak_sharded.py's (table for table, and after an
append), and both soaks end to end at a small size (each server a
subprocess on --device cpu, with append -> /refresh under load), each
ending with no error and at least one refresh."""

from __future__ import annotations

import contextlib
import json
import os
import signal
import socket
import subprocess
import sys
import time

import pytest
import torch

from experiments.soak_sharded import build_synth_store as jax_build_synth_store
from spaghettisearch_tpu.store.tables import Database as JaxDatabase
from spaghettisearch_tpu_torch.cli.soak_sharded import build_synth_store, ensure_synth_store
from spaghettisearch_tpu_torch.store.tables import Database
from test_torch_crawl import assert_same_store

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_build_synth_store_equals_jax(tmp_path):
    t_root, j_root = str(tmp_path / "t"), str(tmp_path / "j")
    for start, n in ((0, 512), (512, 64)):
        build_synth_store(t_root, n, start=start)
        jax_build_synth_store(j_root, n, start=start)
        tdb, jdb = Database(t_root), JaxDatabase(j_root)
        try:
            assert len(tdb.doc_info) == start + n
            assert_same_store(tdb, jdb)
        finally:
            tdb.close()
            jdb.close()


def test_ensure_synth_store_reuses_a_build(tmp_path):
    root = str(tmp_path / "s")
    ensure_synth_store(root, 64)
    stamp = os.path.getmtime(os.path.join(root, "BUILT"))
    ensure_synth_store(root, 64)
    assert os.path.getmtime(os.path.join(root, "BUILT")) == stamp
    ensure_synth_store(root, 96)
    db = Database(root)
    assert len(db.doc_info) == 96
    db.close()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _soak(module: str, tmp_path, *args: str) -> dict:
    cmd = [sys.executable, "-m", f"spaghettisearch_tpu_torch.cli.{module}", "--device", "cpu",
           "--seconds", "5", "--root", str(tmp_path / "db"), "--port", str(_free_port()), *args]
    # one torch thread per process: the tier-1 run shares the cores
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": REPO}
    out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300, env=env)
    lines = out.stdout.strip().splitlines()
    assert out.returncode == 0 and lines, (out.stdout[-2000:], out.stderr[-2000:])
    return json.loads(lines[-1])


def test_soak_refreshes_under_load(tmp_path):
    rep = _soak("soak", tmp_path)
    assert rep["n_errors"] == 0 and rep["errors"] == []
    assert rep["counts"]["refreshes"] >= 1 and rep["counts"]["queries"] > 0
    assert rep["counts"]["wordlists"] > 0


@pytest.mark.parametrize("corpus", [False, True])
def test_soak_sharded_refreshes_under_load(tmp_path, corpus):
    """The synthetic store at 2,048 docs, and --corpus over a copy of a
    built store (synthetic docs appended before the load)."""
    args = ["--docs", "2048"]
    if corpus:
        src = str(tmp_path / "src")
        build_synth_store(src, 1024)
        args = ["--corpus", src]
    rep = _soak("soak_sharded", tmp_path, *args)
    assert rep["n_errors"] == 0 and rep["errors"] == []
    assert rep["counts"]["refreshes"] >= 1 and rep["counts"]["queries"] > 0
    assert rep["p50_s"] is not None and rep["p99_s"] >= rep["p50_s"]
    assert rep["docs_final"] == (1024 if corpus else 2048) + 2000
    assert rep["segregation"] == "inactive"  # below 2^19 docs
    if corpus:
        db = Database(src)  # the copied store is left as it was
        assert len(db.doc_info) == 1024
        db.close()


def test_soak_sharded_waits_for_its_start_file(tmp_path):
    """--startFile: the store, the server and the warm pass are set up, then
    nothing more happens until the file exists; the load and a refresh
    follow."""
    start = tmp_path / "go"
    cmd = [sys.executable, "-m", "spaghettisearch_tpu_torch.cli.soak_sharded", "--device", "cpu",
           "--seconds", "3", "--docs", "1024", "--root", str(tmp_path / "db"),
           "--port", str(_free_port()), "--startFile", str(start)]
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": REPO}
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                            text=True, env=env, start_new_session=True)
    try:
        seen = []
        for line in proc.stdout:
            seen.append(line)
            if line.startswith("waiting for"):
                break
        assert seen and seen[-1].startswith("waiting for"), seen
        time.sleep(1.0)
        assert proc.poll() is None
        start.touch()
        rest = proc.stdout.read().strip().splitlines()
        assert proc.wait(timeout=120) == 0, seen + rest
    finally:
        with contextlib.suppress(ProcessLookupError):
            os.killpg(proc.pid, signal.SIGKILL)
    assert rest[0].startswith("load starts after"), rest
    assert not any(line.startswith("refresh #") for line in seen)
    rep = json.loads(rest[-1])
    assert rep["n_errors"] == 0 and rep["counts"]["refreshes"] >= 1 and rep["counts"]["queries"] > 0
