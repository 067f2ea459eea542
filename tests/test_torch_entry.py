"""The port's graft entry points and tools against the JAX package's, on the
CPU: corpus.synth_snapshot against bench.synth_snapshot and
corpus.build_corpus_db against tests/corpus.py (array for array, table for
table), graft_entry.entry against __graft_entry__.entry (the XLA twin on the
CPU), graft_entry.dryrun_multichip on ["cpu"] * 4 against the JAX sharded
scorer and sharded PageRank on the conftest's virtual CPU devices,
utils.timing.device_trace, and cli.bench_micro.

Top-k ids equal up to ties at equal scores; scores within rtol 1e-6 (the
kernel-vs-twin bar); PageRank within the float32 rtol 1e-5."""

from __future__ import annotations

import dataclasses
import json
import os
import random

import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
import bench
import corpus as jcorpus
from spaghettisearch_tpu.cli import bench_micro as jbench_micro
from spaghettisearch_tpu.ops.pagerank import _load_graph as jax_load_graph
from spaghettisearch_tpu.parallel import mesh as jmesh
from spaghettisearch_tpu.parallel import sharded as jsh
from spaghettisearch_tpu.retrieval.engine import QueryEngine as JaxEngine
from spaghettisearch_tpu.retrieval.engine import parse_query as jax_parse
from spaghettisearch_tpu_torch import corpus as tcorpus
from spaghettisearch_tpu_torch import graft_entry
from spaghettisearch_tpu_torch.cli import bench_micro
from spaghettisearch_tpu_torch.utils.timing import device_trace
from test_torch_crawl import assert_same_store
from test_torch_sharded import RTOL_JAX, _agree

torch.set_num_threads(1)

RTOL = 1e-6
RANK_RTOL = 1e-5


def _same_arrays(got, want, what: str) -> None:
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if dataclasses.is_dataclass(w):
            _same_arrays(g, w, f"{what}.{f.name}")
        elif isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and np.array_equal(g, w), f"{what}.{f.name}"
        else:
            assert g == w, f"{what}.{f.name}"


@pytest.mark.parametrize("seed,sizes", [
    (0, (2048, 1024, 16, 4, 256)),
    (5, (700, 300, 9, 3, 40)),
])
def test_synth_snapshot_equals_bench(seed, sizes):
    n_docs, n_words, body, title, max_df = sizes
    kw = dict(n_docs=n_docs, n_words=n_words, body_terms_per_doc=body,
              title_terms_per_doc=title, max_df=max_df, seed=seed)
    _same_arrays(tcorpus.synth_snapshot(**kw), bench.synth_snapshot(**kw), "snapshot")


@pytest.mark.parametrize("n_pages,seed", [(20, 0), (512, 3)])
def test_build_corpus_db_equals_tests_corpus(n_pages, seed):
    tdb = tcorpus.build_corpus_db(n_pages=n_pages, seed=seed, device="cpu")
    jdb = jcorpus.build_corpus_db(n_pages=n_pages, seed=seed)
    assert len(tdb.doc_info) >= n_pages
    assert_same_store(tdb, jdb)
    assert tcorpus.VOCAB == jcorpus.VOCAB
    for i in (0, 7):
        assert (tcorpus.make_page(random.Random(i), i, 30, "http://x")
                == jcorpus.make_page(random.Random(i), i, 30, "http://x"))


def _rows(scores, ids):
    return [[(int(d), float(s)) for s, d in zip(sr, ir) if np.isfinite(s)]
            for sr, ir in zip(np.asarray(scores), np.asarray(ids))]


def test_entry_matches_jax_twin():
    fn, args = graft_entry.entry(device="cpu")
    jfn, jargs = jentry.entry()
    assert all(a.device.type == "cpu" for a in args)
    for a, j in zip(args, jargs):
        assert np.array_equal(a.numpy(), np.asarray(j)), "example arguments differ"
    got, want = fn(*args), jfn(*jargs)
    assert tuple(got[0].shape) == (8, 10)
    _agree((got[0].numpy(), got[1].numpy()), (np.asarray(want[0]), np.asarray(want[1])), RTOL)
    assert sum(len(r) for r in _rows(*want)) > 0


@pytest.fixture(scope="module")
def dryrun():
    return graft_entry.dryrun_multichip(4, devices=["cpu"] * 4)


def test_dryrun_multichip_scorer_matches_jax(dryrun):
    """The port's scorer output against the JAX sharded scorer on the same
    2 x 2 mesh shape (the conftest's virtual CPU devices) and corpus."""
    jdb = jcorpus.build_corpus_db(n_pages=512, seed=3)
    eng = JaxEngine(jdb)
    mesh = jmesh.make_mesh2d(2, 2)
    sidx = jsh.ShardedIndex.from_snapshot(eng.snapshot, mesh)
    parsed = jax_parse('ranking "quantum physics" retrieval')
    term_ids = np.full((2, 4), eng.snapshot.n_words, np.int32)
    kw = eng.snapshot.term_ids(parsed.keyword_hashes)[:4]
    term_ids[:, : len(kw)] = kw
    qlen = np.full((2,), float(parsed.query_len), np.float32)
    tp = np.zeros((2, sidx.pagerank.shape[-1]), np.float32)
    ph_ids = np.full(4, eng.snapshot.n_words, np.int32)
    ph_valid = np.zeros(4, bool)
    pids = eng.snapshot.term_ids(parsed.phrase_hashes)
    ph_ids[: len(pids)] = pids
    ph_valid[: len(pids)] = True
    js, ji = jsh.make_sharded_scorer(sidx, topk=10)(
        sidx, term_ids, qlen, tp, ph_ids, ph_valid, np.int32(0))
    got = (dryrun["scores"].numpy(), dryrun["ids"].numpy())
    _agree(got, (np.asarray(js), np.asarray(ji)), RTOL_JAX)
    assert all(len(r) == 10 for r in _rows(*got))

    node_list, es, ed, od = jax_load_graph(jdb)
    want = np.asarray(jsh.sharded_pagerank(
        mesh, es, ed, od.astype(np.float32), np.array([float(len(node_list))], np.float32),
        len(node_list), eps=1e-8, max_iters=50))
    np.testing.assert_allclose(dryrun["ranks"].numpy(), want, rtol=RANK_RTOL, atol=0)


def test_dryrun_multichip_serves(dryrun):
    results = dryrun["results"]
    assert results and all(r["Url"].startswith("http://test.local/") for r in results)
    ranks = [r["FinalRank"] for r in results]
    assert ranks == sorted(ranks, reverse=True)


def test_entry_points_refuse_without_cuda(monkeypatch):
    """Each entry point defaults to the card and refuses to start without
    it (no fallback to the CPU)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.dryrun_multichip(2)
    with pytest.raises(SystemExit, match="CUDA is not available"):
        bench_micro.main(["--device"])


def test_device_trace_writes_a_trace(tmp_path):
    logdir = str(tmp_path / "trace")
    with device_trace(logdir):
        torch.ones(64).cumsum(0).sum()
    files = os.listdir(logdir)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(os.path.join(logdir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    assert any("cumsum" in e.get("name", "") for e in events)


def _row_names(out: str) -> list[str]:
    return [line[:42].strip() for line in out.splitlines() if line.endswith("/op")]


def test_bench_micro_prints_every_row(capsys):
    bench_micro.main(["--device", "cpu"])
    got = capsys.readouterr().out
    jbench_micro.main(["--device"])
    want = capsys.readouterr().out
    assert got.splitlines()[0] == want.splitlines()[0] == "store backend: mem"
    names = _row_names(got)
    assert names == _row_names(want) and len(names) == 11
    assert names[-1] == "intersect: device searchsorted"


@pytest.mark.parametrize("seed", range(6))
def test_py_intersect_matches_jax(seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 40, int(rng.integers(0, 60))).astype(float).tolist()
    b = rng.integers(0, 40, int(rng.integers(0, 60))).astype(float).tolist()
    got = bench_micro.py_intersect(a, b)
    assert got == jbench_micro.py_intersect(a, b)
    assert sorted(set(got)) == sorted(set(a) & set(b))
