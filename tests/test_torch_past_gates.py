"""The port's single-device engine and batcher past the residency and
segregation gates that the 2M tier crosses (HOT_MAX_DPAD and
FWD_DEV_MAX_DPAD at 1,400,000 padded docs, SEGREGATE_MIN_DOCS at 2^19),
on a small corpus with the gates set to 0, 0 and 1 in both packages: no
hot-term cache, the doc-major ft/fw/fj on the host until the sparse lane
first needs them, phrase-class batch segregation on. Top-50 against the
JAX engine in the same setup (ids up to ties, FinalRank rtol 1e-6)."""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

import spaghettisearch_tpu.retrieval.device_index as jdi
import spaghettisearch_tpu.retrieval.engine as jeng
import spaghettisearch_tpu_torch.retrieval.device_index as tdi
import spaghettisearch_tpu_torch.retrieval.engine as teng
from spaghettisearch_tpu.models.blended import BlendedRanker as JaxBlended
from spaghettisearch_tpu.retrieval.engine import QueryEngine as JaxEngine
from spaghettisearch_tpu_torch.corpus import bench_queries, write_corpus
from spaghettisearch_tpu_torch.models.blended import BlendedRanker
from spaghettisearch_tpu_torch.retrieval.engine import QueryEngine, parse_query
from spaghettisearch_tpu_torch.serve.batcher import MicroBatcher
from test_torch_engine import _check_rank

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def gated():
    """Both engines on one corpus with the gates crossed (module scope, so
    the constants are set by hand and restored after)."""
    mp = pytest.MonkeyPatch()
    for mod in (jdi, tdi):
        mp.setattr(mod, "HOT_MAX_DPAD", 0)
        mp.setattr(mod, "FWD_DEV_MAX_DPAD", 0)
    for mod in (jeng, teng):
        mp.setattr(mod, "SEGREGATE_MIN_DOCS", 1)
    db = write_corpus(None, n_pages=120, n_vocab=600, seed=4, device="cpu")
    eng, jax_eng = QueryEngine(db, device="cpu"), JaxEngine(db)
    queries = bench_queries(eng.snapshot, 32, seed=9, phrase_every=3, db=db)
    yield eng, jax_eng, queries
    mp.undo()


def _host_side(sec) -> bool:
    return all(isinstance(getattr(sec.fwd, n), np.ndarray) for n in ("ft", "fw", "fj"))


def test_engines_past_the_gates_match_jax(gated):
    eng, jax_eng, queries = gated
    assert eng.class_batching_pays() and jax_eng.class_batching_pays()
    idx = eng.index
    assert idx.hot_body_w is None and jax_eng.index.hot_body_w is None
    assert idx.pos_dense and eng.model.supports_mixed(idx)
    assert _host_side(idx.title) and _host_side(idx.body)
    assert sum('"' in q for q in queries) > 0
    _check_rank(jax_eng, eng, queries)  # the fused lane (K2) and the keyword lane (K1)
    _check_rank(jax_eng, eng, [q for q in queries if '"' not in q])
    assert _host_side(idx.title) and _host_side(idx.body)  # neither lane uploads them


def test_sparse_lane_uploads_the_forward_arrays_once(gated, monkeypatch):
    """A phrase under a custom blend takes the sparse lane, whose matcher
    reads ft/fj on the device: the first call uploads them, the next
    reuses them."""
    eng, jax_eng, queries = gated
    puts = []
    put = tdi._put
    monkeypatch.setattr(tdi, "_put", lambda a, dev: puts.append(a.shape) or put(a, dev))
    phrases = [q for q in queries if '"' in q]
    pt = [parse_query(q) for q in phrases]
    live = (eng.snapshot, eng.index, BlendedRanker(w_title=0.5))
    jlive = (jax_eng.snapshot, jax_eng.index, JaxBlended(w_title=0.5))
    from spaghettisearch_tpu.retrieval.engine import parse_query as jax_parse

    for _ in range(2):
        st, it = eng.rank(pt, live=live)
        sj, ij = jax_eng.rank([jax_parse(q) for q in phrases], live=jlive)
        for r in range(len(pt)):
            real = np.isfinite(sj[r])
            np.testing.assert_allclose(st[r][real], sj[r][real], rtol=1e-6)
            same = it[r][real] == ij[r][real]
            assert np.isclose(st[r][real][~same], sj[r][real][~same], rtol=1e-6).all()
    assert len(puts) == 6  # ft, fw, fj of two sections, once
    for sec in (eng.index.title, eng.index.body):
        assert not _host_side(sec) and sec.fwd_device() is sec.fwd


def test_batcher_auto_segregates_past_the_gate(gated):
    """segregate="auto" asks the engine, which now answers yes: every
    dispatched batch is class-pure and each answer equals the engine's."""
    eng = gated[0]
    recorded = []
    orig = eng.rank_async

    def recording(parsed, *a, **k):
        recorded.append([bool(p.phrase_hashes) for p in parsed])
        return orig(parsed, *a, **k)

    eng.rank_async = recording
    batcher = MicroBatcher(eng, max_batch=8, max_wait_ms=20, segregate="auto",
                           ph_patience_ms=10_000)
    try:
        queries = gated[2][:16]
        results = [None] * len(queries)

        def issue(i):
            results[i] = batcher.query(queries[i])

        threads = [threading.Thread(target=issue, args=(i,)) for i in range(len(queries))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert recorded and all(len(set(c)) == 1 for c in recorded), recorded
        assert batcher.stats.ph_batches >= 1 and batcher.stats.ph_batches < batcher.stats.batches
        for q, res in zip(queries, results):
            assert [r["Url"] for r in res] == [r["Url"] for r in eng.query(q)], q
    finally:
        batcher.shutdown()
        eng.rank_async = orig
