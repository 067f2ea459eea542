"""The port's tracing on the CPU: the Tracer's spans, ranges and counters
against torch.profiler, the engine's dispatch spans and counters per lane,
the scoring stages' ranges nested under the launch, and the set-up spans
of the device index."""

from __future__ import annotations

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from spaghettisearch_tpu_torch.corpus import bench_queries, write_corpus
from spaghettisearch_tpu_torch.models.blended import BlendedRanker
from spaghettisearch_tpu_torch.retrieval.device_index import DeviceIndex
from spaghettisearch_tpu_torch.retrieval.engine import QueryEngine, parse_query
from spaghettisearch_tpu_torch.utils.timing import TRACER, Tracer

torch.set_num_threads(1)

ENGINE_SPANS = ("engine.pack", "engine.upload", "engine.launch")


def _profiled(fn):
    """fn() under a CPU torch.profiler -> the host events (name, start, end,
    is a user annotation)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), e.is_user_annotation())
            for e in prof.profiler.kineto_results.events()]


def _names(events) -> list[str]:
    return [n for n, *_ in events]


def test_span_is_a_profiler_range_only_while_a_profiler_records():
    t = Tracer()
    with t.span("t.off"):
        pass
    assert t.range("t.off") is t.range("t.other")  # the shared no-op: nothing allocated

    def body():
        with t.span("t.span"):
            with t.range("t.range"):
                torch.ones(4).sum()

    events = _profiled(body)
    assert _names(events).count("t.span") == 1 and _names(events).count("t.range") == 1
    assert "t.off" not in _names(events)
    # operator-scope ranges: the profiler makes no device-side copy of them
    assert not any(user for n, *_, user in events if n in ("t.span", "t.range"))
    (span,) = [(s, e) for n, s, e, _ in events if n == "t.span"]
    (rng,) = [(s, e) for n, s, e, _ in events if n == "t.range"]
    assert span[0] <= rng[0] and rng[1] <= span[1]
    rep = t.report()
    assert set(rep) == {"t.off", "t.span"}  # a range aggregates nothing
    assert rep["t.span"]["count"] == 1


def test_counters_in_report_and_reset():
    t = Tracer()
    with t.span("s"):
        pass
    t.count("c.batches")
    t.count("c.bytes", 4096)
    t.count("c.bytes", 1024)
    rep = t.report()
    assert set(rep["s"]) == {"count", "total_s", "mean_ms", "max_ms"}
    assert rep["c.batches"] == {"count": 1} and rep["c.bytes"] == {"count": 5120}
    assert list(rep) == ["s", "c.batches", "c.bytes"]
    t.reset()
    assert t.report() == {}


@pytest.fixture(scope="module")
def db():
    return write_corpus(None, n_pages=120, n_vocab=600, seed=4, device="cpu")


@pytest.fixture(scope="module")
def texts(db):
    from spaghettisearch_tpu_torch.index.snapshot import build_snapshot

    qs = bench_queries(build_snapshot(db), 40, seed=2, phrase_every=4, db=db)
    keyword = [q for q in qs if '"' not in q]
    phrase = [q for q in qs if '"' in q]
    assert len(keyword) >= 8 and len(phrase) >= 2
    return keyword, phrase


def _one_batch(eng, texts):
    parsed = [parse_query(t) for t in texts]
    TRACER.reset()
    eng.rank_async(parsed, topk=10).finish()
    return TRACER.report()


def _counters(rep, prefix):
    return {k: v["count"] for k, v in rep.items() if k.startswith(prefix)}


@pytest.mark.parametrize("lane", ["fused", "keyword"])
def test_rank_async_spans_and_counters(db, texts, lane):
    eng = QueryEngine(db, device="cpu")
    keyword, phrase = texts
    batch = keyword[:6] + phrase[:2] if lane == "fused" else keyword[:8]
    rep = _one_batch(eng, batch)
    for name in ENGINE_SPANS:
        assert rep[name]["count"] == 1, name
    assert "engine.phrase_match" not in rep and "rank.device" not in rep
    assert _counters(rep, "engine.lane.") == {f"engine.lane.{lane}": 1}
    p = 16 if lane == "fused" else 0
    assert _counters(rep, "engine.shape.") == {f"engine.shape.B16.Q4.P{p}": 1}
    uploads = rep["engine.uploads"]["count"]
    hot = eng.index.hot_body_w is not None
    assert uploads == (7 if lane == "fused" else 4) + 2 * hot
    # B=16 rows: int32/f32 columns of 4 B, the term ids [16, 4], topic probs
    # [16, C] and, in the fused lane, the phrase ids and flags [16, 16]
    c = eng.index.n_categories
    want = 16 * 4 * (4 + 1 + c + 1) + (16 * 4 * (16 + 16 + 1) if lane == "fused" else 0)
    want += 16 * 4 * (1 + 4) if hot else 0
    assert rep["engine.upload_bytes"]["count"] == want


@pytest.mark.parametrize("lane", ["sparse_phrase", "csr"])
def test_rank_async_other_lanes(db, texts, lane):
    eng = QueryEngine(db, device="cpu")
    if lane == "sparse_phrase":
        eng.index.body.posT = None
    else:
        eng.index.title.dense_truncated = True
    keyword, phrase = texts
    rep = _one_batch(eng, keyword[:6] + phrase[:2])
    assert rep["engine.phrase_match"]["count"] == 1
    for name in ENGINE_SPANS:
        assert rep[name]["count"] >= 1, name
    assert rep["engine.launch"]["count"] == 1
    assert _counters(rep, "engine.lane.") == {f"engine.lane.{lane}": 1}
    assert list(_counters(rep, "engine.shape.")) == ["engine.shape.B16.Q4.P4"]


def _inside(events, name, outer):
    """Every `name` range lies inside some `outer` range."""
    outs = [(s, e) for n, s, e, _ in events if n == outer]
    ins = [(s, e) for n, s, e, _ in events if n == name]
    return bool(ins) and all(any(a <= s and e <= b for a, b in outs) for s, e in ins)


@pytest.mark.parametrize("lane", ["fused", "keyword", "sparse_phrase"])
def test_scoring_ranges_nest_under_the_launch(db, texts, lane):
    eng = QueryEngine(db, device="cpu")
    if lane == "sparse_phrase":
        eng.index.body.posT = None
    keyword, phrase = texts
    parsed = [parse_query(t) for t in keyword[:6] + phrase[:2]
              if lane != "keyword" or '"' not in t]
    events = _profiled(lambda: eng.rank_async(parsed, topk=10).finish())
    stages = ["scoring.kernel", "scoring.finalize", "scoring.sqd", "scoring.topk"]
    stages += ["scoring.hot"] if eng.index.hot_body_w is not None else []
    stages += ["scoring.fold"] if lane == "sparse_phrase" else []
    for name in stages:
        assert _inside(events, name, "engine.launch"), name
    assert _inside(events, "scoring.sqd", "scoring.finalize")
    # the stand-in or the mixed lane's derivation of candidacy
    assert any(n == "scoring.counts" for n, *_ in events) or eng.index.has_zero_weight
    for name in ENGINE_SPANS:
        assert _names(events).count(name) >= 1


def test_custom_blend_and_csr_ranges(db, texts):
    keyword, phrase = texts
    parsed = [parse_query(t) for t in keyword[:6] + phrase[:2]]
    custom = QueryEngine(db, device="cpu", model=BlendedRanker(w_title=0.5))
    events = _profiled(lambda: custom.rank_async(parsed, topk=10).finish())
    for name in ("scoring.kernel", "scoring.fold", "scoring.finalize", "scoring.topk"):
        assert _inside(events, name, "engine.launch"), name
    trunc = QueryEngine(db, device="cpu")
    trunc.index.title.dense_truncated = True
    events = _profiled(lambda: trunc.rank_async(parsed, topk=10).finish())
    for name in ("scoring.csr", "scoring.finalize", "scoring.topk"):
        assert _inside(events, name, "engine.launch"), name
    assert _inside(events, "scoring.fold", "scoring.csr")


def test_device_index_setup_spans(db):
    eng = QueryEngine(db, device="cpu")
    TRACER.reset()
    index = DeviceIndex.from_snapshot(eng.snapshot, "cpu")
    rep = TRACER.report()
    for name in ("index.sort", "index.title", "index.body"):
        assert rep[name]["count"] == 1, name
    assert ("index.hot" in rep) == (index.hot_body_w is not None)
