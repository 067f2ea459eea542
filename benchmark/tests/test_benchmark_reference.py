"""The plain references (the blend's and BM25's) against brute-force
scorers, the port's plain path against each, the controls against the
limits, and the configuration's `reference` key."""

from __future__ import annotations

import math
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from bench_util import CELLS, tiny_cell
from benchmark import collection, compare, control, reference, reference_bm25, run, traffic

BM25_REF = "benchmark.reference_bm25:Reference"
BM25_RANKER = "spaghettisearch_tpu_torch.models.bm25:BM25Ranker"
BLEND_RANKER = "spaghettisearch_tpu_torch.models.blended:BlendedRanker"


def brute_model(coll):
    """Per section and doc: the token list, its word weights (float32 steps)
    and its magnitude, by loops over the token lists."""
    n = coll.n_docs
    model = {}
    for name in ("title", "body"):
        rows = [[int(x) for x in r if x >= 0] for r in getattr(coll, name).tok]
        df = {}
        for r in rows:
            for w in set(r):
                df[w] = df.get(w, 0) + 1
        docs = []
        for row in rows:
            tf = {w: row.count(w) for w in set(row)}
            mx = max(tf.values())
            wt = {w: np.float32(np.float32(c / mx) * np.float32(math.log2(n / df[w])))
                  for w, c in tf.items()}
            mag = np.float32(math.sqrt(sum(float(v) ** 2 for v in wt.values())))
            docs.append((row, wt, mag))
        model[name] = docs
    return model


def brute_parse(coll, text: str, stop) -> tuple[list, list]:
    """-> (keyword ranks, phrase chain ranks), None for an unknown word."""
    vocab = {w: r for r, w in enumerate(coll.words())}
    phrases = [s[1:-1] for s in re.findall(r'".*?"', text)]
    stripped = text
    for p in phrases:
        stripped = stripped.replace('"' + p + '"', "", 1)
    toks = lambda s: [w.lower() for w in re.findall(r"[a-zA-Z0-9]+", s) if w.lower() not in stop]
    return [vocab.get(w) for w in toks(stripped)], [vocab.get(w) for w in toks(" ".join(phrases))]


def brute_scores(coll, model, text: str, stop) -> np.ndarray:
    """Every doc's score by loops (float32 steps)."""
    kw, ph = brute_parse(coll, text, stop)
    out = np.full(coll.n_docs, -np.inf, np.float32)
    for d in range(coll.n_docs):
        score, mag, cand = {}, {}, False
        for name, docs in model.items():
            row, wt, mag[name] = docs[d]
            s = np.float32(0)
            for w in kw:
                if w in wt:
                    s = np.float32(s + wt[w])
                    cand = True
            if ph and None not in ph:
                k = len(ph)
                if any(row[i: i + k] == ph for i in range(len(row) - k + 1)):
                    cand = True
                    t = np.float32(0)
                    for w in ph:
                        t = np.float32(t + wt[w])
                    s = np.float32(s + t)
            score[name] = s
        if not cand:
            continue
        q = np.float32(math.sqrt(len(kw) + len(ph)))
        tn = np.float32(score["title"] / np.float32(mag["title"] * q))
        bn = np.float32(score["body"] / np.float32(mag["body"] * q))
        out[d] = np.float32((np.float32(0.38) * tn + np.float32(0.29) * bn) * np.float32(100))
    return out


def brute_bm25_model(coll):
    """Per section and doc: the token list and its words' BM25 weights, by
    loops over the token lists (f64 steps, each weight rounded to f32)."""
    n, k1, b = coll.n_docs, 1.2, 0.75
    model = {}
    for name in ("title", "body"):
        rows = [[int(x) for x in r if x >= 0] for r in getattr(coll, name).tok]
        df = {}
        for r in rows:
            for w in set(r):
                df[w] = df.get(w, 0) + 1
        avgdl = sum(len(r) for r in rows) / n
        docs = []
        for row in rows:
            wt = {}
            for w in set(row):
                tf, idf = row.count(w), math.log((n - df[w] + 0.5) / (df[w] + 0.5) + 1.0)
                wt[w] = np.float32(idf * tf * (k1 + 1.0)
                                   / (tf + k1 * (1.0 - b + b * len(row) / avgdl)))
            docs.append((row, wt))
        model[name] = docs
    return model


def brute_bm25_scores(coll, model, text: str, stop) -> np.ndarray:
    """Every doc's BM25 score by loops (float32 steps)."""
    kw, ph = brute_parse(coll, text, stop)
    out = np.full(coll.n_docs, -np.inf, np.float32)
    for d in range(coll.n_docs):
        score, cand = {}, False
        for name, docs in model.items():
            row, wt = docs[d]
            s = np.float32(0)
            for w in kw:
                if w in wt:
                    s = np.float32(s + wt[w])
                    cand = True
            if ph and None not in ph:
                k = len(ph)
                if any(row[i: i + k] == ph for i in range(len(row) - k + 1)):
                    cand = True
                    t = np.float32(0)
                    for w in ph:
                        t = np.float32(t + wt[w])
                    s = np.float32(s + t)
            score[name] = s
        if cand:
            out[d] = np.float32(np.float32(2.0) * score["title"] + score["body"])
    return out


def bm25_cell(name: str, ranker: str = BM25_RANKER, **kw) -> dict:
    """A tiny cell whose configuration is checked against BM25's reference."""
    cell = tiny_cell(name, **kw)
    cell["config_data"].update(reference=BM25_REF, ranker=ranker)
    return cell


@pytest.mark.parametrize("name", CELLS)
def test_reference_against_brute_force(name):
    cell = tiny_cell(name, body_words=40)
    coll = collection.generate(cell["config_data"], 8, "cpu", snapshot=False)
    stream = traffic.make_stream(cell["traffic_data"], coll, 45, 8)
    model = brute_model(coll)
    stop = traffic.stopwords()
    ref = reference.Reference(coll.title.tok, coll.body.tok,
                              coll.words(),
                              stop, "cpu")
    stop = set(stop)
    for text in stream.texts:
        got = ref.scores(text).numpy()
        want = brute_scores(coll, model, text, stop)
        assert np.array_equal(np.isfinite(got), np.isfinite(want)), text
        fin = np.isfinite(want)
        np.testing.assert_allclose(got[fin], want[fin], rtol=2e-6, atol=1e-6)


@pytest.mark.parametrize("name", CELLS)
def test_ports_plain_path_against_reference(name):
    from spaghettisearch_tpu_torch.retrieval.engine import QueryEngine, parse_query
    from spaghettisearch_tpu_torch.store.tables import Database

    cell = tiny_cell(name)
    coll = collection.generate(cell["config_data"], 9, "cpu")
    stream = traffic.make_stream(cell["traffic_data"], coll, 256, 9)
    eng = QueryEngine(db=Database(None), snapshot=coll.snapshot, device="cpu")
    assert eng.index.hot_body_w is not None  # the hot split is on, as at full size
    ref = reference.Reference(coll.title.tok, coll.body.tok,
                              coll.words(),
                              traffic.stopwords(), "cpu")
    for i in range(0, 256, 128):
        texts = stream.texts[i: i + 128]
        scores, ids = eng.rank([parse_query(t) for t in texts], topk=50)
        rows = [compare.gaps(s, d, ref.scores(t)) for s, d, t in zip(scores, ids, texts)]
        worst = compare.worst(rows)
        assert worst["score_gap"] <= 1e-6 and worst["id_gap"] <= 1e-6, worst


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_limits(name):
    """The reference in bfloat16 in the port's place reads above a limit."""
    cell = tiny_cell(name)
    worst = control.control_readings(cell, 21, 600, "cpu")
    assert any(worst[n] > cell["limits"][n] for n in compare.NUMBERS), worst


def test_gaps_catch_wrong_rows():
    final = torch.tensor([5.0, 4.0, 4.0, 3.0, -float("inf")])
    vals, ids = reference.top_k(final, 4)
    assert compare.gaps(vals, ids, final) == {"score_gap": 0.0, "id_gap": 0.0}
    # tied docs may trade places
    assert compare.gaps(vals, torch.tensor([0, 2, 1, 3]), final)["id_gap"] == 0.0
    # a doc out of its rank, a doc that is no candidate, a doc twice
    assert compare.gaps(vals, torch.tensor([0, 3, 1, 2]), final)["id_gap"] > 0.2
    assert compare.gaps(vals, torch.tensor([0, 4, 1, 3]), final)["id_gap"] == compare.MISMATCH
    assert compare.gaps(vals, torch.tensor([0, 0, 1, 3]), final)["id_gap"] == compare.MISMATCH
    # a rank filled on one side only
    short = torch.tensor([5.0, 4.0, 4.0, -float("inf")])
    assert compare.gaps(short, ids, final)["score_gap"] == compare.MISMATCH


@pytest.mark.parametrize("name", CELLS)
def test_bm25_reference_against_brute_force(name):
    cell = tiny_cell(name, body_words=40)
    coll = collection.generate(cell["config_data"], 8, "cpu", snapshot=False)
    stream = traffic.make_stream(cell["traffic_data"], coll, 45, 8)
    assert any('"' in t for t in stream.texts) == (name == "lucene-mixed")
    stop = traffic.stopwords()
    model = brute_bm25_model(coll)
    ref = reference_bm25.Reference(coll.title.tok, coll.body.tok, coll.words(), stop, "cpu")
    for text in stream.texts:
        got = ref.scores(text).numpy()
        want = brute_bm25_scores(coll, model, text, set(stop))
        assert np.array_equal(np.isfinite(got), np.isfinite(want)), text
        fin = np.isfinite(want)
        np.testing.assert_allclose(got[fin], want[fin], rtol=2e-6, atol=1e-6)


@pytest.mark.parametrize("name", CELLS)
def test_ports_bm25_against_bm25_reference(name):
    """The port's BM25Ranker through QueryEngine.rank, phrase rows through
    the sparse phrase lane, against the BM25 reference."""
    from spaghettisearch_tpu_torch.models.bm25 import BM25Ranker
    from spaghettisearch_tpu_torch.retrieval.engine import QueryEngine, parse_query
    from spaghettisearch_tpu_torch.store.tables import Database

    cell = tiny_cell(name)
    coll = collection.generate(cell["config_data"], 9, "cpu")
    stream = traffic.make_stream(cell["traffic_data"], coll, 256, 9)
    eng = QueryEngine(db=Database(None), snapshot=coll.snapshot, device="cpu",
                      model=BM25Ranker())
    ref = reference_bm25.Reference(coll.title.tok, coll.body.tok, coll.words(),
                                   traffic.stopwords(), "cpu")
    n_phrase = 0
    for i in range(0, 256, 128):
        texts = stream.texts[i: i + 128]
        parsed = [parse_query(t) for t in texts]
        n_phrase += sum(bool(p.phrase_hashes) for p in parsed)
        scores, ids = eng.rank(parsed, topk=50)
        rows = [compare.gaps(s, d, ref.scores(t)) for s, d, t in zip(scores, ids, texts)]
        worst = compare.worst(rows)
        assert worst["score_gap"] <= 1e-6 and worst["id_gap"] <= 1e-6, worst
    assert (n_phrase > 0) == (name == "lucene-mixed")


@pytest.mark.parametrize("name", CELLS)
def test_bm25_control_fails_the_limits(name):
    """BM25's reference in bfloat16 in the port's place reads above a
    limit."""
    cell = bm25_cell(name)
    worst = control.control_readings(cell, 21, 600, "cpu")
    assert any(worst[n] > cell["limits"][n] for n in compare.NUMBERS), worst


@pytest.mark.parametrize("ranker, correct", [(BM25_RANKER, True), (BLEND_RANKER, False)],
                         ids=["bm25", "blend"])
@pytest.mark.parametrize("name", CELLS)
def test_run_checks_against_the_configurations_reference(name, ranker, correct):
    """Through run_cell: the port's BM25 under BM25's reference is correct;
    the blend under it is not, so the configuration's reference is the one
    a run uses."""
    cell = bm25_cell(name, ranker)
    result, checks = run.run_cell(cell, 33, 60.0, False, "cpu", n_check=128,
                                  window_blocks=1)
    assert result["attempted"] == 1024 and result["failed"] == 0
    assert result["correct"] is correct, checks


@pytest.mark.parametrize("spec", ["spaghettisearch_tpu_torch.oracle:Oracle",
                                  "benchmark_extra.reference:Reference",
                                  "benchmark.reference", 7])
def test_reference_outside_the_benchmark_is_refused(spec, monkeypatch):
    load = run.load_json

    def fake(kind, name):
        data = load(kind, name)
        return {**data, "reference": spec} if kind == "configs" else data

    monkeypatch.setattr(run, "load_json", fake)
    with pytest.raises(ValueError, match="'reference'"):
        run.load_cell("lucene-mixed")


def test_defaults_without_the_new_keys(monkeypatch):
    """A configuration without `reference` is checked against the blend's
    reference, and its ranker is built with no arguments."""
    cell = tiny_cell("nq-questions")
    cfg = cell["config_data"]
    assert "reference" not in cfg
    assert run.reference_spec(cfg) == "benchmark.reference:Reference"
    coll = collection.generate(cfg, 5, "cpu", snapshot=False)
    ref = run.make_reference(cfg, coll, "cpu")
    assert type(ref) is reference.Reference and ref.dtype == torch.float32
    calls = []
    monkeypatch.setattr(run, "_load", lambda spec: lambda *a, **kw: calls.append((spec, a, kw)))
    run._ranker(cfg["ranker"])
    assert calls == [(BLEND_RANKER, (), {})]


def test_bm25_reference_imports_nothing_of_the_port():
    code = ("import sys\n"
            "import benchmark.reference_bm25\n"
            "print('FOUND', sorted(m for m in sys.modules\n"
            "      if m.split('.')[0].startswith('spaghettisearch_tpu')))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=run.ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "FOUND []" in proc.stdout
