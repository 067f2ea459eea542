"""The plain reference against a brute-force scorer, the port's plain path
against the reference, and the control against the limits."""

from __future__ import annotations

import math
import re

import numpy as np
import pytest
import torch

from bench_util import CELLS, tiny_cell
from benchmark import collection, compare, control, reference, traffic


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


def brute_scores(coll, model, text: str, stop) -> np.ndarray:
    """Every doc's score by loops (float32 steps)."""
    vocab = {w: r for r, w in enumerate(coll.words())}
    phrases = [s[1:-1] for s in re.findall(r'".*?"', text)]
    stripped = text
    for p in phrases:
        stripped = stripped.replace('"' + p + '"', "", 1)
    toks = lambda s: [w.lower() for w in re.findall(r"[a-zA-Z0-9]+", s) if w.lower() not in stop]
    kw = [vocab.get(w) for w in toks(stripped)]
    ph = [vocab.get(w) for w in toks(" ".join(phrases))]
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
