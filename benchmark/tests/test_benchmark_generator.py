"""The generators: determinism per seed, the configurations' stated shapes,
the traffic mixes' stated shapes, and the snapshot against its tokens."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from bench_util import CELLS, tiny_cell
from benchmark import collection, traffic


@pytest.fixture(scope="module")
def shards():
    out = {}
    for name in CELLS:
        cell = tiny_cell(name, body_words=None)
        out[name] = (cell, collection.generate(cell["config_data"], 17, "cpu"))
    return out


def test_same_seed_same_shard_and_stream():
    cell = tiny_cell("lucene-mixed")
    a = collection.generate(cell["config_data"], 3, "cpu")
    b = collection.generate(cell["config_data"], 3, "cpu")
    c = collection.generate(cell["config_data"], 4, "cpu")
    assert np.array_equal(a.body.tok, b.body.tok) and np.array_equal(a.title.tok, b.title.tok)
    for f in ("doc_ids", "weights", "positions", "post_offsets"):
        assert np.array_equal(getattr(a.snapshot.body, f), getattr(b.snapshot.body, f))
    assert not np.array_equal(a.body.tok, c.body.tok)
    s1 = traffic.make_stream(cell["traffic_data"], a, 300, 3)
    s2 = traffic.make_stream(cell["traffic_data"], b, 300, 3)
    assert s1.texts == s2.texts
    assert s1.texts != traffic.make_stream(cell["traffic_data"], a, 300, 4).texts


@pytest.mark.parametrize("name", CELLS)
def test_configuration_shapes(shards, name):
    cell, coll = shards[name]
    cfg = cell["config_data"]
    lengths = (coll.body.tok >= 0).sum(axis=1)
    want = cfg["body_words"] * cfg["content_share"]
    assert abs(lengths.mean() - want) < 0.03 * want
    t_len = (coll.title.tok >= 0).sum(axis=1)
    lo, hi = cfg["title_words"]
    assert t_len.min() >= lo and t_len.max() <= hi
    assert abs(t_len.mean() - (lo + hi) / 2) < 0.15
    if cfg.get("title_run_mean"):
        _, counts = np.unique(coll.title.tok, axis=0, return_counts=True)
        assert abs(coll.n_docs / len(counts) - cfg["title_run_mean"]) < 0.15 * cfg["title_run_mean"]
    # every rank in a doc's section is counted once in df
    assert coll.body.df.sum() == coll.body.n_postings


@pytest.mark.parametrize("name", CELLS)
def test_zipf_head_is_the_stopword_list(name):
    """Content words take the Zipf ranks after the stopwords, whose share of
    the tokens matches the configuration's content share."""
    cfg = tiny_cell(name)["config_data"]
    head = cfg["zipf_head_ranks"]
    assert head == len(traffic.stopwords())
    r = np.arange(1, head + 1_000_000 + 1, dtype=np.float64) ** -cfg["zipf_s"]
    assert abs(1 - r[:head].sum() / r.sum() - cfg["content_share"]) < 0.01


def test_tokens_are_fixed_points_of_the_ports_parse():
    from spaghettisearch_tpu_torch.text.laundry import laundry

    for r in list(range(2000)) + [99_999, 999_999]:
        w = collection.word_string(r)
        assert laundry(w) == [w]
    for w in traffic.stopwords():
        assert laundry(w) == [], w


@pytest.mark.parametrize("name", CELLS)
def test_snapshot_follows_the_tokens(shards, name):
    """Each posting of the snapshot: its doc holds the word at exactly its
    positions, with the build's normTF x idf weight."""
    _, coll = shards[name]
    snap = coll.snapshot
    rank_of_id = np.empty(snap.n_words, np.int64)
    present = np.flatnonzero(coll.word_id >= 0)
    rank_of_id[coll.word_id[present]] = present
    assert list(snap.word_hashes) == sorted(snap.word_hashes)
    assert list(snap.doc_hashes) == sorted(snap.doc_hashes)
    rng = np.random.default_rng(0)
    for sec_name in ("title", "body"):
        csr, sec = snap.section(sec_name), getattr(coll, sec_name)
        assert csr.n_postings == sec.n_postings
        for j in rng.integers(0, csr.n_postings, 300).tolist():
            wid = int(np.searchsorted(csr.post_offsets, j, side="right") - 1)
            doc, r = int(csr.doc_ids[j]), int(rank_of_id[wid])
            row = sec.tok[doc]
            want = np.flatnonzero(row == r).astype(np.float32)
            got = csr.positions[csr.pos_offsets[j]: csr.pos_offsets[j + 1]]
            assert np.array_equal(got, want)
            tf = np.bincount(row[row >= 0])
            ntf = np.float32(len(want) / tf.max())
            idf = np.float32(np.log2(coll.n_docs / sec.df[r]))
            assert csr.weights[j] == np.float32(ntf * idf)


def test_lucene_mix_shapes(shards):
    cell, coll = shards["lucene-mixed"]
    s = traffic.make_stream(cell["traffic_data"], coll, 128 * 40, 5)
    share = np.mean([len(p) > 0 for p in s.ph])
    assert abs(share - 1 / 3) < 0.04
    for i in range(0, len(s), 128):
        assert any(len(p) for p in s.ph[i: i + 128])  # every batch takes the fused lane
    bounds = cell["traffic_data"]["df_classes"]
    for name, kw, ph, c in zip(s.texts, s.kw, s.ph, s.cls):
        cls = s.class_names[c]
        if cls.endswith("Phrase"):
            assert name.startswith('"') and len(ph) == 2 and len(kw) == 0
            lo, hi = bounds[cls[: -len("Phrase")]]
            share_df = coll.body.df[ph].min() / coll.n_docs
            assert lo <= share_df and (share_df < hi or hi >= 1.0)
            # an adjacent pair of some doc's body
            toks = coll.body.tok
            assert ((toks[:, :-1] == ph[0]) & (toks[:, 1:] == ph[1])).any()


def test_nq_mix_shapes(shards):
    cell, coll = shards["nq-questions"]
    s = traffic.make_stream(cell["traffic_data"], coll, 128 * 60, 5)
    words = np.array([len(t.split()) for t in s.texts])
    assert abs(words.mean() - 9.16) < 0.2 and words.max() <= 30 and words.min() >= 3
    kw = np.array([len(k) for k in s.kw])
    assert kw.min() >= 1
    assert abs(1 - kw.sum() / words.sum() - 0.45) < 0.03
    catch_all = np.mean([max(len(k) for k in s.kw[i: i + 128]) > 4
                         for i in range(0, len(s), 128)])
    assert catch_all > 0.95
    assert all(len(p) == 0 for p in s.ph)


@pytest.mark.parametrize("name", CELLS)
def test_run_seed_reorders_the_same_work(name):
    """With the cell's content seed, two run seeds give the same documents
    and queries under other doc ids, word labels and arrival orders."""
    cell = tiny_cell(name)
    cs = cell["content_seed"]
    a = collection.generate(cell["config_data"], 5, "cpu", content_seed=cs)
    b = collection.generate(cell["config_data"], 6, "cpu", content_seed=cs)
    assert not np.array_equal(a.body.tok, b.body.tok)
    assert not np.array_equal(a.labels, b.labels)
    for sec in ("title", "body"):
        ta, tb = getattr(a, sec), getattr(b, sec)
        assert np.array_equal(ta.df, tb.df) and ta.n_postings == tb.n_postings
        # doc for doc (by content index), the same token rows
        assert np.array_equal(ta.tok[a.row_of], tb.tok[b.row_of])
    assert a.snapshot.body.max_positions == b.snapshot.body.max_positions
    n = traffic.BLOCK * 2  # whole blocks: each is permuted whole
    sa = traffic.make_stream(cell["traffic_data"], a, n, 5, content_seed=cs)
    sb = traffic.make_stream(cell["traffic_data"], b, n, 6, content_seed=cs)
    key = lambda s, i: (int(s.cls[i]), tuple(s.kw[i].tolist()), tuple(s.ph[i].tolist()))
    assert [key(sa, i) for i in range(n)] != [key(sb, i) for i in range(n)]
    for lo in range(0, n, traffic.BLOCK):
        hi = min(lo + traffic.BLOCK, n)
        assert sorted(key(sa, i) for i in range(lo, hi)) == sorted(key(sb, i) for i in range(lo, hi))
    # the texts spell each run's own labels
    assert sa.texts != sb.texts


@pytest.mark.parametrize("name", CELLS)
def test_cursor_draws_the_stream_part_by_part(shards, name):
    """The loop's cursor, drawing one part of a block after each batch,
    gives the stream that whole blocks give, and keeps its next batch drawn
    ahead, so that `take` never draws inside the window."""
    cell, coll = shards[name]
    flow = traffic.Traffic(cell["traffic_data"], coll, 7, content_seed=cell["content_seed"])
    cur = traffic.Cursor(flow, 1)
    cur.take(0, traffic.BLOCK)
    pos = 0
    for _ in range(30):
        drawn = (cur.next, len(cur.parts))
        assert len(cur.take(pos, 128)) == 128
        assert (cur.next, len(cur.parts)) == drawn  # take drew nothing
        pos += 128
        cur.prefetch(pos)
    whole = traffic.make_stream(cell["traffic_data"], coll, pos, 7,
                                content_seed=cell["content_seed"], first=1)
    assert cur.stream.texts[:pos] == whole.texts
    assert all(np.array_equal(a, b) for a, b in zip(cur.stream.kw, whole.kw))
    assert np.array_equal(cur.stream.cls[:pos], whole.cls)


@pytest.mark.parametrize("name", CELLS)
def test_feed_gives_the_stream_from_its_child(shards, name):
    """The window's feed, drawn by a child process, gives the stream that
    whole blocks give, texts and ranks alike; its child has ended once it
    is closed, and a feed of a few blocks ends there."""
    cell, coll = shards[name]
    flow = traffic.Traffic(cell["traffic_data"], coll, 7, content_seed=cell["content_seed"])
    feed = traffic.Feed(flow, 1)
    pos = 0
    for _ in range(30):
        assert len(feed.take(pos, 128)) == 128
        pos += 128
        feed.prefetch(pos)
    feed.close()
    assert not feed._proc.is_alive() and feed._proc.exitcode == 0
    whole = traffic.make_stream(cell["traffic_data"], coll, pos, 7,
                                content_seed=cell["content_seed"], first=1)
    got = feed.stream
    assert got.texts[:pos] == whole.texts
    assert all(np.array_equal(a, b) for a, b in zip(got.kw, whole.kw))
    assert all(np.array_equal(a, b) for a, b in zip(got.ph, whole.ph))
    assert np.array_equal(got.cls[:pos], whole.cls)
    assert len(got.kw) == len(got.ph) == len(got.texts) == got.cls.size
    short = traffic.Feed(flow, 1, 2)
    assert len(short.take(0, 10 * traffic.BLOCK)) == 2 * traffic.BLOCK and short.ended
    short.close()
    assert short._proc.exitcode == 0
