"""K6's plain version (phrase_delta's CPU route) against the TPU prototype it
replaces, experiments/phrase_delta_probe.py pallas_phrase_delta in
interpret mode, on the JAX tests' fixture corpora with the int16 planes of
quantize_posT (and their f32 dequantization), both layouts, emit_flag on
and off, and a batch whose last 8-row block has no phrase (pn == 0: the
prototype's zero-trip block, K6's skipped row tile): add_t / add_b within
rtol 1e-6 (the JAX package's kernel-vs-twin bar), the flag exact.

Then the split composition of the phrase-delta probe (K1 with the
doc-sorted bound, K6 on the phrase rows, the hot fold, candidacy from
scores, finalize, top-50) against the port's score_queries_mixed (K2):
ids equal, scores within rtol 1e-6; and the torch probe script at a tiny
corpus on the CPU, with its own exactness check.
"""

from __future__ import annotations

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spaghettisearch_tpu.ops.kernels.mixed import _deq_posT
from spaghettisearch_tpu_torch.ops.kernels import check
from spaghettisearch_tpu_torch.ops.kernels import mixed as k2
from spaghettisearch_tpu_torch.ops.kernels import phrase_delta as k6
from test_torch_membership import (  # noqa: F401 — module fixtures
    RTOL,
    _indexes,
    _np,
    bench_snap,
    crawl_snap,
)
from test_torch_mixed import _phrase_batch

EXPERIMENTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "experiments")
sys.path.insert(0, EXPERIMENTS)

from phrase_delta_probe import pallas_phrase_delta  # noqa: E402

torch.set_num_threads(1)


def _batch(snap, seed):
    """16 rows, phrase rows first, the last 8 without a phrase."""
    _, _, _, ph_ids, ph_valid, pn = _phrase_batch(snap, 16, 16, seed)
    ph_ids[8:] = snap.n_words
    ph_valid[8:] = 0.0
    pn[8:] = 0
    return ph_ids, ph_valid, pn


@pytest.mark.parametrize("emit_flag", [True, False])
@pytest.mark.parametrize("which,doc_sort,planes", [
    ("crawl", False, "int16"),
    ("crawl", True, "f32"),
    ("bench", False, "f32"),
    ("bench", True, "int16"),
])
def test_phrase_delta_plain_matches_pallas_prototype(crawl_snap, bench_snap, which, doc_sort,
                                                     planes, emit_flag):
    snap = crawl_snap if which == "crawl" else bench_snap
    jdx, tdx = _indexes(snap, doc_sort)
    assert tdx.body.posT.dtype == torch.int16
    ph_ids, ph_valid, pn = _batch(snap, seed=5)
    tpos, bpos = jdx.title.posT, jdx.body.posT
    ttp, tbp = tdx.title.posT, tdx.body.posT
    if planes == "f32":
        tpos, bpos = _deq_posT(tpos), _deq_posT(bpos)
        ttp, tbp = k2.deq_posT(ttp), k2.deq_posT(tbp)
    want = pallas_phrase_delta(
        jdx.title.fwd.ftT, jdx.title.fwd.fwT, jdx.body.fwd.ftT, jdx.body.fwd.fwT, tpos, bpos,
        jnp.asarray(ph_ids), jnp.asarray(ph_valid), jnp.asarray(pn),
        doc_block=256, emit_flag=emit_flag, interpret=True,
    )
    got = k6.phrase_delta(
        tdx.title.fwd.ftT, tdx.title.fwd.fwT, tdx.body.fwd.ftT, tdx.body.fwd.fwT, ttp, tbp,
        *(torch.from_numpy(a) for a in (ph_ids, ph_valid, pn)), emit_flag=emit_flag,
    )
    assert len(want) == (3 if emit_flag else 2) and (got[2] is None) == (not emit_flag)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _np(w), rtol=RTOL, atol=0.0)
    if emit_flag:
        assert np.array_equal(got[2].numpy(), _np(want[2]))
        assert got[2].sum() > 0  # some phrase matched
    assert not got[0][8:].any() and not got[1][8:].any()  # pn == 0 rows


@pytest.mark.parametrize("doc_sort", [False, True])
def test_plain_mixed_is_keywords_plus_phrase_delta(bench_snap, doc_sort):
    """K2's plain version is K1's plain version plus K6's (the flag in the
    title count), exactly: the factoring both share."""
    _, tdx = _indexes(bench_snap, doc_sort)
    df = np.diff(bench_snap.body.post_offsets).astype(np.float64)
    batch = check.to_device(check.mixed_batch(tdx, 32, 4, 16, seed=3, df=df, snap=bench_snap),
                            "cpu")
    t, bd = tdx.title, tdx.body
    fwd = (t.fwd.ftT, t.fwd.fwT, bd.fwd.ftT, bd.fwd.fwT)
    mixed = k2.plain_mixed_scores(*fwd, t.posT, bd.posT, batch["term_ids"], batch["ph_ids"],
                                  batch["ph_valid"], qnb=batch["qnb"])
    kw = check.run_k1(tdx, batch, True, body_tmax=doc_sort, plain=True)
    add_t, add_b, flag = k6.phrase_delta(*fwd, t.posT, bd.posT, batch["ph_ids"],
                                         batch["ph_valid"], batch["pn"], emit_flag=True)
    assert flag.sum() > 0
    for got, want in zip(mixed, (kw[0] + add_t, kw[1] + flag, kw[2] + add_b, kw[3])):
        assert torch.equal(got, want)


@pytest.mark.parametrize("doc_sort", [False, True])
def test_split_program_matches_score_queries_mixed(bench_snap, doc_sort):
    """The probe's split program (K1 + K6 on the phrase rows, bp = every
    phrase row, and bp = the whole batch) ranks the top-50 of the fused
    mixed lane: ids equal, scores within rtol 1e-6."""
    import torch_phrase_delta_probe as probe

    _, tdx = _indexes(bench_snap, doc_sort)
    assert not tdx.has_zero_weight and tdx.pos_dense
    df = np.diff(bench_snap.body.post_offsets).astype(np.float64)
    batch = check.to_device(check.mixed_batch(tdx, 64, 4, 16, seed=4, df=df, snap=bench_snap),
                            "cpu")
    batch["qlen"] = batch["qn"].clamp(min=1).to(torch.float32)
    tp = torch.zeros((64, tdx.n_categories))
    want_s, want_i = probe.control_rank(tdx, batch, tp)
    n_ph = int((batch["pn"] > 0).sum())
    assert 0 < n_ph < 64
    for bp in (n_ph, 64):
        got_s, got_i = probe.split_rank(tdx, batch, tp, bp, True)
        assert torch.equal(got_i, want_i)
        np.testing.assert_allclose(got_s.numpy(), want_s.numpy(), rtol=1e-6)
    # without the phrase rows' adds the ranks differ (the phrases matter)
    kw_s, kw_i = probe.split_rank(tdx, batch, tp, n_ph, False)
    assert not torch.equal(kw_i[:n_ph], want_i[:n_ph])


def test_torch_phrase_delta_probe_runs_on_cpu(tmp_path, monkeypatch):
    """experiments/torch_phrase_delta_probe.py on a 2,000-page benchmark
    corpus (built by the port's bench in a subprocess) with --device cpu:
    both splits equal the control (ids equal, rtol 1e-6)."""
    import torch_phrase_delta_probe as probe

    from spaghettisearch_tpu_torch import bench

    monkeypatch.setattr(bench, "BENCH_DIR", str(tmp_path))
    res = probe.main(["2000", "--device", "cpu", "--reps", "1"])
    assert res["ok"], res
    assert res["phrase_rows"] > 0 and res["launches"] == {"K1": 0, "K2": 0, "K6": 0}
    splits = [r for k, r in res["runs"].items() if "split" in k]
    assert len(splits) == 2 and all(r["exact"] for r in splits)


def test_phrase_delta_plane_bucket_and_tile_rows():
    """The chain check's compiled plane counts: the smallest bucket that
    holds C, none past 32; 16-row tiles for batches of at most 16 rows,
    32 otherwise."""
    assert [k6.plane_bucket(c) for c in (1, 3, 4, 5, 7, 8, 9, 16, 17, 32)] == [
        4, 4, 4, 8, 8, 8, 16, 16, 32, 32]
    for c in (0, 33):
        with pytest.raises(ValueError):
            k6.plane_bucket(c)
    assert [k6.tile_rows(b) for b in (1, 16, 17, 128)] == [16, 16, 32, 32]


@pytest.mark.parametrize("seed", [0, 1])
def test_phrase_delta_partition(bench_snap, seed):
    """plain_phrase_rows (the kernel's partition): phrase rows first, then
    the others, each in batch order, the others' slots invalid; the plain
    phrase delta of the partitioned batch, put back in batch order, is the
    batch's own, exactly; and the tables built over it (the build K6's
    entry point launches) hold entries of phrase rows only."""
    from spaghettisearch_tpu_torch.ops.kernels import probe

    _, tdx = _indexes(bench_snap, False)
    df = np.diff(bench_snap.body.post_offsets).astype(np.float64)
    batch = check.to_device(check.mixed_batch(tdx, 48, 4, 16, seed=seed, df=df, snap=bench_snap),
                            "cpu")
    perm = torch.from_numpy(np.random.default_rng(seed).permutation(48))
    ph_ids, ph_valid = batch["ph_ids"][perm], batch["ph_valid"][perm]
    ph_valid[5, 0] = 0.0  # a later slot valid, slot 0 not: no phrase
    ph_valid[5, 1] = 1.0
    row_map, ids, valid, n = k6.plain_phrase_rows(ph_ids, ph_valid)
    has = ph_valid[:, 0] > 0
    assert n == int(has.sum()) and 0 < n < 48
    assert sorted(row_map.tolist()) == list(range(48))
    assert bool(has[row_map[:n].long()].all()) and not bool(has[row_map[n:].long()].any())
    assert bool((row_map[:n].diff() > 0).all()) and bool((row_map[n:].diff() > 0).all())
    assert not bool(valid[n:].any())
    t, bd = tdx.title, tdx.body
    fwd = (t.fwd.ftT, t.fwd.fwT, bd.fwd.ftT, bd.fwd.fwT, t.posT, bd.posT)
    want = k2.plain_phrase_delta(*fwd, ph_ids, ph_valid, emit_flag=True)
    got = k2.plain_phrase_delta(*fwd, ids, valid, emit_flag=True)
    inv = torch.argsort(row_map.long())
    for g, w in zip(got, want):
        assert torch.equal(g[inv], w)
    rows = k6.tile_rows(48)
    terms, pay = probe.build_tables(k6.pad_column(48, "cpu"), torch.ones((1, 48), dtype=torch.int32),
                                    rows, ids, valid)
    real = terms[0] != probe.TERM_PAD
    tile = torch.arange(terms.shape[1])[:, None].expand_as(real)
    pos = tile * rows + (pay[0] >> 16)
    assert bool((pos[real] < n).all())
