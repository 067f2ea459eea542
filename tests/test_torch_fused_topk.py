"""K5's plain version (fused_topk's CPU route) against the TPU prototype it
replaces: experiments/fused2_probe.py build_kernel, run through
pl.pallas_call(..., interpret=True) with the probe's own BlockSpecs, at
D=2,048, B=16, Q=4, k_pad=16 and doc_block 512 or 1,024, so the
prototype's streaming merge crosses several grid steps.

The batches are adversarial for a streaming top-k: a row with no hit, a
row with fewer than k_pad hits, equal scores in different doc tiles (and
more equal scores than k_pad, so the k-th cut falls inside a tie), a
duplicated query term, a title score over a zero magnitude (+inf) and a
zero score over a zero magnitude (NaN -> 0). Values within rtol 1e-6 and
atol 1e-6 (two summation orders of f32), ids equal wherever a doc ranks
(the prototype leaves the ids of its -inf slots wherever its argmax
lands; the port writes id 0 there). Also the torch probe script at a
tiny size on the CPU, with its own exactness check.
"""

from __future__ import annotations

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from spaghettisearch_tpu_torch.ops.kernels import fused_topk as k5

EXPERIMENTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "experiments")
sys.path.insert(0, EXPERIMENTS)

from fused2_probe import build_kernel  # noqa: E402

torch.set_num_threads(1)
D, B, Q, K_PAD = 2048, 16, 4, 16
TT, TB, N_WORDS = 4, 24, 400
RARE, TIE, TITLE_INF = N_WORDS - 1, N_WORDS - 2, N_WORDS - 3  # planted terms
TIE_DOCS = np.linspace(3, D - 3, 40).astype(int)


def _distinct_slots(rng, t: int, d: int, lo: int) -> np.ndarray:
    """[t, d] int32: each doc lo..t distinct real terms first, -1 pads."""
    ft = np.full((t, d), -1, np.int32)
    for j in range(d):
        n = int(rng.integers(lo, t + 1))
        ft[:n, j] = rng.choice(N_WORDS - 3, n, replace=False)
    return ft


def _index(seed: int) -> dict:
    """A seeded index (each doc's real slots first, as the kernels require)
    with planted terms: RARE in 5 docs, TIE in 40 docs spread over every
    tile with equal weights and magnitudes (their body scores tie),
    TITLE_INF in doc 5's title with mag_title[5] = 0 (+inf); doc 9 holds
    TIE at weight 0 with zero magnitudes (0/0 in both sections -> 0)."""
    rng = np.random.default_rng(seed)
    tft, bft = _distinct_slots(rng, TT, D, 0), _distinct_slots(rng, TB, D, 2)
    tfw = np.where(tft >= 0, rng.random((TT, D)) + 0.01, 0.0).astype(np.float32)
    bfw = np.where(bft >= 0, rng.random((TB, D)) + 0.01, 0.0).astype(np.float32)
    mt = (rng.random(D) + 0.5).astype(np.float32)
    mb = (rng.random(D) + 0.5).astype(np.float32)
    bft[1, TIE_DOCS], bfw[1, TIE_DOCS] = TIE, 0.5
    mb[TIE_DOCS] = 1.0
    for j in rng.choice(D, 5, replace=False):
        bft[0, j], bfw[0, j] = RARE, 0.7
    tft[0, 5], tfw[0, 5], mt[5] = TITLE_INF, 0.9, 0.0
    bft[1, 9], bfw[1, 9], mt[9], mb[9] = TIE, 0.0, 0.0, 0.0
    return {"tft": tft, "tfw": tfw, "bft": bft, "bfw": bfw, "mt": mt, "mb": mb}


def _batch(seed: int, ix: dict) -> tuple[np.ndarray, np.ndarray]:
    """[B, Q] rows: no hit, fewer than k_pad hits, the tie term alone (40
    equal scores across the tiles), a duplicated term, the +inf title,
    then df-weighted rows with some unknown-word pads."""
    rng = np.random.default_rng(seed + 1)
    df = np.bincount(ix["bft"][ix["bft"] >= 0], minlength=N_WORDS).astype(np.float64) + 1
    tq = rng.choice(N_WORDS, (B, Q), p=df / df.sum()).astype(np.int32)
    tq[0] = N_WORDS + 7  # unknown everywhere
    tq[1] = [RARE, N_WORDS, N_WORDS, N_WORDS]
    tq[2] = [TIE, N_WORDS, N_WORDS, N_WORDS]
    tq[3, 1] = tq[3, 0]
    tq[4, 0] = TITLE_INF
    tq[11, 2:] = N_WORDS
    qlen = rng.integers(1, Q + 1, B).astype(np.float32)
    return tq, qlen


def _pallas_topk(ix: dict, tq, qlen, doc_block: int, b_block: int = 8):
    """The prototype's kernel as fused2_probe.py's make() calls it, in
    interpret mode."""
    kernel = functools.partial(build_kernel(K_PAD, Q), b_block=b_block)
    spec = lambda rows: pl.BlockSpec((rows, doc_block), lambda i: (0, i),  # noqa: E731
                                     memory_space=pltpu.VMEM)
    vals, ids = pl.pallas_call(
        kernel,
        grid=(D // doc_block,),
        in_specs=[
            pl.BlockSpec((B, Q), lambda i: (0, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((B,), lambda i: (0,), memory_space=pltpu.VMEM),
            spec(TT), spec(TT), spec(TB), spec(TB), spec(1), spec(1),
        ],
        out_specs=[pl.BlockSpec((B, K_PAD), lambda i: (0, 0), memory_space=pltpu.VMEM)] * 2,
        out_shape=[jax.ShapeDtypeStruct((B, K_PAD), jnp.float32),
                   jax.ShapeDtypeStruct((B, K_PAD), jnp.int32)],
        interpret=True,
    )(jnp.asarray(tq), jnp.asarray(qlen), *(jnp.asarray(ix[k]) for k in ("tft", "tfw", "bft", "bfw")),
      jnp.asarray(ix["mt"])[None], jnp.asarray(ix["mb"])[None])
    return np.asarray(vals), np.asarray(ids)


def _port_topk(ix: dict, tq, qlen, k_pad: int = K_PAD):
    args = [torch.from_numpy(ix[k]) for k in ("tft", "tfw", "bft", "bfw", "mt", "mb")]
    vals, ids = k5.fused_topk(*args, torch.from_numpy(tq), torch.from_numpy(qlen), k_pad)
    return vals.numpy(), ids.numpy()


@pytest.mark.parametrize("doc_block", [512, 1024])
@pytest.mark.parametrize("seed", [0, 1])
def test_fused_topk_plain_matches_pallas_prototype(seed, doc_block):
    ix = _index(seed)
    tq, qlen = _batch(seed, ix)
    want_v, want_i = _pallas_topk(ix, tq, qlen, doc_block)
    got_v, got_i = _port_topk(ix, tq, qlen)
    np.testing.assert_allclose(got_v, want_v, rtol=1e-6, atol=1e-6)
    ranked = want_v > -np.inf
    assert np.array_equal(got_i[ranked], want_i[ranked])
    assert (got_i[~ranked] == 0).all()
    # the planted cases are there
    assert not ranked[0].any()  # no hit
    assert 0 < ranked[1].sum() < K_PAD  # fewer hits than k_pad
    assert (got_v[2] == got_v[2, 0]).all() and list(got_i[2]) == sorted(TIE_DOCS)[:K_PAD]
    assert got_v[4, 0] == np.inf
    assert np.isfinite(got_v[ranked & (got_v < np.inf)]).all()


def test_fused_topk_plain_is_the_full_rank_cut():
    """The plain version's k_pad slots are the head of the whole final
    row ordered by (value desc, id asc): a k_pad wider than the row's
    candidates pads -inf / id 0, and k_pad past D pads too."""
    ix = _index(2)
    tq, qlen = _batch(2, ix)
    wide_v, wide_i = _port_topk(ix, tq, qlen, k_pad=k5.K_MAX)
    v, i = _port_topk(ix, tq, qlen)
    assert np.array_equal(v, wide_v[:, :K_PAD]) and np.array_equal(i, wide_i[:, :K_PAD])
    small = {k: x[..., :24] for k, x in ix.items()}  # D=24 < k_pad
    sv, si = _port_topk(small, tq, qlen, k_pad=k5.K_MAX)
    assert sv.shape == (B, k5.K_MAX) and (si[sv == -np.inf] == 0).all()


def test_torch_fused2_probe_runs_on_cpu():
    """experiments/torch_fused2_probe.py at a tiny size with --device cpu:
    its own exactness check (top-10 values against the production keyword
    scorer at rtol 1e-5, atol 1e-6; K5 against its plain version) passes."""
    import torch_fused2_probe

    res = torch_fused2_probe.main(["--device", "cpu", "--docs", "1500", "--words", "800",
                                   "--batch", "16", "--reps", "1"])
    assert res["ok"] and res["matches_prod"] and res["vs_plain"]["ok"]
    assert res["launches"] == {"K1": 0, "K5": 0}  # the CPU route launches nothing


def test_fused_topk_launch_plan():
    """The sweep's grid: about two waves of 5 resident blocks per SM,
    fewer chunks per block at small sizes, at most 64."""
    assert k5.chunks_per_block(100_352, 256, 32, 132) == 5  # 157 blocks per tile
    assert k5.chunks_per_block(100_352, 16, 16, 132) == 1
    assert k5.chunks_per_block(100_000_000, 256, 32, 132) == 64
