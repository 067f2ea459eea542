#!/usr/bin/env python3
"""tbound_probe.py on the PyTorch port: does the doc-sorted layout with a
per-512-doc-block T bound on the body sweep pay on Hopper, and does the
TPU's megacore block balancing cost anything there?

    python3 experiments/torch_tbound_probe.py [n_docs] [--device cuda]

The original's synthetic shapes and draws (seed 0): n = 1,000,448 docs
(D padded to 512), body T 120 with 35-119 real slots per doc (-1 pads
after), title T 8 with 4 real slots, 30,000 words, B=128 queries of Q=4
with 1-4 active terms sorted descending (int32-max pads). The TPU's
variant kernel with a chunked dynamic-trip body loop is the function K1
computes with body_tmax (csrc/membership.cu: each warp stops at its
512-doc block's max distinct count), so the runs are K1 on the card
(its plain version with --device cpu), timed by CUDA events:
  - static T (body_tmax=None) on the natural doc order (the baseline);
  - for two layouts of the docs sorted by distinct count, descending:
    "balanced" (balance_blocks' snake order, which evens the two halves of
    a TPU megacore's grid) and "sorted-only": K1 static and K1 with
    body_tmax on that layout. Hopper schedules blocks dynamically, so the
    two layouts show what balancing costs here.
Beside them, on the natural order: K1's plain version and
torch.sparse.mm per section (CSR [D, V+1] weights of the real slots times
the [V+1, B] query-multiplicity matrix; scores only, as the timed K1 runs
elide counts), the one PyTorch call for the same function, held to K1's
scores within rel 1e-5 (another summation order) before it is timed.
The check (the original's, held per layout): the bounded run's scores
within rel 1e-6 of static on the same layout and its counts equal; and,
un-permuted, the title exactly and the body within rel 1e-6 of the
natural-order baseline. Timed runs elide counts, as the original's. Prints
the original's lines, then one JSON line; main() returns the same dict
(chip_smoke.py phase 17).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DOC_BLOCK = 512  # K1's TMAX_BLOCK
N_VOCAB = 30_000


def balance_blocks(tmax: np.ndarray) -> np.ndarray:
    """Reorder doc blocks so contiguous grid halves carry ~equal work
    (megacore splits the 1-D grid in half). Snake-assign sorted blocks to
    two halves. Returns the block order (new position -> old block)."""
    order = np.argsort(-tmax, kind="stable")
    a, b = [], []
    for i, blk in enumerate(order):
        (a if i % 4 in (0, 3) else b).append(blk)
    return np.array(a + b, dtype=np.int64)


def make_data(n: int, seed: int = 0) -> dict:
    """The original's arrays, drawn in its order: nt [D], body ft/fw
    [120, D], title ft/fw [8, D], term_ids [128, 4], qn [128]."""
    d = -(-n // DOC_BLOCK) * DOC_BLOCK
    rng = np.random.default_rng(seed)
    n_vocab = N_VOCAB
    tb_nat = 120
    tt = 8
    b, q = 128, 4
    nt = rng.integers(35, tb_nat, n).astype(np.int32)
    nt = np.concatenate([nt, np.zeros(d - n, np.int32)])  # pad docs empty
    probs_idx = rng.integers(0, n_vocab, size=(tb_nat, d), dtype=np.int32)
    mask = np.arange(tb_nat, dtype=np.int32)[:, None] < nt[None, :]
    bft = np.where(mask, probs_idx, -1).astype(np.int32)
    bfw = np.where(mask, rng.random((tb_nat, d), np.float32) + 0.01, 0.0).astype(np.float32)
    tft = np.where(
        np.arange(tt)[:, None] < 4, rng.integers(0, n_vocab, (tt, d)), -1
    ).astype(np.int32)
    tfw = np.where(tft >= 0, 0.5, 0.0).astype(np.float32)
    term_ids = rng.integers(0, n_vocab, (b, q)).astype(np.int32)
    qn = np.sort(rng.integers(1, q + 1, b).astype(np.int32))[::-1].copy()
    for i in range(b):
        term_ids[i, qn[i]:] = np.iinfo(np.int32).max
    return {"nt": nt, "bft": bft, "bfw": bfw, "tft": tft, "tfw": tfw,
            "term_ids": term_ids, "qn": qn}


def sparse_section(ft, fw, tq, qn, n_words: int):
    """(W, M) of torch.sparse.mm(W, M) for one section: W the CSR [D, V+1]
    weights of the real slots (each doc's columns sorted), M the dense
    [V+1, B] multiplicity matrix of each row's first qn columns, so
    sparse.mm(W, M)[d, b] is score[b, d]."""
    import torch

    big = torch.iinfo(torch.int32).max
    cols, order = torch.where(ft >= 0, ft, big).t().sort(dim=1)
    vals = fw.t().gather(1, order)
    real = cols != big
    crow = torch.zeros(cols.shape[0] + 1, dtype=torch.int64, device=ft.device)
    crow[1:] = real.sum(1).cumsum(0)
    w = torch.sparse_csr_tensor(crow, cols[real].long(), vals[real],
                                size=(cols.shape[0], n_words + 1))
    b, q = tq.shape
    active = torch.arange(q, device=ft.device)[None, :] < qn[:, None]
    m = torch.zeros((n_words + 1, b), dtype=torch.float32, device=ft.device)
    m.index_put_((torch.where(active, tq.long(), n_words).flatten(),
                  torch.arange(b, device=ft.device).repeat_interleave(q)),
                 torch.ones(b * q, device=ft.device), accumulate=True)
    m[n_words] = 0.0
    return w, m


def sorted_layouts(nt: np.ndarray) -> list[tuple[str, np.ndarray, np.ndarray]]:
    """(label, doc permutation, tmax per 512-doc block) of the docs sorted
    by distinct count, descending: block-balanced, then sorted only."""
    perm0 = np.argsort(-nt, kind="stable")
    tmax0 = nt[perm0].reshape(-1, DOC_BLOCK).max(axis=1)
    out = []
    for label, order in (("balanced", balance_blocks(tmax0)),
                         ("sorted-only", np.arange(len(tmax0)))):
        perm = perm0.reshape(-1, DOC_BLOCK)[order].reshape(-1)
        out.append((label, perm, tmax0[order].astype(np.int32)))
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n", nargs="?", type=int, default=1_000_448, help="docs")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=8)
    args = ap.parse_args(argv)

    import torch

    from spaghettisearch_tpu_torch.ops.kernels import check, membership

    dev = check.probe_device(args.device)
    data = make_data(args.n)
    b = data["term_ids"].shape[0]
    jtq = torch.from_numpy(data["term_ids"]).to(dev)
    jqn = torch.from_numpy(data["qn"]).to(dev)

    def put_layout(perm):
        return [torch.from_numpy(np.ascontiguousarray(data[k][:, perm])).to(dev)
                for k in ("tft", "tfw", "bft", "bfw")]

    def k1(arrs, tmax, emit_counts):
        return membership.forward_scores_2sec(*arrs, jtq, jqn, emit_counts=emit_counts,
                                              body_tmax=tmax)

    def rel_err(got, want):
        return float(((got - want).abs() / want.abs().clamp_min(1e-9)).max())

    membership.reset_launches()
    base = put_layout(np.arange(data["nt"].shape[0]))
    rows = [{int(t) for t in data["term_ids"][i, : data["qn"][i]]} for i in range(b)]
    bound = check.bound_ms([(base[0], rows), (base[2], rows)], N_VOCAB, b, base[0].shape[1], 2)
    print(f"bound (K1, counts elided, any layout): {bound[0]:.4f} ms ({bound[1]})", flush=True)
    ms = check.time_on(lambda: k1(base, None, False), dev, iters=args.reps, warmup=1)
    print(f"baseline static-T (T={data['bft'].shape[0]}, natural order): {ms:.4f} ms "
          f"({b * 1e3 / ms:.0f} qps)", flush=True)
    res = {"probe": "tbound", "device": str(dev), "n": args.n, "static_natural_ms": ms,
           "bound_ms": bound[0], "bound_by": bound[1], "layouts": {}}
    base_ts, _, base_bs, _ = k1(base, None, False)
    plain_ms = check.time_on(
        lambda: membership.plain_forward_scores_2sec(*base, jtq, jqn, emit_counts=False),
        dev, iters=1, warmup=1)
    print(f"K1 plain version (natural order): {plain_ms:.4f} ms", flush=True)
    ops = [sparse_section(base[k], base[k + 1], jtq, jqn, N_VOCAB) for k in (0, 2)]
    lib_rel = max(rel_err(torch.sparse.mm(w, m).t(), want)
                  for (w, m), want in zip(ops, (base_ts, base_bs)))
    lib_ms = check.time_on(lambda: [torch.sparse.mm(w, m) for w, m in ops], dev,
                           iters=args.reps, warmup=1)
    print(f"torch.sparse.mm per section (natural order): {lib_ms:.4f} ms "
          f"(max_rel vs K1 {lib_rel:.2e})", flush=True)
    res.update(plain_ms=plain_ms, library_ms=lib_ms, library_max_rel=lib_rel)
    del base, ops
    ok = True
    for label, perm, tmax_np in sorted_layouts(data["nt"]):
        arrs = put_layout(perm)
        tmax = torch.from_numpy(tmax_np).to(dev)
        static_ms = check.time_on(lambda: k1(arrs, None, False), dev, iters=args.reps, warmup=1)
        tb_ms = check.time_on(lambda: k1(arrs, tmax, False), dev, iters=args.reps, warmup=1)
        want = k1(arrs, None, True)
        got = k1(arrs, tmax, True)
        same_layout = max(rel_err(got[0], want[0]), rel_err(got[2], want[2]))
        counts_equal = bool(torch.equal(got[1], want[1]) and torch.equal(got[3], want[3]))
        inv = torch.from_numpy(np.argsort(perm)).to(dev)
        title_exact = bool(torch.equal(got[0][:, inv], base_ts))
        body_rel = rel_err(got[2][:, inv], base_bs)
        del want, got
        print(f"static {label}: {static_ms:.4f} ms ({b * 1e3 / static_ms:.0f} qps)", flush=True)
        print(f"tbound {label}: {tb_ms:.4f} ms ({b * 1e3 / tb_ms:.0f} qps) "
              f"title_exact={title_exact} body_max_rel={body_rel:.2e} "
              f"vs static same layout: max_rel={same_layout:.2e} counts_equal={counts_equal}",
              flush=True)
        layout_ok = same_layout <= 1e-6 and counts_equal and title_exact and body_rel <= 1e-6
        ok &= layout_ok
        res["layouts"][label] = {
            "static_ms": static_ms, "tbound_ms": tb_ms, "max_rel_vs_static": same_layout,
            "counts_equal": counts_equal, "title_exact": title_exact,
            "body_max_rel_vs_natural": body_rel, "ok": layout_ok,
            "swept_share": float(tmax_np.sum() / (len(tmax_np) * data["bft"].shape[0])),
        }
        del arrs
    res["ok"] = ok and lib_rel <= 1e-5
    res["launches"] = {"K1": membership.LAUNCHES}
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    raise SystemExit(0 if main()["ok"] else 1)
