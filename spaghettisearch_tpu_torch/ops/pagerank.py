"""Topic-sensitive PageRank as a batched power iteration on the card.

The port of the JAX package's ops/pagerank.py (reference:
ranking/pagerank.go:14-145). The link graph is two flat edge arrays (src,
dst) sorted by destination, the rank vectors are dense, and one loop
iterates all categories at once:

    contrib[p] = d * r[p] / outdeg[p]           (0 when outdeg == 0)
    inherited  = segment_sum(contrib[src] -> dst)
    total      = sum(contrib) + (1-d) * N
    r'         = (first_iter * r + inherited + (1-d)) / total
    delta      = sum(|r' - r|)   ; stop when delta <= eps (or max_iters)

Reference quirks preserved: the first iteration adds the uniform init value
on top of the inherited mass (pagerank.go:97-107 only clears currentRank from
iteration 2), and the init is 1/numPages with numPages taken from the
*category metadata*, not the node count (pagerank.go:60-61,104). Converged
categories yield identical vectors: the category axis is decorative, as in
the reference. `personalized=True` runs the repaired model (per-category
teleport vectors from the ODP term profiles).

What differs from the JAX package, and why:
- The segmented sum adds each destination's edges in one fixed order: the
  destination-sorted edges make a CSR row pointer, and
  `torch.segment_reduce` sums each row's gathered contributions with no
  atomics, so two runs on the card give bit-identical ranks (an
  `index_add_` on CUDA adds with atomics in whatever order they land).
  Ranks are kept node-major, [N, C], so the gather reads whole rows.
- The dtype is explicit (float32 by default, as the TPU ran it) where the
  JAX package read `jax_enable_x64`, and so is the device: `update_pagerank`
  runs on CUDA unless it is given `device="cpu"`.
- No power-of-two padding: it existed only to reuse XLA compiles.
- The stop rule is the JAX one: stop after the first iteration whose delta
  is <= eps (or is NaN), or at max_iters; one host read of delta per
  iteration.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..config import PAGERANK_CONVERGENCE, PAGERANK_DAMPING
from ..store.tables import Database

DEFAULT_MAX_ITERS = 200


def csr_offsets(edge_dst: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """Row pointer [N+1] of destination-sorted edges, in the edge ids' dtype
    (int32 from _load_graph: the iteration reads 4 B per edge and node)."""
    counts = torch.bincount(edge_dst, minlength=n_nodes)
    offsets = torch.zeros(n_nodes + 1, dtype=edge_dst.dtype, device=edge_dst.device)
    offsets[1:] = torch.cumsum(counts, 0)
    return offsets


def _inherited(contrib: torch.Tensor, edge_src: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """[N, C] sum over each destination's in-edges of contrib[src] ([N, C]),
    in edge order."""
    return torch.segment_reduce(contrib.index_select(0, edge_src), "sum", offsets=offsets, axis=0)


def _iterate(step, r: torch.Tensor, eps: float, max_iters: int, stats: dict | None) -> torch.Tensor:
    it = 0
    while True:
        r_new = step(r, it)
        # max over categories of the L1 change (the JAX package's delta)
        delta = float((r_new - r).abs().sum(dim=0).max())
        r, it = r_new, it + 1
        if not (delta > eps and it < max_iters):
            break
    if stats is not None:
        stats["iterations"] = it
        stats["delta"] = delta
    return r


def pagerank_power(
    edge_src: torch.Tensor,  # int [E] parent node ids (sorted by edge_dst)
    edge_dst: torch.Tensor,  # int [E] child node ids
    outdeg: torch.Tensor,  # float [N]
    n_pages: torch.Tensor,  # float [C] per-category page count (init 1/n)
    n_nodes: int,
    damping: float = PAGERANK_DAMPING,
    eps: float = PAGERANK_CONVERGENCE,
    max_iters: int = DEFAULT_MAX_ITERS,
    stats: dict | None = None,
) -> torch.Tensor:
    """Returns ranks [C, N] on outdeg's device, in outdeg's dtype (pass
    float64 for bit-level parity tests). `stats`, if given, receives the
    iteration count and the last delta."""
    dtype = outdeg.dtype
    c = n_pages.shape[0]
    offsets = csr_offsets(edge_dst, n_nodes)
    teleport = 1.0 - damping
    inv_out = torch.where(outdeg > 0, damping / torch.clamp(outdeg, min=1), 0.0).to(dtype)
    total_base = torch.tensor(teleport * n_nodes, dtype=dtype, device=outdeg.device)
    r0 = (1.0 / n_pages).to(dtype)[None, :].expand(n_nodes, c).contiguous()  # [N, C]

    def step(r: torch.Tensor, it: int) -> torch.Tensor:
        contrib = r * inv_out[:, None]
        inherited = _inherited(contrib, edge_src, offsets)
        total = contrib.sum(dim=0) + total_base  # [C]
        base = r if it == 0 else 0.0
        return (base + inherited + teleport) / total

    return _iterate(step, r0, eps, max_iters, stats).t()


def pagerank_personalized(
    edge_src: torch.Tensor,  # int [E] (sorted by edge_dst)
    edge_dst: torch.Tensor,  # int [E]
    outdeg: torch.Tensor,  # float [N]
    personalization: torch.Tensor,  # float [C, N] (row-normalized)
    n_nodes: int,
    damping: float = PAGERANK_DAMPING,
    eps: float = 1e-12,
    max_iters: int = DEFAULT_MAX_ITERS,
    stats: dict | None = None,
) -> torch.Tensor:
    """Textbook topic-sensitive PageRank (one batched power iteration over
    the categories): r' = d*(A r + dangling_mass * p) + (1-d) * p.
    Returns ranks [C, N] (each category sums to 1). This is the repaired
    model the reference's decorative category loop was meant to be."""
    dtype = outdeg.dtype
    offsets = csr_offsets(edge_dst, n_nodes)
    p = personalization.to(dtype).t().contiguous()  # [N, C]
    inv_out = torch.where(outdeg > 0, 1.0 / torch.clamp(outdeg, min=1), 0.0).to(dtype)
    dangling_w = (outdeg <= 0).to(dtype)

    def step(r: torch.Tensor, it: int) -> torch.Tensor:
        contrib = r * inv_out[:, None]
        inherited = _inherited(contrib, edge_src, offsets)
        dangling = (r * dangling_w[:, None]).sum(dim=0)  # [C]
        return damping * (inherited + dangling * p) + (1.0 - damping) * p

    return _iterate(step, p, eps, max_iters, stats).t()


def topic_personalization(
    db: Database, node_list: list[str], categories: list[str]
) -> np.ndarray:
    """Per-category teleport vectors [C, N] from the ODP term profiles:
    affinity(doc, cat) = sum over the doc's terms of the category's ODP
    frequency for that term (invTopic_PR, ODP-scraper.go:128-139) weighted
    by the doc's term frequency (DocInfo words_mapping), row-normalized.
    Categories with zero affinity everywhere fall back to uniform."""
    node_id = {h: i for i, h in enumerate(node_list)}
    cat_id = {c: j for j, c in enumerate(categories)}
    n, c = len(node_list), len(categories)
    # word -> per-category freq (the ODP vocabulary is small)
    word_cat = {wh: row for wh, row in db.inv_topic.items()}
    aff = np.zeros((c, n), dtype=np.float64)
    for dh, info in db.doc_info.items():
        i = node_id.get(dh)
        if i is None:
            continue
        for wh, tf in info.words_mapping.items():
            row = word_cat.get(wh)
            if not row:
                continue
            for cat, freq in row.items():
                j = cat_id.get(cat)
                if j is not None:
                    aff[j, i] += float(freq) * float(tf)
    sums = aff.sum(axis=1, keepdims=True)
    uniform = np.full((1, n), 1.0 / max(n, 1))
    return np.where(sums > 0, aff / np.maximum(sums, 1e-30), uniform)


def _load_graph(db: Database) -> tuple[list[str], np.ndarray, np.ndarray, np.ndarray]:
    """Node census + edge arrays from the children table
    (reference: pagerank.go:18-43 builds the same node set)."""
    children_rows = dict(db.doc_children.items())
    nodes: set[str] = set(children_rows)
    for kids in children_rows.values():
        nodes.update(kids)
    node_list = sorted(nodes)
    node_id = {h: i for i, h in enumerate(node_list)}

    srcs: list[int] = []
    dsts: list[int] = []
    outdeg = np.zeros(len(node_list), dtype=np.float64)
    for parent, kids in children_rows.items():
        p = node_id[parent]
        outdeg[p] = len(kids)
        for kid in kids:
            srcs.append(p)
            dsts.append(node_id[kid])

    edge_src = np.asarray(srcs, dtype=np.int32)
    edge_dst = np.asarray(dsts, dtype=np.int32)
    order = np.argsort(edge_dst, kind="stable")
    return node_list, edge_src[order], edge_dst[order], outdeg


def _device(device: str | torch.device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"update_pagerank(device={str(device)!r}): CUDA is not available "
            "(pass device='cpu' to run on the CPU explicitly)"
        )
    return device


def update_pagerank(
    db: Database,
    damping: float = PAGERANK_DAMPING,
    eps: float = PAGERANK_CONVERGENCE,
    max_iters: int = DEFAULT_MAX_ITERS,
    personalized: bool = False,
    device: str | torch.device = "cuda",
    dtype: torch.dtype = torch.float32,
    keep_ranks: bool = False,
) -> dict:
    """Recompute per-category PageRank on `device` in `dtype` and store
    doc_rank rows (reference: ranking/pagerank.go:14-83). personalized=True
    runs the repaired topic-sensitive model (per-category ODP teleport
    vectors) instead of the reference's decorative category loop.
    -> {"nodes", "edges", "categories", "iterations", "ms"}: ms is the
    iteration's time (CUDA events on the card, the host clock otherwise);
    with keep_ranks also "node_list" (the sorted node hashes) and "ranks"
    (numpy [categories, nodes], the numbers the rows hold)."""
    device = _device(device)
    node_list, edge_src, edge_dst, outdeg = _load_graph(db)
    n_nodes = len(node_list)
    run = {"nodes": n_nodes, "edges": len(edge_src), "categories": 0,
           "iterations": 0, "ms": 0.0}
    if n_nodes == 0:
        return run

    categories = sorted(db.topic_meta.keys())
    run["categories"] = len(categories)
    if categories:
        src = torch.as_tensor(edge_src, device=device)
        dst = torch.as_tensor(edge_dst, device=device)
        out = torch.as_tensor(outdeg, dtype=dtype, device=device)
        if personalized:
            pers = topic_personalization(db, node_list, categories)
            args = (torch.as_tensor(pers, dtype=dtype, device=device),)
            fn, kw = pagerank_personalized, {"eps": max(eps, 1e-12)}
        else:
            n_pages = np.array(
                [max(float((db.topic_meta.get(c) or {}).get("numPages", 0.0)), 1.0)
                 for c in categories]
            )
            args = (torch.as_tensor(n_pages, dtype=dtype, device=device),)
            fn, kw = pagerank_power, {"eps": eps}
        stats: dict = {}
        on_card = device.type == "cuda"
        if on_card:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        ranks = fn(src, dst, out, *args, n_nodes, damping=damping, max_iters=max_iters,
                   stats=stats, **kw)
        if on_card:
            end.record()
            end.synchronize()
            run["ms"] = start.elapsed_time(end)
        else:
            run["ms"] = 1e3 * (time.perf_counter() - t0)
        run["iterations"] = stats["iterations"]
        ranks = ranks.cpu().numpy()
    else:
        ranks = np.zeros((0, n_nodes))

    with db.doc_rank.batch() as bw:
        for i, node in enumerate(node_list):
            bw.set(node, {c: float(ranks[j, i]) for j, c in enumerate(categories)})
    if keep_ranks:
        run.update(node_list=node_list, ranks=ranks)
    return run
