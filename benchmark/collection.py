"""The general collection generator: a search shard drawn from a seed.

A configuration file (configs/<name>.json) gives the deployment's sizes;
`generate` draws the shard's documents from them on a torch device and
returns both forms of it:

- the raw collection (`Collection`): every document's content tokens in
  order, as vocabulary ranks, for the title and the body, plus the
  vocabulary's words. This is what the plain reference (reference.py)
  reads;
- the snapshot the offline build would write for it (`snapshot`), in the
  port's `IndexSnapshot` format: postings per word sorted by doc id,
  normTF x idf weights, positions, per-doc magnitudes, PageRank. This is
  what the port's engine loads.

Two seeds make a shard. The content seed (fixed in the cell's file) draws
the documents' tokens, so every run of a cell does the same work: words
Zipf over the whole vocabulary, whose `zipf_head_ranks` head ranks are the
stopwords the build drops, so content words take the ranks after them. The run's seed permutes what the port
sees: which doc id each document gets (doc ids are the sorted hashes of
the documents' URLs, as the build assigns them) and which word each rank
is labelled with (word ids are the sorted hashes of the words). A word is
"t<n>", a token the port's parse leaves unchanged (no letter suffix for
the stemmer to strip, not a stopword), so the reference needs no stemmer.
Positions are a token's index in its section's content stream (stopwords
are never emitted into a document: the build drops them before positions
are counted here).

The snapshot's arithmetic restates the build's (index/indexer.py and
ops/weighting.py of the port): normTF = tf / max tf of the doc's section,
divided in f64 and rounded to f32; idf = log2(N / df) per section, N the
doc census, rounded to f32; weight = normTF * idf in f32; magnitude =
sqrt of the doc's f64 sum of squared weights, rounded to f32.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

import numpy as np
import torch

#: pad the build leaves after each posting array (index/snapshot.py _pad_to)
_PAD = 128
#: positions are packed below the doc/word key while sorting, so a
#: section holds fewer tokens than this
_POS_BITS = 8


def word_string(rank: int) -> str:
    """The vocabulary word of a 0-based rank."""
    return f"t{rank + 1}"


def doc_url(i: int, cfg: dict) -> str:
    return cfg["url_pattern"].format(i)


@dataclass
class Section:
    """One section's content tokens and postings, in vocabulary ranks."""

    tok: np.ndarray  # int32 [D, L] rank of each content token, -1 pad
    df: np.ndarray  # int64 [V] docs holding each rank
    n_postings: int  # (doc, word) pairs: the forward index's real slots
    max_tf: int = 0  # most tokens of one word in one doc's section


@dataclass
class Collection:
    config: dict
    seed: int
    n_docs: int
    vocab_size: int
    title: Section
    body: Section
    #: rank -> word id in the snapshot (-1 for a rank no doc holds)
    word_id: np.ndarray
    #: rank -> the label its word string carries (word_string(label))
    labels: np.ndarray
    #: content doc index -> doc id (row of the token matrices)
    row_of: np.ndarray
    snapshot: object = None  # the port's IndexSnapshot
    stats: dict = field(default_factory=dict)

    def word(self, rank: int) -> str:
        return word_string(int(self.labels[rank]))

    def words(self) -> list[str]:
        """The vocabulary, by rank."""
        return [word_string(x) for x in self.labels.tolist()]


def _zipf_cdf(v: int, s: float, head: int, device) -> torch.Tensor:
    """The content words' cdf: Zipf ranks head + 1 .. head + v."""
    p = torch.arange(head + 1, head + v + 1, dtype=torch.float64, device=device).pow(-s)
    cdf = torch.cumsum(p, 0)
    return cdf / cdf[-1]


def _draw_ranks(n: int, cdf: torch.Tensor, g: torch.Generator) -> torch.Tensor:
    u = torch.rand(n, dtype=torch.float64, device=cdf.device, generator=g)
    return torch.searchsorted(cdf, u).clamp_(max=cdf.numel() - 1)


def _matrix(lengths: torch.Tensor, ranks: torch.Tensor) -> torch.Tensor:
    """The padded [D, L] token matrix of docs of the given lengths."""
    d = lengths.numel()
    doc = torch.repeat_interleave(torch.arange(d, device=lengths.device), lengths)
    start = torch.cumsum(lengths, 0) - lengths
    pos = torch.arange(doc.numel(), device=lengths.device) - start[doc]
    tok = torch.full((d, int(lengths.max())), -1, dtype=torch.int32, device=lengths.device)
    tok[doc, pos] = ranks.to(torch.int32)
    return tok


def _postings(doc, pos, rank, v: int):
    """Group tokens into (doc, rank) postings. -> (doc, rank, tf, positions
    grouped per posting in (doc, rank) order, ascending within)."""
    if int(pos.max()) >= 1 << _POS_BITS:
        raise ValueError("a section holds more tokens than the position packing allows")
    comp = ((doc.long() * v + rank.long()) << _POS_BITS) | pos.long()
    comp = torch.sort(comp).values
    key = comp >> _POS_BITS
    ukey, tf = torch.unique_consecutive(key, return_counts=True)
    return ukey // v, ukey % v, tf, comp & ((1 << _POS_BITS) - 1)


def _weights(pdoc, prank, tf, n_docs: int, v: int):
    """The build's normTF x idf per posting and the per-doc magnitudes."""
    maxtf = torch.zeros(n_docs, dtype=tf.dtype, device=tf.device)
    maxtf.scatter_reduce_(0, pdoc, tf, "amax")
    ntf = (tf.double() / maxtf[pdoc].double()).float()
    df = torch.bincount(prank, minlength=v)
    idf = torch.log2(float(n_docs) / df.double().clamp(min=1)).float()
    w = ntf * idf[prank]
    # postings are sorted by doc: a segment sum per doc, in one order
    lengths = torch.bincount(pdoc, minlength=n_docs)
    sq = torch.segment_reduce(w.double().pow(2), "sum", lengths=lengths)
    return w, torch.sqrt(sq).float(), df


def _pad_to(n: int) -> int:
    return (n // _PAD + 1) * _PAD


def _csr(pdoc, prank, tf, positions, w, id_of_rank, n_words: int, n_docs: int):
    """The snapshot's SectionCSR arrays (host numpy): postings by (word id,
    doc id), positions regrouped to follow them."""
    from spaghettisearch_tpu_torch.index.snapshot import SectionCSR

    wid = id_of_rank[prank]
    perm = torch.argsort(wid * n_docs + pdoc)
    n_post = int(perm.numel())
    tf_s = tf[perm]
    counts = torch.bincount(wid, minlength=n_words)
    post_offsets = torch.zeros(n_words + 1, dtype=torch.int64, device=w.device)
    post_offsets[1:] = torch.cumsum(counts, 0)
    old_start = torch.cumsum(tf, 0) - tf
    new_start = torch.cumsum(tf_s, 0) - tf_s
    total = int(tf_s.sum())
    src = torch.repeat_interleave(old_start[perm] - new_start, tf_s) + torch.arange(
        total, device=w.device
    )
    p_pad, l_pad = _pad_to(n_post), _pad_to(total)
    doc_ids = np.full(p_pad, n_docs, np.int32)
    doc_ids[:n_post] = pdoc[perm].int().cpu().numpy()
    weights = np.zeros(p_pad, np.float32)
    weights[:n_post] = w[perm].cpu().numpy()
    pos_offsets = np.full(p_pad + 1, total, np.int32)
    pos_offsets[: n_post + 1] = np.concatenate(
        [[0], torch.cumsum(tf_s, 0).cpu().numpy()]
    )
    pos = np.full(l_pad, np.inf, np.float32)
    pos[:total] = positions[src].float().cpu().numpy()
    return SectionCSR(
        post_offsets=post_offsets.int().cpu().numpy(),
        doc_ids=doc_ids,
        weights=weights,
        pos_offsets=pos_offsets,
        positions=pos,
        n_postings=n_post,
        max_df=int(counts.max()) if n_words else 0,
        max_positions=int(tf.max()) if n_post else 0,
    )


def _title_lengths(cfg: dict, d: int, g, device) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Title token counts per doc, and per doc its article (runs of
    passages sharing one title) or None."""
    lo, hi = cfg["title_words"]
    run = cfg.get("title_run_mean")
    if not run:
        return torch.randint(lo, hi + 1, (d,), generator=g, device=device), None
    n_art = int(d / run * 1.25) + 16
    sizes = 1 + torch.poisson(
        torch.full((n_art,), float(run) - 1.0, device=device), generator=g
    ).long()
    if int(sizes.sum()) < d:
        raise ValueError("title runs do not cover the shard")
    slot_art = torch.repeat_interleave(torch.arange(n_art, device=device), sizes)[:d]
    art = torch.empty(d, dtype=torch.long, device=device)
    art[torch.randperm(d, generator=g, device=device)] = slot_art
    art_len = torch.randint(lo, hi + 1, (n_art,), generator=g, device=device)
    return art_len, art


def generate(cfg: dict, seed: int, device: str | torch.device = "cuda",
             snapshot: bool = True, content_seed: int | None = None) -> Collection:
    """Draw the configuration's shard on `device`: its content from
    `content_seed` (the run's seed when None), its doc ids and word labels
    from `seed`."""
    device = torch.device(device)
    d, v = int(cfg["n_docs"]), int(cfg["vocab_size"])
    g = torch.Generator(device=device)
    g.manual_seed(int(seed if content_seed is None else content_seed) & ((1 << 63) - 1))
    cdf = _zipf_cdf(v, float(cfg["zipf_s"]), int(cfg["zipf_head_ranks"]), device)

    body_len = torch.binomial(
        torch.full((d,), float(cfg["body_words"]), device=device),
        torch.full((d,), float(cfg["content_share"]), device=device),
        generator=g,
    ).long().clamp_(min=2)
    b_tok = _matrix(body_len, _draw_ranks(int(body_len.sum()), cdf, g))
    t_len, art = _title_lengths(cfg, d, g, device)
    if art is None:
        t_tok = _matrix(t_len, _draw_ranks(int(t_len.sum()), cdf, g))
    else:  # one title per article, shared by its passages
        t_tok = _matrix(t_len, _draw_ranks(int(t_len.sum()), cdf, g))[art]
    # PageRank: a power law of the configured exponent (Pareto, x_min 1),
    # normalized to sum 1; one category
    alpha = float(cfg["pagerank_exponent"])
    u = torch.rand(d, dtype=torch.float64, device=device, generator=g)
    pr = (1.0 - u).pow(-1.0 / (alpha - 1.0))
    pr = pr / pr.sum()

    # the run's seed: which doc id each document gets, which label each rank
    g.manual_seed(int(seed) & ((1 << 63) - 1))
    order = torch.randperm(d, generator=g, device=device)
    labels = torch.randperm(v, generator=g, device=device).cpu().numpy()
    b_tok, t_tok, pr = b_tok[order], t_tok[order], pr[order]
    row_of = torch.empty_like(order)
    row_of[order] = torch.arange(d, device=device)

    sections = {}
    for name, tok in (("title", t_tok), ("body", b_tok)):
        doc, pos = (tok >= 0).nonzero(as_tuple=True)
        pdoc, prank, tf, positions = _postings(doc, pos, tok[doc, pos].long(), v)
        w, mag, df = _weights(pdoc, prank, tf, d, v)
        sections[name] = (pdoc, prank, tf, positions, w, mag, df, tok)

    df_all = sections["title"][6] + sections["body"][6]
    present = (df_all > 0).cpu().numpy()
    id_of_rank, word_hashes = _word_ids(present, labels)

    coll = Collection(
        config=cfg, seed=int(seed), n_docs=d, vocab_size=v,
        title=Section(t_tok.cpu().numpy(), sections["title"][6].cpu().numpy(),
                      int(sections["title"][0].numel()), int(sections["title"][2].max())),
        body=Section(b_tok.cpu().numpy(), sections["body"][6].cpu().numpy(),
                     int(sections["body"][0].numel()), int(sections["body"][2].max())),
        word_id=id_of_rank, labels=labels, row_of=row_of.cpu().numpy(),
    )
    coll.stats = {
        "body_tokens_mean": float(body_len.double().mean()),
        "title_tokens_mean": float((t_tok >= 0).sum(dim=1).double().mean()),
        "body_terms_max": int(torch.bincount(sections["body"][0], minlength=d).max()),
        "n_words": int(present.sum()),
    }
    if snapshot:
        coll.snapshot = _snapshot(cfg, coll, sections, word_hashes, pr, device)
    return coll


def _word_ids(present: np.ndarray, labels: np.ndarray) -> tuple[np.ndarray, list[str]]:
    """rank -> word id: the present words' hashes in sorted order, as the
    build numbers them (-1 for an absent rank); and the sorted hashes."""
    hashes = np.array(
        [hashlib.md5(word_string(x).encode()).hexdigest() for x in labels.tolist()],
        dtype="S32",
    )
    order = np.argsort(hashes, kind="stable")
    keep = present[order]
    id_of_rank = np.full(len(present), -1, np.int64)
    id_of_rank[order[keep]] = np.arange(int(keep.sum()))
    return id_of_rank, [h.decode() for h in hashes[order[keep]]]


def _snapshot(cfg, coll: Collection, sections, word_hashes, pr, device):
    from spaghettisearch_tpu_torch.index.snapshot import IndexSnapshot

    d = coll.n_docs
    n_words = len(word_hashes)
    doc_hashes = sorted(hashlib.md5(doc_url(i, cfg).encode()).hexdigest() for i in range(d))
    id_dev = torch.from_numpy(coll.word_id).to(device)
    csr = {}
    mags = {}
    for name, (pdoc, prank, tf, positions, w, mag, _df, _tok) in sections.items():
        csr[name] = _csr(pdoc, prank, tf, positions, w, id_dev, n_words, d)
        mags[name] = mag.cpu().numpy()
    return IndexSnapshot(
        doc_hashes=doc_hashes,
        word_hashes=word_hashes,
        doc_id={h: i for i, h in enumerate(doc_hashes)},
        word_id={h: i for i, h in enumerate(word_hashes)},
        title=csr["title"],
        body=csr["body"],
        mag_title=mags["title"],
        mag_body=mags["body"],
        categories=["pagerank"],
        pagerank=pr.float().cpu().numpy()[:, None],
    )
